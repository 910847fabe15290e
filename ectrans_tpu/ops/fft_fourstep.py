"""Four-step (Cooley-Tukey N = N1*N2) FFT built from real matmuls.

The Bluestein convolution FFTs run as matmuls rather than as log2(N)
radix-2 sweeps (each a full device-memory round trip — the pure-XLA loop
in ``realfft.py``): the DFT is factored as

    X[k1 + N1*k2] = DFT_N2( W_N^(n2*k1) * DFT_N1(x[n1*N2 + n2]) )

with both inner DFTs executed as dense (N1, N1) / (N2, N2) complex matrix
multiplies over the whole batch (the reference GPU backend feeds cuFFT
instead, ``hicfft.cuda.cu``; the design was chosen for an earlier
accelerator with no FFT op and no complex dtype).  Three memory round
trips in total, no unrolled stages.

Ordering: the forward transform leaves results in (k1, k2) layout — flat
position p = k1*N2 + k2 holds natural frequency k1 + N1*k2 (``ord_map``).
The inverse kernel is the exact transposed network: it consumes that
layout and emits natural order.  Inside a Bluestein convolution the
pointwise table is simply pre-permuted on the host, so no device
reordering ever happens.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .legendre_matmul import tier_einsum

# Precision tier of the DFT/twiddle matmuls for each public tier (see
# legendre_matmul.tier_einsum for what each tier computes; float64 data
# always contracts in true fp64).  The FFT layer runs true fp32 at BOTH the
# "highest" and "high" tiers: reduced operand precision is amplified by
# the chirp-z convolution lengths (~4k at TCO1279) past the reference's
# 100*eps(fp32) benchmark gate, while the Legendre layer tolerates it.  The
# split mirrors the reference GPU backend's own precision choices:
# reduced-precision Legendre GEMMs (CUTLASS 3xTF32,
# ``hicblas_cutlass.cuda.h``) with full-fp32 cuFFT.  The bf16 tier runs one
# bf16 pass in both layers, gated at the reference's relaxed FLT precedent
# (1e6*eps).
_FFT_TIER = {"highest": "highest", "high": "highest", "bf16": "bf16"}


def fft_tier(prec) -> str:
    """Tier of the FFT matmuls for a public tier (None = "highest").
    ECTRANS_TPU_FFT_PREC overrides it independently of the public
    precision argument (mixed-precision experiments: the LT and FFT layers
    have different error-vs-resolution slopes)."""
    import os

    override = os.environ.get("ECTRANS_TPU_FFT_PREC", "")
    if override:
        return override
    return _FFT_TIER["highest" if prec is None else prec]


def _factor(n: int) -> tuple[int, int]:
    """Split n = N1 * N2 with N2 = 128 when possible (a factor chosen for
    an earlier accelerator's 128-lane tiles; ROADMAP 3.2 re-measures it);
    otherwise as square as possible."""
    if n % 128 == 0 and 2 <= n // 128 <= 512:
        return n // 128, 128
    n1 = int(np.sqrt(n))
    while n % n1:
        n1 -= 1
    return n1, n // n1


def good_size(target: int) -> int:
    """Smallest transform length >= target of the form k*128 (four-step
    factors with N2 = 128, see _factor; a pow-2 length would pad the
    Bluestein convolution by up to 2x)."""
    if target <= 256:
        return target
    return -(-target // 128) * 128


def ord_map(n: int) -> np.ndarray:
    """Flat forward-output position p = k1*N2 + k2 -> natural frequency
    k1 + N1*k2."""
    if n <= 256:
        return np.arange(n)
    n1, n2 = _factor(n)
    k1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    return (k1 + n1 * k2).reshape(-1)


@functools.lru_cache(maxsize=32)
def _tables_np(n: int, dtype_str: str):
    """Host DFT matrices + twiddles for both directions (numpy).

    Converted to device constants per trace at the call site: these are a
    few small (<=256 x 256) matrices, safely embedded in the HLO."""
    dt = np.dtype(dtype_str)

    def dft(m, sign):
        k = np.arange(m)
        ang = sign * 2.0 * np.pi * np.outer(k, k % m) / m
        return np.cos(ang).astype(dt), np.sin(ang).astype(dt)

    out = {}
    if n <= 256:
        out["f_r"], out["f_i"] = dft(n, -1.0)
        out["b_r"], out["b_i"] = dft(n, +1.0)
        return out
    n1, n2 = _factor(n)
    for nm, m in (("f1", n1), ("f2", n2)):
        out[nm + "_r"], out[nm + "_i"] = dft(m, -1.0)
        out[nm + "b_r"], out[nm + "b_i"] = dft(m, +1.0)
    k1 = np.arange(n1)[:, None]
    nn2 = np.arange(n2)[None, :]
    ang = -2.0 * np.pi * (k1 * nn2) / n
    out["tw_r"] = np.cos(ang).astype(dt)
    out["tw_i"] = np.sin(ang).astype(dt)
    return out


def _tables(n: int, dtype_str: str):
    return {k: jnp.asarray(v) for k, v in _tables_np(n, dtype_str).items()}


def _cmatmul(ar, ai, br, bi, spec, prec=None):
    """Complex einsum via Karatsuba: 3 real contractions instead of 4:
    m1 = a_r b_r, m2 = a_i b_i, m3 = (a_r+a_i)(b_r+b_i);
    re = m1 - m2, im = m3 - m1 - m2."""
    tier = fft_tier(prec)
    dt = jnp.result_type(ar, br)
    m1 = tier_einsum(spec, ar, br, tier).astype(dt)
    m2 = tier_einsum(spec, ai, bi, tier).astype(dt)
    m3 = tier_einsum(spec, ar + ai, br + bi, tier).astype(dt)
    return m1 - m2, m3 - m1 - m2


# ----------------------------------------------------------------------
# K-packed bf16-limb complex matmuls — OPT-IN EXPERIMENT
# (ECTRANS_TPU_FFT_MXU=pack; the default stays on the einsums).
#
# Each complex Karatsuba einsum becomes ONE real bf16 dot at full
# fp32-mantissa coverage: complex-as-real A=[xr|xi] against
# W=[[tr,ti],[-ti,tr]], both split into 3 bf16 limbs by bitwise masking
# and the 6 kept limb pairs (j+k<=2) stacked along the contraction axis.
# Accuracy is pinned by tests/test_fft_pack.py (stage error ~3e-7
# relative).  It was measured slower than the einsums on the accelerator
# it was written for, and has not been measured on a GPU.
# ----------------------------------------------------------------------

_PAIRS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def split_planes(x, nplanes: int):
    """fp32 -> list of nplanes bf16 limb planes summing to x (~2^-25).

    The limbs are extracted by BITWISE mantissa truncation, not by
    round-trip casts: XLA's excess-precision simplification may fold
    ``x - f32(bf16(x))`` patterns away inside larger programs (the bf16
    rounding is elided), silently zeroing the low limbs.  Masking the low
    16 mantissa bits yields a value exactly representable in bf16, the
    subtraction is exact (Sterbenz), and no convert pair exists for the
    simplifier to fold."""
    if x.dtype != jnp.float32:
        x = x.astype(jnp.float32)
    mask = jnp.uint32(0xFFFF0000)
    outs = []
    rem = x
    for _ in range(nplanes - 1):
        hi = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(rem, jnp.uint32) & mask,
            jnp.float32)
        outs.append(hi.astype(jnp.bfloat16))
        rem = rem - hi
    outs.append(rem.astype(jnp.bfloat16))
    return outs


def _np_split3(a):
    """numpy fp32 -> 3 bf16-representable fp32 limbs (bitwise masking)."""
    out = []
    rem = np.ascontiguousarray(a, np.float32)
    for _ in range(2):
        hi = (rem.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        out.append(hi)
        rem = rem - hi
    out.append(rem)
    return out


@functools.lru_cache(maxsize=128)
def _packed_w_np(n: int, kind: str, cols: int | None = None,
                 rows: int | None = None):
    """Packed limb weights (12K, 2N) bf16 for one DFT/twiddle matrix of
    the length-n plan.  kind selects the matrix (orientation contract x
    out); cols prunes the contraction extent (occupied f1 rows of the
    forward step-1), rows prunes the output extent (needed output rows of
    the inverse step-2)."""
    import ml_dtypes

    t = _tables_np(n, "float32")
    if kind in ("f", "b"):
        tr, ti = t[kind + "_r"], t[kind + "_i"]
    elif kind == "f1":
        tr, ti = t["f1_r"][:, :cols], t["f1_i"][:, :cols]
    elif kind == "f2":
        tr, ti = t["f2_r"], t["f2_i"]
    elif kind == "f2b":
        tr, ti = t["f2b_r"], t["f2b_i"]
    elif kind == "f1b":
        tr, ti = t["f1b_r"][:rows], t["f1b_i"][:rows]
    else:  # pragma: no cover
        raise ValueError(kind)
    trt, tit = tr.T, ti.T                       # (contract, out)
    imp = np.block([[trt, tit], [-tit, trt]])   # (2K, 2N)
    limbs = _np_split3(imp)
    return np.concatenate([limbs[k] for (_, k) in _PAIRS],
                          axis=0).astype(ml_dtypes.bfloat16)


def _pack_mm(xr, xi, wnp, axis=-1):
    """One K-packed limb dot replacing a complex matmul: contracts `axis`
    of (xr, xi) against the packed weight's rows.  With axis=-1 the
    output is (..., out) per half; with axis=-2 the contracted axis is
    removed and the kept last axis moves BEFORE the out axis — callers
    exploit this to four-step without explicit panel transposes."""
    lr = split_planes(xr, 3)
    li = split_planes(xi, 3)
    segs = [jnp.concatenate([lr[j], li[j]], axis) for (j, _) in _PAIRS]
    a = jnp.concatenate(segs, axis)
    # keep the limb split out of the dot fusion (the excess-precision
    # folding class — see split_planes)
    a = jax.lax.optimization_barrier(a)
    cax = a.ndim + axis if axis < 0 else axis
    o = jax.lax.dot_general(a, jnp.asarray(wnp),
                            (((cax,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    half = o.shape[-1] // 2
    return o[..., :half], o[..., half:]


def _pack_mode(prec, dtype) -> bool:
    """Packed-limb path active?  Only for fp32 data at the full-fp32
    tiers; the bf16 tier keeps its single-pass einsums and fp64 keeps
    true-fp64 contractions."""
    import os

    if jnp.dtype(dtype) != jnp.float32 or fft_tier(prec) != "highest":
        return False
    return os.environ.get("ECTRANS_TPU_FFT_MXU", "auto") == "pack"


def _fft_ord_pack(re, im, n: int):
    """fft_ord on the packed-limb path (same contract and output layout)."""
    if n <= 256:
        re = _pad_to(re, n)
        im = _pad_to(im, n)
        return _pack_mm(re, im, _packed_w_np(n, "f"), axis=-1)
    n1, n2 = _factor(n)
    in_len = re.shape[-1]
    f1 = -(-in_len // n2)
    re = _pad_to(re, f1 * n2)
    im = _pad_to(im, f1 * n2)
    xr = re.reshape(re.shape[:-1] + (f1, n2))
    xi = im.reshape(im.shape[:-1] + (f1, n2))
    # step 1: contract the occupied f1 rows -> FLIPPED layout (..., n2, k1)
    ar, ai = _pack_mm(xr, xi, _packed_w_np(n, "f1", cols=f1), axis=-2)
    t = _tables_np(n, "float32")
    twr = jnp.asarray(np.ascontiguousarray(t["tw_r"].T))
    twi = jnp.asarray(np.ascontiguousarray(t["tw_i"].T))
    ar, ai = ar * twr - ai * twi, ar * twi + ai * twr
    # step 2: contract n2 -> (..., k1, k2): exactly the ord_map layout,
    # so the flip costs no transposes at all
    br, bi = _pack_mm(ar, ai, _packed_w_np(n, "f2"), axis=-2)
    shape = re.shape[:-1] + (n,)
    return br.reshape(shape), bi.reshape(shape)


def _ifft_from_ord_pack(re, im, out_len: int | None):
    """ifft_from_ord on the packed-limb path."""
    n = re.shape[-1]
    if n <= 256:
        orr, oii = _pack_mm(re, im, _packed_w_np(n, "b"), axis=-1)
        if out_len is not None:
            orr, oii = orr[..., :out_len], oii[..., :out_len]
        return orr / n, oii / n
    n1, n2 = _factor(n)
    xr = re.reshape(re.shape[:-1] + (n1, n2))
    xi = im.reshape(im.shape[:-1] + (n1, n2))
    # conj DFT over k2 (last axis) -> (..., k1, n2)
    ar, ai = _pack_mm(xr, xi, _packed_w_np(n, "f2b"), axis=-1)
    t = _tables_np(n, "float32")
    twr, twi = jnp.asarray(t["tw_r"]), jnp.asarray(t["tw_i"])
    ar, ai = ar * twr + ai * twi, ai * twr - ar * twi
    # conj DFT over k1 (axis -2), pruned -> (..., n2, fo); one swap back
    fo = n1 if out_len is None else min(n1, -(-out_len // n2))
    br, bi = _pack_mm(ar, ai, _packed_w_np(n, "f1b", rows=fo), axis=-2)
    br = br.swapaxes(-1, -2)
    bi = bi.swapaxes(-1, -2)
    shape = re.shape[:-1] + (fo * n2,)
    return br.reshape(shape) / n, bi.reshape(shape) / n


def fft_ord(re, im, n: int | None = None, prec=None):
    """Forward FFT of length n over the last axis; output in ord_map order.

    The inputs may be SHORTER than n (implicitly zero-padded): the first
    DFT matmul is then pruned to the occupied n1-rows — inside a Bluestein
    convolution the signal occupies only mmax+1 (synthesis) or nloen
    (analysis) of the nfft slots, so pruning skips most of step 1.
    """
    if n is None:
        n = re.shape[-1]
    if _pack_mode(prec, re.dtype):
        return _fft_ord_pack(re, im, n)
    t = _tables(n, str(re.dtype))
    if n <= 256:
        re = _pad_to(re, n)
        im = _pad_to(im, n)
        return _cmatmul(re, im, t["f_r"], t["f_i"], "...n,kn->...k", prec)
    n1, n2 = _factor(n)
    in_len = re.shape[-1]
    f1 = -(-in_len // n2)  # occupied n1-rows
    re = _pad_to(re, f1 * n2)
    im = _pad_to(im, f1 * n2)
    xr = re.reshape(re.shape[:-1] + (f1, n2))
    xi = im.reshape(im.shape[:-1] + (f1, n2))
    # DFT over n1 (columns, pruned to the occupied rows): A[k1, n2]
    ar, ai = _cmatmul(xr, xi, t["f1_r"][:, :f1], t["f1_i"][:, :f1],
                      "...fn,kf->...kn", prec)
    # twiddle W_N^(k1*n2)
    ar, ai = ar * t["tw_r"] - ai * t["tw_i"], ar * t["tw_i"] + ai * t["tw_r"]
    # DFT over n2: X[k1, k2]
    br, bi = _cmatmul(ar, ai, t["f2_r"], t["f2_i"], "...kn,ln->...kl", prec)
    shape = re.shape[:-1] + (n,)
    return br.reshape(shape), bi.reshape(shape)


def ifft_from_ord(re, im, out_len: int | None = None, prec=None):
    """Inverse FFT consuming ord_map order, emitting natural order, with
    the 1/n normalisation (exact transposed network of fft_ord with
    conjugated coefficients).  With out_len, only the first out_len
    natural-order outputs are computed (the final DFT matmul is pruned);
    the result's last axis is then ceil(out_len/n2)*n2 >= out_len.
    """
    n = re.shape[-1]
    if _pack_mode(prec, re.dtype):
        return _ifft_from_ord_pack(re, im, out_len)
    t = _tables(n, str(re.dtype))
    if n <= 256:
        orr, oii = _cmatmul(re, im, t["b_r"], t["b_i"], "...n,kn->...k", prec)
        if out_len is not None:
            orr, oii = orr[..., :out_len], oii[..., :out_len]
        return orr / n, oii / n
    n1, n2 = _factor(n)
    xr = re.reshape(re.shape[:-1] + (n1, n2))
    xi = im.reshape(im.shape[:-1] + (n1, n2))
    # conj DFT over k2
    ar, ai = _cmatmul(xr, xi, t["f2b_r"], t["f2b_i"], "...kl,nl->...kn", prec)
    # conj twiddle
    ar, ai = ar * t["tw_r"] + ai * t["tw_i"], ai * t["tw_r"] - ar * t["tw_i"]
    # conj DFT over k1, pruned to the needed output rows
    fo = n1 if out_len is None else min(n1, -(-out_len // n2))
    br, bi = _cmatmul(ar, ai, t["f1b_r"][:fo], t["f1b_i"][:fo],
                      "...kn,fk->...fn", prec)
    shape = re.shape[:-1] + (fo * n2,)
    return br.reshape(shape) / n, bi.reshape(shape) / n


def _pad_to(x, n):
    if x.shape[-1] == n:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])
