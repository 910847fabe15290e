"""Fourier layer: per-latitude real (inverse) DFTs, batched.

Replaces the reference's FFT machinery (FTINV/FTDIR + FFTW plan cache,
``ftinv_mod.F90``, ``tpm_fftw.F90``; GPU batched variant ``hicfft.cuda.cu``)
with a **batched Bluestein chirp-z transform built on the four-step
matmul FFT** (``ops.fft_fourstep``):

* All arithmetic is on (re, im) float array pairs: the layer was designed
  for an earlier accelerator with neither complex dtypes nor an FFT op
  (ROADMAP 1.2 measures cuFFT through ``jnp.fft`` against it).
* Every latitude's arbitrary-length DFT becomes one four-step
  FFT length shared by ALL latitudes — the whole (field, lat) batch is
  transformed in one uniform call instead of one FFT plan per distinct NLOEN
  (the reference's per-loen plan cache, ``hicfft.cuda.cu:136-160``).  Reduced
  and full Gaussian grids take the same path.
* **Real transforms run two fields per complex transform** (the classic
  c2r/r2c pair trick): for synthesis, the pair (a, b) is packed as the full
  Hermitian spectrum w_k = F_a,k + i F_b,k (k = -mmax..mmax, with
  w_{-m} = conj(F_a,m) + i conj(F_b,m)), so ONE complex inverse DFT emits
  f_a + i f_b — no discarded imaginary half.  The convolution span grows
  from L+mmax to L+2mmax, but the field count halves: ~40% fewer matmul FLOPs.
  Fields are RMS-normalized before packing so the pair's cross-field
  rounding (~eps * |partner|) stays relative to each field's own scale.

Normalization matches the reference (``tpm_fftw.F90:251-377``): the direct
(analysis) DFT divides by NLOEN; synthesis is unnormalized, i.e.
``f_j = F_0 + 2 sum_m Re(F_m e^{i m lambda_j})``.

Chirp phase tables are built on host in exact integer arithmetic mod 2L
(phase = pi * (k^2 mod 2L) / L) so float32 device tables stay accurate at
large NLOEN.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np



def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _chirp(L: int, kk: np.ndarray, sign: float) -> np.ndarray:
    """exp(sign * i*pi*k^2/L) with exact integer phase reduction mod 2L."""
    k2 = (kk.astype(np.int64) ** 2) % (2 * L)  # exact: |k| < 3e9 fits int64
    ph = np.pi * k2.astype(np.float64) / L
    return np.cos(ph) + 1j * np.sin(ph) * sign


def _cmul(ar, ai, br, bi):
    """Complex multiply on real pairs."""
    return ar * br - ai * bi, ar * bi + ai * br


@dataclasses.dataclass(frozen=True, eq=False)
class BluesteinTables:
    """Per-resolution device tables for the batched chirp-z transform.

    All complex tables are stored as (re, im) float pairs.
    """

    nfft: int
    mmax: int           # max zonal mode index (nsmax)
    ndlon: int
    # synthesis (inverse, pair-packed): w slots p = k+mmax, k = -mmax..mmax
    syn_in_r: Any       # (ndgl, 2*mmax+1): e^{+i pi k^2/L}, masked |k|<=nmen
    syn_in_i: Any
    syn_bh_r: Any       # (ndgl, nfft): FFT of the offset chirp kernel
    syn_bh_i: Any
    syn_out_r: Any      # (ndgl, ndlon): e^{+i pi j^2/L}, masked j < L
    syn_out_i: Any
    # analysis (direct, pair-packed): output slots t = m+mmax
    ana_in_r: Any       # (ndgl, ndlon): e^{-i pi j^2/L}, masked j < L
    ana_in_i: Any
    ana_bh_r: Any       # (ndgl, nfft): FFT of the offset chirp kernel
    ana_bh_i: Any
    ana_out_r: Any      # (ndgl, 2*mmax+1): (1/L) e^{-i pi m^2/L}, masked
    ana_out_i: Any


@functools.lru_cache(maxsize=8)
def host_bluestein_tables(nloen: tuple, nmen: tuple, nsmax: int) -> dict:
    """Host (numpy float64) chirp tables keyed for the sharded distribution.

    Array values all have the latitude axis first (ndgl, ...), so a
    distributed transform can shard/pad them along latitude blocks.
    """
    from . import fft_fourstep

    ndgl = len(nloen)
    mmax = nsmax
    ndlon = max(nloen)
    P = 2 * mmax + 1  # full-spectrum slots, p = k + mmax with k = -mmax..mmax
    nfft = fft_fourstep.good_size(ndlon + P)

    syn_in = np.zeros((ndgl, P), dtype=np.complex128)
    syn_bh = np.zeros((ndgl, nfft), dtype=np.complex128)
    syn_out = np.zeros((ndgl, ndlon), dtype=np.complex128)
    ana_in = np.zeros((ndgl, ndlon), dtype=np.complex128)
    ana_bh = np.zeros((ndgl, nfft), dtype=np.complex128)
    ana_out = np.zeros((ndgl, P), dtype=np.complex128)

    om = fft_fourstep.ord_map(nfft)
    for l, (L, me) in enumerate(zip(nloen, nmen)):
        me = min(me, mmax)
        # NB: k is a literal (not mod-L) wavenumber in the chirp identity,
        # so modes with 2*me >= L are evaluated exactly (the lat-lon path
        # synthesizes spectral sums beyond the row's Nyquist on purpose).
        ks = np.arange(-me, me + 1)  # signed wavenumber at slots mmax+ks
        js = np.arange(L)
        # synthesis (pair-packed): g_j = e^{+i pi j^2/L}
        #     sum_k (w_k e^{+i pi k^2/L}) e^{-i pi (j-k)^2/L},  k=-mmax..mmax
        # with w stored at slot p = k+mmax, so the circular-conv kernel is
        # the chirp offset by mmax: b[u] = e^{-i pi (u+mmax)^2/L}.
        syn_in[l, mmax + ks] = _chirp(L, ks, +1.0)
        us = np.arange(-2 * mmax, L)  # u = j - p
        b = np.zeros(nfft, dtype=np.complex128)
        b[us % nfft] = _chirp(L, us + mmax, -1.0)
        syn_bh[l] = np.fft.fft(b)[om]  # pre-permuted to fourstep ORD
        syn_out[l, :L] = _chirp(L, js, +1.0)
        # analysis (pair-packed): Z at slots t = m+mmax, m = -mmax..mmax:
        # Z_m = (1/L) e^{-i pi m^2/L}
        #         sum_j (z_j e^{-i pi j^2/L}) e^{+i pi (m-j)^2/L}
        # kernel offset: b2[u] = e^{+i pi (u-mmax)^2/L}, u = t - j.
        ana_in[l, :L] = _chirp(L, js, -1.0)
        us2 = np.arange(-(L - 1), 2 * mmax + 1)
        b2 = np.zeros(nfft, dtype=np.complex128)
        b2[us2 % nfft] = _chirp(L, us2 - mmax, +1.0)
        ana_bh[l] = np.fft.fft(b2)[om]  # pre-permuted to fourstep ORD
        ana_out[l, mmax + ks] = _chirp(L, ks, -1.0) / L

    return dict(
        nfft=nfft, mmax=mmax, ndlon=ndlon,
        syn_in_r=np.ascontiguousarray(syn_in.real),
        syn_in_i=np.ascontiguousarray(syn_in.imag),
        syn_bh_r=np.ascontiguousarray(syn_bh.real),
        syn_bh_i=np.ascontiguousarray(syn_bh.imag),
        syn_out_r=np.ascontiguousarray(syn_out.real),
        syn_out_i=np.ascontiguousarray(syn_out.imag),
        ana_in_r=np.ascontiguousarray(ana_in.real),
        ana_in_i=np.ascontiguousarray(ana_in.imag),
        ana_bh_r=np.ascontiguousarray(ana_bh.real),
        ana_bh_i=np.ascontiguousarray(ana_bh.imag),
        ana_out_r=np.ascontiguousarray(ana_out.real),
        ana_out_i=np.ascontiguousarray(ana_out.imag),
    )


_PYTREES_REGISTERED = False


def _ensure_pytrees():
    """Register table containers as pytrees (passed as jit arguments, never
    closed over — see resolution._register_pytrees)."""
    global _PYTREES_REGISTERED
    if _PYTREES_REGISTERED:
        return
    import dataclasses as _dc

    import jax

    for cls, meta in (
        (BluesteinTables, ["nfft", "mmax", "ndlon"]),
        (UniformDftTables, ["L", "kmax", "nfft"]),
        (LatBucket, ["i0", "i1", "mb"]),
        (BucketedTables, ["ndgl", "ndlon", "mmax"]),
    ):
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in _dc.fields(cls) if f.name not in meta],
            meta_fields=meta,
        )
    _PYTREES_REGISTERED = True


@functools.lru_cache(maxsize=8)
def build_bluestein_tables(grid_key, dtype_str: str) -> BluesteinTables:
    """Device tables; grid_key: (nloen tuple, nmen tuple, nsmax)."""
    import jax.numpy as jnp

    _ensure_pytrees()
    nloen, nmen, nsmax = grid_key
    dt = np.dtype(dtype_str)
    h = host_bluestein_tables(nloen, nmen, nsmax)
    cast = {
        k: (jnp.asarray(v.astype(dt)) if isinstance(v, np.ndarray) else v)
        for k, v in h.items()
    }
    return BluesteinTables(**cast)


def tables_for(res, dtype) -> BluesteinTables:
    import jax.numpy as jnp

    dt = "float64" if jnp.dtype(dtype) == jnp.float64 else "float32"
    key = (tuple(res.grid.nloen), tuple(int(x) for x in res.nmen), res.nsmax)
    return build_bluestein_tables(key, dt)


# ----------------------------------------------------------------------
# Latitude-bucketed transforms.  On reduced grids both NLOEN and the
# per-latitude truncation NMEN shrink toward the poles, so one global
# worst-case convolution length wastes most of its bandwidth on polar
# rows.  Latitudes are split into hemisphere-symmetric buckets, each with
# its own (smaller) chirp length — the analogue of the reference's
# per-NLOEN FFT plan cache (``hicfft.cuda.cu:136-160``), but with a
# bounded number of uniform batches instead of one plan per length.
# At TCO1279 the polar bucket's nfft is ~5x smaller than the equatorial
# one; total convolution traffic roughly halves.
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class LatBucket:
    bt: BluesteinTables
    i0: int     # NH row range [i0, i1); SH mirror rows [ndgl-i1, ndgl-i0)
    i1: int
    mb: int     # max retained zonal mode in this bucket


@dataclasses.dataclass(frozen=True, eq=False)
class BucketedTables:
    buckets: tuple
    ndgl: int
    ndlon: int
    mmax: int


@functools.lru_cache(maxsize=8)
def bucketed_tables(grid_key, dtype_str: str, nbuckets: int = 6) -> BucketedTables:
    """Hemisphere-symmetric equal-latitude buckets with per-bucket tables."""
    _ensure_pytrees()
    nloen, nmen, nsmax = grid_key
    ndgl = len(nloen)
    nh = ndgl // 2
    nb = 1 if nh < 16 * nbuckets else nbuckets
    bounds = [round(nh * b / nb) for b in range(nb + 1)]
    buckets = []
    for b in range(nb):
        i0, i1 = bounds[b], bounds[b + 1]
        if i0 == i1:
            continue
        rows = list(range(i0, i1)) + list(range(ndgl - i1, ndgl - i0))
        nloen_b = tuple(nloen[r] for r in rows)
        mb = min(nsmax, max(nmen[r] for r in rows))
        nmen_b = tuple(min(nmen[r], mb) for r in rows)
        buckets.append(LatBucket(
            bt=build_bluestein_tables((nloen_b, nmen_b, mb), dtype_str),
            i0=i0, i1=i1, mb=mb,
        ))
    return BucketedTables(buckets=tuple(buckets), ndgl=ndgl,
                          ndlon=max(nloen), mmax=nsmax)


def bucketed_tables_for(res, dtype) -> BucketedTables:
    import os

    import jax.numpy as jnp

    dt = "float64" if jnp.dtype(dtype) == jnp.float64 else "float32"
    key = (tuple(res.grid.nloen), tuple(int(x) for x in res.nmen), res.nsmax)
    # finer buckets tighten the per-bucket chirp length staircase (each
    # bucket pays nfft = max nloen + 2*max nmen over its rows; the
    # octahedral nloen slope makes polar buckets overshoot ~40% at 6
    # buckets); more buckets trade that for extra per-bucket fixed cost
    nb = int(os.environ.get("ECTRANS_TPU_FFT_BUCKETS", "12"))
    return bucketed_tables(key, dt, nbuckets=nb)


def synthesis_bucketed(fourier, mbt: BucketedTables, normalize: bool = True,
                       prec=None):
    """(nfld, 2, M, ndgl) -> (nfld, ndgl, ndlon) via per-bucket chirp-z."""
    import jax.numpy as jnp

    nfld = fourier.shape[0]
    if fourier.shape[2] != mbt.mmax + 1:
        raise ValueError("synthesis_bucketed expects M == mmax+1")
    x = _pad_pair(fourier)
    if normalize:
        scale = _rms_scale(x, (1, 2, 3))
        x = x / scale
    else:
        scale = jnp.ones((x.shape[0], 1, 1, 1), x.dtype)
    outs_nh, outs_sh = [], []
    for bk in mbt.buckets:
        i0, i1, mb = bk.i0, bk.i1, bk.mb
        fb = jnp.concatenate(
            [x[:, :, : mb + 1, i0:i1],
             x[:, :, : mb + 1, mbt.ndgl - i1 : mbt.ndgl - i0]], axis=-1)
        g = synthesis(fb, bk.bt, normalize=False, prec=prec)  # (F, rows, ndlon_b)
        g = _pad_last(g, mbt.ndlon)
        outs_nh.append(g[:, : i1 - i0])
        outs_sh.append(g[:, i1 - i0 :])
    out = jnp.concatenate(outs_nh + outs_sh[::-1], axis=1)
    return (out[:nfld] * scale[:nfld, 0]).astype(fourier.dtype)


def analysis_bucketed(grid, mbt: BucketedTables, M: int, normalize: bool = True,
                      prec=None):
    """(nfld, ndgl, ndlon) -> (nfld, 2, M, ndgl) via per-bucket chirp-z."""
    import jax.numpy as jnp

    nfld = grid.shape[0]
    x = _pad_pair(grid)
    outs_nh, outs_sh = [], []
    for bk in mbt.buckets:
        i0, i1, mb = bk.i0, bk.i1, bk.mb
        gb = jnp.concatenate(
            [x[:, i0:i1], x[:, mbt.ndgl - i1 : mbt.ndgl - i0]],
            axis=1)[..., : bk.bt.ndlon]
        # RMS pair-normalization happens inside the per-bucket analysis
        # (on the bucket-local tensors), a miscompile guard kept from the
        # previous accelerator — per-bucket scales are equally exact (each
        # bucket divides and multiplies by the same value).
        fb = analysis(gb, bk.bt, min(M, mb + 1), normalize=normalize,
                      prec=prec)
        if fb.shape[2] < M:   # pad truncated zonal modes (zero beyond nmen)
            fb = jnp.pad(fb, [(0, 0), (0, 0), (0, M - fb.shape[2]), (0, 0)])
        outs_nh.append(fb[..., : i1 - i0])
        outs_sh.append(fb[..., i1 - i0 :])
    out = jnp.concatenate(outs_nh + outs_sh[::-1], axis=-1)
    return out[:nfld].astype(grid.dtype)


def _pad_last(x, n):
    import jax.numpy as jnp

    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])


# ----------------------------------------------------------------------
# Uniform-length half-complex DFTs (all rows the same length).  Used by the
# LAM bi-Fourier path (reference ELEINV/ELEDIR meridional FFTs,
# ``eleinv_mod.F90:72-101``, and the zonal FFTs on the uniform LAM grid)
# where, unlike the reduced Gaussian grid, one 1-D chirp table serves every
# row.  Conventions identical to synthesis/analysis above:
#   synthesis: f_j = re_0 + 2*sum_{k>=1} (re_k cos(2 pi k j / L) -
#                                         im_k sin(2 pi k j / L))
#   analysis:  F_k = (1/L) sum_j f_j e^{-2 pi i k j / L}
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class UniformDftTables:
    L: int
    kmax: int           # max retained mode index
    nfft: int
    syn_in_r: Any       # (kmax+1,)
    syn_in_i: Any
    syn_bh_r: Any       # (nfft,)
    syn_bh_i: Any
    syn_out_r: Any      # (L,)
    syn_out_i: Any
    ana_in_r: Any       # (L,)
    ana_in_i: Any
    ana_bh_r: Any       # (nfft,)
    ana_bh_i: Any
    ana_out_r: Any      # (kmax+1,)
    ana_out_i: Any


@functools.lru_cache(maxsize=32)
def uniform_dft_tables(L: int, kmax: int, dtype_str: str = "float32") -> UniformDftTables:
    import jax.numpy as jnp

    _ensure_pytrees()
    from . import fft_fourstep

    dt = np.dtype(dtype_str)
    nfft = fft_fourstep.good_size(L + kmax + 1)
    om = fft_fourstep.ord_map(nfft)
    ks = np.arange(kmax + 1)
    js = np.arange(L)
    cm = np.where(ks == 0, 1.0, 2.0)
    syn_in = cm * _chirp(L, ks, +1.0)
    b = np.zeros(nfft, dtype=np.complex128)
    kk = np.arange(-kmax, L)
    b[kk % nfft] = _chirp(L, kk, -1.0)
    syn_bh = np.fft.fft(b)[om]  # pre-permuted to fourstep ORD
    syn_out = _chirp(L, js, +1.0)
    ana_in = _chirp(L, js, -1.0)
    b2 = np.zeros(nfft, dtype=np.complex128)
    kk2 = np.arange(-(L - 1), kmax + 1)
    b2[kk2 % nfft] = _chirp(L, kk2, +1.0)
    ana_bh = np.fft.fft(b2)[om]
    ana_out = _chirp(L, ks, -1.0) / L
    f = lambda a: jnp.asarray(np.ascontiguousarray(a).astype(dt))
    return UniformDftTables(
        L=L, kmax=kmax, nfft=nfft,
        syn_in_r=f(syn_in.real), syn_in_i=f(syn_in.imag),
        syn_bh_r=f(syn_bh.real), syn_bh_i=f(syn_bh.imag),
        syn_out_r=f(syn_out.real), syn_out_i=f(syn_out.imag),
        ana_in_r=f(ana_in.real), ana_in_i=f(ana_in.imag),
        ana_bh_r=f(ana_bh.real), ana_bh_i=f(ana_bh.imag),
        ana_out_r=f(ana_out.real), ana_out_i=f(ana_out.imag),
    )


def synthesis_uniform(re, im, ut: UniformDftTables):
    """(..., kmax+1) half-complex coeffs -> (..., L) real signal."""
    from . import fft_fourstep

    ar, ai = _cmul(re, im, ut.syn_in_r, ut.syn_in_i)
    fr, fi = fft_fourstep.fft_ord(ar, ai, ut.nfft)
    cr, ci = _cmul(fr, fi, ut.syn_bh_r, ut.syn_bh_i)
    vr, vi = fft_fourstep.ifft_from_ord(cr, ci, ut.L)
    vr, vi = vr[..., : ut.L], vi[..., : ut.L]
    return vr * ut.syn_out_r - vi * ut.syn_out_i


def analysis_uniform(x, ut: UniformDftTables):
    """(..., L) real signal -> ((..., kmax+1) re, (..., kmax+1) im)."""
    from . import fft_fourstep

    ar = x * ut.ana_in_r
    ai = x * ut.ana_in_i
    fr, fi = fft_fourstep.fft_ord(ar, ai, ut.nfft)
    cr, ci = _cmul(fr, fi, ut.ana_bh_r, ut.ana_bh_i)
    vr, vi = fft_fourstep.ifft_from_ord(cr, ci, ut.kmax + 1)
    vr, vi = vr[..., : ut.kmax + 1], vi[..., : ut.kmax + 1]
    return _cmul(vr, vi, ut.ana_out_r, ut.ana_out_i)


# working-set budget for one Bluestein convolution chunk (bytes); the
# convolution holds ~6 arrays of (chunk, ndgl, nfft) fp32 live at once
_CHUNK_BYTES = int(1.5e9)


def _field_chunks(nrows: int, nfft: int, itemsize: int) -> int:
    per_field = nrows * nfft * itemsize * 6
    return max(1, _CHUNK_BYTES // max(1, per_field))


def _chunked_conv(ar, ai, bhr, bhi, out_len=None, prec=None):
    """Bluestein convolution core: forward four-step FFT of length nfft
    (input implicitly zero-padded; the first DFT matmul is pruned to the
    occupied rows), pointwise multiply with the pre-permuted chirp FFT,
    pruned inverse (only out_len outputs computed).  Chunked over the
    leading (field) axis so the TCO1279-scale working set stays bounded in
    device memory.  An unrolled Python loop rather than lax.map, a
    miscompile guard kept from the previous accelerator (ROADMAP 3.3)."""
    import jax.numpy as jnp

    from . import fft_fourstep

    nfft = bhr.shape[-1]

    def body(car, cai):
        fr, fi = fft_fourstep.fft_ord(car, cai, nfft, prec)
        cr, ci = _cmul(fr, fi, bhr, bhi)
        return fft_fourstep.ifft_from_ord(cr, ci, out_len, prec)

    F = ar.shape[0]
    chunk = _field_chunks(int(np.prod(ar.shape[1:-1])), nfft, ar.dtype.itemsize)
    if F <= chunk:
        return body(ar, ai)
    outs = [body(ar[i : i + chunk], ai[i : i + chunk])
            for i in range(0, F, chunk)]
    vr = jnp.concatenate([o[0] for o in outs], axis=0)
    vi = jnp.concatenate([o[1] for o in outs], axis=0)
    return vr, vi


def _rms_scale(x, axes):
    """Per-field RMS (stop-gradient-free, zeros guarded) for pair packing."""
    import jax.numpy as jnp

    r = jnp.sqrt(jnp.mean(x * x, axis=axes, keepdims=True))
    return jnp.where(r > 0, r, 1.0)


def _pad_pair(x):
    """Pad the leading field axis to even length."""
    import jax.numpy as jnp

    if x.shape[0] % 2:
        x = jnp.concatenate(
            [x, jnp.zeros((1,) + x.shape[1:], x.dtype)], axis=0)
    return x


def synthesis(fourier, bt: BluesteinTables, normalize: bool = True,
              prec=None):
    """(nfld, 2, M, ndgl) Fourier coeffs -> grid (nfld, ndgl, ndlon).

    Ragged rows (lat with NLOEN < ndlon) are zero beyond their length.  One
    batched chirp-z (four-step matmul FFT) covers every latitude; fields are
    transformed two-per-complex-transform via Hermitian full-spectrum
    packing (module docstring).

    normalize=False skips the (data-dependent) RMS pre-scaling — required
    under ``jax.linear_transpose`` (adjoints), where the traced function
    must be structurally linear; the scaling cancels exactly in exact
    arithmetic, so the transposed operator is the same operator.
    """
    import jax.numpy as jnp

    nfld = fourier.shape[0]
    M = fourier.shape[2]
    if M != bt.mmax + 1:
        raise ValueError(f"synthesis expects M == mmax+1 ({bt.mmax+1}), got {M}")
    x = _pad_pair(fourier)
    if normalize:
        scale = _rms_scale(x, (1, 2, 3))
        x = x / scale
    else:
        scale = jnp.ones((x.shape[0], 1, 1, 1), x.dtype)
    # pair fields (0,1),(2,3),... via reshape rather than x[0::2]/x[1::2]
    # (a strided-slice miscompile guard kept from the previous accelerator)
    xr = x.reshape(-1, 2, *x.shape[1:])
    A, B = xr[:, 0], xr[:, 1]                 # (P2, 2, M, ndgl)
    Ar = A[:, 0].swapaxes(1, 2)               # (P2, ndgl, M)
    mask0 = (jnp.arange(M) > 0).astype(x.dtype)
    Ai = A[:, 1].swapaxes(1, 2) * mask0       # m=0 imag is ignored (c2r parity)
    Br = B[:, 0].swapaxes(1, 2)
    Bi = B[:, 1].swapaxes(1, 2) * mask0
    # Hermitian pack: w_m = F_a,m + i F_b,m;  w_{-m} = conj(F_a,m) + i conj(F_b,m)
    wr_pos, wi_pos = Ar - Bi, Ai + Br                      # slots mmax..2mmax
    wr_neg = (Ar + Bi)[..., 1:][..., ::-1]                 # slots 0..mmax-1
    wi_neg = (Br - Ai)[..., 1:][..., ::-1]
    wr = jnp.concatenate([wr_neg, wr_pos], axis=-1)        # (P2, ndgl, 2M-1)
    wi = jnp.concatenate([wi_neg, wi_pos], axis=-1)
    ar, ai = _cmul(wr, wi, bt.syn_in_r[None], bt.syn_in_i[None])
    # materialise the Hermitian pack before the conv matmuls (a fusion
    # miscompile guard kept from the previous accelerator, ROADMAP 1.4)
    import jax as _jax

    ar, ai = _jax.lax.optimization_barrier((ar, ai))
    vr, vi = _chunked_conv(ar, ai, bt.syn_bh_r[None], bt.syn_bh_i[None],
                           out_len=bt.ndlon, prec=prec)
    vr, vi = vr[..., : bt.ndlon], vi[..., : bt.ndlon]
    ga = vr * bt.syn_out_r[None] - vi * bt.syn_out_i[None]   # Re -> field a
    gb = vr * bt.syn_out_i[None] + vi * bt.syn_out_r[None]   # Im -> field b
    out = jnp.stack([ga, gb], axis=1).reshape(-1, ga.shape[1], ga.shape[2])
    return (out[:nfld] * scale[:nfld, 0]).astype(fourier.dtype)


def analysis(grid, bt: BluesteinTables, M: int, normalize: bool = True,
             prec=None):
    """grid (nfld, ndgl, ndlon) -> Fourier coeffs (nfld, 2, M, ndgl).

    Two real fields per complex transform (r2c pair trick): z = f_a + i f_b,
    then F_a,m = (Z_m + conj Z_{-m})/2, F_b,m = (Z_m - conj Z_{-m})/(2i).
    ``normalize`` as in :func:`synthesis`.
    """
    import jax.numpy as jnp

    nfld = grid.shape[0]
    mmax = bt.mmax
    if M > mmax + 1:
        raise ValueError(f"analysis expects M <= mmax+1 ({mmax+1}), got {M}")
    x = _pad_pair(grid)
    # reshape-based pairing (see synthesis)
    xr = x.reshape(-1, 2, *x.shape[1:])        # (P2, 2, ndgl, ndlon)
    if normalize:
        # 4-D broadcast on the paired tensor rather than the equivalent
        # 3-D leading-axis divide (a miscompile guard kept from the
        # previous accelerator)
        scale = _rms_scale(xr, (2, 3))         # (P2, 2, 1, 1)
        xr = xr / scale
    else:
        scale = jnp.ones((xr.shape[0], 2, 1, 1), x.dtype)
    ga, gb = xr[:, 0], xr[:, 1]                # (P2, ndgl, ndlon)
    sr = ga * bt.ana_in_r[None] - gb * bt.ana_in_i[None]
    si = ga * bt.ana_in_i[None] + gb * bt.ana_in_r[None]
    vr, vi = _chunked_conv(sr, si, bt.ana_bh_r[None], bt.ana_bh_i[None],
                           out_len=2 * mmax + 1, prec=prec)
    vr, vi = vr[..., : 2 * mmax + 1], vi[..., : 2 * mmax + 1]
    # materialise before the reversed-slot unpack (fusion miscompile
    # guard — see synthesis)
    import jax as _jax

    vr, vi = _jax.lax.optimization_barrier((vr, vi))
    zr, zi = _cmul(vr, vi, bt.ana_out_r[None], bt.ana_out_i[None])
    zp_r, zp_i = zr[..., mmax : mmax + M], zi[..., mmax : mmax + M]
    zn_r = zr[..., mmax::-1][..., :M]
    zn_i = zi[..., mmax::-1][..., :M]
    fa = jnp.stack([(zp_r + zn_r) * 0.5, (zp_i - zn_i) * 0.5], axis=1)
    fb = jnp.stack([(zp_i + zn_i) * 0.5, (zn_r - zp_r) * 0.5], axis=1)
    fa = fa * scale[:, 0][:, None]             # (P2, 2cmp, ndgl, M) 4-D
    fb = fb * scale[:, 1][:, None]
    out = jnp.stack([fa, fb], axis=1)          # (P2, 2fields, 2cmp, ndgl, M)
    out = out.reshape(-1, 2, out.shape[3], M)[:nfld]
    return out.swapaxes(2, 3).astype(grid.dtype)
