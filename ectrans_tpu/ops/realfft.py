"""Power-of-two FFT in pure real arithmetic (separate re/im arrays).

NOTE: the production Fourier layer uses ``ops.fft_fourstep`` (the four-step
matmul FFT); this radix-2 formulation is retained as an independent
numerical cross-check.

Like the production layer, it avoids complex dtypes and ``jnp.fft`` (the
accelerator the layer was designed for had neither; the reference leans on
FFTW/cuFFT, ``tpm_fftw.F90``, ``hicfft.cuda.cu``).  Instead this module
implements an iterative radix-2 DIF FFT on (re, im) float array pairs:

* every stage is a whole-array butterfly (4 mul + 6 add elementwise ops with
  a broadcast twiddle vector) — pure VPU work that XLA fuses well;
* log2(N) stages, then one static bit-reversal gather;
* arbitrary leading batch dimensions.

Only power-of-two lengths are needed: arbitrary per-latitude DFT lengths are
handled by the Bluestein chirp-z layer in ``ops.fourier``, which freely
chooses its internal FFT length.
"""

from __future__ import annotations

import functools

import numpy as np


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=64)
def _twiddles(n: int, sign: float, dtype_str: str):
    """Per-stage twiddle tables w_L[k] = exp(sign*2*pi*i*k/L), host-built."""
    dt = np.dtype(dtype_str)
    out = []
    L = n
    while L > 1:
        k = np.arange(L // 2)
        ang = sign * 2.0 * np.pi * k / L
        out.append((np.cos(ang).astype(dt), np.sin(ang).astype(dt)))
        L //= 2
    return out


def fft_pow2(re, im, sign: int = -1):
    """In-order FFT of the last axis (power-of-two length), batched.

    sign=-1: forward DFT  X_k = sum_n x_n e^{-2 pi i k n / N}
    sign=+1: unnormalized inverse (divide by N for the true inverse).
    Inputs/outputs: float arrays (..., N); returns (re, im).
    """
    import jax.numpy as jnp

    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"fft_pow2 requires power-of-two length, got {n}")
    if n == 1:
        return re, im
    tw = _twiddles(n, float(sign), str(re.dtype))
    # maintain shape (..., B, L): B sub-transforms of current length L
    rr = re[..., None, :]
    ii = im[..., None, :]
    for twr, twi in tw:
        L = rr.shape[-1]
        h = L // 2
        ar, br = rr[..., :h], rr[..., h:]
        ai, bi = ii[..., :h], ii[..., h:]
        ur, ui = ar + br, ai + bi                    # even outputs
        dr, di = ar - br, ai - bi
        vr = dr * twr - di * twi                     # odd outputs (twiddled)
        vi = dr * twi + di * twr
        # stack sub-transforms: (..., B, L) -> (..., 2B, L/2)
        rr = jnp.concatenate([ur[..., None, :], vr[..., None, :]], axis=-2)
        rr = rr.reshape(rr.shape[:-3] + (-1, h))
        ii = jnp.concatenate([ui[..., None, :], vi[..., None, :]], axis=-2)
        ii = ii.reshape(ii.shape[:-3] + (-1, h))
    rr = rr[..., 0]   # (..., N) in bit-reversed sub-transform order
    ii = ii[..., 0]
    perm = jnp.asarray(_bit_reverse_perm(n))
    return rr[..., perm], ii[..., perm]


def ifft_pow2(re, im):
    """True inverse FFT (includes the 1/N normalization)."""
    n = re.shape[-1]
    rr, ii = fft_pow2(re, im, sign=+1)
    return rr / n, ii / n
