"""Independent numerical cross-checks of the Fourier stack.

Three mutually independent DFT implementations must agree:
* ``ops.fft_fourstep`` — the production four-step matmul FFT,
* ``ops.realfft`` — radix-2 DIF butterflies (entirely different algorithm),
* an O(n²) direct DFT evaluated in float64 numpy (ground truth).

This is the role the reference's dual FFTW/hicfft backends play for each
other (``tpm_fftw.F90`` vs ``hicfft.cuda.cu``).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ectrans_tpu.ops import fft_fourstep, realfft


def _direct_dft(z, sign=-1.0):
    n = z.shape[-1]
    k = np.arange(n)
    W = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return z @ W.T


@pytest.mark.parametrize("n", [512, 1024])
def test_fourstep_vs_radix2_vs_direct(n):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    ref = _direct_dft(z)

    fr, fi = fft_fourstep.fft_ord(jnp.asarray(z.real), jnp.asarray(z.imag), n)
    om = fft_fourstep.ord_map(n)
    four = np.zeros_like(ref)
    four[:, om] = np.asarray(fr) + 1j * np.asarray(fi)
    assert np.abs(four - ref).max() < 1e-10 * np.abs(ref).max()

    rr, ri = realfft.fft_pow2(jnp.asarray(z.real), jnp.asarray(z.imag))
    r2 = np.asarray(rr) + 1j * np.asarray(ri)
    assert np.abs(r2 - ref).max() < 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("n", [640])  # non-pow2: fourstep only
def test_fourstep_inverse_roundtrip(n):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    fr, fi = fft_fourstep.fft_ord(jnp.asarray(z.real), jnp.asarray(z.imag), n)
    br, bi = fft_fourstep.ifft_from_ord(fr, fi)
    back = np.asarray(br) + 1j * np.asarray(bi)
    assert np.abs(back[:, :n] - z).max() < 1e-11 * np.abs(z).max()


def test_radix2_inverse_roundtrip():
    rng = np.random.default_rng(2)
    n = 256
    z = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    fr, fi = realfft.fft_pow2(jnp.asarray(z.real), jnp.asarray(z.imag))
    br, bi = realfft.ifft_pow2(fr, fi)
    back = np.asarray(br) + 1j * np.asarray(bi)
    assert np.abs(back - z).max() < 1e-12 * np.abs(z).max()
