"""K-packed bf16-limb FFT matmul path (ops/fft_fourstep, an opt-in
"highest"-tier formulation).

Pins: (a) the packed fft_ord/ifft_from_ord match the einsum formulation
at full-fp32-class accuracy across small-n, four-step, pruned-input and
pruned-output shapes; (b) the full bucketed synthesis/analysis layer
produces the same fields when forced onto the packed path; (c) the
dispatch rules (fp64 and the bf16 tier never take it).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import fft_fourstep as fs


def _data(rows, k, seed=0):
    rng = np.random.default_rng(seed)
    re = jnp.asarray(rng.standard_normal((rows, k)), jnp.float32)
    im = jnp.asarray(rng.standard_normal((rows, k)), jnp.float32)
    return re, im


# measured stage error of the 6-limb-pair dot is ~3e-7 relative; allow a
# few stages of compounding
TOL = 3e-6


@pytest.mark.parametrize("n,in_len,out_len", [
    (128, 128, None),          # small-n direct DFT
    (896, 215, 656),           # four-step, pruned input + pruned output
    (1792, 1792, None),        # four-step, full
])
def test_pack_matches_einsum(n, in_len, out_len, monkeypatch):
    re, im = _data(7, in_len)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "einsum")
    fr0, fi0 = fs.fft_ord(re, im, n)
    gr0, gi0 = fs.ifft_from_ord(fr0, fi0, out_len)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "pack")
    fr1, fi1 = fs.fft_ord(re, im, n)
    gr1, gi1 = fs.ifft_from_ord(fr1, fi1, out_len)
    assert fr1.shape == fr0.shape and gi1.shape == gi0.shape
    sc = float(np.abs(np.asarray(fr0)).max())
    for a, b in ((fr0, fr1), (fi0, fi1)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() / sc < TOL
    sc = float(np.abs(np.asarray(gr0)).max())
    for a, b in ((gr0, gr1), (gi0, gi1)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() / sc < TOL


def test_pack_roundtrip_identity(monkeypatch):
    """ifft(fft(x)) == x through the packed path alone."""
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "pack")
    n = 896
    re, im = _data(5, n, seed=3)
    fr, fi = fs.fft_ord(re, im, n)
    gr, gi = fs.ifft_from_ord(fr, fi)
    sc = float(np.abs(np.asarray(re)).max())
    assert np.abs(np.asarray(gr) - np.asarray(re)).max() / sc < TOL
    assert np.abs(np.asarray(gi) - np.asarray(im)).max() / sc < TOL


def test_pack_dispatch_rules(monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "pack")
    assert fs._pack_mode("highest", jnp.float32)
    assert fs._pack_mode("high", jnp.float32)
    assert fs._pack_mode(None, jnp.float32)
    assert not fs._pack_mode("bf16", jnp.float32)
    assert not fs._pack_mode("highest", jnp.float64)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "einsum")
    assert not fs._pack_mode("highest", jnp.float32)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "auto")
    assert not fs._pack_mode("highest", jnp.float32)  # CPU backend


def test_pack_full_layer_synthesis_analysis(monkeypatch):
    """Whole bucketed Fourier layer through the packed path: grid fields
    and re-analysed spectra match the einsum path (fp32 transforms)."""
    from ectrans_tpu.ops import fourier

    res = et.setup("O48", 47)
    bt = fourier.bucketed_tables_for(res, jnp.float32)
    rng = np.random.default_rng(5)
    four = jnp.asarray(rng.standard_normal((6, 2, res.M, res.ndgl)),
                       jnp.float32)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "einsum")
    g0 = np.asarray(fourier.synthesis_bucketed(four, bt, prec="highest"))
    a0r = fourier.analysis_bucketed(jnp.asarray(g0), bt, res.M,
                                    prec="highest")
    a0 = np.asarray(a0r)
    monkeypatch.setenv("ECTRANS_TPU_FFT_MXU", "pack")
    g1 = np.asarray(fourier.synthesis_bucketed(four, bt, prec="highest"))
    a1r = fourier.analysis_bucketed(jnp.asarray(g0), bt, res.M,
                                    prec="highest")
    a1 = np.asarray(a1r)
    assert np.abs(g1 - g0).max() / np.abs(g0).max() < TOL
    assert np.abs(a1 - a0).max() / np.abs(a0).max() < TOL


def test_split_planes_exact():
    """The bitwise limb split reconstructs fp32 to ~2^-24 with 3 planes,
    and one plane is plain bf16 rounding."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.concatenate([
        rng.standard_normal(500),
        10.0 ** rng.uniform(-30, 3, 500) * np.sign(rng.standard_normal(500)),
        [0.0, 1.0, -1.0],
    ]), jnp.float32)
    planes = fs.split_planes(x, 3)
    rec = sum(p.astype(jnp.float32) for p in planes)
    rel = np.abs(np.asarray(rec - x)) / np.maximum(np.abs(np.asarray(x)), 1e-38)
    assert rel.max() < 2 ** -23, rel.max()
    # single-plane split == plain bf16 rounding to within 1 ulp(bf16)
    one = fs.split_planes(x, 1)[0].astype(jnp.float32)
    rel1 = np.abs(np.asarray(one - x)) / np.maximum(np.abs(np.asarray(x)), 1e-38)
    assert rel1.max() < 2 ** -7.5, rel1.max()
