"""Round-trip and analytic-spectrum correctness of the core transforms.

Modeled on the reference's benchmark-driven functional tests
(ectrans-benchmark.F90:850-860: spectral-norm error vs an analytically known
initial condition below a machine-eps multiple).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp

import ectrans_tpu as et
from ectrans_tpu.ops import fourier as four_ops


def random_packed(res, nfld, seed=0):
    """Random spectral state with reference constraints: m=0 imag parts zero."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((nfld, res.nspec2))
    # zero imaginary parts of m=0 coefficients
    n0 = res.grid.nsmax + 1
    spec[:, 1 : 2 * n0 : 2] = 0.0
    return spec


@pytest.mark.parametrize("gridname,nsmax,tol", [
    ("F24", 47, 1e-11),
    ("F32", 47, 1e-11),
    # reduced grids: the per-m latitude restriction (reference NDGLU,
    # setup_geom_mod.F90) makes quadrature orthogonality inexact at ~1e-10
    ("O48", 47, 1e-8),
])
def test_scalar_roundtrip(gridname, nsmax, tol):
    res = et.setup(gridname, nsmax)
    spec = random_packed(res, 3)
    grid = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float64)
    _, _, spec2 = et.dir_trans(res, scalars=grid, dtype=jnp.float64)
    err = np.max(np.abs(np.asarray(spec2) - spec))
    assert err < tol, f"roundtrip error {err}"


def test_analytic_spherical_harmonic():
    """inv_trans of a single (m, n) coefficient must equal the analytic Y_n^m."""
    res = et.setup("F24", 47)
    mu, _ = res.grid.gauss()
    nlon = res.grid.ndlon
    lam = 2 * np.pi * np.arange(nlon) / nlon
    for m, n, comp in [(0, 0, 0), (0, 5, 0), (3, 7, 0), (3, 7, 1), (21, 40, 1)]:
        spec = np.zeros((1, res.nspec2))
        spec[0, res.nasm0[m] + 2 * (n - m) + comp] = 1.0
        grid = np.asarray(et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float64))[0]
        # analytic: Re[ c_m * (re + i*im) * P̄_n^m(mu) * e^{i m lambda} ]
        from math import factorial

        norm = np.sqrt((2 * n + 1) * factorial(n - m) / factorial(n + m))
        pbar = sp.lpmv(m, n, mu) * ((-1) ** m) * norm
        cm = 1.0 if m == 0 else 2.0
        coeff = 1.0 if comp == 0 else 1.0j
        expect = cm * np.real(coeff * np.exp(1j * m * lam)[None, :]) * pbar[:, None]
        err = np.max(np.abs(grid - expect))
        assert err < 1e-12, (m, n, comp, err)


def test_direct_analytic():
    """dir_trans of an analytic Y_n^m field recovers the single coefficient."""
    res = et.setup("F24", 47)
    mu, _ = res.grid.gauss()
    nlon = res.grid.ndlon
    lam = 2 * np.pi * np.arange(nlon) / nlon
    from math import factorial

    m, n = 4, 11
    norm = np.sqrt((2 * n + 1) * factorial(n - m) / factorial(n + m))
    pbar = sp.lpmv(m, n, mu) * ((-1) ** m) * norm
    f = 2.0 * np.cos(m * lam)[None, :] * pbar[:, None]
    _, _, spec = et.dir_trans(res, scalars=jnp.asarray(f[None]), dtype=jnp.float64)
    spec = np.asarray(spec)[0]
    expect = np.zeros(res.nspec2)
    expect[res.nasm0[m] + 2 * (n - m)] = 1.0
    err = np.max(np.abs(spec - expect))
    assert err < 1e-12, err


def test_reduced_grid_roundtrip_matches_full_where_resolved():
    """On O48 with T47 truncation every spectral mode survives a round trip."""
    res = et.setup("O48", 47)
    spec = random_packed(res, 2, seed=1)
    grid = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float64)
    _, _, spec2 = et.dir_trans(res, scalars=grid, dtype=jnp.float64)
    err = np.max(np.abs(np.asarray(spec2) - spec))
    assert err < 1e-8, err


def test_fp32_roundtrip_tolerance():
    """fp32 path accuracy comparable to the reference single-precision build."""
    res = et.setup("F24", 47)
    spec = random_packed(res, 2, seed=2).astype(np.float32)
    grid = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float32)
    _, _, spec2 = et.dir_trans(res, scalars=grid, dtype=jnp.float32)
    err = np.max(np.abs(np.asarray(spec2) - spec))
    assert err < 5e-4, err


def test_next_pow2():
    for n, expect in [(1, 1), (5, 8), (8, 8), (97, 128), (6417, 8192)]:
        assert four_ops._next_pow2(n) == expect


def test_vorgp_divgp_flags():
    """LDVORGP/LDDIVGP: grid-point vor/div outputs equal the scalar
    transform of the same spectral fields, and the PGP ordering holds."""
    import ectrans_tpu as et
    from ectrans_tpu.transform import InvFlags

    res = et.setup("F24", 47)
    spec = random_packed(res, 1, seed=5)
    vor = jnp.asarray(spec)
    div = jnp.asarray(random_packed(res, 1, seed=6))
    out = et.inv_trans(
        res, spvor=vor, spdiv=div,
        flags=InvFlags(vorgp=True, divgp=True), dtype=jnp.float64,
    )
    assert out.shape[0] == 4  # vor, div, u, v
    ref_vor = et.inv_trans(res, spscalar=vor, dtype=jnp.float64)
    ref_div = et.inv_trans(res, spscalar=div, dtype=jnp.float64)
    assert np.abs(np.asarray(out[0]) - np.asarray(ref_vor[0])).max() < 1e-11
    assert np.abs(np.asarray(out[1]) - np.asarray(ref_div[0])).max() < 1e-11


def test_bfloat16_smoke():
    """bfloat16 compute path stays finite and roughly round-trips (the CLI
    advertises --dtype bfloat16; accuracy is bf16-limited by design)."""
    res = et.setup("F24", 47)
    spec = random_packed(res, 2, seed=9).astype(np.float32)
    g = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.bfloat16)
    assert np.isfinite(np.asarray(g, dtype=np.float32)).all()
    _, _, s2 = et.dir_trans(res, scalars=g, dtype=jnp.bfloat16)
    err = np.abs(np.asarray(s2, dtype=np.float32) - spec).max()
    assert err < 0.15, err


def test_precision_bf16_tier_relaxed_gate():
    """precision="bf16" (single-pass contraction + bfloat16 grouped tables,
    the TCO2047 memory mode) round-trips within the reference's relaxed FLT
    gate (1e6*eps, reference tests/CMakeLists.txt:316) — and the tables it
    streams really are bfloat16 (half the LT table traffic)."""
    res = et.setup("O48", 47)
    spec = random_packed(res, 3, seed=11).astype(np.float32)
    g = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float32,
                     precision="bf16")
    _, _, s2 = et.dir_trans(res, scalars=g, dtype=jnp.float32,
                            precision="bf16")
    scale = np.abs(spec).max()
    err = np.abs(np.asarray(s2) - spec).max()
    assert err < 1e6 * np.finfo(np.float32).eps * scale, err
    gl = res.grouped_legendre("bfloat16")
    assert str(gl.groups[0].psym.dtype) == "bfloat16"
    # and the tiers are ordered: highest must be strictly tighter
    g_hi = et.inv_trans(res, spscalar=jnp.asarray(spec), dtype=jnp.float32,
                        precision="highest")
    _, _, s2_hi = et.dir_trans(res, scalars=g_hi, dtype=jnp.float32,
                               precision="highest")
    err_hi = np.abs(np.asarray(s2_hi) - spec).max()
    assert err_hi < 100 * np.finfo(np.float32).eps * scale, err_hi


def test_npromatr_packet_split_matches_single_call():
    """Library-level NPROMATR (inv_trans_ctl_mod.F90:143-276): packeted
    transforms must reproduce the single-call result and PGP ordering."""
    import jax.numpy as jnp
    from ectrans_tpu.transform import InvFlags

    res = et.setup("O48", 47)
    rng = np.random.default_rng(11)
    n0 = 2 * (res.nsmax + 1)

    def rp(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1:n0:2] = 0.0
        x[:, 0] = 0.0
        return jnp.asarray(x)

    vor, div, sc = rp(3), rp(3), rp(5)
    flags = InvFlags(vorgp=True, scders=True, uvders=True)
    ref = np.asarray(et.inv_trans(res, vor, div, sc, flags=flags,
                                  dtype=jnp.float64))
    got = np.asarray(et.inv_trans(res, vor, div, sc, flags=flags,
                                  dtype=jnp.float64, npromatr=4))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-11 * np.abs(ref).max()

    # direct
    u = jnp.asarray(rng.standard_normal((3, res.ndgl, res.grid.ndlon)))
    vv = jnp.asarray(rng.standard_normal((3, res.ndgl, res.grid.ndlon)))
    scg = jnp.asarray(rng.standard_normal((5, res.ndgl, res.grid.ndlon)))
    r = et.dir_trans(res, u, vv, scg, dtype=jnp.float64)
    g = et.dir_trans(res, u, vv, scg, dtype=jnp.float64, npromatr=4)
    for a, b in zip(r, g):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-11


def test_npromatr_sharded_matches():
    import jax.numpy as jnp
    from ectrans_tpu.parallel import ShardedTransform, make_mesh
    from ectrans_tpu.transform import InvFlags

    res = et.setup("O48", 47)
    rng = np.random.default_rng(12)
    n0 = 2 * (res.nsmax + 1)

    def rp(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1:n0:2] = 0.0
        x[:, 0] = 0.0
        return jnp.asarray(x)

    vor, div, sc = rp(2), rp(2), rp(3)
    flags = InvFlags(scders=True, uvders=True)
    st = ShardedTransform(res, make_mesh(2, 2), dtype=jnp.float64)
    ref = np.asarray(st.inv_trans(vor, div, sc, flags))
    got = np.asarray(st.inv_trans(vor, div, sc, flags, npromatr=3))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-11 * np.abs(ref).max()
