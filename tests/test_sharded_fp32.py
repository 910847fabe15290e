"""Sharded transforms in float32 against the single-device transforms.

``tests/test_sharded.py`` pins decomposition invariance in float64; these
cases cover the float32 einsum path on the meshes and field mixes a GPU
deployment runs (the precision the benchmark uses), on the 8-virtual-device
CPU mesh.  Tolerance: 100*eps(fp32) of the reference's max, the reference's
ctest multiple — both sides compute the same fp32 contractions, only the
decomposition (and so the summation order) differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ectrans_tpu as et
from ectrans_tpu.parallel import ShardedTransform, make_mesh

TOL = 100 * np.finfo(np.float32).eps


def _random_state(res, nuv, nsc, seed=0):
    rng = np.random.default_rng(seed)
    n0 = 2 * (res.nsmax + 1)

    def rp(n):
        x = rng.standard_normal((n, res.nspec2)).astype(np.float32)
        x[:, 1:n0:2] = 0.0
        return x

    vor, div, sc = rp(nuv), rp(nuv), rp(nsc)
    if nuv:
        vor[:, 0] = 0.0
        div[:, 0] = 0.0
    return vor, div, sc


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def res():
    return et.setup("O48", 47)


@pytest.mark.parametrize("w,v", [(2, 1), (4, 2), (1, 2)])
def test_sharded_fp32_inv_matches_single(res, w, v):
    vor, div, sc = _random_state(res, 2, 3)
    flags = et.InvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    args = dict(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
                spscalar=jnp.asarray(sc), flags=flags)
    ref = et.inv_trans(res, **args)
    got = ShardedTransform(res, make_mesh(w, v)).inv_trans(**args)
    assert got.shape == ref.shape
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("w,v", [(2, 1), (4, 2)])
def test_sharded_fp32_dir_matches_single(res, w, v):
    rng = np.random.default_rng(1)
    shape = (3, res.ndgl, res.grid.ndlon)
    u, vv = (jnp.asarray(rng.standard_normal(shape), jnp.float32)
             for _ in range(2))
    sc = jnp.asarray(rng.standard_normal((2,) + shape[1:]), jnp.float32)
    ref = et.dir_trans(res, u=u, v=vv, scalars=sc)
    got = ShardedTransform(res, make_mesh(w, v)).dir_trans(
        u=u, v=vv, scalars=sc)
    for name, r, g in zip(("vor", "div", "sc"), ref, got):
        assert _rel(g, r) < TOL, name


def test_sharded_fp32_scalar_only_and_uv_only(res):
    vor, div, sc = _random_state(res, 2, 3, seed=5)
    st = ShardedTransform(res, make_mesh(2, 2))
    g = st.inv_trans(spscalar=jnp.asarray(sc))
    assert _rel(g, et.inv_trans(res, spscalar=jnp.asarray(sc))) < TOL
    g = st.inv_trans(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div))
    ref = et.inv_trans(res, spvor=jnp.asarray(vor), spdiv=jnp.asarray(div))
    assert _rel(g, ref) < TOL


def test_sharded_fp32_roundtrip(res):
    """fp32 round trip on a (4, 2) mesh within the single-precision gate
    the single-device round-trip tests use."""
    vor, div, sc = _random_state(res, 2, 3, seed=2)
    st = ShardedTransform(res, make_mesh(4, 2))
    grid = st.inv_trans(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
                        spscalar=jnp.asarray(sc))
    sv, sd, ss = st.dir_trans(u=grid[0:2], v=grid[2:4], scalars=grid[4:7])
    assert np.abs(np.asarray(sv) - vor).max() < 2e-5
    assert np.abs(np.asarray(sd) - div).max() < 2e-5
    assert np.abs(np.asarray(ss) - sc).max() < 2e-5


def test_sharded_bf16_tier_on_square_mesh(res):
    """bf16 tier on a (2, 2) mesh: bfloat16 shard-local tables, one bf16
    pass, inside the reference's relaxed FLT gate (1e6*eps)."""
    _, _, sc = _random_state(res, 0, 3, seed=6)
    st = ShardedTransform(res, make_mesh(2, 2), precision="bf16")
    assert all(str(a.dtype) == "bfloat16" for k, a in st.tables.items()
               if k.startswith("lg"))
    grid = st.inv_trans(spscalar=jnp.asarray(sc))
    _, _, ss = st.dir_trans(scalars=grid)
    err = np.abs(np.asarray(ss) - sc).max()
    assert err < 1e6 * np.finfo(np.float32).eps * np.abs(sc).max(), err


def test_sharded_fp64_tables_are_fp64_parity_pairs():
    """float64 transforms keep true-fp64 parity-pair tables on the mesh."""
    res = et.setup("F24", 23)
    st = ShardedTransform(res, make_mesh(2, 2), dtype=jnp.float64)
    lg = {k: a for k, a in st.tables.items() if k.startswith("lg")}
    assert lg and all(a.dtype == jnp.float64 for a in lg.values())
    assert {k.split("_")[1] for k in lg} == {"psym", "pasym"}
