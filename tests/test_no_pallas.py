"""Every public transform path is plain JAX: no ``pallas_call`` anywhere.

The transforms run on whatever backend JAX compiles for; a hand-written
kernel on one of these paths would need its own GPU route, its own
reference and an end-to-end gain on the card (see README).  These tests
trace each entry point and scan the whole jaxpr, nested programs included.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ectrans_tpu as et
from ectrans_tpu.lam import (LamInvFlags, dir_trans_lam, inv_trans_lam,
                             make_lam_grid, setup_lam)
from ectrans_tpu.lam.sharded import ShardedLamTransform
from ectrans_tpu.parallel import ShardedTransform, make_mesh

PKG = pathlib.Path(et.__file__).parent


def _assert_plain(fn, *args):
    # run once first: the entry points fill lru-cached device tables, which
    # must hold concrete arrays, not tracers of this trace
    jax.block_until_ready(fn(*args))
    text = str(jax.make_jaxpr(fn)(*args))
    assert "dot_general" in text          # the trace reached the matmuls
    assert "pallas_call" not in text


@pytest.fixture(scope="module")
def res():
    return et.setup("O48", 47)


def _spec(res, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, res.nspec2))
    x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
    return jnp.asarray(x, jnp.float32)


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_inv_trans_is_plain(res, precision):
    flags = et.InvFlags(scders=True, uvders=True)
    _assert_plain(lambda a, b, c: et.inv_trans(
        res, spvor=a, spdiv=b, spscalar=c, flags=flags, precision=precision),
        _spec(res, 2, 0), _spec(res, 2, 1), _spec(res, 3, 2))


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
def test_dir_trans_is_plain(res, precision):
    g = jnp.ones((2, res.ndgl, res.grid.ndlon), jnp.float32)
    _assert_plain(lambda u, v, s: et.dir_trans(
        res, u=u, v=v, scalars=s, precision=precision), g, g, g)


def test_sharded_transform_is_plain(res):
    st = ShardedTransform(res, make_mesh(2, 2), dtype=jnp.float32)
    _assert_plain(lambda a, b, c: st.inv_trans(spvor=a, spdiv=b, spscalar=c),
                  _spec(res, 2, 0), _spec(res, 2, 1), _spec(res, 2, 2))
    g = jnp.ones((2, res.ndgl, res.grid.ndlon), jnp.float32)
    _assert_plain(lambda u, v, s: st.dir_trans(u=u, v=v, scalars=s), g, g, g)


def test_lam_transforms_are_plain():
    lres = setup_lam(make_lam_grid(48, 40))
    spec = jnp.zeros((2, lres.nspec2), jnp.float64)
    grid = jnp.zeros((2, lres.grid.ny, lres.grid.nx), jnp.float64)
    flags = LamInvFlags(scders=True, uvders=True)
    _assert_plain(lambda a: inv_trans_lam(lres, a, a, a, flags=flags), spec)
    _assert_plain(lambda g: dir_trans_lam(lres, g, g, g), grid)
    st = ShardedLamTransform(lres, make_mesh(2, 2), dtype=jnp.float64)
    _assert_plain(lambda a: st.inv_trans(a, a, a, flags=flags), spec)


def test_package_has_no_pallas_or_backend_branch():
    """No module imports Pallas or branches on a named backend."""
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert "pallas" not in text, path
        assert "default_backend()" not in text or path.name == "info.py", path
