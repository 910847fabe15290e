"""The grouped Legendre contractions against a plain NumPy fp64 reference.

The reference is the dense fp64 recurrence table P̄[m, n, lat]
(``legendre.compute_legendre_table``, evaluated at every latitude of the
grid with its per-latitude zonal truncation) contracted by ``np.einsum`` in
float64: no parity split, no m-grouping, no padding.  The code under test is
the production path: ``layout.dense_to_parity`` + ``legendre_inv_grouped``
(inverse) and ``legendre_dir_grouped`` + ``layout.parity_to_dense``
(direct), at every public precision tier.

Tolerances, relative to the reference's max:
* "highest" (fp32 operands, sums in fp64): 100*eps(fp32), the reference's
  own ctest multiple;
* "high" (three bf16 passes, ~2^-16 operand split): 1e-4;
* "bf16" (operands rounded to bf16, 2^-9 relative each): 1e-2;
* float64 data (true fp64): 1e-12.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.legendre import compute_legendre_table
from ectrans_tpu.ops import layout, legendre_matmul
from ectrans_tpu.transform import _table_dtype

# (grid, truncation): full, octahedral cubic, a larger octahedral, and a
# linear truncation on a reduced (octahedral) grid
CONFIGS = [("T47", None), ("O48", 47), ("O160", 159), ("O32", 63)]
TIERS = {
    "highest": (np.float32, 100 * np.finfo(np.float32).eps),
    "high": (np.float32, 1e-4),
    "bf16": (np.float32, 1e-2),
    "fp64": (np.float64, 1e-12),
}


@functools.lru_cache(maxsize=4)
def _setup(name, nsmax):
    res = et.setup(name, nsmax)
    # P̄ at all latitudes (north -> south), zero where m > nmen(lat)
    p = compute_legendre_table(res.nsmax, res.mu, 1, res.nmen)
    return res, p                                     # (M, NP, ndgl)


def _tier_args(res, tier):
    dtype, tol = TIERS[tier]
    prec = "highest" if tier == "fp64" else tier
    gl = res.grouped_legendre(_table_dtype(dtype, prec))
    return dtype, tol, prec, gl


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name,nsmax", CONFIGS)
def test_inverse_matches_numpy_fp64(name, nsmax, tier):
    res, p = _setup(name, nsmax)
    dtype, tol, prec, gl = _tier_args(res, tier)
    tables = res.device_tables(dtype)
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((3, 2, res.M, res.NP))
    dense *= np.asarray(tables.dense_valid, np.float64)
    sym, asym = layout.dense_to_parity(jnp.asarray(dense, dtype), tables)
    got = np.asarray(legendre_matmul.legendre_inv_grouped(
        sym, asym, gl, precision=prec), np.float64)
    ref = np.einsum("mnl,fcmn->fcml", p, dense)
    assert got.shape == ref.shape == (3, 2, res.M, res.ndgl)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, f"{name} {tier}: inverse rel err {err:.3e} >= {tol:.1e}"


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name,nsmax", CONFIGS)
def test_direct_matches_numpy_fp64(name, nsmax, tier):
    res, p = _setup(name, nsmax)
    dtype, tol, prec, gl = _tier_args(res, tier)
    tables = res.device_tables(dtype)
    rng = np.random.default_rng(2)
    four = rng.standard_normal((2, 2, res.M, res.ndgl))
    w = jnp.asarray(res.w[: res.ndgnh], dtype)
    sym, asym = legendre_matmul.legendre_dir_grouped(
        jnp.asarray(four, dtype), gl, w, precision=prec)
    got = np.asarray(layout.parity_to_dense(sym, asym, tables, res.NP),
                     np.float64)
    ref = np.einsum("mnl,l,fcml->fcmn", p, res.w, four)
    # compare where the dense layout is defined (m <= n <= nsmax)
    valid = np.asarray(tables.dense_valid, np.float64) > 0
    d = np.abs(got - ref)[..., valid]
    err = d.max() / np.abs(ref[..., valid]).max()
    assert err < tol, f"{name} {tier}: direct rel err {err:.3e} >= {tol:.1e}"


def test_unknown_tier_is_refused():
    a = jnp.ones((2, 3, 4), jnp.float32)
    with pytest.raises(ValueError, match="precision must be one of"):
        legendre_matmul.tier_einsum("mik,mkf->mif", a, a.swapaxes(1, 2),
                                    "fast")


def test_highest_tier_sums_in_fp64_without_x64():
    """At "highest" the Legendre sums accumulate in float64 even with JAX's
    64-bit types off (the library default): a sum that cancels keeps its
    digits, where an fp32 accumulation loses them."""
    rng = np.random.default_rng(5)
    big = rng.standard_normal(4096) * 1e3
    x = np.concatenate([big, -big[::-1]]) + 1e-3 * rng.standard_normal(8192)
    x32 = x.astype(np.float32)
    ref = float(np.sum(x32.astype(np.float64)))
    with jax.enable_x64(False):
        table = jnp.ones((1, 1, x32.size), jnp.float32)
        xs = jnp.asarray(x32)[None, None, None, :]
        got = legendre_matmul.legendre_einsum("mik,fcmk->fcmi", table, xs)
        fp32 = legendre_matmul.tier_einsum("mik,fcmk->fcmi", table, xs)
        assert got.dtype == jnp.float32
        got, fp32 = float(got.ravel()[0]), float(fp32.ravel()[0])
    assert abs(got - ref) <= 2 * np.finfo(np.float32).eps * abs(ref)
    assert abs(fp32 - ref) > 10 * abs(got - ref)
