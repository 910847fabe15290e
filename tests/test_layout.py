"""Packed <-> dense spectral layout against a plain NumPy index loop.

The packed layout is the reference's NASM0 addressing
(``suwavedi_mod.F90``): m-major, n ascending within m, (re, im)
interleaved.  The loop below writes it out directly from that definition;
``layout.dense_to_packed`` (a gather) and ``layout.packed_to_dense`` (a
row-slice gather + realignment) must reproduce it exactly: they move values
and do no arithmetic.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import layout

CONFIGS = ["T47", "O48", "O160"]
NFLDS = [1, 3, 10]


def _packed_loop(dense, nsmax):
    """(nfld, 2, M, NP) -> (nfld, nspec2) by the NASM0 definition."""
    out = []
    for m in range(nsmax + 1):
        for n in range(m, nsmax + 1):
            out += [dense[:, 0, m, n], dense[:, 1, m, n]]
    return np.stack(out, axis=1)


def _dense_loop(packed, nsmax, NP):
    """(nfld, nspec2) -> (nfld, 2, M, NP), zero outside m <= n <= nsmax."""
    dense = np.zeros((packed.shape[0], 2, nsmax + 1, NP), packed.dtype)
    j = 0
    for m in range(nsmax + 1):
        for n in range(m, nsmax + 1):
            dense[:, 0, m, n] = packed[:, j]
            dense[:, 1, m, n] = packed[:, j + 1]
            j += 2
    return dense


@pytest.mark.parametrize("nfld", NFLDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_dense_to_packed_matches_loop(config, nfld):
    res = et.setup(config)
    tables = res.device_tables(jnp.float32)
    rng = np.random.default_rng(7)
    dense = rng.standard_normal((nfld, 2, res.M, res.NP)).astype(np.float32)
    got = np.asarray(layout.dense_to_packed(jnp.asarray(dense), tables))
    np.testing.assert_array_equal(got, _packed_loop(dense, res.nsmax))


@pytest.mark.parametrize("nfld", NFLDS)
@pytest.mark.parametrize("config", CONFIGS)
def test_packed_to_dense_matches_loop(config, nfld):
    res = et.setup(config)
    tables = res.device_tables(jnp.float32)
    rng = np.random.default_rng(8)
    packed = rng.standard_normal((nfld, res.nspec2)).astype(np.float32)
    got = np.asarray(layout.packed_to_dense(jnp.asarray(packed), tables))
    np.testing.assert_array_equal(got, _dense_loop(packed, res.nsmax, res.NP))
