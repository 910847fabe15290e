"""Global-mean (m=0) conservation over repeated round trips.

The reference computes the m=0 Legendre transform in float64 even in its
single-precision build (``ledir_mod.F90:139-172``) because the global mean
(mass) must not drift over thousands of model timesteps.  The framework's
answer is:

* fp32 compute with fp32 (HIGHEST) accumulation — drift of the
  global-mean coefficient is ~5e-7 per round trip (random-walk-like), and
* a true-fp64 path (dtype=float64) for mass-critical work.

This test pins those measured rates so a regression in the accumulation
strategy (e.g. a kernel change that silently drops to bf16 accumulation,
which drifts ~1e-3/iteration) is caught.
"""

import numpy as np
import jax.numpy as jnp

import ectrans_tpu as et

N_ITERS = 20


def _roundtrips(res, sc, dtype, n):
    x = jnp.asarray(sc, dtype)
    for _ in range(n):
        g = et.inv_trans(res, spscalar=x, dtype=dtype)
        _, _, x = et.dir_trans(res, scalars=g, dtype=dtype)
    return np.asarray(x)


def test_global_mean_drift_bounds():
    res = et.setup("O48", 47)
    rng = np.random.default_rng(0)
    sc = rng.standard_normal((2, res.nspec2)).astype(np.float32)
    sc[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0

    out32 = _roundtrips(res, sc, jnp.float32, N_ITERS)
    out64 = _roundtrips(res, sc.astype(np.float64), jnp.float64, N_ITERS)

    # global-mean coefficient (m=0, n=0)
    d32 = np.abs(out32[:, 0] - sc[:, 0]).max()
    d64 = np.abs(out64[:, 0] - sc[:, 0]).max()
    # measured round-2: ~5e-7/iter fp32, ~5e-15/iter fp64; gate at 4x
    assert d32 < 4 * 5e-7 * N_ITERS, f"fp32 global-mean drift {d32}"
    assert d64 < 4 * 5e-15 * N_ITERS * 10, f"fp64 global-mean drift {d64}"

    # whole m=0 column (zonal-mean state)
    n0 = 2 * (res.nsmax + 1)
    c32 = np.abs(out32[:, :n0] - sc[:, :n0]).max()
    assert c32 < 4 * 1e-6 * N_ITERS, f"fp32 m=0 column drift {c32}"
