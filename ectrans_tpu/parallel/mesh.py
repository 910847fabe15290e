"""Device-mesh construction for distributed transforms.

The reference's process grid (``sump_trans0_mod.F90``: NPRTRW wave sets x
NPRTRV field sets, with grid space re-partitioned over the same processes as
A x B sets) maps onto a single 2-D ``jax.sharding.Mesh`` with axes:

* ``"w"`` — the wave/latitude axis (NPRTRW): zonal wavenumber blocks in
  spectral space, latitude blocks in Fourier/grid space;
* ``"v"`` — the field/level axis (NPRTRV): fields in spectral/Fourier space,
  extra latitude splitting in grid space.

All transpositions (TRMTOL/TRLTOM/TRGTOL/TRLTOG) become ``lax.all_to_all``
over one of these axes (NCCL over NVLink between GPUs).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(w: int | None = None, v: int | None = None, devices=None) -> Mesh:
    """Build a (w, v) mesh.  Defaults: all devices on the "w" axis.

    ``make_mesh()`` -> (ndev, 1); ``make_mesh(w=4, v=2)`` -> 4x2.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if w is None and v is None:
        w, v = n, 1
    elif w is None:
        w = n // v
    elif v is None:
        v = n // w
    if w * v > n:
        raise ValueError(f"mesh {w}x{v} needs more than the {n} available devices")
    arr = np.asarray(devices[: w * v]).reshape(w, v)
    return Mesh(arr, ("w", "v"))
