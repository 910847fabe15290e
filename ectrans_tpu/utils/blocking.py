"""NPROMA grid-point blocking (reference PGP layout parity).

ecTrans callers exchange grid-point data in NPROMA-blocked arrays
``PGP(NPROMA, NFLD, NGPBLKS)`` over the locally-owned reduced-grid points
(``inv_trans.F90:58-106``; INIGPTR ``inigptr_mod.F90``).  XLA has no use
for NPROMA (it tiles internally), so this framework's native grid layout
is the padded (nfld, ndgl, ndlon) tensor — these converters exist for
callers porting NPROMA-shaped code and for bitwise output comparison with
the reference.
"""

from __future__ import annotations

import numpy as np


def _point_index(grid):
    """(lat, lon) indices of each reduced-grid point in lat-major order."""
    lats = []
    lons = []
    for i, nl in enumerate(grid.nloen):
        lats.append(np.full(int(nl), i))
        lons.append(np.arange(int(nl)))
    return np.concatenate(lats), np.concatenate(lons)


def fields_to_blocked(fields, grid, nproma: int):
    """(nfld, ndgl, ndlon) padded tensor -> (nproma, nfld, ngpblks) blocked.

    Points are ordered lat-major over the reduced grid (the serial-run
    ordering of the reference); the last block is zero-padded.
    """
    fields = np.asarray(fields)
    lat, lon = _point_index(grid)
    flat = fields[:, lat, lon]                     # (nfld, ngptot)
    nfld, ngptot = flat.shape
    ngpblks = -(-ngptot // nproma)
    out = np.zeros((nproma, nfld, ngpblks), dtype=fields.dtype)
    padded = np.zeros((nfld, ngpblks * nproma), dtype=fields.dtype)
    padded[:, :ngptot] = flat
    out[:, :, :] = padded.reshape(nfld, ngpblks, nproma).transpose(2, 0, 1)
    return out


def blocked_to_fields(blocked, grid):
    """(nproma, nfld, ngpblks) -> (nfld, ndgl, ndlon) padded tensor."""
    blocked = np.asarray(blocked)
    nproma, nfld, ngpblks = blocked.shape
    flat = blocked.transpose(1, 2, 0).reshape(nfld, ngpblks * nproma)
    lat, lon = _point_index(grid)
    ngptot = lat.size
    out = np.zeros((nfld, grid.ndgl, grid.ndlon), dtype=blocked.dtype)
    out[:, lat, lon] = flat[:, :ngptot]
    return out
