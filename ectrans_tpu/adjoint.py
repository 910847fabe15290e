"""Adjoint transforms (INV_TRANSAD / DIR_TRANSAD equivalents).

The reference maintains ~3.5k lines of hand-written transpose code
(``ltinvad_mod.F90``, ``ledirad_mod.F90``, ...) for 4D-Var.  Here the
transforms are linear JAX functions of their field arguments, so the exact
adjoints fall out of ``jax.linear_transpose`` — guaranteed to satisfy the
inner-product identity <F x, y> = <x, F^T y> to rounding error (the property
the reference tests to 2000*eps in ``tests/trans/test_adjoint.F90``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .resolution import Resolution
from .transform import InvFlags, dir_trans, inv_trans


def inv_trans_adj(
    res: Resolution,
    grid_ad,
    nfld_uv: int = 0,
    nfld_sc: int = 0,
    *,
    flags: InvFlags = InvFlags(),
    dtype=jnp.float32,
):
    """Adjoint of inv_trans: grid-space cotangent -> spectral cotangents.

    grid_ad: (nfld_out, ndgl, ndlon) with the PGP field ordering of
    ``inv_trans``.  Returns (spvor_ad, spdiv_ad, spscalar_ad) — entries are
    None for absent field groups.
    """
    dtype = jnp.dtype(dtype)
    shapes = []
    if nfld_uv:
        shapes += [jax.ShapeDtypeStruct((nfld_uv, res.nspec2), dtype)] * 2
    if nfld_sc:
        shapes += [jax.ShapeDtypeStruct((nfld_sc, res.nspec2), dtype)]

    def fwd(*specs):
        i = 0
        spvor = spdiv = spsc = None
        if nfld_uv:
            spvor, spdiv = specs[0], specs[1]
            i = 2
        if nfld_sc:
            spsc = specs[i]
        # _normalize=False: linear_transpose needs a structurally linear
        # trace; the RMS pre-scaling cancels exactly, so this is the same
        # operator (see fourier.synthesis)
        return inv_trans(res, spvor, spdiv, spsc, flags=flags, dtype=dtype,
                         _normalize=False)

    transpose = jax.linear_transpose(fwd, *shapes)
    outs = transpose(grid_ad.astype(dtype))
    spvor_ad = spdiv_ad = spsc_ad = None
    i = 0
    if nfld_uv:
        spvor_ad, spdiv_ad = outs[0], outs[1]
        i = 2
    if nfld_sc:
        spsc_ad = outs[i]
    return spvor_ad, spdiv_ad, spsc_ad


def dir_trans_adj(
    res: Resolution,
    spvor_ad=None,
    spdiv_ad=None,
    spscalar_ad=None,
    *,
    nfld_uv: int = 0,
    nfld_sc: int = 0,
    dtype=jnp.float32,
):
    """Adjoint of dir_trans: spectral cotangents -> grid-space cotangents.

    Returns (u_ad, v_ad, scalars_ad) with grid shapes (nfld, ndgl, ndlon).
    """
    dtype = jnp.dtype(dtype)
    gshape = (res.ndgl, res.grid.ndlon)
    shapes = []
    if nfld_uv:
        shapes += [jax.ShapeDtypeStruct((nfld_uv,) + gshape, dtype)] * 2
    if nfld_sc:
        shapes += [jax.ShapeDtypeStruct((nfld_sc,) + gshape, dtype)]

    def fwd(*grids):
        i = 0
        u = v = sc = None
        if nfld_uv:
            u, v = grids[0], grids[1]
            i = 2
        if nfld_sc:
            sc = grids[i]
        sv, sd, ss = dir_trans(res, u, v, sc, dtype=dtype, _normalize=False)
        return tuple(x for x in (sv, sd, ss) if x is not None)

    cotangents = tuple(
        x.astype(dtype)
        for x in (spvor_ad, spdiv_ad, spscalar_ad)
        if x is not None
    )
    transpose = jax.linear_transpose(fwd, *shapes)
    outs = transpose(cotangents)
    u_ad = v_ad = sc_ad = None
    i = 0
    if nfld_uv:
        u_ad, v_ad = outs[0], outs[1]
        i = 2
    if nfld_sc:
        sc_ad = outs[i]
    return u_ad, v_ad, sc_ad
