"""Spectral and grid-point norms (SPECNORM / GPNORM_TRANS equivalents).

* ``specnorm``: per-field spectral norm with optional per-n metric weights —
  norm_f = sqrt( sum_m (2 - delta_m0) sum_n met(n) (re^2 + im^2) )
  (reference ``spnormd_mod.F90:36-54``; m=0 counts only the real part).
* ``gpnorm``: per-field (average, min, max) over the grid, the average
  area-weighted with the Gaussian weights
  (reference ``gpnorm_trans_ctl_mod.F90:193-218``: ave = sum_lat w(lat)
  * mean_lon f).

Both are pure functions of global arrays; on sharded arrays XLA inserts the
psum/all-reduce automatically (the reference's 2-stage (NPRTRV, NPRTRW)
reduction).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .resolution import Resolution


def specnorm(res: Resolution, spec, met=None):
    """Spectral norms per field.  spec: (nfld, nspec2); met: (nsmax+1,) or None."""
    pm = jnp.asarray(res.packed_gather_m)
    pc = jnp.asarray(res.packed_gather_c)
    pn = jnp.asarray(res.packed_gather_n)
    w = jnp.where(pm == 0, jnp.where(pc == 0, 1.0, 0.0), 2.0)
    if met is not None:
        w = w * jnp.asarray(met)[pn]
    return jnp.sqrt(jnp.sum(spec * spec * w[None, :].astype(spec.dtype), axis=1))


def gpnorm_tl(res: Resolution, grid_pert):
    """Tangent-linear of the gpnorm average (GPNORM_TRANSTL): the average is
    linear, so the TL of ave is gpnorm(ave_only) of the perturbation."""
    ave, _, _ = gpnorm(res, grid_pert, ave_only=True)
    return ave


def gpnorm_ad(res: Resolution, ave_ad):
    """Adjoint of the gpnorm average (GPNORM_TRANSAD): distribute the
    cotangent of each field average back over the grid with the area
    weights."""
    nfld = ave_ad.shape[0]
    shape = (nfld, res.ndgl, res.grid.ndlon)
    fwd = lambda g: gpnorm(res, g, ave_only=True)[0]
    (out,) = jax.linear_transpose(
        fwd, jax.ShapeDtypeStruct(shape, ave_ad.dtype)
    )(ave_ad)
    return out


def gpnorm(res: Resolution, grid, ave_only: bool = False):
    """Grid-point norms per field: (ave, min, max).

    grid: (nfld, ndgl, ndlon) — ragged longitude rows beyond nloen(lat) are
    ignored via masking.
    """
    nloen = np.asarray(res.grid.nloen)
    ndlon = res.grid.ndlon
    mask = (np.arange(ndlon)[None, :] < nloen[:, None])  # (ndgl, ndlon)
    maskj = jnp.asarray(mask)
    latw = jnp.asarray(res.w / nloen)  # w(lat)/nloen(lat)
    # HIGHEST: a float32 contraction at the default precision may run in
    # TF32 on a GPU
    ave = jnp.einsum("fij,ij,i->f", grid, maskj.astype(grid.dtype),
                     latw.astype(grid.dtype),
                     precision=jax.lax.Precision.HIGHEST)
    if ave_only:
        return ave, None, None
    big = jnp.asarray(jnp.finfo(grid.dtype).max, grid.dtype)
    gmin = jnp.min(jnp.where(maskj[None], grid, big), axis=(1, 2))
    gmax = jnp.max(jnp.where(maskj[None], grid, -big), axis=(1, 2))
    return ave, gmin, gmax
