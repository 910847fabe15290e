"""LAM inverse/direct bi-Fourier transforms (EINV_TRANS / EDIR_TRANS).

A JAX redesign of the etrans transform chain
(``einv_trans_ctl_mod.F90:264-292``): no per-m loop — the meridional DFT
(the reference's ELEINV/ELEDIR "Legendre" stage, ``eleinv_mod.F90:95-108``)
and the zonal DFT run as whole-tensor batched chirp-z transforms on (re, im)
float pairs.

Spectral-space operators (all diagonal in bi-Fourier space):
  * winds from vor/div   — EVDTUV (``evdtuv_mod.F90:95-135``):
      U = rlepinm (i kx D - i ky Z),  V = rlepinm (i kx Z + i ky D),
      rlepinm = -1/(kx^2 + ky^2) (``suemp_trans_preleg_mod.F90:91``),
      mean wind (m=n=0) injected from meanu/meanv.
  * vor/div from winds   — EUVTVD (``euvtvd_mod.F90:95-127``):
      Z = i kx V - i ky U,  D = i kx U + i ky V; mean wind extracted
      (``eltdir_mod.F90:160-182``).
  * N-S derivative       — ESPNSDE: i ky F.
  * E-W derivative       — EFSC:    i kx F.

Grid arrays are (nfld, ny, nx) over the full extended (biperiodic) domain;
use ``lam.biper.biperiodicize`` to extend C+I data first.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.fourier import analysis_uniform, synthesis_uniform, uniform_dft_tables
from .resolution import LamResolution


@dataclasses.dataclass(frozen=True)
class LamInvFlags:
    vorgp: bool = False
    divgp: bool = False
    scders: bool = False
    uvders: bool = False


def _izon(x):
    """Multiply by i in the zonal direction: components (RR,RI,IR,II) ->
    (-IR, -II, RR, RI)."""
    return jnp.stack([-x[:, 2], -x[:, 3], x[:, 0], x[:, 1]], axis=1)


def _imer(x):
    """Multiply by i in the meridional direction: (RR,RI,IR,II) ->
    (-RI, RR, -II, IR)."""
    return jnp.stack([-x[:, 1], x[:, 0], -x[:, 3], x[:, 2]], axis=1)


def packed_to_dense(spec, t):
    nfld = spec.shape[0]
    padded = jnp.concatenate([spec, jnp.zeros((nfld, 1), spec.dtype)], axis=-1)
    return padded[:, t["dense_gather"]]


def dense_to_packed(dense, t):
    return dense[:, t["packed_c"], t["packed_m"], t["packed_n"]]


def vordiv_to_uv_lam(dvor, ddiv, t, meanu=None, meanv=None):
    """EVDTUV: dense (nfld, 4, M, N) vor/div -> U, V."""
    kx, ky, rl = t["kx"], t["ky"], t["rlepinm"]
    u = rl * (kx * _izon(ddiv) - ky * _imer(dvor))
    v = rl * (kx * _izon(dvor) + ky * _imer(ddiv))
    if meanu is not None:
        u = u.at[:, 0, 0, 0].set(meanu)
        v = v.at[:, 0, 0, 0].set(meanv)
    return u, v


def uv_to_vordiv_lam(du, dv, t):
    """EUVTVD: dense U, V -> vor, div (+ mean wind extraction)."""
    kx, ky = t["kx"], t["ky"]
    vor = kx * _izon(dv) - ky * _imer(du)
    div = kx * _izon(du) + ky * _imer(dv)
    meanu = du[:, 0, 0, 0]
    meanv = dv[:, 0, 0, 0]
    return vor * t["valid"], div * t["valid"], meanu, meanv


def _synth2d(dense, uty, utx):
    """dense (nfld, 4, M, N) -> grid (nfld, ny, nx)."""
    # meridional synthesis per zonal component: (f, M, N) -> (f, M, ny)
    gre = synthesis_uniform(dense[:, 0], dense[:, 1], uty)
    gim = synthesis_uniform(dense[:, 2], dense[:, 3], uty)
    # zonal synthesis: (f, ny, M) -> (f, ny, nx)
    return synthesis_uniform(gre.swapaxes(1, 2), gim.swapaxes(1, 2), utx)


def _anal2d(grid, uty, utx):
    """grid (nfld, ny, nx) -> dense (nfld, 4, M, N)."""
    zre, zim = analysis_uniform(grid, utx)          # (f, ny, M)
    rr, ri = analysis_uniform(zre.swapaxes(1, 2), uty)   # (f, M, N)
    ir, ii = analysis_uniform(zim.swapaxes(1, 2), uty)
    return jnp.stack([rr, ri, ir, ii], axis=1)


@functools.partial(jax.jit, static_argnames=("flags",))
def _lam_inv_impl(t, uty, utx, spvor, spdiv, spscalar, meanu, meanv, flags):
    dtype = t["kx"].dtype
    nuv = spvor.shape[0] if spvor is not None else 0
    groups = []
    uvd = None
    if nuv:
        dvor = packed_to_dense(spvor.astype(dtype), t)
        ddiv = packed_to_dense(spdiv.astype(dtype), t)
        du, dv = vordiv_to_uv_lam(dvor, ddiv, t, meanu, meanv)
        if flags.vorgp:
            groups.append(dvor)
        if flags.divgp:
            groups.append(ddiv)
        uvd = jnp.concatenate([du, dv], axis=0)
        groups.append(uvd)
    scd = None
    if spscalar is not None:
        scd = packed_to_dense(spscalar.astype(dtype), t)
        groups.append(scd)
        if flags.scders:
            groups.append(t["ky"] * _imer(scd))  # ESPNSDE
    if nuv and flags.uvders:
        groups.append(t["kx"] * _izon(uvd))      # EFSC E-W derivative
    if spscalar is not None and flags.scders:
        groups.append(t["kx"] * _izon(scd))
    dense = jnp.concatenate(groups, axis=0)
    return _synth2d(dense, uty, utx)


@jax.jit
def _lam_dir_impl(t, uty, utx, u, v, scalars):
    dtype = t["kx"].dtype
    nuv = u.shape[0] if u is not None else 0
    parts = []
    if nuv:
        parts += [u.astype(dtype), v.astype(dtype)]
    if scalars is not None:
        parts.append(scalars.astype(dtype))
    grid = jnp.concatenate(parts, axis=0)
    dense = _anal2d(grid, uty, utx) * t["valid"]
    spvor = spdiv = spsc = meanu = meanv = None
    if nuv:
        dvor, ddiv, meanu, meanv = uv_to_vordiv_lam(dense[:nuv], dense[nuv:2 * nuv], t)
        spvor = dense_to_packed(dvor, t)
        spdiv = dense_to_packed(ddiv, t)
    if scalars is not None:
        spsc = dense_to_packed(dense[2 * nuv :], t)
    return spvor, spdiv, spsc, meanu, meanv


def inv_trans_lam(
    res: LamResolution,
    spvor=None,
    spdiv=None,
    spscalar=None,
    meanu=None,
    meanv=None,
    *,
    flags: LamInvFlags = LamInvFlags(),
    dtype=jnp.float32,
):
    """LAM inverse transform: packed spectral -> grid (nfld_out, ny, nx).

    Output field ordering follows the global-transform PGP contract:
    vor?, div?, u, v, scalars, N-S scalar derivs?, E-W u/v derivs?,
    E-W scalar derivs?.
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform")
    dtype = jnp.dtype(dtype)
    t = res.device_tables(str(dtype))
    g = res.grid
    uty = uniform_dft_tables(g.ny, g.nsmax, str(dtype))
    utx = uniform_dft_tables(g.nx, g.msmax, str(dtype))
    nuv = spvor.shape[0] if spvor is not None else 0
    if nuv:
        meanu = jnp.zeros((nuv,), dtype) if meanu is None else jnp.asarray(meanu, dtype)
        meanv = jnp.zeros((nuv,), dtype) if meanv is None else jnp.asarray(meanv, dtype)
    return _lam_inv_impl(t, uty, utx, spvor, spdiv, spscalar, meanu, meanv, flags)


def dir_trans_lam(
    res: LamResolution,
    u=None,
    v=None,
    scalars=None,
    *,
    dtype=jnp.float32,
):
    """LAM direct transform: grid (extended domain) -> packed spectral.

    Returns (spvor, spdiv, spscalar, meanu, meanv); mean wind is the
    (m=0, n=0) coefficient of u, v (reference PSPMEANU/V,
    ``eltdir_mod.F90:160-182``).
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is None and scalars is None:
        raise ValueError("nothing to transform")
    dtype = jnp.dtype(dtype)
    t = res.device_tables(str(dtype))
    g = res.grid
    uty = uniform_dft_tables(g.ny, g.nsmax, str(dtype))
    utx = uniform_dft_tables(g.nx, g.msmax, str(dtype))
    return _lam_dir_impl(t, uty, utx, u, v, scalars)
