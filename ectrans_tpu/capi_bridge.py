"""Bridge module for the C API (src/capi/ectrans_tpu_capi.c).

The C layer passes raw pointers as integers; this module wraps them
zero-copy as NumPy arrays (ctypes) and drives the jitted transforms.
Spectral layout: ecTrans packed (NASM0); grid layout: flat reduced-grid
points, latitude-major (the transi grid convention) — see
``utils.blocking._point_index`` and ``compat4py``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

import jax

# The C API trades in double precision (like transi); enable x64 unless the
# caller overrides (ECTRANS_TPU_CAPI_DTYPE=float32 for backends without
# fp64 support).
_DTYPE = os.environ.get("ECTRANS_TPU_CAPI_DTYPE", "float64")
if _DTYPE == "float64":
    try:
        jax.config.update("jax_enable_x64", True)
    except Exception:
        _DTYPE = "float32"

import jax.numpy as jnp

_JDT = jnp.dtype(_DTYPE)

from .compat4py import _pack_reduced, _unpack_reduced
from .norms import specnorm as _specnorm
from .resolution import setup as _setup
from .transform import InvFlags, dir_trans, inv_trans

_RESOLUTIONS: dict[int, object] = {}
_NEXT = [0]


def _wrap(ptr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_double * n).from_address(int(ptr))
    return np.ctypeslib.as_array(buf)


_DEFAULT_RADIUS = [0.0]  # 0 = library default (Earth); trans_set_radius analogue


def set_radius(radius: float):
    """Global planet-radius override applied to subsequent setups (the
    reference's ``trans_set_radius``, ``transi.h:131``)."""
    _DEFAULT_RADIUS[0] = float(radius)
    return 0


def _register(res) -> int:
    h = _NEXT[0]
    _NEXT[0] += 1
    _RESOLUTIONS[h] = res
    return h


def setup(grid: str, nsmax: int) -> int:
    kw = {}
    if _DEFAULT_RADIUS[0] > 0.0:
        kw["radius"] = _DEFAULT_RADIUS[0]
    return _register(_setup(grid, None if nsmax < 0 else nsmax, **kw))


def setup_ex(grid: str, nsmax: int, radius: float, stretch: float) -> int:
    """Per-resolution setup with explicit radius and Schmidt stretching
    (reference SETUP_TRANS PRESOL radius + PSTRET, ``setup_trans.F90``).
    radius <= 0 / stretch <= 0 select the defaults."""
    kw = {}
    if radius > 0.0:
        kw["radius"] = radius
    elif _DEFAULT_RADIUS[0] > 0.0:
        kw["radius"] = _DEFAULT_RADIUS[0]
    if stretch > 0.0:
        kw["stretch"] = stretch
    return _register(_setup(grid, None if nsmax < 0 else nsmax, **kw))


def _res(handle: int):
    return _RESOLUTIONS[handle]


def inquire(handle: int):
    res = _res(handle)
    return (int(res.nspec2), int(res.grid.ngptot), int(res.ndgl),
            int(res.grid.ndlon), int(res.nsmax))


def fill_nloen(handle: int, ptr: int):
    res = _res(handle)
    buf = (ctypes.c_int * res.ndgl).from_address(int(ptr))
    arr = np.ctypeslib.as_array(buf)
    arr[:] = np.asarray(res.grid.nloen, dtype=np.int32)
    return 0


def invtrans_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    res = _res(handle)
    spec = _wrap(spec_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    out = np.asarray(
        inv_trans(res, spscalar=jnp.asarray(spec), dtype=_JDT)
    )
    gp = _wrap(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    for f in range(nfld):
        gp[f] = _pack_reduced(out[f], res.grid.nloen)
    return 0


def dirtrans_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    res = _res(handle)
    gp = _wrap(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    fields = np.stack(
        [_unpack_reduced(gp[f], res.grid.nloen, res.grid.ndlon)
         for f in range(nfld)]
    )
    _, _, spec = dir_trans(res, scalars=jnp.asarray(fields), dtype=_JDT)
    _wrap(spec_ptr, nfld * res.nspec2)[:] = np.asarray(spec).ravel()
    return 0


def invtrans_vordiv(handle: int, nfld: int, vor_ptr: int, div_ptr: int,
                    u_ptr: int, v_ptr: int):
    res = _res(handle)
    spvor = _wrap(vor_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    spdiv = _wrap(div_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    out = np.asarray(
        inv_trans(res, spvor=jnp.asarray(spvor), spdiv=jnp.asarray(spdiv),
                  dtype=_JDT)
    )
    u = _wrap(u_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    v = _wrap(v_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    for f in range(nfld):
        u[f] = _pack_reduced(out[f], res.grid.nloen)
        v[f] = _pack_reduced(out[nfld + f], res.grid.nloen)
    return 0


def dirtrans_vordiv(handle: int, nfld: int, u_ptr: int, v_ptr: int,
                    vor_ptr: int, div_ptr: int):
    res = _res(handle)
    u = _wrap(u_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    v = _wrap(v_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    uf = np.stack([_unpack_reduced(u[f], res.grid.nloen, res.grid.ndlon)
                   for f in range(nfld)])
    vf = np.stack([_unpack_reduced(v[f], res.grid.nloen, res.grid.ndlon)
                   for f in range(nfld)])
    spvor, spdiv, _ = dir_trans(res, u=jnp.asarray(uf), v=jnp.asarray(vf),
                                dtype=_JDT)
    _wrap(vor_ptr, nfld * res.nspec2)[:] = np.asarray(spvor).ravel()
    _wrap(div_ptr, nfld * res.nspec2)[:] = np.asarray(spdiv).ravel()
    return 0


def invtrans_full(handle: int, nvordiv: int, nscalar: int, vor_ptr: int,
                  div_ptr: int, sc_ptr: int, lscalarders: int,
                  luvder_ew: int, lvordivgp: int, gp_ptr: int):
    """Full-option inverse transform: vor/div + scalars with the reference
    InvTrans_t derivative flags (``transi.h:1014-1016`` lscalarders /
    luvder_EW / lvordivgp).  Grid output follows the documented PGP field
    ordering (``inv_trans.F90:58-106``); returns nfld_out."""
    res = _res(handle)
    spvor = spdiv = spsc = None
    if nvordiv:
        spvor = jnp.asarray(
            _wrap(vor_ptr, nvordiv * res.nspec2).reshape(nvordiv, -1))
        spdiv = jnp.asarray(
            _wrap(div_ptr, nvordiv * res.nspec2).reshape(nvordiv, -1))
    if nscalar:
        spsc = jnp.asarray(
            _wrap(sc_ptr, nscalar * res.nspec2).reshape(nscalar, -1))
    flags = InvFlags(scders=bool(lscalarders), uvders=bool(luvder_ew),
                     vorgp=bool(lvordivgp), divgp=bool(lvordivgp))
    out = np.asarray(inv_trans(res, spvor=spvor, spdiv=spdiv, spscalar=spsc,
                               flags=flags, dtype=_JDT))
    nfld_out = out.shape[0]
    gp = _wrap(gp_ptr, nfld_out * res.grid.ngptot).reshape(nfld_out, -1)
    for f in range(nfld_out):
        gp[f] = _pack_reduced(out[f], res.grid.nloen)
    return nfld_out


def dirtrans_full(handle: int, nvordiv: int, nscalar: int, gp_ptr: int,
                  vor_ptr: int, div_ptr: int, sc_ptr: int):
    """Combined direct transform: grid U, V, scalars (in that order, the
    reference DirTrans_t contract) -> spectral vor/div + scalars."""
    res = _res(handle)
    nfld_in = 2 * nvordiv + nscalar
    gp = _wrap(gp_ptr, nfld_in * res.grid.ngptot).reshape(nfld_in, -1)
    fields = np.stack(
        [_unpack_reduced(gp[f], res.grid.nloen, res.grid.ndlon)
         for f in range(nfld_in)])
    u = v = sc = None
    if nvordiv:
        u = jnp.asarray(fields[:nvordiv])
        v = jnp.asarray(fields[nvordiv : 2 * nvordiv])
    if nscalar:
        sc = jnp.asarray(fields[2 * nvordiv :])
    spvor, spdiv, spsc = dir_trans(res, u=u, v=v, scalars=sc, dtype=_JDT)
    if nvordiv:
        _wrap(vor_ptr, nvordiv * res.nspec2)[:] = np.asarray(spvor).ravel()
        _wrap(div_ptr, nvordiv * res.nspec2)[:] = np.asarray(spdiv).ravel()
    if nscalar:
        _wrap(sc_ptr, nscalar * res.nspec2)[:] = np.asarray(spsc).ravel()
    return 0


def invtrans_adj_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    """Adjoint of the scalar inverse transform (INV_TRANSAD)."""
    from .adjoint import inv_trans_adj

    res = _res(handle)
    gp = _wrap(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    grid_ad = np.stack(
        [_unpack_reduced(gp[f], res.grid.nloen, res.grid.ndlon)
         for f in range(nfld)]
    )
    _, _, spsc_ad = inv_trans_adj(res, jnp.asarray(grid_ad), 0, nfld,
                                  dtype=_JDT)
    _wrap(spec_ptr, nfld * res.nspec2)[:] = np.asarray(spsc_ad).ravel()
    return 0


def dirtrans_adj_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    """Adjoint of the scalar direct transform (DIR_TRANSAD)."""
    from .adjoint import dir_trans_adj

    res = _res(handle)
    spec = _wrap(spec_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    _, _, sc_ad = dir_trans_adj(res, spscalar_ad=jnp.asarray(spec),
                                nfld_sc=nfld, dtype=_JDT)
    out = np.asarray(sc_ad)
    gp = _wrap(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    for f in range(nfld):
        gp[f] = _pack_reduced(out[f], res.grid.nloen)
    return 0


def specnorm(handle: int, nfld: int, spec_ptr: int, norm_ptr: int):
    res = _res(handle)
    spec = _wrap(spec_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    _wrap(norm_ptr, nfld)[:] = np.asarray(_specnorm(res, jnp.asarray(spec)))
    return 0


def release(handle: int):
    _RESOLUTIONS.pop(handle, None)
    return 0


def _wrap_f(ptr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_float * n).from_address(int(ptr))
    return np.ctypeslib.as_array(buf)


def set_legpol_dir(path: str):
    """trans_set_cache/read/write equivalent (transi.h:192-194): directory
    for the on-disk Legendre-table cache ('' disables)."""
    os.environ["ECTRANS_TPU_LEGPOL_DIR"] = path
    return 0


def vordiv_to_uv(handle: int, nfld: int, vor_ptr: int, div_ptr: int,
                 u_ptr: int, v_ptr: int):
    """Standalone spectral vor/div -> spectral U,V (trans_vordiv_to_UV,
    transi.h:648)."""
    from .api import vordiv_to_uv as _vd2uv

    res = _res(handle)
    spvor = _wrap(vor_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    spdiv = _wrap(div_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    u, v = _vd2uv(res, jnp.asarray(spvor), jnp.asarray(spdiv), dtype=_JDT)
    _wrap(u_ptr, nfld * res.nspec2)[:] = np.asarray(u).ravel()
    _wrap(v_ptr, nfld * res.nspec2)[:] = np.asarray(v).ravel()
    return 0


def gpnorm(handle: int, nfld: int, gp_ptr: int, out_ptr: int):
    """Grid-point norms (GPNORM_TRANS): out (nfld, 3) = [ave, min, max]
    with the reference's area weights."""
    from .norms import gpnorm as _gpnorm

    res = _res(handle)
    gp = _wrap(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    fields = np.stack(
        [_unpack_reduced(gp[f], res.grid.nloen, res.grid.ndlon)
         for f in range(nfld)]
    )
    ave, mn, mx = _gpnorm(res, jnp.asarray(fields))
    out = _wrap(out_ptr, nfld * 3).reshape(nfld, 3)
    out[:, 0] = np.asarray(ave)
    out[:, 1] = np.asarray(mn)
    out[:, 2] = np.asarray(mx)
    return 0


def invtrans_lonlat(handle: int, nlat: int, nlon: int, nfld: int,
                    spec_ptr: int, gp_ptr: int):
    """Inverse transform onto a regular lat-lon grid (the LDLL /
    trans_set_resol_lonlat mode, transi.h:869): gp is (nfld, nlat, nlon)
    row-major."""
    from .latlon import LatLonGrid, inv_trans_latlon

    res = _res(handle)
    spec = _wrap(spec_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    ll = LatLonGrid(nlat=nlat, nlon=nlon)
    out = np.asarray(
        inv_trans_latlon(res, ll, spscalar=jnp.asarray(spec), dtype=_JDT))
    _wrap(gp_ptr, nfld * nlat * nlon)[:] = out.ravel()
    return 0


# --- distribution (single-controller: transi with TRANS_USE_MPI=0 performs
# plain copies; dist/gath here are the same owner-view copies,
# transi.h:520-616) ---

def distgrid(handle: int, nfld: int, glob_ptr: int, loc_ptr: int):
    res = _res(handle)
    n = nfld * res.grid.ngptot
    _wrap(loc_ptr, n)[:] = _wrap(glob_ptr, n)
    return 0


def gathgrid(handle: int, nfld: int, loc_ptr: int, glob_ptr: int):
    res = _res(handle)
    n = nfld * res.grid.ngptot
    _wrap(glob_ptr, n)[:] = _wrap(loc_ptr, n)
    return 0


def distspec(handle: int, nfld: int, glob_ptr: int, loc_ptr: int):
    res = _res(handle)
    n = nfld * res.nspec2
    _wrap(loc_ptr, n)[:] = _wrap(glob_ptr, n)
    return 0


def gathspec(handle: int, nfld: int, loc_ptr: int, glob_ptr: int):
    res = _res(handle)
    n = nfld * res.nspec2
    _wrap(glob_ptr, n)[:] = _wrap(loc_ptr, n)
    return 0


# --- single-precision entry points (the reference's trans_sp build /
# DIST_GRID_32 family) ---

def invtrans_scalar_f(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    res = _res(handle)
    spec = _wrap_f(spec_ptr, nfld * res.nspec2).reshape(nfld, res.nspec2)
    out = np.asarray(
        inv_trans(res, spscalar=jnp.asarray(spec, dtype=jnp.float32),
                  dtype=jnp.float32))
    gp = _wrap_f(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    for f in range(nfld):
        gp[f] = _pack_reduced(out[f], res.grid.nloen)
    return 0


def dirtrans_scalar_f(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    res = _res(handle)
    gp = _wrap_f(gp_ptr, nfld * res.grid.ngptot).reshape(nfld, -1)
    fields = np.stack(
        [_unpack_reduced(gp[f].astype(np.float64), res.grid.nloen,
                         res.grid.ndlon)
         for f in range(nfld)]
    )
    _, _, spec = dir_trans(res, scalars=jnp.asarray(fields, dtype=jnp.float32),
                           dtype=jnp.float32)
    _wrap_f(spec_ptr, nfld * res.nspec2)[:] = np.asarray(spec).ravel()
    return 0


# --- LAM (etrans) surface: ectrans_tpu_setup_lam + transforms ---

_LAM = {}


def setup_lam(nx: int, ny: int, nxux: int, nyux: int, msmax: int, nsmax: int,
              dx: float, dy: float) -> int:
    from .lam import make_lam_grid, setup_lam as _setup_lam

    lres = _setup_lam(make_lam_grid(
        nx, ny, nxux=nxux, nyux=nyux,
        msmax=msmax if msmax >= 0 else None,
        nsmax=nsmax if nsmax >= 0 else None, dx=dx, dy=dy))
    h = _NEXT[0]
    _NEXT[0] += 1
    _LAM[h] = lres
    return h


def inquire_lam(handle: int):
    lres = _LAM[handle]
    g = lres.grid
    return (int(lres.nspec2), int(g.nx * g.ny), int(g.nx), int(g.ny))


def invtrans_lam_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    from .lam import inv_trans_lam

    lres = _LAM[handle]
    g = lres.grid
    spec = _wrap(spec_ptr, nfld * lres.nspec2).reshape(nfld, lres.nspec2)
    out = np.asarray(
        inv_trans_lam(lres, spscalar=jnp.asarray(spec), dtype=_JDT))
    _wrap(gp_ptr, nfld * g.ny * g.nx)[:] = out.ravel()
    return 0


def dirtrans_lam_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    from .lam import dir_trans_lam

    lres = _LAM[handle]
    g = lres.grid
    gp = _wrap(gp_ptr, nfld * g.ny * g.nx).reshape(nfld, g.ny, g.nx)
    out = dir_trans_lam(lres, scalars=jnp.asarray(gp), dtype=_JDT)
    spsc = out[2]
    _wrap(spec_ptr, nfld * lres.nspec2)[:] = np.asarray(spsc).ravel()
    return 0


def release_lam(handle: int):
    _LAM.pop(handle, None)
    return 0
