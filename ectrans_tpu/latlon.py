"""Regular lat-lon output grids (the reference's LDLL mode).

The reference's lat-lon path (``LDLL``, ``setup_trans.F90`` dual-latitude
set RMU2 + FMM interpolation between Gaussian and equidistant latitudes,
``cdmap_mod.F90``, ``seefmm_mix.F90``) exists because re-evaluating Legendre
polynomials on a second latitude set was expensive on CPU.  Here the
natural design is *exact spectral evaluation*: build a second parity-split
P-table at the equidistant latitudes with the same native builder and run
the identical batched synthesis pipeline — no interpolation error at all.

Only the inverse (spectral -> lat-lon grid) is meaningful: an equidistant
grid carries no Gaussian quadrature, so the reference's direct-from-lat-lon
mode maps back to the Gaussian grid first; use ``dir_trans`` on the
Gaussian grid for analysis.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

import jax
import jax.numpy as jnp

from .legendre import build_parity_tables
from .ops import fourier, layout, legendre_matmul, spectral
from .resolution import GroupedLegendre, LegendreGroup, Resolution, _ensure_pytrees
from .transform import InvFlags, _coeff_tables


@dataclasses.dataclass(frozen=True, eq=False)
class LatLonGrid:
    """Equidistant lat-lon output grid.

    nlat latitudes: poles included if ``include_poles`` (lat = 90..-90),
    otherwise shifted half a step off the poles (the reference's LDLL
    "shifted" flavour, LSHIFTLL); nlon equidistant longitudes from 0.
    """

    nlat: int
    nlon: int
    include_poles: bool = True

    @functools.cached_property
    def latitudes_deg(self) -> np.ndarray:
        if self.include_poles:
            return np.linspace(90.0, -90.0, self.nlat)
        step = 180.0 / self.nlat
        return 90.0 - step / 2.0 - step * np.arange(self.nlat)

    @property
    def mu(self) -> np.ndarray:
        return np.sin(np.radians(self.latitudes_deg))


@functools.lru_cache(maxsize=8)
def _latlon_tables(res: Resolution, ll: LatLonGrid, dtype_str: str):
    """Parity P-tables at the lat-lon NH latitudes, grouped like the
    Gaussian ones, plus Bluestein tables for the uniform nlon rows."""
    _ensure_pytrees()
    nlat = ll.nlat
    nh = (nlat + 1) // 2          # northern half incl. equator row if odd
    mu_nh = ll.mu[:nh]
    # clamp the pole rows: cos(theta)=0 is fine for P (sectoral seeds -> 0
    # for m>0; P_n^0(±1) = sqrt(2n+1))
    psym, pasym, kmax = build_parity_tables(res.nsmax, mu_nh, ntmax_extra=1)
    M = res.M
    bs = -(-M // max(1, min(16, M // 8)))
    groups = []
    for m0 in range(0, M, bs):
        m1 = min(M, m0 + bs)
        kg = (res.nsmax + 1 - m0) // 2 + 1
        groups.append(LegendreGroup(
            m0=m0, m1=m1, i0=0, kg=kg,
            psym=jnp.asarray(psym[m0:m1, :, :kg], dtype=dtype_str),
            pasym=jnp.asarray(pasym[m0:m1, :, :kg], dtype=dtype_str),
        ))
    gl = GroupedLegendre(groups=tuple(groups), ndgnh=nh, kmax=kmax)
    nloen = (ll.nlon,) * nlat
    nmen = (res.nsmax,) * nlat
    bt = fourier.build_bluestein_tables((nloen, nmen, res.nsmax), dtype_str)
    racthe = 1.0 / np.maximum(np.sqrt(1.0 - ll.mu**2), 1e-12) / res.radius
    # at exact poles 1/cos is singular; derivatives there are zeroed
    if ll.include_poles:
        racthe[0] = 0.0
        racthe[-1] = 0.0
    return gl, bt, jnp.asarray(racthe, dtype_str)


@functools.partial(jax.jit, static_argnames=("flags", "odd_nlat"))
def _inv_ll_impl(tables, gl, ct, bt, racthe, spvor, spdiv, spscalar, flags,
                 odd_nlat):
    dtype = racthe.dtype
    nuv = spvor.shape[0] if spvor is not None else 0

    def lt(dense):
        sym, asym = layout.dense_to_parity(dense, tables)
        out = legendre_matmul.legendre_inv_grouped(sym, asym, gl)
        if odd_nlat:
            # NH half includes the equator row: drop its duplicate from the
            # southern half (legendre_inv_grouped emits 2*nh rows)
            nh = out.shape[-1] // 2
            out = jnp.concatenate([out[..., :nh], out[..., nh + 1 :]], axis=-1)
        return out

    rc = racthe[None, None, None, :]
    groups = []
    uvf = None
    if nuv:
        dvor = layout.packed_to_dense(spvor.astype(dtype), tables)
        ddiv = layout.packed_to_dense(spdiv.astype(dtype), tables)
        du, dv = spectral.vordiv_to_uv(dvor, ddiv, ct["vd"])
        if flags.vorgp:
            groups.append(lt(dvor))
        if flags.divgp:
            groups.append(lt(ddiv))
        uvf = lt(jnp.concatenate([du, dv], axis=0)) * rc
        groups.append(uvf)
    scf = None
    if spscalar is not None:
        dsc = layout.packed_to_dense(spscalar.astype(dtype), tables)
        scf = lt(dsc)
        groups.append(scf)
        if flags.scders:
            groups.append(lt(spectral.ns_derivative(dsc, ct["nsd"])) * rc)
    if nuv and flags.uvders:
        M = uvf.shape[2]
        mv = jnp.arange(M, dtype=dtype)[None, :, None]
        groups.append(jnp.stack([-uvf[:, 1] * mv, uvf[:, 0] * mv], 1) * rc)
    if spscalar is not None and flags.scders:
        M = scf.shape[2]
        mv = jnp.arange(M, dtype=dtype)[None, :, None]
        groups.append(jnp.stack([-scf[:, 1] * mv, scf[:, 0] * mv], 1) * rc)
    four = jnp.concatenate(groups, axis=0)
    return fourier.synthesis(four, bt)


@functools.lru_cache(maxsize=8)
def _latlon_interp_matrix(res: Resolution, ll: LatLonGrid, order: int = 12):
    """(ndgl, nlat_ll) Lagrange interpolation matrix taking per-latitude
    Fourier coefficients from the lat-lon latitudes to the Gaussian ones
    (the role of the reference's SEEFMM interpolation, ``seefmm_mix.F90``,
    in the direct lat-lon mode — here a banded barycentric Lagrange
    stencil of ``order`` nearest nodes)."""
    th_ll = np.radians(ll.latitudes_deg)           # descending
    th_g = np.radians(np.degrees(np.arcsin(res.mu)))
    nll = th_ll.size
    W = np.zeros((res.ndgl, nll))
    for i, t in enumerate(th_g):
        j = np.searchsorted(-th_ll, -t)            # ll lats descending
        lo = max(0, min(nll - order, j - order // 2))
        nodes = th_ll[lo : lo + order]
        for a in range(order):
            num = 1.0
            den = 1.0
            for b in range(order):
                if a != b:
                    num *= t - nodes[b]
                    den *= nodes[a] - nodes[b]
            W[i, lo + a] = num / den
    return W


def dir_trans_latlon(
    res: Resolution,
    ll: LatLonGrid,
    u=None,
    v=None,
    scalars=None,
    *,
    dtype=jnp.float32,
    interp_order: int = 12,
):
    """Direct transform from a regular lat-lon grid (the reference's
    direct LDLL mode, CDMAP before LEDIR, ``cdmap_mod.F90`` +
    ``seefmm_mix.F90``): zonal analysis on the uniform rows, Lagrange
    interpolation of the Fourier coefficients onto the Gaussian
    latitudes, then the standard quadrature-weighted Legendre analysis.

    Accuracy is interpolation-limited (choose nlat >~ 1.5x ndgl for
    near-spectral accuracy); analysis from the Gaussian grid itself
    (``dir_trans``) remains the exact path.
    Returns (spvor, spdiv, spscalar) packed arrays.
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is None and scalars is None:
        raise ValueError("nothing to transform")
    dtype = jnp.dtype(dtype)
    tables = res.device_tables(dtype)
    gl = res.grouped_legendre(str(dtype))
    ct = _coeff_tables(res, str(dtype))
    from .ops.fourier import analysis_uniform, uniform_dft_tables
    from .ops import legendre_matmul

    ut = uniform_dft_tables(ll.nlon, res.nsmax, str(dtype))
    W = jnp.asarray(_latlon_interp_matrix(res, ll, interp_order), dtype)

    nuv = u.shape[0] if u is not None else 0
    parts = ([u.astype(dtype), v.astype(dtype)] if nuv else []) + (
        [scalars.astype(dtype)] if scalars is not None else [])
    grid = jnp.concatenate(parts, axis=0)          # (F, nlat_ll, nlon)
    re, im = analysis_uniform(grid, ut)            # (F, nlat_ll, M)
    four_ll = jnp.stack([re, im], axis=1).swapaxes(2, 3)  # (F, 2, M, nlat_ll)
    four = jnp.einsum("gj,fcmj->fcmg", W, four_ll,
                      precision=jax.lax.Precision.HIGHEST)
    if nuv:
        racthe = tables.racthe[None, None, None, :]
        four = jnp.concatenate([four[: 2 * nuv] * racthe, four[2 * nuv :]], 0)
    sym, asym = legendre_matmul.legendre_dir_grouped(four, gl,
                                                     tables.w[: res.ndgnh])
    dense = layout.parity_to_dense(sym, asym, tables, res.NP)
    spvor = spdiv = spsc = None
    if nuv:
        dvor, ddiv = spectral.uv_to_vordiv(dense[:nuv], dense[nuv : 2 * nuv],
                                           ct["uvtvd"])
        spvor = layout.dense_to_packed(dvor, tables)
        spdiv = layout.dense_to_packed(ddiv, tables)
    if scalars is not None:
        spsc = layout.dense_to_packed(dense[2 * nuv :], tables)
    return spvor, spdiv, spsc


def inv_trans_latlon(
    res: Resolution,
    ll: LatLonGrid,
    spvor=None,
    spdiv=None,
    spscalar=None,
    *,
    flags: InvFlags = InvFlags(),
    dtype=jnp.float32,
):
    """Inverse transform onto a regular lat-lon grid (LDLL equivalent).

    Same field contract as ``inv_trans``; output (nfld_out, nlat, nlon).
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform")
    dtype = jnp.dtype(dtype)
    tables = res.device_tables(dtype)
    ct = _coeff_tables(res, str(dtype))
    gl, bt, racthe = _latlon_tables(res, ll, str(dtype))
    return _inv_ll_impl(tables, gl, ct, bt, racthe, spvor, spdiv, spscalar,
                        flags, ll.nlat % 2 == 1)
