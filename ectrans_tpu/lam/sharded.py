"""Distributed LAM bi-Fourier transforms over a (w, v) mesh.

The reference etrans reuses the global MPI transposition machinery
(``einv_trans_ctl_mod.F90``: ELTINV per local m -> TRMTOL -> EFTINV per
local latitude, with fields over the V-set).  Here the same structure is
one ``shard_map``:

  spectral (4-real packed)      fields sharded over "v", m-blocks over "w"
  -> meridional DFT per local m
  -> all_to_all over "w"        (TRMTOL: m-distributed -> row-distributed)
  -> zonal DFT per local row
  -> all_to_all over "v"        (TRLTOG: gather fields, split rows further)
  grid (nfld, ny/(w*v) rows, nx)

The direct transform is the mirror.  Zonal wavenumbers are split in
contiguous blocks (every m costs the same here — the meridional DFT is
full-length regardless of the elliptic cut), rows in contiguous blocks.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.fourier import (analysis_uniform, synthesis_uniform,
                           uniform_dft_tables)
from .resolution import LamResolution
from .transform import LamInvFlags, _imer, _izon


def _group_perms(group_sizes, v):
    """Owner-major <-> group-major field permutations (cf. the global
    ShardedTransform._group_perms)."""
    om = []
    offs = np.cumsum([0] + list(group_sizes))
    for d in range(v):
        for i, g in enumerate(group_sizes):
            lo = offs[i] + d * (g // v)
            om.extend(range(lo, lo + g // v))
    om = np.asarray(om)
    return om, np.argsort(om)


class ShardedLamTransform:
    """Distributed LAM transforms on a (w, v) mesh (single-device results
    and sharded results are identical — decomposition invariance)."""

    def __init__(self, res: LamResolution, mesh: Mesh, dtype=jnp.float32):
        if tuple(mesh.axis_names) != ("w", "v"):
            raise ValueError(f'mesh must have axes ("w", "v"), got {mesh.axis_names}')
        self.res = res
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        self.w = mesh.shape["w"]
        self.v = mesh.shape["v"]
        g = res.grid
        self.M_pad = -(-res.M // self.w) * self.w
        self.ny_pad = -(-g.ny // (self.w * self.v)) * (self.w * self.v)
        self._place_tables()

    # ------------------------------------------------------------------
    def _place_tables(self):
        res, g = self.res, self.res.grid
        Mp = self.M_pad
        dt = str(self.dtype)
        t = res.device_tables(dt)

        def padm(x):  # pad (.., M, N) tables along M to M_pad
            x = np.asarray(x)
            return np.pad(x, [(0, Mp - res.M)] + [(0, 0)] * (x.ndim - 1))

        host = {
            "kx_w": padm(t["kx"]),
            "ky_w": padm(t["ky"]),
            "rlepinm_w": padm(t["rlepinm"]),
            "valid_w": padm(t["valid"]),
            "dense_gather_w": padm(
                np.asarray(res.dense_gather).transpose(1, 0, 2)
            ),  # (M_pad, 4, N); pad rows index the zero slot? filled below
            "packed_c": np.asarray(res.packed_c),
            "packed_m": np.asarray(res.packed_m),
            "packed_n": np.asarray(res.packed_n),
        }
        # pad rows of dense_gather must point at the zero slot (= nspec2)
        host["dense_gather_w"][res.M :] = res.nspec2
        dev, specs = {}, {}
        for k, val in host.items():
            arr = val.astype(np.int32) if val.dtype.kind in "iu" else val.astype(dt)
            spec = (P("w", *([None] * (arr.ndim - 1)))
                    if k.endswith("_w") else P())
            dev[k] = jax.device_put(jnp.asarray(arr), NamedSharding(self.mesh, spec))
            specs[k] = spec
        self.tables = dev
        self.table_specs = specs
        self.uty = uniform_dft_tables(g.ny, g.nsmax, dt)
        self.utx = uniform_dft_tables(g.nx, g.msmax, dt)
        self._inv_jit = {}
        self._dir_jit = {}

    # ------------------------------------------------------------------
    def _inv_kernel(self, spvor, spdiv, spsc, meanu, meanv, t, flags):
        res = self.res
        dtype = t["kx_w"].dtype
        nuv = spvor.shape[0]
        nsc = spsc.shape[0]

        def p2d(spec):
            nfld = spec.shape[0]
            padded = jnp.concatenate(
                [spec, jnp.zeros((nfld, 1), spec.dtype)], axis=-1
            )
            return padded[:, t["dense_gather_w"].transpose(1, 0, 2)]

        groups = []
        uvd = None
        if nuv:
            dvor = p2d(spvor.astype(dtype))
            ddiv = p2d(spdiv.astype(dtype))
            kx, ky, rl = t["kx_w"], t["ky_w"], t["rlepinm_w"]
            du = rl * (kx * _izon(ddiv) - ky * _imer(dvor))
            dv = rl * (kx * _izon(dvor) + ky * _imer(ddiv))
            # mean wind lives at (m=0, n=0) on the w-rank owning m=0
            own0 = (jax.lax.axis_index("w") == 0).astype(dtype)
            du = du.at[:, 0, 0, 0].add(own0 * meanu)
            dv = dv.at[:, 0, 0, 0].add(own0 * meanv)
            if flags.vorgp:
                groups.append(dvor)
            if flags.divgp:
                groups.append(ddiv)
            uvd = jnp.concatenate([du, dv], axis=0)
            groups.append(uvd)
        scd = None
        if nsc:
            scd = p2d(spsc.astype(dtype))
            groups.append(scd)
            if flags.scders:
                groups.append(t["ky_w"] * _imer(scd))
        if nuv and flags.uvders:
            groups.append(t["kx_w"] * _izon(uvd))
        if nsc and flags.scders:
            groups.append(t["kx_w"] * _izon(scd))
        dense = jnp.concatenate(groups, axis=0)   # (F, 4, ML, N)

        # meridional synthesis on local m-block
        gre = synthesis_uniform(dense[:, 0], dense[:, 1], self.uty)
        gim = synthesis_uniform(dense[:, 2], dense[:, 3], self.uty)
        z = jnp.stack([gre, gim], axis=1)          # (F, 2, ML, ny)
        npad = self.ny_pad - self.res.grid.ny
        if npad:
            z = jnp.pad(z, [(0, 0), (0, 0), (0, 0), (0, npad)])
        # TRMTOL: m-distributed -> row-distributed
        z = jax.lax.all_to_all(z, "w", split_axis=3, concat_axis=2, tiled=True)
        # zonal synthesis on local rows: (F, rows, M) -> (F, rows, nx)
        grid = synthesis_uniform(
            z[:, 0].swapaxes(1, 2)[:, :, : self.res.M],
            z[:, 1].swapaxes(1, 2)[:, :, : self.res.M],
            self.utx,
        )
        # TRLTOG: gather fields over v, split rows further; the concat is
        # owner-major — restore the group-major global field order
        grid = jax.lax.all_to_all(grid, "v", split_axis=1, concat_axis=0,
                                  tiled=True)
        gsz = []
        if nuv:
            if flags.vorgp:
                gsz.append(nuv)
            if flags.divgp:
                gsz.append(nuv)
            gsz += [nuv, nuv]
        if nsc:
            gsz.append(nsc)
        if nsc and flags.scders:
            gsz.append(nsc)
        if nuv and flags.uvders:
            gsz += [nuv, nuv]
        if nsc and flags.scders:
            gsz.append(nsc)
        _, inv_perm = _group_perms([g * self.v for g in gsz], self.v)
        return grid[inv_perm]

    # ------------------------------------------------------------------
    def _dir_kernel(self, grid, t, nuv_g, nsc_g):
        res = self.res
        dtype = t["kx_w"].dtype
        # group-major -> owner-major field order for the v scatter
        gsz = ([nuv_g, nuv_g] if nuv_g else []) + ([nsc_g] if nsc_g else [])
        om, _ = _group_perms(gsz, self.v)
        grid = grid[om]
        # TRGTOL: fields -> v-distributed, rows gathered
        x = jax.lax.all_to_all(grid, "v", split_axis=0, concat_axis=1,
                               tiled=True)        # (F/v, rows_w, nx)
        zre, zim = analysis_uniform(x, self.utx)  # (F/v, rows, M)
        Mp = self.M_pad
        zre = jnp.pad(zre, [(0, 0), (0, 0), (0, Mp - res.M)]).swapaxes(1, 2)
        zim = jnp.pad(zim, [(0, 0), (0, 0), (0, Mp - res.M)]).swapaxes(1, 2)
        z = jnp.stack([zre, zim], axis=1)          # (F, 2, M_pad, rows)
        # TRLTOM: row-distributed -> m-distributed
        z = jax.lax.all_to_all(z, "w", split_axis=2, concat_axis=3, tiled=True)
        z = z[..., : res.grid.ny]                  # (F, 2, ML, ny)
        rr, ri = analysis_uniform(z[:, 0], self.uty)
        ir, ii = analysis_uniform(z[:, 1], self.uty)
        dense = jnp.stack([rr, ri, ir, ii], axis=1) * t["valid_w"]

        nuv = nuv_g // self.v
        nsc = nsc_g // self.v

        def d2p(d):
            # masked local gather + psum over "w" (the spectral gather)
            ML = Mp // self.w
            widx = jax.lax.axis_index("w")
            mloc = t["packed_m"] - widx * ML
            owned = (mloc >= 0) & (mloc < ML)
            ml = jnp.clip(mloc, 0, ML - 1)
            vals = d[:, t["packed_c"], ml, t["packed_n"]]
            vals = jnp.where(owned[None, :], vals, 0)
            return jax.lax.psum(vals, "w")

        spvor = spdiv = spsc = meanu = meanv = None
        zerof = jnp.zeros((0, res.nspec2), dtype)
        if nuv:
            du = dense[:nuv]
            dv = dense[nuv : 2 * nuv]
            kx, ky = t["kx_w"], t["ky_w"]
            dvor = (kx * _izon(dv) - ky * _imer(du)) * t["valid_w"]
            ddiv = (kx * _izon(du) + ky * _imer(dv)) * t["valid_w"]
            spvor = d2p(dvor)
            spdiv = d2p(ddiv)
            own0 = (jax.lax.axis_index("w") == 0).astype(dtype)
            meanu = jax.lax.psum(own0 * du[:, 0, 0, 0], "w")
            meanv = jax.lax.psum(own0 * dv[:, 0, 0, 0], "w")
        else:
            spvor = spdiv = zerof
            meanu = meanv = jnp.zeros((0,), dtype)
        spsc = d2p(dense[2 * nuv :]) if nsc else zerof
        return spvor, spdiv, spsc, meanu, meanv

    # ------------------------------------------------------------------
    def _pad_fields(self, x, like=None):
        if x is None:
            return None, 0
        x = jnp.asarray(x, self.dtype)
        n = x.shape[0]
        npad = (-n) % self.v
        if npad:
            x = jnp.concatenate([x, jnp.zeros((npad,) + x.shape[1:], x.dtype)], 0)
        return x, n

    def inv_trans(self, spvor=None, spdiv=None, spscalar=None,
                  meanu=None, meanv=None, flags: LamInvFlags = LamInvFlags()):
        spvor, nuv = self._pad_fields(spvor)
        spdiv, _ = self._pad_fields(spdiv)
        spsc, nsc = self._pad_fields(spscalar)
        Fuv = spvor.shape[0] if spvor is not None else 0
        Fsc = spsc.shape[0] if spsc is not None else 0
        if Fuv:
            meanu = (jnp.zeros((Fuv,), self.dtype) if meanu is None
                     else jnp.pad(jnp.asarray(meanu, self.dtype), (0, Fuv - nuv)))
            meanv = (jnp.zeros((Fuv,), self.dtype) if meanv is None
                     else jnp.pad(jnp.asarray(meanv, self.dtype), (0, Fuv - nuv)))
        key = (Fuv, Fsc, flags)
        if key not in self._inv_jit:
            self._inv_jit[key] = self._build_inv(flags)
        zero = jnp.zeros((0, self.res.nspec2), self.dtype)
        zf = jnp.zeros((0,), self.dtype)
        grid = self._inv_jit[key](
            spvor if spvor is not None else zero,
            spdiv if spdiv is not None else zero,
            spsc if spsc is not None else zero,
            meanu if meanu is not None else zf,
            meanv if meanv is not None else zf,
            self.tables,
        )
        return self._strip(grid, nuv, nsc, Fuv, Fsc, flags)

    def _build_inv(self, flags):
        # tables as jit arguments, never closures: closed-over device
        # arrays embed into the HLO as constants
        # (parallel/sharded.py::_build_inv)
        def fn(spvor, spdiv, spsc, meanu, meanv, tables):
            kernel = functools.partial(self._inv_kernel, flags=flags)
            sm = jax.shard_map(
                lambda a, b, c, mu, mv, t: kernel(a, b, c, mu, mv, t),
                mesh=self.mesh,
                in_specs=(P("v", None), P("v", None), P("v", None),
                          P("v"), P("v"), self.table_specs),
                out_specs=P(None, ("w", "v"), None),
            )
            out = sm(spvor, spdiv, spsc, meanu, meanv, tables)
            if self.ny_pad != self.res.grid.ny:
                out = out[:, : self.res.grid.ny]
            return out

        return jax.jit(fn)

    def _strip(self, grid, nuv, nsc, Fuv, Fsc, flags):
        if Fuv == nuv and Fsc == nsc:
            return grid
        sel = []
        off = 0

        def take(gpad, greal):
            nonlocal off
            sel.extend(range(off, off + greal))
            off += gpad

        if nuv and flags.vorgp:
            take(Fuv, nuv)
        if nuv and flags.divgp:
            take(Fuv, nuv)
        if nuv:
            take(Fuv, nuv)
            take(Fuv, nuv)
        if nsc:
            take(Fsc, nsc)
        if nsc and flags.scders:
            take(Fsc, nsc)
        if nuv and flags.uvders:
            take(Fuv, nuv)
            take(Fuv, nuv)
        if nsc and flags.scders:
            take(Fsc, nsc)
        return grid[np.asarray(sel)]

    # ------------------------------------------------------------------
    def dir_trans(self, u=None, v=None, scalars=None):
        u, nuv = self._pad_fields(u)
        v, _ = self._pad_fields(v)
        sc, nsc = self._pad_fields(scalars)
        Fuv = u.shape[0] if u is not None else 0
        Fsc = sc.shape[0] if sc is not None else 0
        key = (Fuv, Fsc)
        if key not in self._dir_jit:
            self._dir_jit[key] = self._build_dir(Fuv, Fsc)
        parts = []
        if Fuv:
            parts += [u, v]
        if Fsc:
            parts.append(sc)
        grid = jnp.concatenate(parts, axis=0)
        spvor, spdiv, spsc, mu, mv = self._dir_jit[key](grid, self.tables)
        out = (
            spvor[:nuv] if nuv else None,
            spdiv[:nuv] if nuv else None,
            spsc[:nsc] if nsc else None,
            mu[:nuv] if nuv else None,
            mv[:nuv] if nuv else None,
        )
        return out

    def _build_dir(self, Fuv, Fsc):
        def fn(grid, tables):  # tables as argument — see _build_inv
            npad = self.ny_pad - self.res.grid.ny
            if npad:
                grid = jnp.pad(grid, [(0, 0), (0, npad), (0, 0)])
            kernel = functools.partial(self._dir_kernel, nuv_g=Fuv, nsc_g=Fsc)
            sm = jax.shard_map(
                lambda g, t: kernel(g, t),
                mesh=self.mesh,
                in_specs=(P(None, ("w", "v"), None), self.table_specs),
                out_specs=(P("v", None), P("v", None), P("v", None),
                           P("v"), P("v")),
            )
            return sm(grid, tables)

        return jax.jit(fn)
