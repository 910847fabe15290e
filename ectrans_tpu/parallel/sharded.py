"""Distributed spectral transforms over a (w, v) device mesh.

A JAX redesign of the reference's MPI transposition layer: the four
communication phases become two ``lax.all_to_all`` pairs inside one
``shard_map`` — XLA hands them to the collective library (NCCL on GPUs)
and can overlap them with compute:

  reference                          here
  ---------------------------------- -----------------------------------------
  TRMTOL  (m-distributed -> lat)     all_to_all over "w": split lat, concat m
  TRLTOM  (lat -> m-distributed)     all_to_all over "w": split m, concat lat
  TRLTOG  (lat -> grid columns)      all_to_all over "v": split lat, concat fld
  TRGTOL  (grid columns -> lat)      all_to_all over "v": split fld, concat lat
  UPDSP + spectral gather            masked local scatter + psum over "w"

(reference: ``trmtol_mod.F90:101-127``, ``trltog_mod.F90``, and the GPU
pack/unpack kernels ``trmtol_pack_unpack.F90`` — the packing here is plain
static gathers/reshapes that XLA fuses.)

Data placement per phase (per device of the w x v mesh):

* spectral: packed arrays (nfld/v, nspec2), fields sharded over "v",
  replicated over "w" (each w-rank reads only its own m rows).
* wave space: (nfld/v, 2, M_pad/w, ndgl) — m-blocks over "w" (balanced,
  contiguous in the permuted m axis from ``distribution.pingpong_blocks``).
* Fourier space: (nfld/v, 2, M, ndgl_pad/w) — latitudes over "w", in the
  LENGTH-SORTED order of ``distribution.lat_perm`` (each shard owns an
  equal mix of short/long rows, so the per-bucket chirp-z lengths of the
  bucketed Fourier layer stay static and shard-independent — the SUMPLAT
  load-balance idea).
* grid space: (nfld, ndgl_pad/(w*v), ndlon) — all fields, latitudes over
  both axes in the same sorted order inside the pipeline; the public
  inv/dir surfaces convert to/from pole-to-pole order at the jit boundary.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..resolution import Resolution
from ..transform import InvFlags, _check_spec, _check_grid_arg
from ..ops import spectral
from ..ops.legendre_matmul import legendre_einsum
from ..ops.fourier import BluesteinTables, synthesis, analysis
from .distribution import build_distribution, host_tables

_INT_KEYS = ("idx_sym_w", "idx_asym_w", "dense_gather_w", "pos_of_m", "perm",
             "packed_c", "packed_n", "pm_perm_pos", "lat_perm", "lat_pos")


class ShardedTransform:
    """Distributed inverse/direct spectral transforms on a (w, v) mesh.

    The single-device ``transform.inv_trans``/``dir_trans`` and this class
    produce identical results (decomposition invariance) — see
    tests/test_sharded.py.
    """

    def __init__(self, res: Resolution, mesh: Mesh, dtype=jnp.float32,
                 precision: str = "highest"):
        if tuple(mesh.axis_names) != ("w", "v"):
            raise ValueError(f'mesh must have axes ("w", "v"), got {mesh.axis_names}')
        self.res = res
        self.mesh = mesh
        self.dtype = jnp.dtype(dtype)
        #: Legendre-contraction tier (see transform._table_dtype): "bf16"
        #: stores the shard-local grouped P tables in bfloat16 (half the
        #: table memory per device) and contracts in one bf16 pass.
        self.precision = precision
        self.w = mesh.shape["w"]
        self.v = mesh.shape["v"]
        import os

        nb = int(os.environ.get("ECTRANS_TPU_FFT_BUCKETS", "12"))
        self.dist = build_distribution(res, self.w, self.v, nbuckets=nb)
        self._place_tables()
        self._inv_jit = {}
        self._dir_jit = {}

    # ------------------------------------------------------------------
    def _place_tables(self):
        host = host_tables(self.dist, str(self.dtype))
        dev, specs = {}, {}
        for k, val in host.items():
            if not isinstance(val, np.ndarray):
                continue  # scalars (nfft etc.) stay python ints
            if k in _INT_KEYS:
                arr = val.astype(np.int32)
            elif val.dtype.kind == "f":
                arr = val.astype(self.dtype)
            else:
                arr = val.astype(np.int32)
            if k.endswith("_w"):
                spec = P("w") if arr.ndim == 1 else P(*(["w"] + [None] * (arr.ndim - 1)))
            else:
                spec = P()
            sh = NamedSharding(self.mesh, spec)
            jarr = jnp.asarray(arr)
            if (self.precision == "bf16" and k.startswith("lg")
                    and (k.endswith("_psym_w") or k.endswith("_pasym_w"))):
                jarr = jarr.astype(jnp.bfloat16)
            dev[k] = jax.device_put(jarr, sh)
            specs[k] = spec
        self.tables = dev
        self.table_specs = specs

    # ------------------------------------------------------------------
    def _bucket_bt(self, t, k: int) -> BluesteinTables:
        """Assemble Fourier bucket k's BluesteinTables view from the
        shard-local latitude rows (every shard holds the same local-slot
        length mix — see distribution.build_distribution)."""
        bm = self.dist.lat_buckets[k]
        f = lambda name: t[f"fb{k}_{name}_w"]
        return BluesteinTables(
            nfft=bm.nfft, mmax=bm.mb, ndlon=bm.ndlon,
            syn_in_r=f("syn_in_r"), syn_in_i=f("syn_in_i"),
            syn_bh_r=f("syn_bh_r"), syn_bh_i=f("syn_bh_i"),
            syn_out_r=f("syn_out_r"), syn_out_i=f("syn_out_i"),
            ana_in_r=f("ana_in_r"), ana_in_i=f("ana_in_i"),
            ana_bh_r=f("ana_bh_r"), ana_bh_i=f("ana_bh_i"),
            ana_out_r=f("ana_out_r"), ana_out_i=f("ana_out_i"),
        )

    def _synthesis_bucketed_local(self, four2, t):
        """Per-bucket chirp-z synthesis on the shard's local (length-
        sorted) latitude slots -> (F2, LL, ndlon)."""
        ndlon = self.res.grid.ndlon
        outs = []
        for k, bm in enumerate(self.dist.lat_buckets):
            fb = four2[:, :, : bm.mb + 1, bm.lb0 : bm.lb1]
            g = synthesis(fb, self._bucket_bt(t, k))
            outs.append(jnp.pad(
                g, [(0, 0), (0, 0), (0, ndlon - g.shape[-1])]))
        return jnp.concatenate(outs, axis=1)

    def _analysis_bucketed_local(self, x, t):
        """Per-bucket chirp-z analysis of local latitude rows
        (F, LL, ndlon) -> (F, 2, M, LL)."""
        M = self.res.M
        outs = []
        for k, bm in enumerate(self.dist.lat_buckets):
            gb = x[:, bm.lb0 : bm.lb1, : bm.ndlon]
            fb = analysis(gb, self._bucket_bt(t, k), min(M, bm.mb + 1))
            if fb.shape[2] < M:
                fb = jnp.pad(fb, [(0, 0), (0, 0), (0, M - fb.shape[2]),
                                  (0, 0)])
            outs.append(fb)
        return jnp.concatenate(outs, axis=-1)

    @staticmethod
    def _kvset_slots(kvset, v: int):
        """KVSETUV/KVSETSC equivalent (``inv_trans.F90:43-55``): per-field
        v-shard assignment -> shard-major padded slot layout.

        Returns (slots, maxc): slots[j] = original field index at padded
        slot j (shard s owns slots [s*maxc, (s+1)*maxc); -1 = padding).
        In this single-controller design the caller passes global arrays
        and the vector controls which "v" shard computes each field (load
        balance / ownership), the role KVSET plays in the reference.
        """
        kvset = [int(x) for x in kvset]
        if any(x < 0 or x >= v for x in kvset):
            raise ValueError(f"kvset entries must be in [0, {v})")
        counts = [kvset.count(s) for s in range(v)]
        maxc = max(counts) if counts else 0
        slots = []
        for s in range(v):
            idx = [i for i, x in enumerate(kvset) if x == s]
            slots.extend(idx + [-1] * (maxc - len(idx)))
        return np.asarray(slots, dtype=np.int64), maxc

    @staticmethod
    def _kvset_place(x, slots):
        """(nfld, ...) -> (len(slots), ...) padded shard-major placement."""
        xz = jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)], 0)
        return xz[jnp.asarray(np.where(slots < 0, x.shape[0], slots))]

    @staticmethod
    def _group_perms(group_sizes: list[int], v: int):
        """Owner-major <-> group-major field permutations for TRLTOG/TRGTOL."""
        om = []
        offs = np.cumsum([0] + group_sizes)
        for d in range(v):
            for i, g in enumerate(group_sizes):
                lo = offs[i] + d * (g // v)
                om.extend(range(lo, lo + g // v))
        om = np.asarray(om)
        return om, np.argsort(om)

    # ------------------------------------------------------------------
    def _packed_to_dense_local(self, spec_packed, t):
        nfld = spec_packed.shape[0]
        padded = jnp.concatenate(
            [spec_packed, jnp.zeros((nfld, 1), spec_packed.dtype)], axis=-1
        )
        dg = t["dense_gather_w"].transpose(1, 0, 2)  # (2, ML, NP)
        return padded[:, dg]

    def _dense_to_packed_psum(self, dense, t):
        """Local compaction + psum over "w" (UPDSP + spectral gather)."""
        ML = self.dist.ML
        widx = jax.lax.axis_index("w")
        local_pos = t["pm_perm_pos"] - widx * ML
        owned = (local_pos >= 0) & (local_pos < ML)
        lp = jnp.clip(local_pos, 0, ML - 1)
        vals = dense[:, t["packed_c"], lp, t["packed_n"]]
        vals = jnp.where(owned[None, :], vals, 0)
        return jax.lax.psum(vals, "w")

    def _ct(self, t, prefix, keys):
        """Spectral-operator coefficient tables {prefix}_{key}."""
        return {k: t[f"{prefix}_{k}_w"] for k in keys}

    # ------------------------------------------------------------------
    def _lt_inv(self, dense, t):
        """Grouped inverse Legendre on the shard-local permuted m-block:
        per-group gather to parity + batched matmul (memory-tight tables)."""
        prec = self.precision
        pad = jnp.concatenate(
            [dense, jnp.zeros(dense.shape[:3] + (1,), dense.dtype)], axis=-1
        )
        parts = []
        for gi, g in enumerate(self.dist.groups):
            idx_s = t["idx_sym_w"][g.off : g.off + g.Lg, : g.kg]
            idx_a = t["idx_asym_w"][g.off : g.off + g.Lg, : g.kg]
            mar = jnp.arange(g.Lg)[:, None]
            dblk = pad[:, :, g.off : g.off + g.Lg, :]
            sym = dblk[:, :, mar, idx_s]
            asym = dblk[:, :, mar, idx_a]
            fs = legendre_einsum("mik,fcmk->fcmi", t[f"lg{gi}_psym_w"], sym,
                                 prec).astype(dense.dtype)
            fa = legendre_einsum("mik,fcmk->fcmi", t[f"lg{gi}_pasym_w"],
                                 asym, prec).astype(dense.dtype)
            north = fs + fa
            south = (fs - fa)[..., ::-1]
            zp = [(0, 0)] * 3
            parts.append(jnp.concatenate(
                [jnp.pad(north, zp + [(g.i0, 0)]),
                 jnp.pad(south, zp + [(0, g.i0)])], axis=-1))
        return jnp.concatenate(parts, axis=2)

    def _lt_dir(self, four, t):
        """Grouped direct Legendre (quadrature-weighted transpose) on the
        shard-local m-block; scatters parity back to the dense layout."""
        prec = self.precision
        res = self.res
        ndgnh = res.grid.ndgnh
        NP = res.NP
        north_all = four[..., :ndgnh]
        south_all = four[..., : ndgnh - 1 : -1]
        fsym_all = (north_all + south_all) * t["wq"]
        fasym_all = (north_all - south_all) * t["wq"]
        # materialise before the matmuls (a miscompile guard kept from the
        # previous accelerator — see ops/legendre_matmul.py)
        fsym_all, fasym_all = jax.lax.optimization_barrier(
            (fsym_all, fasym_all))
        F, C = four.shape[0], four.shape[1]
        parts = []
        for gi, g in enumerate(self.dist.groups):
            fsym = fsym_all[:, :, g.off : g.off + g.Lg, g.i0 :]
            fasym = fasym_all[:, :, g.off : g.off + g.Lg, g.i0 :]
            sym = legendre_einsum("mik,fcmi->fcmk", t[f"lg{gi}_psym_w"],
                                  fsym, prec).astype(four.dtype)
            asym = legendre_einsum("mik,fcmi->fcmk", t[f"lg{gi}_pasym_w"],
                                   fasym, prec).astype(four.dtype)
            idx_s = t["idx_sym_w"][g.off : g.off + g.Lg, : g.kg]
            idx_a = t["idx_asym_w"][g.off : g.off + g.Lg, : g.kg]
            mar = jnp.arange(g.Lg)[:, None]
            dg = jnp.zeros((F, C, g.Lg, NP + 1), four.dtype)
            dg = dg.at[:, :, mar, idx_s].add(sym)
            dg = dg.at[:, :, mar, idx_a].add(asym)
            parts.append(dg[..., :NP])
        return jnp.concatenate(parts, axis=2)

    def _inv_kernel(self, spvor, spdiv, spsc, t, flags: InvFlags,
                    fspgl_proc=None):
        res, dist = self.res, self.dist
        Fuv = spvor.shape[0]
        Fsc = spsc.shape[0]

        # ONE grouped Legendre call for every field family: each lt() call
        # streams the shard's P tables from device memory, so batching vor/div/u/v/
        # scalars/N-S-derivs into a single contraction pays table traffic
        # once (the GPU backend's all-field grouped GEMM,
        # gpu/internal/leinv_mod.F90:273-317).
        lt_in = []  # pre-TRMTOL groups: vor? div? u v sc nsd
        if Fuv:
            dvor = self._packed_to_dense_local(spvor, t)
            ddiv = self._packed_to_dense_local(spdiv, t)
            du, dv = spectral.vordiv_to_uv(
                dvor, ddiv, self._ct(t, "vd", ("a", "b", "c", "valid"))
            )
            if flags.vorgp:
                lt_in.append(dvor)
            if flags.divgp:
                lt_in.append(ddiv)
            lt_in += [du, dv]
        if Fsc:
            dsc = self._packed_to_dense_local(spsc, t)
            lt_in.append(dsc)
            if flags.scders:
                dnsd = spectral.ns_derivative(dsc, self._ct(t, "ns", ("a", "b", "valid")))
                lt_in.append(dnsd)

        dense_all = (jnp.concatenate(lt_in, axis=0)
                     if len(lt_in) > 1 else lt_in[0])
        four = self._lt_inv(dense_all, t)  # (F1, 2, ML, ndgl)
        # permute latitudes to the length-sorted distributed order (pad
        # slots read the appended zero column).  Both boundary permutations
        # run as LEADING-axis whole-row gathers, a layout chosen for the
        # previous accelerator, whose gather lowering was slow along minor
        # axes.  The optimization_barriers stop XLA folding the transposes
        # back into minor-axis gather dimension numbers.
        fourz = jnp.concatenate(
            [four, jnp.zeros(four.shape[:3] + (1,), four.dtype)], axis=-1)
        fT = jax.lax.optimization_barrier(jnp.moveaxis(fourz, 3, 0))
        fT = fT[jnp.minimum(t["lat_perm"], res.ndgl)]  # (ndgl_pad, F1, 2, ML)
        # --- TRMTOL: m-distributed -> latitude-distributed ---
        fT = jax.lax.all_to_all(fT, "w", split_axis=0, concat_axis=3, tiled=True)
        # un-permute the m axis to natural order (drop padding rows);
        # fT is (LLW, F1, 2, M_pad) after the tiled all_to_all
        fM = jax.lax.optimization_barrier(jnp.moveaxis(fT, 3, 0))
        four = fM[t["pos_of_m"]].transpose(2, 3, 0, 1)  # (F1, 2, M, LL)

        # --- FSC on local latitudes ---
        racthe = t["racthe_lat_w"][None, None, None, :]
        # m axis is back in natural order here
        mval = jnp.arange(res.M, dtype=four.dtype)[None, :, None]

        def ew(x):
            re, im = x[:, 0], x[:, 1]
            return jnp.stack([-im * mval, re * mval], axis=1) * racthe

        i = 0
        out = []
        if Fuv and flags.vorgp:
            out.append(four[i : i + Fuv]); i += Fuv
        if Fuv and flags.divgp:
            out.append(four[i : i + Fuv]); i += Fuv
        uvf = None
        if Fuv:
            uvf = four[i : i + 2 * Fuv] * racthe; i += 2 * Fuv
            out.append(uvf)
        scf = None
        if Fsc:
            scf = four[i : i + Fsc]; i += Fsc
            out.append(scf)
            if flags.scders:
                out.append(four[i : i + Fsc] * racthe); i += Fsc
        if Fuv and flags.uvders:
            out.append(ew(uvf))
        if Fsc and flags.scders:
            out.append(ew(scf))
        four2 = jnp.concatenate(out, axis=0)
        if fspgl_proc is not None:
            # FSPGL hook on the distributed path (fspgl_int_mod.F90): the
            # callback sees this shard's latitude rows with the full m
            # range — per-latitude semantics as in the reference.  NB the
            # rows arrive in the distribution's length-sorted order
            # (dist.lat_perm), not pole-to-pole.
            four2 = fspgl_proc(four2)

        # --- Fourier synthesis on local latitudes (per-bucket chirp-z) ---
        grid = self._synthesis_bucketed_local(four2, t)  # (F2, LL, ndlon)

        # --- TRLTOG: latitude-distributed -> grid columns (gather fields) ---
        grid = jax.lax.all_to_all(grid, "v", split_axis=1, concat_axis=0, tiled=True)
        # owner-major -> group-major global field order
        # NB: u and v are separate groups (each device's local block is
        # [u-shard, v-shard], not a contiguous slice of a combined group)
        from ..field_layout import FieldLayout

        gsz = FieldLayout.inv(Fuv, Fsc, flags).sizes_padded
        _, inv_perm = self._group_perms([g * self.v for g in gsz], self.v)
        return grid[inv_perm]

    # ------------------------------------------------------------------
    def _dir_ana_kernel(self, grid, t, Fuv_g: int, Fsc_g: int):
        """grid: (Fin_global, LL/v, ndlon) local block, group-major fields
        -> Fourier coefficients (F, 2, ML, ndgl) on this shard's m-block.

        Runs as its OWN program, a workaround for a fusion miscompile of
        the previous accelerator's compiler (the same class as the
        single-device split, transform._dir_ana_impl).
        """
        res = self.res
        gsz = ([Fuv_g, Fuv_g] if Fuv_g else []) + ([Fsc_g] if Fsc_g else [])
        om, _ = self._group_perms(gsz, self.v)
        g_om = grid[om]
        # --- TRGTOL: grid columns -> latitude-distributed (scatter fields) ---
        x = jax.lax.all_to_all(g_om, "v", split_axis=0, concat_axis=1, tiled=True)
        # (Fin/v, LL, ndlon), rows in length-sorted order.
        # u/v and scalars are analysed in separate bucketed calls (the
        # same workaround class as the single-device _dir_ana_impl split)
        Fuv = Fuv_g // self.v
        parts = []
        if Fuv:
            racthe = t["racthe_lat_w"][None, None, None, :]
            parts.append(
                self._analysis_bucketed_local(x[: 2 * Fuv], t) * racthe)
        if Fsc_g:
            parts.append(self._analysis_bucketed_local(x[2 * Fuv :], t))
        four = (jnp.concatenate(parts, axis=0) if len(parts) > 1
                else parts[0])
        # permute m to the distributed layout (pad rows read a zero row);
        # both boundary permutations as leading-axis whole-row gathers
        # (see the matching inverse-path comment)
        fM = jnp.moveaxis(four, 2, 0)                  # (M, F, 2, LL)
        fM = jnp.concatenate(
            [fM, jnp.zeros((1,) + fM.shape[1:], fM.dtype)], axis=0)
        fM = jax.lax.optimization_barrier(fM)
        fM = fM[jnp.minimum(t["perm"], res.M)]         # (M_pad, F, 2, LL)
        # --- TRLTOM: latitude-distributed -> m-distributed ---
        fT = jax.lax.all_to_all(fM, "w", split_axis=0, concat_axis=3, tiled=True)
        # back to natural latitude order for the quadrature/LT (drops
        # pads); fT is (ML, F, 2, ndgl_pad) after the tiled all_to_all
        fL = jax.lax.optimization_barrier(jnp.moveaxis(fT, 3, 0))
        return fL[t["lat_pos"]].transpose(2, 3, 1, 0)  # (F, 2, ML, ndgl)

    def _dir_pack_kernel(self, dense, t, Fuv_g: int, Fsc_g: int):
        """Dense LT output -> packed spectral arrays (UVTVD + compaction +
        psum).  Own program — see _dir_ana_kernel."""
        res = self.res
        Fuv = Fuv_g // self.v
        Fsc = Fsc_g // self.v
        zero = jnp.zeros((0, res.nspec2), dense.dtype)
        spvor = spdiv = spsc = zero
        if Fuv:
            dvor, ddiv = spectral.uv_to_vordiv(
                dense[:Fuv], dense[Fuv : 2 * Fuv],
                self._ct(t, "tv", ("p", "q", "r", "valid")),
            )
            spvor = self._dense_to_packed_psum(dvor, t)
            spdiv = self._dense_to_packed_psum(ddiv, t)
        if Fsc:
            spsc = self._dense_to_packed_psum(dense[2 * Fuv :], t)
        return spvor, spdiv, spsc

    # ------------------------------------------------------------------
    def _pad_fields(self, x):
        """Pad the leading (field) axis to a multiple of v."""
        if x is None:
            return None, 0
        n = x.shape[0]
        npad = (-n) % self.v
        if npad:
            x = jnp.concatenate([x, jnp.zeros((npad,) + x.shape[1:], x.dtype)], 0)
        return x.astype(self.dtype), n

    def _default_kvset(self, n):
        """Block assignment matching _pad_fields' P('v') split."""
        c = max(1, -(-n // self.v))
        return [min(i // c, self.v - 1) for i in range(n)]

    def _inv_kvset(self, spvor, spdiv, spsc, flags, kvsetuv, kvsetsc,
                   fspgl_proc=None):
        """inv_trans with caller-controlled field->v-shard ownership."""
        from ..field_layout import FieldLayout

        nuv = 0 if spvor is None else spvor.shape[0]
        nsc = 0 if spsc is None else spsc.shape[0]
        if kvsetuv is not None and len(kvsetuv) != nuv:
            raise ValueError(f"kvsetuv must have {nuv} entries")
        if kvsetsc is not None and len(kvsetsc) != nsc:
            raise ValueError(f"kvsetsc must have {nsc} entries")
        slots_uv = pos_uv = slots_sc = pos_sc = None
        pv = pd = psc = None
        if nuv:
            slots_uv, _ = self._kvset_slots(
                kvsetuv if kvsetuv is not None else self._default_kvset(nuv),
                self.v)
            pos_uv = {int(f): j for j, f in enumerate(slots_uv) if f >= 0}
            pv = self._kvset_place(jnp.asarray(spvor, self.dtype), slots_uv)
            pd = self._kvset_place(jnp.asarray(spdiv, self.dtype), slots_uv)
        if nsc:
            slots_sc, _ = self._kvset_slots(
                kvsetsc if kvsetsc is not None else self._default_kvset(nsc),
                self.v)
            pos_sc = {int(f): j for j, f in enumerate(slots_sc) if f >= 0}
            psc = self._kvset_place(jnp.asarray(spsc, self.dtype), slots_sc)
        key = (pv is not None, psc is not None,
               0 if pv is None else pv.shape[0],
               0 if psc is None else psc.shape[0], flags, fspgl_proc)
        if key not in self._inv_jit:
            self._inv_jit[key] = self._build_inv(flags, fspgl_proc)
        grid = self._inv_jit[key](pv, pd, psc, self.tables)
        # un-permute padded slot-major output to the original field order
        fl = FieldLayout.inv(nuv, nsc, flags)
        sel = fl.kvset_index(pos_uv, pos_sc,
                             0 if slots_uv is None else len(slots_uv),
                             0 if slots_sc is None else len(slots_sc))
        return grid[sel]

    # -- lat-lon output mode (LDLL) on the distributed path --------------
    def _latlon_tables_sharded(self, ll):
        """Device tables for lat-lon output: per-group Legendre tensors at
        the lat-lon latitudes (permuted/padded like the Gaussian ones) +
        1/(a cos) rows, sharded over "w"; plus the replicated uniform-DFT
        tables for the equal-length longitude rows."""
        from ..legendre import build_parity_tables
        from ..ops.fourier import uniform_dft_tables

        res, dist = self.res, self.dist
        nh = (ll.nlat + 1) // 2
        psym, pasym, _ = build_parity_tables(res.nsmax, ll.mu[:nh],
                                             ntmax_extra=1)
        ML = dist.ML
        dev, specs = {}, {}
        for gi, g in enumerate(dist.groups):
            ps = np.zeros((dist.w * g.Lg, nh, g.kg))
            pa = np.zeros((dist.w * g.Lg, nh, g.kg))
            for s in range(dist.w):
                for j in range(g.Lg):
                    m = dist.perm[s * ML + g.off + j]
                    if m < res.M:
                        ps[s * g.Lg + j] = psym[m, :, : g.kg]
                        pa[s * g.Lg + j] = pasym[m, :, : g.kg]
            for nm, val in ((f"ll{gi}_psym_w", ps), (f"ll{gi}_pasym_w", pa)):
                sh = NamedSharding(self.mesh, P("w", None, None))
                dev[nm] = jax.device_put(
                    jnp.asarray(val.astype(self.dtype)), sh)
                specs[nm] = P("w", None, None)
        wv = self.w * self.v
        nlat_pad = -(-ll.nlat // wv) * wv
        racthe = 1.0 / np.maximum(
            np.sqrt(1.0 - ll.mu**2), 1e-12) / res.radius
        if getattr(ll, "include_poles", False):
            racthe[0] = 0.0
            racthe[-1] = 0.0
        rl = np.pad(racthe, (0, nlat_pad - ll.nlat))
        dev["ll_racthe_lat_w"] = jax.device_put(
            jnp.asarray(rl.astype(self.dtype)),
            NamedSharding(self.mesh, P("w")))
        specs["ll_racthe_lat_w"] = P("w")
        ut = uniform_dft_tables(ll.nlon, res.nsmax, str(self.dtype))
        return dev, specs, ut, nlat_pad

    def _lt_inv_ll(self, dense, t, llt, nh: int, odd: bool, nlat_pad: int):
        """Grouped inverse Legendre at the lat-lon latitudes (local m-block);
        emits (F, 2, ML, nlat_pad)."""
        pad = jnp.concatenate(
            [dense, jnp.zeros(dense.shape[:3] + (1,), dense.dtype)], axis=-1)
        parts = []
        for gi, g in enumerate(self.dist.groups):
            idx_s = t["idx_sym_w"][g.off : g.off + g.Lg, : g.kg]
            idx_a = t["idx_asym_w"][g.off : g.off + g.Lg, : g.kg]
            mar = jnp.arange(g.Lg)[:, None]
            dblk = pad[:, :, g.off : g.off + g.Lg, :]
            sym = dblk[:, :, mar, idx_s]
            asym = dblk[:, :, mar, idx_a]
            fs = legendre_einsum("mik,fcmk->fcmi", llt[f"ll{gi}_psym_w"],
                                 sym).astype(dense.dtype)
            fa = legendre_einsum("mik,fcmk->fcmi", llt[f"ll{gi}_pasym_w"],
                                 asym).astype(dense.dtype)
            north = fs + fa
            south = (fs - fa)[..., ::-1]
            parts.append(jnp.concatenate([north, south], axis=-1))
        out = jnp.concatenate(parts, axis=2)      # (F, 2, ML, 2*nh)
        if odd:   # drop the duplicated equator row from the southern half
            out = jnp.concatenate([out[..., :nh], out[..., nh + 1 :]], -1)
        npad = nlat_pad - out.shape[-1]
        if npad:
            out = jnp.pad(out, [(0, 0)] * 3 + [(0, npad)])
        return out

    def _inv_ll_kernel(self, spvor, spdiv, spsc, t, llt, ut, flags: InvFlags,
                       nh, odd, nlat_pad):
        from ..ops.fourier import synthesis_uniform

        res = self.res
        Fuv = spvor.shape[0]
        Fsc = spsc.shape[0]

        def lt(dense):
            return self._lt_inv_ll(dense, t, llt, nh, odd, nlat_pad)

        groups1 = []
        if Fuv:
            dvor = self._packed_to_dense_local(spvor, t)
            ddiv = self._packed_to_dense_local(spdiv, t)
            du, dv = spectral.vordiv_to_uv(
                dvor, ddiv, self._ct(t, "vd", ("a", "b", "c", "valid")))
            if flags.vorgp:
                groups1.append(lt(dvor))
            if flags.divgp:
                groups1.append(lt(ddiv))
            groups1.append(lt(jnp.concatenate([du, dv], axis=0)))
        if Fsc:
            dsc = self._packed_to_dense_local(spsc, t)
            groups1.append(lt(dsc))
            if flags.scders:
                dnsd = spectral.ns_derivative(
                    dsc, self._ct(t, "ns", ("a", "b", "valid")))
                groups1.append(lt(dnsd))
        four = jnp.concatenate(groups1, axis=0)   # (F1, 2, ML, nlat_pad)
        # TRMTOL
        four = jax.lax.all_to_all(four, "w", split_axis=3, concat_axis=2,
                                  tiled=True)
        four = four[:, :, t["pos_of_m"], :]       # (F1, 2, M, LL_ll)

        racthe = llt["ll_racthe_lat_w"][None, None, None, :]
        mval = jnp.arange(res.M, dtype=four.dtype)[None, :, None]

        def ew(x):
            re, im = x[:, 0], x[:, 1]
            return jnp.stack([-im * mval, re * mval], axis=1) * racthe

        i = 0
        out = []
        if Fuv and flags.vorgp:
            out.append(four[i : i + Fuv]); i += Fuv
        if Fuv and flags.divgp:
            out.append(four[i : i + Fuv]); i += Fuv
        uvf = None
        if Fuv:
            uvf = four[i : i + 2 * Fuv] * racthe; i += 2 * Fuv
            out.append(uvf)
        scf = None
        if Fsc:
            scf = four[i : i + Fsc]; i += Fsc
            out.append(scf)
            if flags.scders:
                out.append(four[i : i + Fsc] * racthe); i += Fsc
        if Fuv and flags.uvders:
            out.append(ew(uvf))
        if Fsc and flags.scders:
            out.append(ew(scf))
        four2 = jnp.concatenate(out, axis=0)
        # uniform-length synthesis on local rows
        re = four2[:, 0].swapaxes(1, 2)           # (F2, LL, M)
        im = four2[:, 1].swapaxes(1, 2)
        grid = synthesis_uniform(re, im, ut)      # (F2, LL, nlon)
        # TRLTOG
        grid = jax.lax.all_to_all(grid, "v", split_axis=1, concat_axis=0,
                                  tiled=True)
        from ..field_layout import FieldLayout

        gsz = FieldLayout.inv(Fuv, Fsc, flags).sizes_padded
        _, inv_perm = self._group_perms([g * self.v for g in gsz], self.v)
        return grid[inv_perm]

    def inv_trans_latlon(self, ll, spvor=None, spdiv=None, spscalar=None,
                         flags: InvFlags = InvFlags()):
        """Distributed inverse transform onto a regular lat-lon grid (the
        LDLL mode of the reference, here exact spectral evaluation at the
        lat-lon latitudes — see ``ectrans_tpu.latlon``).  Output:
        (nfld_out, nlat, nlon) sharded P(None, ("w","v"), None)."""
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        if spvor is None and spscalar is None:
            raise ValueError("nothing to transform")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, self.res)
        if not hasattr(self, "_ll_cache"):
            self._ll_cache = {}
        llkey = (ll.nlat, ll.nlon, getattr(ll, "include_poles", False))
        if llkey not in self._ll_cache:
            self._ll_cache[llkey] = self._latlon_tables_sharded(ll)
        llt, llspecs, ut, nlat_pad = self._ll_cache[llkey]
        spvor, nuv = self._pad_fields(spvor)
        spdiv, _ = self._pad_fields(spdiv)
        spsc, nsc = self._pad_fields(spscalar)
        key = ("ll", llkey, 0 if spvor is None else spvor.shape[0],
               0 if spsc is None else spsc.shape[0], flags)
        if key not in self._inv_jit:
            nh = (ll.nlat + 1) // 2
            odd = ll.nlat % 2 == 1
            specs_t = {k: self.table_specs[k] for k in self.tables}

            # tables as jit arguments, never closures — see _build_inv
            def fn(spvor, spdiv, spsc, tables, llt_):
                kernel = functools.partial(
                    self._inv_ll_kernel, ut=ut, flags=flags, nh=nh, odd=odd,
                    nlat_pad=nlat_pad)
                sm = jax.shard_map(
                    lambda a, b, c, t, lt_: kernel(a, b, c, t, lt_),
                    mesh=self.mesh,
                    in_specs=(P("v", None), P("v", None), P("v", None),
                              specs_t, llspecs),
                    out_specs=P(None, ("w", "v"), None),
                    check_vma=False,
                )
                zero = jnp.zeros((0, self.res.nspec2), self.dtype)
                out = sm(spvor if spvor is not None else zero,
                         spdiv if spdiv is not None else zero,
                         spsc if spsc is not None else zero,
                         tables, llt_)
                if nlat_pad != ll.nlat:
                    out = out[:, : ll.nlat]
                return out

            self._inv_jit[key] = jax.jit(fn)
        grid = self._inv_jit[key](spvor, spdiv, spsc, self.tables, llt)
        return self._strip_fields(grid, nuv, nsc, flags)

    def inv_trans(self, spvor=None, spdiv=None, spscalar=None,
                  flags: InvFlags = InvFlags(), npromatr: int | None = None,
                  kvsetuv=None, kvsetsc=None, fspgl_proc=None):
        """Distributed inverse transform.

        Inputs: global packed spectral arrays; output: global grid
        (nfld_out, ndgl, ndlon) laid out with sharding P(None, ("w","v"), None).
        Padded fields (from rounding nfld up to v) are stripped.
        """
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        if spvor is not None and spvor.shape != spdiv.shape:
            raise ValueError(
                f"spvor/spdiv shape mismatch: {spvor.shape} vs {spdiv.shape}")
        if spvor is None and spscalar is None:
            raise ValueError(
                "nothing to transform: pass spvor/spdiv and/or spscalar")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, self.res)
        nuv0 = 0 if spvor is None else spvor.shape[0]
        nsc0 = 0 if spscalar is None else spscalar.shape[0]
        if npromatr and 2 * nuv0 + nsc0 > npromatr:
            return self._inv_packets(spvor, spdiv, spscalar, flags, npromatr,
                                     kvsetuv, kvsetsc, fspgl_proc)
        if kvsetuv is not None or kvsetsc is not None:
            return self._inv_kvset(spvor, spdiv, spscalar, flags,
                                   kvsetuv, kvsetsc, fspgl_proc)
        spvor, nuv = self._pad_fields(spvor)
        spdiv, _ = self._pad_fields(spdiv)
        spsc, nsc = self._pad_fields(spscalar)
        key = (spvor is not None, spsc is not None,
               0 if spvor is None else spvor.shape[0],
               0 if spsc is None else spsc.shape[0], flags, fspgl_proc)
        if key not in self._inv_jit:
            self._inv_jit[key] = self._build_inv(flags, fspgl_proc)
        grid = self._inv_jit[key](spvor, spdiv, spsc, self.tables)
        return self._strip_fields(grid, nuv, nsc, flags)

    def _inv_packets(self, spvor, spdiv, spsc, flags, npromatr,
                     kvsetuv, kvsetsc, fspgl_proc):
        """NPROMATR packet loop on the sharded path; forwards fspgl_proc and
        slices any KVSET ownership vectors along with their fields."""
        from ..field_layout import FieldLayout
        from ..transform import _chunk_pad

        nuv0 = 0 if spvor is None else spvor.shape[0]
        nsc0 = 0 if spsc is None else spsc.shape[0]
        parts = {}
        if nuv0:
            size = max(1, npromatr // 2)
            for j, ((cv, real), (cd, _)) in enumerate(
                    zip(_chunk_pad(spvor, size), _chunk_pad(spdiv, size))):
                if kvsetuv is not None:
                    # unpadded chunk: the kvset vector must match field count
                    cv, cd = spvor[j * size : j * size + real], \
                        spdiv[j * size : j * size + real]
                    kv = list(kvsetuv[j * size : j * size + real])
                    out = self.inv_trans(cv, cd, None, flags, kvsetuv=kv,
                                         fspgl_proc=fspgl_proc)
                    fl = FieldLayout.inv(real, 0, flags)
                else:
                    out = self.inv_trans(cv, cd, None, flags,
                                         fspgl_proc=fspgl_proc)
                    fl = FieldLayout.inv(real, 0, flags, pad_uv=size)
                for k, blk in fl.split(out).items():
                    parts.setdefault(k, []).append(blk)
        if nsc0:
            size = max(1, npromatr)
            for j, (csc, real) in enumerate(_chunk_pad(spsc, size)):
                if kvsetsc is not None:
                    csc = spsc[j * size : j * size + real]
                    ks = list(kvsetsc[j * size : j * size + real])
                    out = self.inv_trans(None, None, csc, flags, kvsetsc=ks,
                                         fspgl_proc=fspgl_proc)
                    fl = FieldLayout.inv(0, real, flags)
                else:
                    out = self.inv_trans(None, None, csc, flags,
                                         fspgl_proc=fspgl_proc)
                    fl = FieldLayout.inv(0, real, flags, pad_sc=size)
                for k, blk in fl.split(out).items():
                    parts.setdefault(k, []).append(blk)
        order = FieldLayout.inv(nuv0, nsc0, flags).names
        return jnp.concatenate(
            [jnp.concatenate(parts[k], axis=0) for k in order], axis=0)

    def _build_inv(self, flags, fspgl_proc=None):
        specs_t = {k: self.table_specs[k] for k in self.tables}

        # tables are a jit ARGUMENT, never a closure capture: closed-over
        # device arrays embed into the HLO as constants (same rule as
        # transform.py's module docstring)
        def fn(spvor, spdiv, spsc, tables):
            kernel = functools.partial(self._inv_kernel, flags=flags,
                                       fspgl_proc=fspgl_proc)
            sm = jax.shard_map(
                lambda a, b, c, t: kernel(a, b, c, t),
                mesh=self.mesh,
                in_specs=(P("v", None), P("v", None), P("v", None), specs_t),
                out_specs=P(None, ("w", "v"), None),
                check_vma=False,
            )
            zero = jnp.zeros((0, self.res.nspec2), self.dtype)
            out = sm(spvor if spvor is not None else zero,
                     spdiv if spdiv is not None else zero,
                     spsc if spsc is not None else zero,
                     tables)
            # grid rows come back in the length-sorted distributed order;
            # restore pole-to-pole (also drops the pad rows)
            return out[:, jnp.asarray(self.dist.lat_pos)]

        return jax.jit(fn)

    def _strip_fields(self, grid, nuv, nsc, flags):
        """Remove v-padding fields, group by group."""
        from ..field_layout import FieldLayout

        v = self.v
        fl = FieldLayout.inv(nuv, nsc, flags,
                             pad_uv=nuv + (-nuv) % v, pad_sc=nsc + (-nsc) % v)
        sel = fl.strip_index()
        return grid if sel is None else grid[sel]

    # ------------------------------------------------------------------
    def dir_trans(self, u=None, v=None, scalars=None,
                  kvsetuv=None, kvsetsc=None, npromatr: int | None = None):
        """Distributed direct transform: grid -> packed spectral arrays.

        kvsetuv/kvsetsc: optional per-field v-shard ownership vectors
        (reference KVSETUV/KVSETSC) controlling which shard computes each
        field; outputs come back in the caller's field order.
        ``npromatr`` splits huge field sets into memory-bounded packets
        (reference NPROMATR, ``dir_trans_ctl_mod.F90``).
        """
        if (u is None) != (v is None):
            raise ValueError("u and v must be supplied together")
        if u is not None and u.shape != v.shape:
            raise ValueError(f"u/v shape mismatch: {u.shape} vs {v.shape}")
        nuv0 = 0 if u is None else u.shape[0]
        nsc0 = 0 if scalars is None else scalars.shape[0]
        if npromatr and 2 * nuv0 + nsc0 > npromatr:
            sv_p, sd_p, ss_p = [], [], []
            if nuv0:
                size = max(1, npromatr // 2)
                for j in range(0, nuv0, size):
                    kv = (None if kvsetuv is None
                          else list(kvsetuv[j : j + size]))
                    sv, sd, _ = self.dir_trans(u[j : j + size],
                                               v[j : j + size], None,
                                               kvsetuv=kv)
                    sv_p.append(sv); sd_p.append(sd)
            if nsc0:
                size = max(1, npromatr)
                for j in range(0, nsc0, size):
                    ks = (None if kvsetsc is None
                          else list(kvsetsc[j : j + size]))
                    _, _, ss = self.dir_trans(None, None,
                                              scalars[j : j + size],
                                              kvsetsc=ks)
                    ss_p.append(ss)
            return (jnp.concatenate(sv_p) if sv_p else None,
                    jnp.concatenate(sd_p) if sd_p else None,
                    jnp.concatenate(ss_p) if ss_p else None)
        if u is None and scalars is None:
            raise ValueError("nothing to transform: pass u/v and/or scalars")
        for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
            _check_grid_arg(nm, arr, self.res)
        if kvsetuv is not None or kvsetsc is not None:
            return self._dir_kvset(u, v, scalars, kvsetuv, kvsetsc)
        u, nuv = self._pad_fields(u)
        v, _ = self._pad_fields(v)
        sc, nsc = self._pad_fields(scalars)
        Fuv_g = 0 if u is None else u.shape[0]
        Fsc_g = 0 if sc is None else sc.shape[0]
        key = (Fuv_g, Fsc_g)
        if key not in self._dir_jit:
            self._dir_jit[key] = self._build_dir(Fuv_g, Fsc_g)
        spvor, spdiv, spsc = self._dir_jit[key](u, v, sc, self.tables)
        spvor = spvor[:nuv] if nuv else None
        spdiv = spdiv[:nuv] if nuv else None
        spsc = spsc[:nsc] if nsc else None
        return spvor, spdiv, spsc

    def _dir_kvset(self, u, v, sc, kvsetuv, kvsetsc):
        """dir_trans with caller-controlled field->v-shard ownership."""
        nuv = 0 if u is None else u.shape[0]
        nsc = 0 if sc is None else sc.shape[0]
        if kvsetuv is not None and len(kvsetuv) != nuv:
            raise ValueError(f"kvsetuv must have {nuv} entries")
        if kvsetsc is not None and len(kvsetsc) != nsc:
            raise ValueError(f"kvsetsc must have {nsc} entries")
        pu = pv = psc = None
        pos_uv = pos_sc = None
        if nuv:
            slots_uv, _ = self._kvset_slots(
                kvsetuv if kvsetuv is not None else self._default_kvset(nuv),
                self.v)
            pos_uv = np.asarray(
                [int(np.where(slots_uv == i)[0][0]) for i in range(nuv)])
            pu = self._kvset_place(jnp.asarray(u, self.dtype), slots_uv)
            pv = self._kvset_place(jnp.asarray(v, self.dtype), slots_uv)
        if nsc:
            slots_sc, _ = self._kvset_slots(
                kvsetsc if kvsetsc is not None else self._default_kvset(nsc),
                self.v)
            pos_sc = np.asarray(
                [int(np.where(slots_sc == i)[0][0]) for i in range(nsc)])
            psc = self._kvset_place(jnp.asarray(sc, self.dtype), slots_sc)
        Fuv_g = 0 if pu is None else pu.shape[0]
        Fsc_g = 0 if psc is None else psc.shape[0]
        key = (Fuv_g, Fsc_g)
        if key not in self._dir_jit:
            self._dir_jit[key] = self._build_dir(Fuv_g, Fsc_g)
        spvor, spdiv, spsc = self._dir_jit[key](pu, pv, psc, self.tables)
        return (spvor[pos_uv] if nuv else None,
                spdiv[pos_uv] if nuv else None,
                spsc[pos_sc] if nsc else None)

    def _build_dir(self, Fuv_g, Fsc_g):
        """Three separate jitted shard_map programs (analysis | LT |
        UVTVD+pack), a workaround kept from the previous accelerator (see
        _dir_ana_kernel; the same split as the single-device
        transform._dir_* programs)."""
        specs_t = {k: self.table_specs[k] for k in self.tables}
        spec_w = P("v", None, "w", None)  # fields over v, m-blocks over w

        def ana(u, v, sc, tables):  # tables as argument — see _build_inv
            parts = []
            if Fuv_g:
                parts += [u, v]
            if Fsc_g:
                parts.append(sc)
            grid = jnp.concatenate(parts, axis=0)
            # rows to the length-sorted distributed order (pad slots read
            # the appended zero row)
            gz = jnp.concatenate(
                [grid, jnp.zeros((grid.shape[0], 1, grid.shape[2]),
                                 grid.dtype)], axis=1)
            grid = gz[:, jnp.minimum(jnp.asarray(self.dist.lat_perm),
                                     self.res.ndgl)]
            kernel = functools.partial(self._dir_ana_kernel,
                                       Fuv_g=Fuv_g, Fsc_g=Fsc_g)
            sm = jax.shard_map(
                lambda g, t: kernel(g, t),
                mesh=self.mesh,
                in_specs=(P(None, ("w", "v"), None), specs_t),
                out_specs=spec_w,
                check_vma=False,
            )
            return sm(grid, tables)

        def lt(four, tables):
            sm = jax.shard_map(
                lambda f, t: self._lt_dir(f, t),
                mesh=self.mesh,
                in_specs=(spec_w, specs_t),
                out_specs=spec_w,
                check_vma=False,
            )
            return sm(four, tables)

        def pack(dense, tables):
            kernel = functools.partial(self._dir_pack_kernel,
                                       Fuv_g=Fuv_g, Fsc_g=Fsc_g)
            sm = jax.shard_map(
                lambda d, t: kernel(d, t),
                mesh=self.mesh,
                in_specs=(spec_w, specs_t),
                out_specs=(P("v", None), P("v", None), P("v", None)),
                check_vma=False,
            )
            return sm(dense, tables)

        jits = (jax.jit(ana), jax.jit(lt), jax.jit(pack))

        def fn(u, v, sc, tables):
            four = jits[0](u, v, sc, tables)
            dense = jits[1](four, tables)
            return jits[2](dense, tables)

        return fn
