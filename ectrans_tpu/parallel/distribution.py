"""Distributed-transform bookkeeping: the analogue of SUWAVEDI/SUMPLAT.

Builds, on host, everything a (w, v) mesh needs to run sharded transforms:

* **Wave distribution** (reference ``suwavedi_mod.F90:115-131``): zonal
  wavenumbers are assigned to the ``w`` blocks in boustrophedon ("ping-pong")
  order so each block's total coefficient count (nsmax - m + 1 shrinks with
  m) is balanced; the assignment is materialized as a permutation of the m
  axis so every block is a *contiguous* slice of the permuted axis — the
  sharding-friendly equivalent of MYMS/NUMP.
* **Latitude distribution** (reference ``sumplatf_mod.F90``): contiguous
  latitude blocks, padded so ndgl divides w*v; padded latitudes carry zero
  quadrature weight / zero chirp rows and therefore contribute nothing.
* **Permuted, padded device tables**: Legendre tensors, recurrence
  coefficient tables, layout index maps and Bluestein chirp tables, laid out
  so that sharding them over ("w",) is a plain contiguous split.

Everything is returned as numpy; ``device_tables`` in ``sharded.py`` places
them on the mesh with the right ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..resolution import Resolution
from ..ops import spectral as spectral_ops


def pingpong_blocks(M: int, w: int) -> list[list[int]]:
    """Boustrophedon assignment of m=0..M-1 to w blocks (suwavedi ping-pong)."""
    blocks: list[list[int]] = [[] for _ in range(w)]
    i = 0
    for m in range(M):
        cycle, pos = divmod(i, w)
        b = pos if cycle % 2 == 0 else w - 1 - pos
        blocks[b].append(m)
        i += 1
    return blocks


@dataclasses.dataclass(frozen=True)
class LatBucketMeta:
    """One Fourier latitude bucket of the sharded path (local-slot range
    [lb0, lb1) on every "w" shard; see ``build_distribution``)."""

    lb0: int
    lb1: int
    mb: int        # max retained zonal mode over the bucket's rows
    ndlon: int     # max row length over the bucket's rows
    nfft: int      # shared chirp-z convolution length


@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """One m-group of the distributed grouped-Legendre layout.

    Every shard owns ``Lg`` m's of this group (round-robin within the
    contiguous range [m0, m1) — the load-balanced refinement of SUWAVEDI's
    ping-pong that additionally keeps per-shard table shapes identical, so
    the memory-tight grouped Legendre tensors work under shard_map)."""

    m0: int
    m1: int
    Lg: int     # local m count per shard (group padded to Lg * w)
    i0: int     # first active NH latitude (ndgnh - ndglu(m0))
    kg: int     # parity coefficient extent
    off: int    # local-axis offset of this group within a shard's m-block


@dataclasses.dataclass(frozen=True, eq=False)
class Distribution:
    """Host-side distributed layout for one (Resolution, w, v) combination."""

    res: Resolution
    w: int
    v: int

    M_pad: int              # padded wavenumber count (multiple of w)
    ndgl_pad: int           # padded latitude count (multiple of w*v)
    perm: np.ndarray        # (M_pad,) permuted m values; res.M marks padding
    pos_of_m: np.ndarray    # (M,) position of natural m in the permuted axis
    pm_perm_pos: np.ndarray  # (nspec2,) permuted-axis position per packed idx
    groups: tuple           # tuple[GroupMeta]
    # length-sorted latitude distribution (the analogue of SUMPLAT's
    # load balance): permuted position p = s*LLW + j holds the row of
    # global length-sorted rank j*w + s, so every "w" shard owns an equal
    # mix of short/long rows AND local slot range [lb0, lb1) covers
    # near-identical lengths on every shard — the per-bucket chirp
    # lengths of the single-device Fourier bucketing stay STATIC and
    # shard-independent under shard_map.
    lat_perm: np.ndarray    # (ndgl_pad,) original row at permuted slot
    lat_pos: np.ndarray     # (ndgl,) permuted slot of natural row
    lat_buckets: tuple      # tuple[LatBucketMeta]

    @property
    def ML(self) -> int:
        return self.M_pad // self.w

    @property
    def LL(self) -> int:
        return self.ndgl_pad // self.w


@functools.lru_cache(maxsize=8)
def build_distribution(res: Resolution, w: int, v: int,
                       nbuckets: int = 12) -> Distribution:
    """Grouped round-robin wave distribution: contiguous m-groups (the same
    boundaries as the single-device grouped Legendre tables), each dealt
    round-robin to the w shards.  Every shard owns an equal slice of every
    group — balanced like SUWAVEDI's ping-pong, but with identical per-shard
    group shapes so the Legendre tensors stay memory-tight."""
    M = res.M
    ngroups = max(1, min(16, M // 8))
    bs = -(-M // ngroups)
    nmax = res.nsmax + 1

    groups = []
    off = 0
    for gi in range(ngroups):
        m0 = gi * bs
        m1 = min(M, m0 + bs)
        if m0 >= M:
            break
        Lg = -(-(m1 - m0) // w)
        groups.append(GroupMeta(
            m0=m0, m1=m1, Lg=Lg,
            i0=res.ndgnh - int(res.ndglu[m0]),
            kg=(nmax - m0) // 2 + 1,
            off=off,
        ))
        off += Lg
    ML = off
    M_pad = ML * w

    # permuted m-axis: [shard0: g0 slice, g1 slice, ... | shard1: ...]
    perm = np.full(M_pad, M, dtype=np.int64)  # M = padding sentinel
    for s in range(w):
        base = s * ML
        for g in groups:
            for j in range(g.Lg):
                m = g.m0 + j * w + s
                if m < g.m1:
                    perm[base + g.off + j] = m
    pos_of_m = np.zeros(M, dtype=np.int64)
    for pos, m in enumerate(perm):
        if m < M:
            pos_of_m[m] = pos
    pm_perm_pos = pos_of_m[res.packed_gather_m]

    wv = w * v
    ndgl_pad = -(-res.ndgl // wv) * wv

    # ---- length-sorted latitude distribution + Fourier buckets ----
    from ..ops.fft_fourstep import good_size

    ndgl = res.ndgl
    nloen = list(res.grid.nloen)
    nmen = [int(x) for x in res.nmen]
    # sort rows by length; pad rows (length -1) sort first, into the
    # shortest bucket, where they carry zero data/zero chirp input
    order = sorted(range(ndgl_pad),
                   key=lambda r: (nloen[r] if r < ndgl else -1, r))
    LLW = ndgl_pad // w
    lat_perm = np.empty(ndgl_pad, dtype=np.int64)
    for p in range(ndgl_pad):
        s, j = divmod(p, LLW)
        lat_perm[p] = order[j * w + s]
    lat_pos = np.empty(ndgl, dtype=np.int64)
    for p, r in enumerate(lat_perm):
        if r < ndgl:
            lat_pos[r] = p

    nb = max(1, min(nbuckets, LLW // 16))
    bounds = [round(LLW * k / nb) for k in range(nb + 1)]
    lat_buckets = []
    for k in range(nb):
        lb0, lb1 = bounds[k], bounds[k + 1]
        if lb0 == lb1:
            continue
        rows = [r for r in order[lb0 * w : lb1 * w] if r < ndgl]
        mb = min(res.nsmax, max((nmen[r] for r in rows), default=0))
        ndlon_b = max((nloen[r] for r in rows), default=1)
        lat_buckets.append(LatBucketMeta(
            lb0=lb0, lb1=lb1, mb=mb, ndlon=ndlon_b,
            nfft=good_size(ndlon_b + 2 * mb + 1)))

    return Distribution(
        res=res, w=w, v=v, M_pad=M_pad, ndgl_pad=ndgl_pad,
        perm=perm, pos_of_m=pos_of_m, pm_perm_pos=pm_perm_pos,
        groups=tuple(groups),
        lat_perm=lat_perm, lat_pos=lat_pos, lat_buckets=tuple(lat_buckets),
    )


def clear_caches():
    """Release host-side distribution state (called from trans_end)."""
    build_distribution.cache_clear()


def _permute_m_rows(table: np.ndarray, perm: np.ndarray, pad_value=0.0):
    """table (M, ...) -> (M_pad, ...) with rows reordered by perm; padding
    rows (perm == M) filled with pad_value."""
    M = table.shape[0]
    padded = np.concatenate(
        [table, np.full((1,) + table.shape[1:], pad_value, table.dtype)], axis=0
    )
    return padded[np.minimum(perm, M)]


def host_tables(dist: Distribution, dtype_str: str = "float32") -> dict:
    """All numpy tables for the sharded pipeline, in permuted/padded layout.

    Keys ending in ``_w`` are sharded over mesh axis "w" on their first
    (or stated) axis; others are replicated.  ``dtype_str`` selects the
    Legendre-table precision source (fp64 requests lazily upgrade fp32
    setup tables — see ``Resolution.parity_tables``).  The big Legendre
    tensors are the parity pairs ``lg{gi}_psym_w``/``lg{gi}_pasym_w``.
    """
    res = dist.res
    M, NP = res.M, res.NP
    perm = dist.perm

    ct_vd = spectral_ops.vordiv_coeff_tables(res, dtype=np.float64)
    ct_tv = spectral_ops.uvtvd_coeff_tables(res, dtype=np.float64)
    ct_ns = spectral_ops.nsder_coeff_tables(res, dtype=np.float64)

    out = {
        # layout index maps
        "dense_gather_w": _permute_m_rows(
            res.dense_gather.transpose(1, 0, 2), perm, pad_value=res.nspec2
        ),  # (M_pad, 2, NP) -> transposed back in sharded.py
        "idx_sym_w": _permute_m_rows(res.idx_sym, perm, pad_value=NP),
        "idx_asym_w": _permute_m_rows(res.idx_asym, perm, pad_value=NP),
        # spectral-operator coefficient tables (M_pad, NP)
        **{f"vd_{k}_w": _permute_m_rows(val, perm) for k, val in ct_vd.items()},
        **{f"tv_{k}_w": _permute_m_rows(val, perm) for k, val in ct_tv.items()},
        **{f"ns_{k}_w": _permute_m_rows(val, perm) for k, val in ct_ns.items()},
        # replicated
        "wq": res.w[: res.grid.ndgnh],                 # quadrature weights (NH)
        "mval": np.where(perm < M, perm, 0).astype(np.float64),  # (M_pad,)
        "pos_of_m": dist.pos_of_m,                      # (M,)
        "perm": perm,                                   # (M_pad,)
        "packed_c": res.packed_gather_c,
        "packed_n": res.packed_gather_n,
        "pm_perm_pos": dist.pm_perm_pos,
    }

    # per-latitude tables in the length-sorted permuted order (pad rows
    # carry zeros), sharded over "w" on the latitude axis: racthe plus one
    # Bluestein chirp-table set per Fourier bucket (the sharded analogue
    # of ops/fourier.bucketed_tables — per-bucket nfft/mmax stay static
    # and shard-independent because every shard owns the same local-slot
    # length mix; see build_distribution).
    from ..ops.fourier import host_bluestein_tables

    ndgl, lat_perm = res.ndgl, dist.lat_perm
    LLW = dist.ndgl_pad // dist.w
    out["lat_perm"] = lat_perm
    out["lat_pos"] = dist.lat_pos
    for bi, bm in enumerate(dist.lat_buckets):
        rows = [int(lat_perm[s * LLW + j])
                for s in range(dist.w) for j in range(bm.lb0, bm.lb1)]
        nloen_b = tuple(res.grid.nloen[r] if r < ndgl else 1 for r in rows)
        nmen_b = tuple(min(int(res.nmen[r]), bm.mb) if r < ndgl else 0
                       for r in rows)
        bt = host_bluestein_tables(nloen_b, nmen_b, bm.mb)
        assert bt["nfft"] == bm.nfft and bt["ndlon"] == bm.ndlon
        for k, val in bt.items():
            if isinstance(val, np.ndarray):
                out[f"fb{bi}_{k}_w"] = val
    racthe_pad = np.concatenate(
        [res.racthe, np.zeros(dist.ndgl_pad - ndgl)])
    out["racthe_lat_w"] = racthe_pad[lat_perm]

    # grouped Legendre tensors: per group g, rows (w * Lg, Ig, Kg) with row
    # s*Lg + j = P[perm[s*ML + off + j]][i0:, :kg] (zero rows for padding) —
    # sharded over "w" each shard sees the identically-shaped (Lg, Ig, Kg)
    ML = dist.ML
    psym_h, pasym_h = res.parity_tables(dtype_str)
    for gi, g in enumerate(dist.groups):
        ig = res.ndgnh - g.i0
        ps = np.zeros((dist.w * g.Lg, ig, g.kg))
        pa = np.zeros((dist.w * g.Lg, ig, g.kg))
        for s in range(dist.w):
            for j in range(g.Lg):
                m = perm[s * ML + g.off + j]
                if m < M:
                    ps[s * g.Lg + j] = psym_h[m, g.i0 :, : g.kg]
                    pa[s * g.Lg + j] = pasym_h[m, g.i0 :, : g.kg]
        out[f"lg{gi}_psym_w"] = ps
        out[f"lg{gi}_pasym_w"] = pa
    return out


