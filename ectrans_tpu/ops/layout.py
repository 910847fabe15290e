"""Spectral-layout conversions (packed NASM0 <-> dense (c, m, n) <-> parity).

The packed layout is the ecTrans user layout (``suwavedi_mod.F90`` NASM0
addressing, reproduced in ``resolution._build_packed_maps``); the dense and
parity layouts are internal, zero-padded, static-shape tensors that XLA
batches into matmuls.  All conversions are gathers with precomputed index
tables — the replacement of PRFI1B/UPDSP's per-m copy loops
(``prfi1b_mod.F90``, ``updsp_mod.F90``).
"""

from __future__ import annotations

import jax.numpy as jnp


def packed_to_dense(spec, tables):
    """(nfld, nspec2) -> (nfld, 2, M, NP) dense absolute-n layout.

    One row-slice gather (M start offsets, contiguous 2*(NP+1)-wide slices —
    each m-block is contiguous in the packed layout) followed by the
    diagonal-realignment reshape (chosen over a per-element gather on the
    accelerator the layout was designed for).  The validity mask restores exact zeros outside m <= n <= nsmax.
    """
    from jax import lax

    nfld = spec.shape[0]
    M, NP = tables.dense_gather.shape[1], tables.dense_gather.shape[2]
    G = 2 * (NP + 1)
    specp = jnp.pad(spec, [(0, 0), (0, G)])
    dn = lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(1,)
    )
    rows = lax.gather(specp, tables.nasm0[:, None], dn,
                      slice_sizes=(nfld, G),
                      mode=lax.GatherScatterMode.CLIP)   # (M, nfld, G)
    d2 = rows.reshape(M, nfld, NP + 1, 2).transpose(1, 3, 0, 2)
    flat = d2.reshape(nfld, 2, M * (NP + 1))
    dense = flat[..., : M * NP].reshape(nfld, 2, M, NP)
    return dense * tables.dense_valid


def dense_to_packed(dense, tables):
    """(nfld, 2, M, NP) -> (nfld, nspec2).

    A per-element gather.  Whether it is hot on a GPU, and whether a
    unit-stride reformulation or a compaction kernel beats it, is ROADMAP
    1.5 (decided from a profiler trace).
    """
    return dense[:, tables.packed_gather_c, tables.packed_gather_m, tables.packed_gather_n]


def dense_to_parity(dense, tables):
    """(nfld, 2, M, NP) -> sym, asym each (nfld, 2, M, K).

    sym[..., m, k] = dense[..., m, m+2k]; asym at n = m+1+2k.  Implemented
    as a pure pad + reshape: appending one slot per m-row turns the
    diagonal realignment D2[m, j] = dense[m, m+j] into the identity on the
    flat buffer (index algebra m*(W+1) + j = m*W + (m+j)), so no gather is
    needed; this costs two relayouts.  Entries beyond the m-th diagonal's end are
    neighbouring rows' data; they are harmless downstream because the
    Legendre tables are zero there and every n+-1 recurrence coefficient
    vanishes at the parity boundary (eps(m, m) = 0).
    """
    f, c, M, W = dense.shape
    K = tables.idx_sym.shape[-1]
    flat = dense.reshape(f, c, M * W)
    flat = jnp.pad(flat, [(0, 0), (0, 0), (0, M)])
    d2 = flat.reshape(f, c, M, W + 1)      # d2[..., m, j] = dense[..., m, m+j]
    sym = d2[..., 0::2][..., :K]
    asym = d2[..., 1::2][..., :K]
    return sym, asym


def parity_to_dense(sym, asym, tables, NP):
    """Inverse of dense_to_parity on the valid (n >= m) region; entries at
    n < m are neighbouring rows' coefficients (not zeros) — every consumer
    either masks with the (n >= m) validity table or gathers valid
    positions only.

    The parity interleave is a static last-axis gather from the
    concatenated [sym | asym | 0] buffer — NOT a stack on a new trailing
    axis of size 2, which a tiled layout may pad along that minor axis
    (a 32x padded-memory expansion on the accelerator the layout was
    designed for).
    """
    import numpy as np

    f, c, M, K = sym.shape
    W = NP
    conc = jnp.concatenate(
        [sym, asym, jnp.zeros((f, c, M, 1), sym.dtype)], axis=-1)
    j = np.arange(W + 1)
    idx = np.where(j % 2 == 0, j // 2, K + j // 2)
    idx = np.where(j // 2 < K, idx, 2 * K).astype(np.int32)  # 2K = zero col
    d2 = conc[..., jnp.asarray(idx)]           # (f, c, M, W+1) interleaved
    flat = d2.reshape(f, c, M * (W + 1))
    return flat[..., : M * W].reshape(f, c, M, W)


def dense_to_parity_gather(dense, tables):
    """Gather-based parity split for a PERMUTED m axis (the sharded path,
    where row index != m so the diagonal-realignment trick does not apply).
    Index NP selects an appended zero row (padding)."""
    M = dense.shape[2]
    pad = jnp.concatenate(
        [dense, jnp.zeros(dense.shape[:3] + (1,), dtype=dense.dtype)], axis=-1
    )
    marange = jnp.arange(M)[:, None]
    sym = pad[:, :, marange, tables.idx_sym]
    asym = pad[:, :, marange, tables.idx_asym]
    return sym, asym


def parity_to_dense_scatter(sym, asym, tables, NP):
    """Scatter-based exact inverse for a permuted m axis (sharded path);
    produces exact zeros outside the valid region."""
    nfld, two, M, K = sym.shape
    dense = jnp.zeros((nfld, two, M, NP + 1), dtype=sym.dtype)
    marange = jnp.arange(M)[:, None]
    dense = dense.at[:, :, marange, tables.idx_sym].add(sym)
    dense = dense.at[:, :, marange, tables.idx_asym].add(asym)
    return dense[..., :NP]
