"""Single-device inverse and direct spectral transforms.

A JAX re-design of the reference transform pipeline
(``inv_trans_ctl_mod.F90`` / ``dir_trans_ctl_mod.F90`` and the batched GPU
variant ``gpu/internal/inv_trans_ctl_mod.F90:160-236``): every stage operates
on whole (field, wavenumber, latitude) tensors at once — there are no per-m
or per-latitude loops, and XLA fuses the elementwise stages (FSC scaling,
recombination) into the surrounding matmuls/FFTs.

The compute kernels are jitted with all precomputed tables passed as
*arguments* (registered pytrees): closing over multi-GB tables would embed
them into the HLO as constants, which bloats compile payloads and defeats
XLA buffer reuse.

Inverse pipeline (spectral -> grid):
    packed -> dense -> [VDTUV winds] -> [SPNSDE N-S derivs] -> parity split
    -> grouped inverse Legendre matmuls -> FSC (1/(a cos) scaling + E-W
    derivs) -> batched (i)rfft / Bluestein -> grid

Direct pipeline (grid -> spectral) is the exact mirror with Gaussian
quadrature and UVTVD.

Field ordering of the combined grid output follows the reference contract
(``inv_trans.F90:58-106``): vor?, div?, u, v, scalars, N-S derivs of
scalars?, E-W derivs of u and v?, E-W derivs of scalars?.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops import fourier, layout, legendre_matmul, spectral
from .resolution import Resolution


@dataclasses.dataclass(frozen=True)
class InvFlags:
    vorgp: bool = False     # output grid-point vorticity (LDVORGP)
    divgp: bool = False     # output grid-point divergence (LDDIVGP)
    scders: bool = False    # output N-S and E-W derivatives of scalars
    uvders: bool = False    # output E-W derivatives of u, v (LDUVDER)


def num_inv_output_fields(nfld_uv: int, nfld_sc: int, flags: InvFlags) -> int:
    n = 0
    if nfld_uv:
        n += nfld_uv * (2 + int(flags.vorgp) + int(flags.divgp))
        if flags.uvders:
            n += 2 * nfld_uv
    if nfld_sc:
        n += nfld_sc * (3 if flags.scders else 1)
    return n


def _table_dtype(dtype, precision: str) -> str:
    """Legendre table storage dtype for a precision tier.

    The ``bf16`` tier stores the grouped P tables in bfloat16: its
    single-pass bf16 contraction rounds operands to bf16 anyway, so
    accuracy is unchanged while table traffic and footprint halve (TCO2047:
    13.1 GiB fp32 -> 6.5 GiB), the role of the reference's butterfly
    compression (``butterfly_alg_mod.F90``) at its own relaxed FLT gate."""
    if precision == "bf16" and jnp.dtype(dtype) == jnp.float32:
        return "bfloat16"
    return str(jnp.dtype(dtype))


@functools.lru_cache(maxsize=64)
def _coeff_tables(res: Resolution, dtype_str: str):
    np_dtype = np.dtype(dtype_str)
    return jax.device_put(dict(
        vd=spectral.vordiv_coeff_tables(res, np_dtype),
        uvtvd=spectral.uvtvd_coeff_tables(res, np_dtype),
        nsd=spectral.nsder_coeff_tables(res, np_dtype),
    ))


def _ew_derivative(four, racthe):
    """i*m*F scaled by 1/(a cos): Fourier-space E-W derivative (FSC 2.x)."""
    M = four.shape[2]
    mvec = jnp.arange(M, dtype=four.dtype)[None, :, None]
    re, im = four[:, 0], four[:, 1]
    return jnp.stack([-im * mvec, re * mvec], axis=1) * racthe


def _check_spec(name, arr, res):
    if arr is not None and (arr.ndim != 2 or arr.shape[1] != res.nspec2):
        raise ValueError(
            f"{name} must have shape (nfld, nspec2={res.nspec2}), got {arr.shape}"
        )


def _check_grid_arg(name, arr, res):
    if arr is not None and (
        arr.ndim != 3
        or arr.shape[1] != res.ndgl
        or arr.shape[2] != res.grid.ndlon
    ):
        raise ValueError(
            f"{name} must have shape (nfld, ndgl={res.ndgl}, "
            f"ndlon={res.grid.ndlon}), got {arr.shape}"
        )


@functools.partial(jax.jit, static_argnames=("flags", "fspgl_proc", "normalize",
                                             "precision"))
def _inv_impl(tables, gl, ct, bt, spvor, spdiv, spscalar, flags,
              fspgl_proc=None, normalize=True, precision="highest"):
    dtype = tables.racthe.dtype
    racthe = tables.racthe[None, None, None, :]  # broadcast over (f, c, m, lat)
    nfld_uv = spvor.shape[0] if spvor is not None else 0
    nfld_sc = spscalar.shape[0] if spscalar is not None else 0

    # All fields go through ONE grouped Legendre call: each separate call
    # streams the full grouped P tables from device memory (~GBs at
    # TCO1279), so batching vor/div/u/v/scalars/N-S-derivs into a single
    # contraction is the analogue of the GPU backend's all-m all-field
    # grouped GEMM (gpu/internal/leinv_mod.F90:273-317) — table traffic is
    # paid once and the per-matmul field dimension is maximal.
    lt_inputs = []
    with jax.named_scope("spectral_inv"):
        if nfld_uv:
            with jax.named_scope("unpack"):
                dvor = layout.packed_to_dense(spvor.astype(dtype), tables)
                ddiv = layout.packed_to_dense(spdiv.astype(dtype), tables)
            du, dv = spectral.vordiv_to_uv(dvor, ddiv, ct["vd"])
            if flags.vorgp:
                lt_inputs.append(dvor)
            if flags.divgp:
                lt_inputs.append(ddiv)
            lt_inputs += [du, dv]
        if nfld_sc:
            with jax.named_scope("unpack"):
                dsc = layout.packed_to_dense(spscalar.astype(dtype), tables)
            lt_inputs.append(dsc)
            if flags.scders:
                lt_inputs.append(spectral.ns_derivative(dsc, ct["nsd"]))
        dense_all = (jnp.concatenate(lt_inputs, axis=0)
                     if len(lt_inputs) > 1 else lt_inputs[0])
        sym, asym = layout.dense_to_parity(dense_all, tables)
    with jax.named_scope("legendre_inv"):
        four_all = legendre_matmul.legendre_inv_grouped(
            sym, asym, gl, precision=precision)

    off = 0

    def take(n):
        nonlocal off
        s = four_all[off : off + n]
        off += n
        return s

    out_groups = []  # ordered fourier tensors matching the PGP contract
    uv_four = None
    if nfld_uv:
        if flags.vorgp:
            out_groups.append(take(nfld_uv))
        if flags.divgp:
            out_groups.append(take(nfld_uv))
        uv_four = take(2 * nfld_uv) * racthe
        out_groups.append(uv_four)
    sc_four = None
    if nfld_sc:
        sc_four = take(nfld_sc)
        out_groups.append(sc_four)
        if flags.scders:
            out_groups.append(take(nfld_sc) * racthe)
    if nfld_uv and flags.uvders:
        out_groups.append(_ew_derivative(uv_four, racthe))
    if nfld_sc and flags.scders:
        out_groups.append(_ew_derivative(sc_four, racthe))

    four = jnp.concatenate(out_groups, axis=0)
    if fspgl_proc is not None:
        # user-supplied Fourier-space hook (reference FSPGL_INT,
        # fspgl_int_mod.F90: the IFS semi-Lagrangian callback point)
        four = fspgl_proc(four)
    # materialise before the bucketed synthesis (a guard kept from the
    # previous accelerator's fusion miscompile; ROADMAP 1.4 measures
    # removing it)
    four = jax.lax.optimization_barrier(four)
    with jax.named_scope("fourier_synthesis"):
        return fourier.synthesis_bucketed(four, bt, normalize=normalize,
                                          prec=precision)


# NB: the direct transform runs as TWO jitted programs with a dispatch
# boundary between the Fourier analysis and the Legendre stage.  The split
# was a workaround for a fusion miscompile on the previous accelerator;
# it costs one dispatch and one device-memory materialisation of the
# Fourier tensor, and ROADMAP 1.4 measures fusing it back.


@functools.partial(jax.jit, static_argnames=("normalize", "precision"))
def _dir_ana_impl(tables, bt, u, v, scalars, normalize=True,
                  precision="highest"):
    dtype = tables.racthe.dtype
    M = tables.dense_gather.shape[1]
    # u/v and scalars are analysed in separate bucketed calls (the same
    # workaround class as the program split above); pairing also stays
    # within each field family.
    parts = []
    with jax.named_scope("fourier_analysis"):
        if u is not None:
            uv = jnp.concatenate([u.astype(dtype), v.astype(dtype)], axis=0)
            parts.append(fourier.analysis_bucketed(
                uv, bt, M, normalize=normalize, prec=precision))
        if scalars is not None:
            parts.append(fourier.analysis_bucketed(
                scalars.astype(dtype), bt, M, normalize=normalize,
                prec=precision))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


@functools.partial(jax.jit, static_argnames=("nfld_uv", "has_sc", "precision"))
def _dir_lt_impl(tables, gl, ct, four, nfld_uv, has_sc, precision="highest"):
    """Direct Legendre transform, UVTVD and packing (one program)."""
    NP = tables.dense_gather.shape[2]
    ndgnh = gl.ndgnh
    if nfld_uv:
        racthe = tables.racthe[None, None, None, :]
        uvpart = four[: 2 * nfld_uv] * racthe
        four = jnp.concatenate([uvpart, four[2 * nfld_uv :]], axis=0)
    with jax.named_scope("legendre_dir"):
        sym, asym = legendre_matmul.legendre_dir_grouped(
            four, gl, tables.w[:ndgnh], precision=precision)
    with jax.named_scope("spectral_dir"):
        dense = layout.parity_to_dense(sym, asym, tables, NP)
        spvor = spdiv = spsc = None
        if nfld_uv:
            dvor, ddiv = spectral.uv_to_vordiv(
                dense[:nfld_uv], dense[nfld_uv : 2 * nfld_uv], ct["uvtvd"])
        with jax.named_scope("pack"):
            if nfld_uv:
                spvor = layout.dense_to_packed(dvor, tables)
                spdiv = layout.dense_to_packed(ddiv, tables)
            if has_sc:
                spsc = layout.dense_to_packed(dense[2 * nfld_uv :], tables)
    return spvor, spdiv, spsc


def _dir_impl(tables, gl, ct, bt, u, v, scalars, normalize=True,
              precision="highest"):
    four = _dir_ana_impl(tables, bt, u, v, scalars, normalize, precision)
    nfld_uv = u.shape[0] if u is not None else 0
    return _dir_lt_impl(tables, gl, ct, four, nfld_uv, scalars is not None,
                        precision=precision)


def inv_trans(
    res: Resolution,
    spvor=None,
    spdiv=None,
    spscalar=None,
    *,
    flags: InvFlags = InvFlags(),
    dtype=jnp.float32,
    fspgl_proc=None,
    npromatr: int | None = None,
    precision: str = "highest",
    _normalize=True,
):
    """Inverse transform: packed spectral arrays -> grid fields.

    spvor/spdiv: (nfld_uv, nspec2); spscalar: (nfld_sc, nspec2).
    Returns (nfld_out, ndgl, ndlon) with the reference PGP field ordering.

    fspgl_proc: optional jittable callback applied to the Fourier-space
    tensor (nfld_out, 2, M, ndgl) before longitude synthesis (the
    reference's FSPGL_PROC hook, ``fspgl_int_mod.F90:13-110``).

    npromatr: split huge field sets into packets of at most this many
    fields (counting 2 per vor/div pair), bounding device working-set
    memory — the library-level NPROMATR of the reference
    (``inv_trans_ctl_mod.F90:143-276`` + FIELD_SPLIT).  Packets are
    homogeneous (uv-only / scalar-only) and padded to a uniform size so
    one compiled executable serves all packets of each kind; outputs are
    reassembled into the exact single-call PGP ordering.
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is not None and spvor.shape != spdiv.shape:
        raise ValueError(f"spvor/spdiv shape mismatch: {spvor.shape} vs {spdiv.shape}")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform: pass spvor/spdiv and/or spscalar")
    for nm, arr in (("spvor", spvor), ("spdiv", spdiv), ("spscalar", spscalar)):
        _check_spec(nm, arr, res)
    nuv = 0 if spvor is None else spvor.shape[0]
    nsc = 0 if spscalar is None else spscalar.shape[0]
    if npromatr and 2 * nuv + nsc > npromatr:
        return _inv_packets(res, spvor, spdiv, spscalar, flags, dtype,
                            fspgl_proc, npromatr, precision, _normalize)
    dtype = jnp.dtype(dtype)
    tables = res.device_tables(dtype)
    gl = res.grouped_legendre(_table_dtype(dtype, precision))
    ct = _coeff_tables(res, str(dtype))
    bt = fourier.bucketed_tables_for(res, dtype)
    return _inv_impl(tables, gl, ct, bt, spvor, spdiv, spscalar, flags,
                     fspgl_proc, _normalize, precision)


def _chunk_pad(x, size):
    """Yield equal-`size` leading-axis chunks of x (last padded with zeros),
    with the count of real fields in each."""
    n = x.shape[0]
    for i in range(0, n, size):
        c = x[i : i + size]
        real = c.shape[0]
        if real < size:
            c = jnp.concatenate(
                [c, jnp.zeros((size - real,) + c.shape[1:], c.dtype)], axis=0)
        yield c, real


def _inv_packets(res, spvor, spdiv, spscalar, flags, dtype, fspgl_proc,
                 npromatr, precision, _normalize):
    """NPROMATR packet loop: uv pairs then scalars, group-wise reassembly."""
    from .field_layout import FieldLayout

    nuv = 0 if spvor is None else spvor.shape[0]
    nsc = 0 if spscalar is None else spscalar.shape[0]
    parts = {}
    if nuv:
        size = max(1, npromatr // 2)
        for (cv, real), (cd, _) in zip(_chunk_pad(spvor, size),
                                       _chunk_pad(spdiv, size)):
            out = inv_trans(res, cv, cd, None, flags=flags, dtype=dtype,
                            fspgl_proc=fspgl_proc, precision=precision,
                            _normalize=_normalize)
            fl = FieldLayout.inv(real, 0, flags, pad_uv=size)
            for k, blk in fl.split(out).items():
                parts.setdefault(k, []).append(blk)
    if nsc:
        size = max(1, npromatr)
        for csc, real in _chunk_pad(spscalar, size):
            out = inv_trans(res, None, None, csc, flags=flags, dtype=dtype,
                            fspgl_proc=fspgl_proc, precision=precision,
                            _normalize=_normalize)
            fl = FieldLayout.inv(0, real, flags, pad_sc=size)
            for k, blk in fl.split(out).items():
                parts.setdefault(k, []).append(blk)
    order = FieldLayout.inv(nuv, nsc, flags).names
    return jnp.concatenate(
        [jnp.concatenate(parts[k], axis=0) for k in order], axis=0)


def dir_trans(
    res: Resolution,
    u=None,
    v=None,
    scalars=None,
    *,
    dtype=jnp.float32,
    npromatr: int | None = None,
    precision: str = "highest",
    _normalize=True,
):
    """Direct transform: grid fields -> packed spectral arrays.

    u/v: (nfld_uv, ndgl, ndlon) grid winds; scalars: (nfld_sc, ndgl, ndlon).
    Returns (spvor, spdiv, spscalar) packed arrays (None where no input).
    ``npromatr`` splits huge field sets into memory-bounded packets (see
    :func:`inv_trans`).
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is not None and u.shape != v.shape:
        raise ValueError(f"u/v shape mismatch: {u.shape} vs {v.shape}")
    if u is None and scalars is None:
        raise ValueError("nothing to transform: pass u/v and/or scalars")
    for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
        _check_grid_arg(nm, arr, res)
    nuv = 0 if u is None else u.shape[0]
    nsc = 0 if scalars is None else scalars.shape[0]
    if npromatr and 2 * nuv + nsc > npromatr:
        sv_p, sd_p, ss_p = [], [], []
        if nuv:
            size = max(1, npromatr // 2)
            for (cu, real), (cv, _) in zip(_chunk_pad(u, size),
                                           _chunk_pad(v, size)):
                sv, sd, _ = dir_trans(res, cu, cv, None, dtype=dtype,
                                      precision=precision,
                                      _normalize=_normalize)
                sv_p.append(sv[:real]); sd_p.append(sd[:real])
        if nsc:
            for csc, real in _chunk_pad(scalars, max(1, npromatr)):
                _, _, ss = dir_trans(res, None, None, csc, dtype=dtype,
                                     precision=precision,
                                     _normalize=_normalize)
                ss_p.append(ss[:real])
        return (jnp.concatenate(sv_p) if sv_p else None,
                jnp.concatenate(sd_p) if sd_p else None,
                jnp.concatenate(ss_p) if ss_p else None)
    dtype = jnp.dtype(dtype)
    tables = res.device_tables(dtype)
    gl = res.grouped_legendre(_table_dtype(dtype, precision))
    ct = _coeff_tables(res, str(dtype))
    bt = fourier.bucketed_tables_for(res, dtype)
    return _dir_impl(tables, gl, ct, bt, u, v, scalars, _normalize,
                     precision)
