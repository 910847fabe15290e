"""Batched Legendre-transform matmuls (the FLOP core of the transform).

A JAX re-design of the reference's per-m GEMM loops (LEINV,
``leinv_mod.F90:99-185``; LEDIR, ``ledir_mod.F90:126-175``) and of the GPU
backend's grouped GEMMs (``gpu/internal/leinv_mod.F90:273-317``): one batched
contraction per contiguous m-group, with m as the batch dimension of
zero-padded (gm, ig, kg) Legendre tensors.  XLA hands each batched matmul to
cuBLAS; zero padding only costs FLOPs (~2x triangular waste), never
correctness, because the padded P̄ entries are exactly zero.

Accumulation is always float32-or-better (``preferred_element_type``), which
also covers the reference's fp64-for-m=0 mass-conservation concern
(``ledir_mod.F90:139-172``) when inputs are fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Public precision tiers (the API-level ``precision`` argument).  Each names
# its arithmetic explicitly, so that it does not depend on a backend's
# default (a float32 matmul at Precision.DEFAULT may run in TF32 on a GPU):
#   "highest" — exact fp32 operands: the Legendre sums accumulate in fp64
#               (legendre_einsum; an fp64 GEMM on the card), other matmuls
#               run F32_F32_F32 (true fp32 products and sums, on an H100
#               the fp32 units, not TF32).  The reference computes its
#               Legendre GEMMs in fp32/fp64 (ectrans_blas_mod.F90); this
#               tier passes its 100*eps gate.
#   "high"    — BF16_BF16_F32_X3: three bf16 tensor-core passes (~2^-16
#               operand split), the analogue of the reference GPU's 3xTF32
#               CUTLASS path (hicblas_cutlass.cuda.h).  The FFT layer stays
#               at fp32 in this tier (see fft_fourstep.fft_tier).
#   "bf16"    — one bf16 pass with fp32 accumulation: both operands are
#               rounded to bfloat16 (the tables are stored so,
#               transform._table_dtype) and contracted at the default
#               precision, which for bf16 operands is that one pass on
#               every backend.  Gated at the reference's relaxed FLT
#               precedent (1e6*eps, tests/CMakeLists.txt:316).
# float64 operands always contract in true fp64 (Precision.HIGHEST).
_TIER_ALGORITHM = {
    "highest": jax.lax.DotAlgorithmPreset.F32_F32_F32,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}
TIERS = ("highest", "high", "bf16")


def tier_einsum(spec, a, b, precision: str = "highest"):
    """``jnp.einsum(spec, a, b)`` at a public precision tier, accumulated in
    float32-or-better; the result has the accumulation dtype."""
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {TIERS}, got {precision!r}")
    acc = jnp.promote_types(jnp.promote_types(a.dtype, b.dtype), jnp.float32)
    if acc == jnp.float64:
        return jnp.einsum(spec, a, b, precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=acc)
    if precision == "bf16":
        return jnp.einsum(spec, a.astype(jnp.bfloat16),
                          b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    return jnp.einsum(spec, a, b, precision=_TIER_ALGORITHM[precision],
                      preferred_element_type=jnp.float32)


def legendre_einsum(spec, table, x, precision: str = "highest"):
    """A Legendre contraction at a public tier.  At "highest", float32
    operands are summed in float64 (their products are exact there): the
    latitude and degree sums cancel heavily at high degree, and an fp32
    accumulation error, amplified about n-fold by UVTVD, breaks the
    reference's 100*eps vor/div round-trip gate from TCO639 up."""
    acc = jnp.promote_types(jnp.promote_types(table.dtype, x.dtype),
                            jnp.float32)
    if precision != "highest" or acc != jnp.float32:
        return tier_einsum(spec, table, x, precision)
    with jax.enable_x64(True):
        return jnp.einsum(spec, table.astype(jnp.float64),
                          x.astype(jnp.float64),
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float64
                          ).astype(jnp.float32)


def legendre_inv_grouped(sym, asym, gl, precision: str = "highest"):
    """Grouped inverse Legendre transform (the GPU backend's grouped GEMMs,
    ``gpu/internal/leinv_mod.F90:273-317``).

    Both the active-latitude count ndglu(m) and the coefficient count shrink
    with m; batching contiguous m-groups with per-group-padded tensors
    recovers the ~2-2.5x triangular saving in FLOPs and table memory that one
    dense zero-padded (M, ndgnh, K) batch wastes.

    sym/asym: (nfld, 2, M, kmax); returns (nfld, 2, M, ndgl) north->south
    (recombination north = S + A, south = S - A, reference ASRE1B
    ``asre1b_mod.F90:84-102``).  ``precision`` is a public tier.
    """
    parts = []
    for g in gl.groups:
        s = sym[:, :, g.m0 : g.m1, : g.kg]
        a = asym[:, :, g.m0 : g.m1, : g.kg]
        fs = legendre_einsum("mik,fcmk->fcmi", g.psym, s, precision)
        fa = legendre_einsum("mik,fcmk->fcmi", g.pasym, a, precision)
        north = (fs + fa).astype(sym.dtype)
        south = (fs - fa).astype(sym.dtype)[..., ::-1]
        # group lats cover NH indices [i0, ndgnh) -> SH indices [ndgnh, ndgl-i0)
        pad = [(0, 0)] * 3
        parts.append(jnp.concatenate(
            [jnp.pad(north, pad + [(g.i0, 0)]), jnp.pad(south, pad + [(0, g.i0)])],
            axis=-1,
        ))
    return jnp.concatenate(parts, axis=2)


def legendre_dir_grouped(fourier, gl, w, precision: str = "highest"):
    """Grouped direct Legendre transform (quadrature-weighted transpose).

    fourier: (nfld, 2, M, ndgl) north->south; w: (ndgnh,) quadrature weights
    (ecTrans weights, sum = 1: S_even = sum_i w_i P̄_sym (F_n + F_s),
    S_odd = sum_i w_i P̄_asym (F_n - F_s), reference LEDIR).
    Returns (sym, asym) each (nfld, 2, M, kmax).
    """
    ndgnh = gl.ndgnh
    kmax = gl.kmax
    north_all = fourier[..., :ndgnh]
    south_all = fourier[..., : ndgnh - 1 : -1]  # paired with NH index
    fsym_all = (north_all + south_all) * w
    fasym_all = (north_all - south_all) * w
    # Materialise before the matmuls: a guard kept from the previous
    # accelerator, whose compiler miscompiled the reversed-latitude slice
    # fused into the per-group contractions (ROADMAP 1.4 measures it).
    fsym_all, fasym_all = jax.lax.optimization_barrier((fsym_all, fasym_all))
    syms, asyms = [], []
    for g in gl.groups:
        fsym = fsym_all[:, :, g.m0 : g.m1, g.i0 :]
        fasym = fasym_all[:, :, g.m0 : g.m1, g.i0 :]
        sym = legendre_einsum("mik,fcmi->fcmk", g.psym, fsym,
                              precision).astype(fourier.dtype)
        asym = legendre_einsum("mik,fcmi->fcmk", g.pasym, fasym,
                               precision).astype(fourier.dtype)
        pad = [(0, 0)] * 3 + [(0, kmax - g.kg)]
        syms.append(jnp.pad(sym, pad))
        asyms.append(jnp.pad(asym, pad))
    return jnp.concatenate(syms, axis=2), jnp.concatenate(asyms, axis=2)
