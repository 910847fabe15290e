"""Per-resolution immutable state: the analogue of ecTrans's TPM
modules (``tpm_dim.F90`` R, ``tpm_geometry.F90`` G, ``tpm_fields.F90`` F,
``tpm_distr.F90`` D) and of SETUP_TRANS (``setup_trans.F90``).

All precomputation happens on host in float64 NumPy; ``device_tables()``
returns a pytree of jnp arrays in the requested compute dtype, ready to be
closed over by jitted transforms.

Spectral storage layouts
------------------------
* **packed** (user-facing, ecTrans-compatible): real array ``(nfld, nspec2)``
  ordered m-major, n ascending within m, (re, im) interleaved — the NASM0
  addressing of ``suwavedi_mod.F90``.
* **dense** (internal work layout): real array ``(nfld, 2, M, NP)`` with
  ``M = nsmax+1`` zonal wavenumbers and ``NP = nsmax+2`` absolute-n rows
  (n = 0..nsmax+1; entries with n < m are zero).  The absolute-n layout makes
  the n±1 recurrences (VDTUV/SPNSDE/UVTVD) uniform shifts across all m.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

from .grids import GridSpec, make_grid
from .legendre import eps_table

EARTH_RADIUS = 6371229.0  # metres; reference default RA (setup_trans0.F90)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: ndarray fields
class Resolution:
    """Everything needed to transform at one (grid, truncation) resolution."""

    grid: GridSpec
    radius: float

    # --- host tables (numpy float64/int32) ---
    mu: np.ndarray          # (ndgl,) sin(lat), north -> south
    w: np.ndarray           # (ndgl,) Gaussian weights, sum = 1
    nmen: np.ndarray        # (ndgl,) per-lat zonal truncation
    ndglu: np.ndarray       # (M,) NH lats active per m
    psym: np.ndarray        # (M, ndgnh, K) symmetric P̄ (n-m even)
    pasym: np.ndarray       # (M, ndgnh, K) antisymmetric P̄ (n-m odd)
    kmax: int               # padded parity extent K
    eps: np.ndarray         # (M, NP+2) eps(n,m)
    rlapin: np.ndarray      # (NP+1,) -a^2/(n(n+1)), 0 at n=0
    racthe: np.ndarray      # (ndgl,) 1/(a cos(theta))
    # packed<->dense index maps
    nasm0: np.ndarray       # (M,) offset of (m, n=m, re) in packed layout
    dense_gather: np.ndarray    # (2, M, NP) int32 index into packed (+pad) or -1
    packed_gather_c: np.ndarray  # (nspec2,) c-index (0 re / 1 im)
    packed_gather_m: np.ndarray  # (nspec2,) m-index
    packed_gather_n: np.ndarray  # (nspec2,) n-index
    idx_sym: np.ndarray     # (M, K) absolute n for symmetric coeffs (or NP, the zero row)
    idx_asym: np.ndarray    # (M, K)

    # ------------------------------------------------------------------
    @property
    def nsmax(self) -> int:
        return self.grid.nsmax

    @property
    def ntmax(self) -> int:
        return self.grid.nsmax

    @property
    def M(self) -> int:
        return self.grid.nsmax + 1

    @property
    def NP(self) -> int:
        """Dense n-rows: n = 0 .. nsmax+1 (u/v spectra extend to nsmax+1)."""
        return self.grid.nsmax + 2

    @property
    def ndgl(self) -> int:
        return self.grid.ndgl

    @property
    def ndgnh(self) -> int:
        return self.grid.ndgnh

    @property
    def nspec2(self) -> int:
        return self.grid.nspec2

    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=2)
    def parity_tables(self, dtype_str: str = "float32"):
        """(psym, pasym) host tables at >= the requested precision.

        Above ECTRANS_TPU_FP64_TABLE_LIMIT the setup-time tables are built
        in float32 (device compute there is float32); when a caller then
        explicitly requests a float64 transform, the fp64 tables are built
        lazily here (and cached) so dtype=float64 always means true double
        precision — never silently fp32-table accuracy.  ``bfloat16`` (the
        half-memory table mode for very large truncations, e.g. single-chip
        TCO2047 — the FLT-precedent relaxed-accuracy tier) is served from
        the fp32 host tables; the cast happens on group upload."""
        if dtype_str != "float64" or self.psym.dtype == np.float64:
            return self.psym, self.pasym
        from .cache import load_parity_cached

        psym, pasym, kmax = load_parity_cached(
            self.grid, self.mu[: self.ndgnh], self.nmen[: self.ndgnh],
            dtype=np.float64,
        )
        assert kmax == self.kmax
        return psym, pasym

    @functools.lru_cache(maxsize=4)
    def grouped_legendre(self, dtype_str: str = "float32",
                         ngroups: int | None = None) -> "GroupedLegendre":
        """Per-m-group Legendre tensors for the grouped matmuls.

        Contiguous m-groups, each padded only to its own max active-latitude
        count ndglu(m0) and coefficient count — the analogue of the GPU
        backend's per-m packed GEMM offsets
        (``gpu/internal/sump_trans_mod.F90:273-298``).  ~2.3x smaller than the
        dense (M, ndgnh, K) batch at TCO1279.
        """
        import jax.numpy as jnp

        _ensure_pytrees()
        M, ndgnh, nmax = self.M, self.ndgnh, self.nsmax + 1
        psym, pasym = self.parity_tables(dtype_str)
        if ngroups is None:
            import os as _os

            # finer grouping tightens the staircase padding of ndglu/k (a
            # few % of table memory) at the cost of more einsum calls per
            # transform
            env = _os.environ.get("ECTRANS_TPU_LEG_GROUPS")
            ngroups = int(env) if env else max(1, min(16, M // 8))
        bs = -(-M // ngroups)
        groups = []
        for gi in range(ngroups):
            m0 = gi * bs
            m1 = min(M, m0 + bs)
            if m0 >= M:
                break
            ig = int(self.ndglu[m0])       # ndglu is non-increasing in m
            i0 = ndgnh - ig
            kg = (nmax - m0) // 2 + 1      # max parity coeff count in group
            groups.append(LegendreGroup(
                m0=m0, m1=m1, i0=i0, kg=kg,
                psym=jnp.asarray(psym[m0:m1, i0:, :kg], dtype=dtype_str),
                pasym=jnp.asarray(pasym[m0:m1, i0:, :kg], dtype=dtype_str),
            ))
        return GroupedLegendre(groups=tuple(groups), ndgnh=ndgnh, kmax=self.kmax)

    @functools.lru_cache(maxsize=4)
    def device_tables(self, dtype: Any = np.float32) -> "DeviceTables":
        import jax.numpy as jnp

        _ensure_pytrees()
        f = lambda x: jnp.asarray(x, dtype=dtype)
        i = lambda x: jnp.asarray(x, dtype=jnp.int32)
        nn = np.arange(self.NP)[None, :]
        mm = np.arange(self.M)[:, None]
        dense_valid = ((nn >= mm) & (nn <= self.nsmax)).astype(np.float64)
        return DeviceTables(
            nasm0=i(self.nasm0),
            dense_valid=f(dense_valid),
            w=f(self.w),
            eps=f(self.eps),
            rlapin=f(self.rlapin),
            racthe=f(self.racthe),
            nmen=i(self.nmen),
            dense_gather=i(self.dense_gather),
            packed_gather_c=i(self.packed_gather_c),
            packed_gather_m=i(self.packed_gather_m),
            packed_gather_n=i(self.packed_gather_n),
            idx_sym=i(self.idx_sym),
            idx_asym=i(self.idx_asym),
        )


@dataclasses.dataclass(frozen=True)
class LegendreGroup:
    """One contiguous m-group: tensors (m1-m0, ndgnh-i0, kg)."""

    m0: int
    m1: int
    i0: int     # first active NH latitude index (= ndgnh - ndglu(m0))
    kg: int     # parity coefficient extent for this group
    psym: Any
    pasym: Any


@dataclasses.dataclass(frozen=True)
class GroupedLegendre:
    groups: tuple
    ndgnh: int
    kmax: int


def _register_pytrees():
    """Register the table containers as JAX pytrees so they are passed to
    jitted kernels as runtime *arguments* — never closed over (a closed-over
    multi-GB table would be embedded into the HLO as a constant, which both
    bloats compile payloads and defeats buffer reuse)."""
    import jax

    jax.tree_util.register_dataclass(
        LegendreGroup,
        data_fields=["psym", "pasym"],
        meta_fields=["m0", "m1", "i0", "kg"],
    )
    jax.tree_util.register_dataclass(
        GroupedLegendre,
        data_fields=["groups"],
        meta_fields=["ndgnh", "kmax"],
    )
    jax.tree_util.register_dataclass(
        DeviceTables,
        data_fields=[f.name for f in dataclasses.fields(DeviceTables)],
        meta_fields=[],
    )


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Device-resident arrays (the analogue of the GPU backend's FG state,
    tpm_fields_gpu.F90).  The Legendre tensors themselves live in
    ``GroupedLegendre`` (grouped, memory-tight); DeviceTables holds the small
    per-resolution coefficient/index tables."""

    nasm0: Any
    dense_valid: Any   # (M, NP) 1.0 where m <= n <= nsmax
    w: Any
    eps: Any
    rlapin: Any
    racthe: Any
    nmen: Any
    dense_gather: Any
    packed_gather_c: Any
    packed_gather_m: Any
    packed_gather_n: Any
    idx_sym: Any
    idx_asym: Any


def _build_packed_maps(nsmax: int, NP: int):
    """Index maps between packed (NASM0) and dense (c, m, n) layouts."""
    M = nsmax + 1
    nasm0 = np.zeros(M, dtype=np.int64)
    off = 0
    for m in range(M):
        nasm0[m] = off
        off += 2 * (nsmax - m + 1)
    nspec2 = off

    dense_gather = np.full((2, M, NP), -1, dtype=np.int64)
    pc = np.zeros(nspec2, dtype=np.int64)
    pm = np.zeros(nspec2, dtype=np.int64)
    pn = np.zeros(nspec2, dtype=np.int64)
    for m in range(M):
        for n in range(m, nsmax + 1):
            base = nasm0[m] + 2 * (n - m)
            dense_gather[0, m, n] = base
            dense_gather[1, m, n] = base + 1
            pc[base], pm[base], pn[base] = 0, m, n
            pc[base + 1], pm[base + 1], pn[base + 1] = 1, m, n
    # map -1 to an extra zero slot appended by the converter
    dense_gather = np.where(dense_gather < 0, nspec2, dense_gather)
    return nasm0, dense_gather, pc, pm, pn


def _build_parity_maps(nsmax: int, NP: int, kmax: int):
    """idx_sym[m,k] = m+2k (absolute n), idx_asym[m,k] = m+1+2k; NP = zero row."""
    M = nsmax + 1
    idx_sym = np.full((M, kmax), NP, dtype=np.int64)
    idx_asym = np.full((M, kmax), NP, dtype=np.int64)
    nmax = NP - 1  # = nsmax+1
    for m in range(M):
        ks = np.arange((nmax - m) // 2 + 1)
        idx_sym[m, : ks.size] = m + 2 * ks
        ka = np.arange((nmax - m - 1) // 2 + 1) if m + 1 <= nmax else np.arange(0)
        idx_asym[m, : ka.size] = m + 1 + 2 * ka
    return idx_sym, idx_asym


def printlev() -> int:
    """Verbosity level (the reference NPRINTLEV, ``tpm_gen.F90``):
    0 silent (default), 1 setup banners, 2 detailed tables.  Set via
    ECTRANS_TPU_PRINTLEV."""
    import os

    try:
        return int(os.environ.get("ECTRANS_TPU_PRINTLEV", "0"))
    except ValueError:
        return 0


def _setup_banner(res: "Resolution") -> None:
    """Setup banner at NPRINTLEV >= 1 (reference setup_trans0.F90:115-153)."""
    import sys

    from . import __version__

    g = res.grid
    print(f"ectrans_tpu {__version__}: setup T{res.nsmax} "
          f"ndgl={res.ndgl} ndlon={g.ndlon} ngptot={g.ngptot} "
          f"nspec2={res.nspec2} tables={res.psym.dtype}", file=sys.stderr)
    if printlev() >= 2:
        tbytes = res.psym.nbytes + res.pasym.nbytes
        print(f"  legendre tables: {tbytes/1e9:.2f} GB host "
              f"(kmax={res.kmax}, ndgnh={res.ndgnh}); "
              f"radius={res.radius}", file=sys.stderr)
        print(f"  nloen: {g.nloen[0]}..{max(g.nloen)}; "
              f"nmen: {int(res.nmen[0])}..{int(res.nmen.max())}",
              file=sys.stderr)


_CURRENT: list = []  # most-recently set up Resolution (GET_CURRENT parity)


def get_current() -> "Resolution | None":
    """Most recently set-up Resolution (reference GET_CURRENT,
    ``get_current.F90``); None before any setup."""
    return _CURRENT[-1] if _CURRENT else None


def trans_end() -> None:
    """Release every cached resolution and its device tables (reference
    TRANS_END, ``trans_end.F90``).  Live Resolution objects held by the
    caller keep working; this only drops the framework-held caches."""
    _CURRENT.clear()
    _setup_cached.cache_clear()
    Resolution.parity_tables.cache_clear()
    Resolution.grouped_legendre.cache_clear()
    Resolution.device_tables.cache_clear()
    from .ops import fourier

    fourier.host_bluestein_tables.cache_clear()
    fourier.build_bluestein_tables.cache_clear()
    fourier.bucketed_tables.cache_clear()
    fourier.uniform_dft_tables.cache_clear()
    from . import transform as _t

    _t._coeff_tables.cache_clear()
    from . import latlon as _ll

    _ll._latlon_tables.cache_clear()
    _ll._latlon_interp_matrix.cache_clear()
    from .lam.resolution import LamResolution, setup_lam

    LamResolution.device_tables.cache_clear()
    setup_lam.cache_clear()
    from . import compat4py as _c4

    _c4._lam_res.cache_clear()
    from .parallel import distribution as _pd

    _pd.clear_caches()


def ini_spec_dist(nsmax: int, nprtrw: int) -> dict:
    """Spectral wave distribution without a full setup (reference
    INI_SPEC_DIST, ``ini_spec_dist.F90`` -> SUWAVEDI): boustrophedon
    assignment of zonal wavenumbers to nprtrw wave sets.

    Returns dict with ``myms`` (tuple of m-lists per set), ``numpp``
    (wavenumber count per set), ``nspec2`` (real-coefficient count per
    set), ``nasm0`` (global packed offsets), ``nspec2_g``.
    """
    from .parallel.distribution import pingpong_blocks

    M = nsmax + 1
    blocks = pingpong_blocks(M, nprtrw)
    nasm0 = np.zeros(M, dtype=np.int64)
    off = 0
    for m in range(M):
        nasm0[m] = off
        off += 2 * (nsmax - m + 1)
    return {
        "myms": tuple(tuple(b) for b in blocks),
        "numpp": tuple(len(b) for b in blocks),
        "nspec2": tuple(
            int(sum(2 * (nsmax - m + 1) for m in b)) for b in blocks
        ),
        "nasm0": nasm0,
        "nspec2_g": int(off),
    }


_PYTREES_REGISTERED = False


def _ensure_pytrees():
    global _PYTREES_REGISTERED
    if not _PYTREES_REGISTERED:
        _register_pytrees()
        _PYTREES_REGISTERED = True


def setup(grid_or_name: Any, nsmax: int | None = None,
          radius: float = EARTH_RADIUS, stretch: float = 1.0) -> Resolution:
    """Build a Resolution (the SETUP_TRANS equivalent).

    ``setup("O48", 47)`` or ``setup("TCO159")`` or ``setup(GridSpec(...))``.
    Heavy host precompute (Gauss nodes, Legendre tables) is cached in-process;
    see ``ectrans_tpu.cache`` for the on-disk legpol cache.

    ``stretch`` is the Schmidt stretching factor (reference PSTRET,
    ``setup_trans.F90:49``): when != 1 the Legendre polynomials are
    evaluated at the stretched latitudes mu' = (t + mu)/(1 + t*mu),
    t = (1 - c^2)/(1 + c^2) (``suleg_mod.F90:272-287``), while the
    Gaussian quadrature weights stay those of the computational sphere.

    Precision note: setup-time Legendre tables are built in float64 up to
    nsmax = ECTRANS_TPU_FP64_TABLE_LIMIT (default 800) and in float32 above
    it (matching the float32 device compute there).  A transform called
    with an explicit ``dtype=float64`` always gets true fp64 tables — they
    are built lazily on first use (``Resolution.parity_tables``).
    """
    if isinstance(grid_or_name, GridSpec):
        grid = grid_or_name
    else:
        grid = make_grid(grid_or_name, nsmax)
    res = _setup_cached(grid, radius, stretch)
    if not _CURRENT or _CURRENT[-1] is not res:
        _CURRENT.append(res)
        del _CURRENT[:-4]  # keep a short history only
        if printlev() >= 1:
            _setup_banner(res)
    return res


@functools.lru_cache(maxsize=16)
def _setup_cached(grid: GridSpec, radius: float, stretch: float) -> Resolution:
    return _setup_from_grid(grid, radius, stretch)


def _setup_from_grid(grid: GridSpec, radius: float,
                     stretch: float = 1.0) -> Resolution:
    nsmax = grid.nsmax
    M = nsmax + 1
    NP = nsmax + 2
    mu, w = grid.gauss()
    nmen = grid.nmen()
    ndglu = grid.ndglu()
    if abs(stretch - 1.0) > 1e-13:
        t = (1.0 - stretch**2) / (1.0 + stretch**2)
        nh = grid.ndgnh
        mu_s = np.empty_like(mu)
        mu_s[:nh] = (t + mu[:nh]) / (1.0 + t * mu[:nh])
        mu_s[nh:] = (t - mu[:nh][::-1]) / (1.0 - t * mu[:nh][::-1])
        mu = mu_s
    mu_nh = mu[: grid.ndgnh]

    from .cache import load_parity_cached

    # Host tables in fp64 for modest resolutions (exact fp64 transforms);
    # above ECTRANS_TPU_FP64_TABLE_LIMIT the tables are built fp32 —
    # device compute is fp32 there anyway and the table build/transfer is
    # memory-bound (the reference's own single-precision build precedent).
    import os as _os

    fp64_limit = int(_os.environ.get("ECTRANS_TPU_FP64_TABLE_LIMIT", "800"))
    tdtype = np.float64 if nsmax <= fp64_limit else np.float32
    psym, pasym, kmax = load_parity_cached(
        grid, mu_nh, nmen[: grid.ndgnh], dtype=tdtype
    )

    eps = eps_table(nsmax, 3)
    n_arr = np.arange(NP + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        rlapin = np.where(n_arr > 0, -(radius * radius) / (n_arr * (n_arr + 1.0)), 0.0)
    costh = np.sqrt(np.maximum(1e-300, 1.0 - mu * mu))
    racthe = 1.0 / costh / radius

    nasm0, dense_gather, pc, pm, pn = _build_packed_maps(nsmax, NP)
    idx_sym, idx_asym = _build_parity_maps(nsmax, NP, kmax)

    return Resolution(
        grid=grid,
        radius=radius,
        mu=mu,
        w=w,
        nmen=nmen,
        ndglu=ndglu,
        psym=psym,
        pasym=pasym,
        kmax=kmax,
        eps=eps,
        rlapin=rlapin,
        racthe=racthe,
        nasm0=nasm0,
        dense_gather=dense_gather,
        packed_gather_c=pc,
        packed_gather_m=pm,
        packed_gather_n=pn,
        idx_sym=idx_sym,
        idx_asym=idx_asym,
    )
