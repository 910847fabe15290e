"""On-disk cache for the Legendre-polynomial setup product.

The equivalent of the reference's legpol checkpoint/restore
(``CDIO_LEGPOL='READF'/'WRITEF'/'MEMBUF'``, ``setup_trans.F90:360-384``,
``read_legpol_mod.F90`` / ``write_legpol_mod.F90``): the expensive setup
product (the dense P̄ table) is cached as an ``.npz`` keyed by
(grid name, truncation, ndgl), so repeated setups at large resolutions skip
the O(M·N·nlat) recurrence.

Set ``ECTRANS_TPU_LEGPOL_DIR`` to move the cache; set it to the empty string
to disable on-disk caching entirely.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

from .grids import GridSpec
from .legendre import build_parity_tables


def _cache_dir() -> pathlib.Path | None:
    env = os.environ.get("ECTRANS_TPU_LEGPOL_DIR")
    if env == "":
        return None
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "ectrans_tpu" / "legpol"


def _cache_key(grid: GridSpec, dtype, mu_nh: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(
        repr((grid.name, grid.nsmax, grid.ndgl, grid.nloen, np.dtype(dtype).name)).encode()
    )
    # latitude set is part of the key (stretched-sphere setups share a grid)
    h.update(np.ascontiguousarray(mu_nh).tobytes())
    return f"legpol_{grid.name}_T{grid.nsmax}_{h.hexdigest()[:12]}.npz"


def load_parity_cached(
    grid: GridSpec, mu_nh: np.ndarray, nmen_nh: np.ndarray, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, int]:
    """(psym, pasym, kmax) parity tables, from disk cache if available.

    Cache format: raw ``.npy`` files loaded with ``mmap_mode="r"`` —
    ``np.load`` of a multi-GiB ``.npz`` member costs minutes on this host
    (single-core chunked copy + page faults; measured 364 s for 2.1 GiB at
    TCO639), while a memmap is instant and downstream per-group slicing
    reads pages at disk/page-cache speed.  Legacy ``.npz`` entries are
    converted in place on first touch.  Set ``ECTRANS_TPU_LEGPOL_DIR=""``
    to disable caching.
    """
    d = _cache_dir()
    if d is not None:
        base = d / _cache_key(grid, dtype, mu_nh)
        got = _read_npy_pair(base)
        if got is None and base.exists():
            got = _convert_npz(base)  # legacy .npz entry
        if got is not None:
            return got
    psym, pasym, kmax = build_parity_tables(
        grid.nsmax, mu_nh, ntmax_extra=1, nmen_nh=nmen_nh, dtype=dtype
    )
    if d is not None:
        try:
            d.mkdir(parents=True, exist_ok=True)
            base = d / _cache_key(grid, dtype, mu_nh)
            for name, arr in (("psym", psym), ("pasym", pasym)):
                tmp = d / f".tmp{os.getpid()}_{name}.npy"
                np.save(tmp, arr)
                os.replace(tmp, _npy_path(base, name))
        except Exception:
            pass  # cache write failure is non-fatal
    return psym, pasym, kmax


def _npy_path(base: pathlib.Path, name: str) -> pathlib.Path:
    return base.with_suffix(f".{name}.npy")


def _read_npy_pair(base: pathlib.Path):
    ps_p, pa_p = _npy_path(base, "psym"), _npy_path(base, "pasym")
    if not (ps_p.exists() and pa_p.exists()):
        return None
    try:
        psym = np.load(ps_p, mmap_mode="r")
        pasym = np.load(pa_p, mmap_mode="r")
        return psym, pasym, int(psym.shape[2])
    except Exception:
        return None


def _convert_npz(path: pathlib.Path):
    """Extract a legacy .npz cache entry into the .npy pair (members of an
    uncompressed npz ARE npy files — a pure streaming copy, no parse)."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as z:
            for name in ("psym", "pasym"):
                tmp = path.parent / f".tmp{os.getpid()}_{name}.npy"
                with z.open(name + ".npy") as src, open(tmp, "wb") as dst:
                    while True:
                        buf = src.read(1 << 24)
                        if not buf:
                            break
                        dst.write(buf)
                os.replace(tmp, _npy_path(path, name))
        path.unlink(missing_ok=True)
        return _read_npy_pair(path)
    except Exception:
        return None


def clear_cache() -> None:
    d = _cache_dir()
    if d is not None and d.exists():
        for p in d.glob("legpol_*"):
            p.unlink(missing_ok=True)
