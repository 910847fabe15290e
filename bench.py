"""Benchmark: inverse+direct spectral-transform round trip on one GPU.

Mirrors the reference benchmark driver (``src/programs/ectrans-benchmark.F90``:
a timed inv_trans/dir_trans loop with a correctness gate).  For each config
in ``ECTRANS_BENCH_CONFIGS`` (default ``TCO1279,TCO639``; TCO1279 is the
reference's headline resolution) it runs 10 fields — 2 vor/div pairs and 6
scalars, with scalar and wind derivatives — in fp32 at the precision tier
``ECTRANS_BENCH_PRECISION`` (default ``highest``).

Correctness gate per field family (vor, div, scalars): the reference's ctest
multiple of machine epsilon, 100*eps(fp32) of the family's max
(``ectrans-benchmark.F90:850-860``, ``tests/CMakeLists.txt:262``); the bf16
tier uses the reference's relaxed FLT precedent (1e6*eps,
``tests/CMakeLists.txt:316``).

Each timed round trip ends in ``block_until_ready``.  Prints ONE JSON line
with the device (platform, kind, count) and the card's name and power limit
beside the numbers.  Exits non-zero when JAX finds no GPU, or when any config
raises or fails its gate.

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from chip_smoke import NFLD_SC, NFLD_UV, card_label, family_errors, gate_ok
from chip_smoke import packed_spectra, require_gpu

ITERS = 10
WARMUP = 2
PRECISION = os.environ.get("ECTRANS_BENCH_PRECISION", "highest")


def run(config: str) -> dict:
    import jax
    import jax.numpy as jnp

    import ectrans_tpu as et

    t0 = time.perf_counter()
    res = et.setup(config)
    t_setup = time.perf_counter() - t0
    flags = et.InvFlags(scders=True, uvders=True)
    rng = np.random.default_rng(0)
    spvor, spdiv, spsc = (jnp.asarray(packed_spectra(res, n, rng))
                          for n in (NFLD_UV, NFLD_UV, NFLD_SC))

    def step():
        grid = et.inv_trans(res, spvor=spvor, spdiv=spdiv, spscalar=spsc,
                            flags=flags, precision=PRECISION)
        u = grid[0:NFLD_UV]
        v = grid[NFLD_UV : 2 * NFLD_UV]
        sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
        return et.dir_trans(res, u=u, v=v, scalars=sc, precision=PRECISION)

    t0 = time.perf_counter()
    out = jax.block_until_ready(step())
    t_first = time.perf_counter() - t0
    ncheck = 1e6 if PRECISION == "bf16" else 100
    rows = family_errors(out, (spvor, spdiv, spsc), ncheck=ncheck)
    for _ in range(WARMUP):
        jax.block_until_ready(step())
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    nfld = 2 * NFLD_UV + NFLD_SC  # u, v, scalars transformed both ways
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "ok": gate_ok(rows),
        "setup_s": t_setup,
        "first_call_s": t_first,
        "sec_per_roundtrip_median": dt,
        "roundtrip_s": times,
        "gridpoint_fields_per_s": res.grid.ngptot * nfld / dt,
        "nfld": nfld,
        "gate": {name: {"err": err, "gate": gate}
                 for name, err, gate in rows},
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def main():
    import jax

    devices = jax.devices()
    require_gpu(devices)
    from ectrans_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    label = card_label()
    configs = os.environ.get("ECTRANS_BENCH_CONFIGS",
                             "TCO1279,TCO639").split(",")
    results = {}
    for config in configs:
        results[config] = run(config)
        print(f"# {config}: {results[config]['sec_per_roundtrip_median']:.6f}"
              f" s per round trip [{label}]", file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "inv+dir round trip",
        "precision": PRECISION,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": label,
        "configs": results,
    }))
    if not all(r["ok"] for r in results.values()):
        raise SystemExit("bench: correctness gate failed")


if __name__ == "__main__":
    main()
