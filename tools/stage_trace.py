"""Device time per stage of the round trip, from one profiler trace.

    python tools/stage_trace.py OUT_DIR [CONFIG]

Runs the chip_smoke field set (2 vor/div pairs + 6 scalars with scalar and
wind derivatives, fp32, tier "highest") at CONFIG (default TCO1279),
warms up, then traces ``ROUND_TRIPS`` round trips with ``jax.profiler``
into OUT_DIR.  Every device kernel of the trace is attributed to the
innermost ``jax.named_scope`` of the HLO instruction it ran (scopes set in
``ectrans_tpu/transform.py``), read from the optimized HLO of the three
transform programs.  Prints one JSON line: per-stage device seconds per
round trip, the bytes each memory-bound stage must move (computed from
shapes), and the device's busy and idle share of the traced window.

Needs a GPU; writes only under OUT_DIR.  Adds
``--xla_gpu_enable_command_buffer=`` to ``XLA_FLAGS`` (one trace event per
kernel), so its programs compile apart from the other entry points'.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import NFLD_SC, NFLD_UV, card_label, packed_spectra  # noqa: E402
from chip_smoke import require_gpu  # noqa: E402

ROUND_TRIPS = 3
# innermost first: a kernel counts for the first scope its op_name holds
SCOPES = ("unpack", "pack", "legendre_inv", "legendre_dir", "spectral_inv",
          "spectral_dir", "fourier_synthesis", "fourier_analysis")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def hlo_scopes(hlo_text: str) -> dict:
    """instruction name -> stage, from an optimized HLO module's text."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            parts = m.group(2).split("/")
            out[m.group(1)] = next((s for s in SCOPES if s in parts), "other")
    return out


def reduce_trace(xplane_path: str, scopes_by_module: dict) -> dict:
    """Sum device kernel time per stage; busy = union of kernel intervals."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    per_stage = collections.Counter()
    intervals = []
    unmatched = collections.Counter()
    line_names = collections.Counter()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        # kernel events sit on the per-stream lines; other lines summarise
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            line_names[line.name] += 1
            for ev in line.events:
                stats = dict(ev.stats)
                module = str(stats.get("hlo_module", ""))
                op = str(stats.get("hlo_op", ""))
                table = next((v for k, v in scopes_by_module.items()
                              if module and (k in module or module in k)),
                             None)
                stage = table.get(op) if table is not None else None
                if stage is None:
                    unmatched[f"{module}:{op or ev.name}"[:80]] += ev.duration_ns
                    stage = "unattributed"
                per_stage[stage] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end = 0, None
    start = intervals[0][0] if intervals else 0
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (end - start) if intervals else 0
    return {"stage_ns": dict(per_stage), "busy_ns": busy, "window_ns": window,
            "unmatched_top": unmatched.most_common(10),
            "lines": sorted(line_names)}


def main():
    # one trace event per kernel: CUDA-graph command buffers would fold a
    # whole program into one event
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax
    import jax.numpy as jnp

    out_dir = sys.argv[1]
    config = sys.argv[2] if len(sys.argv) > 2 else "TCO1279"
    devices = jax.devices()
    require_gpu(devices)
    from ectrans_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import ectrans_tpu as et
    from ectrans_tpu import transform
    from ectrans_tpu.ops import fourier

    res = et.setup(config)
    flags = et.InvFlags(scders=True, uvders=True)
    rng = np.random.default_rng(0)
    spvor, spdiv, spsc = (jnp.asarray(packed_spectra(res, n, rng))
                          for n in (NFLD_UV, NFLD_UV, NFLD_SC))

    def step():
        grid = et.inv_trans(res, spvor=spvor, spdiv=spdiv, spscalar=spsc,
                            flags=flags)
        return et.dir_trans(res, u=grid[:NFLD_UV],
                            v=grid[NFLD_UV : 2 * NFLD_UV],
                            scalars=grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC])

    for _ in range(3):
        jax.block_until_ready(step())

    # optimized HLO of the three programs, for kernel -> scope attribution
    dtype = jnp.float32
    tables = res.device_tables(dtype)
    gl = res.grouped_legendre("float32")
    ct = transform._coeff_tables(res, "float32")
    bt = fourier.bucketed_tables_for(res, dtype)
    grid = transform._inv_impl(tables, gl, ct, bt, spvor, spdiv, spsc, flags)
    u, v = grid[:NFLD_UV], grid[NFLD_UV : 2 * NFLD_UV]
    sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
    four = transform._dir_ana_impl(tables, bt, u, v, sc)
    lowered = {
        "_inv_impl": transform._inv_impl.lower(
            tables, gl, ct, bt, spvor, spdiv, spsc, flags),
        "_dir_ana_impl": transform._dir_ana_impl.lower(tables, bt, u, v, sc),
        "_dir_lt_impl": transform._dir_lt_impl.lower(
            tables, gl, ct, four, NFLD_UV, True),
    }
    scopes_by_module = {k: hlo_scopes(lo.compile().as_text())
                        for k, lo in lowered.items()}

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    jax.profiler.start_trace(out_dir)
    for _ in range(ROUND_TRIPS):
        jax.block_until_ready(step())
    jax.profiler.stop_trace()
    wall = (time.perf_counter() - t0) / ROUND_TRIPS
    paths = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    red = reduce_trace(paths[-1], scopes_by_module)

    nfld_lt = 2 * NFLD_UV + 2 * NFLD_SC   # u, v, scalars, N-S derivatives
    table_bytes = sum(g.psym.nbytes + g.pasym.nbytes for g in gl.groups)
    packed_bytes = res.nspec2 * 4
    print(json.dumps({
        "config": config,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": card_label(),
        "round_trips": ROUND_TRIPS,
        "wall_s_per_round_trip": wall,
        "stage_s_per_round_trip": {k: v / ROUND_TRIPS / 1e9
                                   for k, v in red["stage_ns"].items()},
        "busy_share": red["busy_ns"] / max(1, red["window_ns"]),
        "idle_share": 1 - red["busy_ns"] / max(1, red["window_ns"]),
        "window_s": red["window_ns"] / 1e9 / ROUND_TRIPS,
        "legendre_table_bytes_per_direction": table_bytes,
        "legendre_fields_inv": nfld_lt,
        "packed_bytes_per_field": packed_bytes,
        "packed_fields_each_way": 2 * NFLD_UV + NFLD_SC,
        "unmatched_top": red["unmatched_top"],
        "trace_lines": red["lines"],
        "xplane": paths[-1],
    }))


if __name__ == "__main__":
    main()
