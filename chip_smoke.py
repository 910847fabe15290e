"""Smoke test of the spectral transforms on NVIDIA GPUs, at TCO1279.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # ShardedTransform over four cards

One card, in order:
  1. device check: the first JAX device must be a GPU (no CPU fallback);
  2. setup: ``et.setup("TCO1279")`` plus the host-built grouped Legendre
     and Fourier tables, uploaded to the card (set-up time);
  3. round trip through ``et.inv_trans``/``et.dir_trans`` with the benchmark
     field set (2 vor/div pairs + 6 scalars, scalar and wind derivatives,
     fp32, precision "highest"), gated per family at the reference's
     100*eps(fp32) (``ectrans-benchmark.F90:850-860``);
  4. the grouped inverse Legendre contraction of the two largest m-groups at
     16 fields against a NumPy fp64 product of the same host tables;
  5. five timed round trips.

``--four-cards`` runs only ShardedTransform over meshes (4, 1) and (2, 2)
against the single-card transforms on device 0 of the same process.

Exits non-zero if any phase fails.  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time

import numpy as np

CONFIG = "TCO1279"
NFLD_UV = 2
NFLD_SC = 6
NCHECK = 100           # the reference ctest multiple of machine epsilon
TIMED_ROUND_TRIPS = 5
REF_GROUPS = 2         # largest m-groups checked against NumPy fp64
REF_FIELDS = 16        # fields through the inverse Legendre contraction
MESHES = ((4, 1), (2, 2))
EPS32 = float(np.finfo(np.float32).eps)


def require_gpu(devices) -> None:
    """Stop unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX's first device is "
                         f"{plat!r}")


def card_label() -> str:
    """Name and power limit of the cards, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def family_errors(got, ref, drop_mean=(True, True, False), ncheck=NCHECK):
    """Spectral round-trip gate per family (vor, div, scalars).

    Returns [(name, err, gate)] with err = max|got - ref| and gate =
    ncheck * eps(fp32) * max|ref|.  Families flagged in ``drop_mean`` skip
    the (m=0, n=0) coefficient: a global-mean vorticity or divergence
    carries no wind, and the reference's UVTVD also returns 0 there.
    """
    rows = []
    for name, g, r, drop in zip(("vor", "div", "sc"), got, ref, drop_mean):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(r, np.float64))
        if drop:
            d[:, :2] = 0.0
        err = float(d.max())
        gate = ncheck * EPS32 * float(np.abs(np.asarray(r)).max())
        rows.append((name, err, gate))
    return rows


def gate_ok(rows) -> bool:
    return all(np.isfinite(err) and err <= gate for _, err, gate in rows)


def packed_spectra(res, n, rng):
    """n random packed fp32 spectra; the m=0 imaginary parts and the
    (m=0, n=0) coefficient are zero."""
    x = rng.standard_normal((n, res.nspec2)).astype(np.float32)
    x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0   # m=0 imaginary parts
    x[:, 0] = 0.0
    return x


def _print_rows(title, rows):
    for name, err, gate in rows:
        flag = "ok" if np.isfinite(err) and err <= gate else "FAIL"
        print(f"{title} {name}: err {err:.6e} gate {gate:.6e} {flag}")


def legendre_reference_check(res, gl, precision, rng):
    """Grouped inverse Legendre of the first REF_GROUPS m-groups (the
    largest tables) on the card against a NumPy fp64 product of the same
    host tables.  Returns max|got - ref| / max|ref|."""
    import jax.numpy as jnp

    from ectrans_tpu.ops import legendre_matmul
    from ectrans_tpu.resolution import GroupedLegendre

    groups = gl.groups[:REF_GROUPS]
    sub = GroupedLegendre(groups=groups, ndgnh=gl.ndgnh, kmax=gl.kmax)
    mtop = groups[-1].m1
    sym = rng.standard_normal((REF_FIELDS, 2, mtop, res.kmax)).astype(np.float32)
    asym = rng.standard_normal((REF_FIELDS, 2, mtop, res.kmax)).astype(np.float32)
    got = np.asarray(legendre_matmul.legendre_inv_grouped(
        jnp.asarray(sym), jnp.asarray(asym), sub, precision=precision))
    psym, pasym = res.parity_tables("float32")
    ref = np.zeros(got.shape, np.float64)
    nh, fc = res.ndgnh, 2 * REF_FIELDS
    for g in groups:
        def contract(table, x):
            p = np.asarray(table[g.m0 : g.m1, g.i0 :, : g.kg], np.float64)
            xs = x[:, :, g.m0 : g.m1, : g.kg].astype(np.float64)
            xs = xs.transpose(2, 3, 0, 1).reshape(g.m1 - g.m0, g.kg, fc)
            out = np.matmul(p, xs)                       # (gm, ig, fc)
            return out.reshape(out.shape[:2] + (REF_FIELDS, 2)
                               ).transpose(2, 3, 0, 1)   # (f, c, gm, ig)
        fs, fa = contract(psym, sym), contract(pasym, asym)
        ref[:, :, g.m0 : g.m1, g.i0 : nh] = fs + fa
        ref[:, :, g.m0 : g.m1, nh : res.ndgl - g.i0] = (fs - fa)[..., ::-1]
    return rel_err(got, ref)


def one_card(label, config=CONFIG):
    import jax
    import jax.numpy as jnp

    import ectrans_tpu as et
    from ectrans_tpu import native
    from ectrans_tpu.ops import fourier

    flags = et.InvFlags(scders=True, uvders=True)
    dtype = jnp.float32

    # -- 2. setup ---------------------------------------------------------
    t0 = time.perf_counter()
    res = et.setup(config)
    t_host = time.perf_counter() - t0
    gl = res.grouped_legendre("float32")
    res.device_tables(dtype)
    bt = fourier.bucketed_tables_for(res, dtype)
    jax.block_until_ready((gl, bt))
    t_setup = time.perf_counter() - t0
    print(f"setup {config}: T{res.nsmax} ndgl {res.ndgl} ngptot "
          f"{res.grid.ngptot} nspec2 {res.nspec2}; native builder "
          f"{'yes' if native.available() else 'no'}")
    print(f"setup seconds {t_setup:.3f} (host recurrence {t_host:.3f}); "
          f"host peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

    # -- 3. round trip + per-family gate ----------------------------------
    rng = np.random.default_rng(0)
    spvor, spdiv, spsc = (jnp.asarray(packed_spectra(res, n, rng))
                          for n in (NFLD_UV, NFLD_UV, NFLD_SC))

    def step():
        grid = et.inv_trans(res, spvor=spvor, spdiv=spdiv, spscalar=spsc,
                            flags=flags, dtype=dtype, precision="highest")
        u = grid[:NFLD_UV]
        v = grid[NFLD_UV : 2 * NFLD_UV]
        sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
        return et.dir_trans(res, u=u, v=v, scalars=sc, dtype=dtype,
                            precision="highest")

    t0 = time.perf_counter()
    out = jax.block_until_ready(step())
    t_first = time.perf_counter() - t0
    print(f"compile seconds (first round trip, compile + run) {t_first:.3f}")
    rows = family_errors(out, (spvor, spdiv, spsc))
    _print_rows("round trip", rows)
    if not gate_ok(rows):
        raise SystemExit("chip_smoke: round-trip gate failed")

    # -- 4. plain-reference check of the Legendre contraction -------------
    tol = NCHECK * EPS32
    errs = {}
    for tier in ("highest", "high", "bf16"):
        errs[tier] = legendre_reference_check(res, gl, tier,
                                              np.random.default_rng(1))
        print(f"legendre groups 0-{REF_GROUPS - 1} x {REF_FIELDS} fields, "
              f"tier {tier}: rel max err vs numpy fp64 {errs[tier]:.3e}"
              + (f" (tolerance {tol:.3e})" if tier == "highest" else
                 " (not gated)"))
    if not errs["highest"] <= tol:
        raise SystemExit("chip_smoke: Legendre contraction off its fp64 "
                         "reference")

    # -- 5. timed round trips ---------------------------------------------
    jax.block_until_ready(step())
    times = []
    for _ in range(TIMED_ROUND_TRIPS):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        times.append(time.perf_counter() - t0)
    nfld = 2 * NFLD_UV + NFLD_SC
    mean = float(np.mean(times))
    print(f"[{label}] round trip seconds: "
          + " ".join(f"{t:.6f}" for t in times)
          + f"; mean {mean:.6f}")
    print(f"[{label}] grid-point*fields/s {res.grid.ngptot * nfld / mean:.6e}"
          f" ({nfld} fields)")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use", 0)
    print(f"[{label}] device peak_bytes_in_use {peak} "
          f"({peak / 2**30:.3f} GiB)")


def four_cards(label, config=CONFIG):
    import jax
    import jax.numpy as jnp

    import ectrans_tpu as et
    from ectrans_tpu.field_layout import FieldLayout
    from ectrans_tpu.parallel import ShardedTransform, make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, found "
                         f"{len(devices)}")
    flags = et.InvFlags(scders=True, uvders=True)
    t0 = time.perf_counter()
    res = et.setup(config)
    print(f"setup {config} seconds {time.perf_counter() - t0:.3f}")
    rng = np.random.default_rng(0)
    spvor, spdiv, spsc = (packed_spectra(res, n, rng)
                          for n in (NFLD_UV, NFLD_UV, NFLD_SC))

    # single-card reference on device 0
    with jax.default_device(devices[0]):
        grid1 = et.inv_trans(res, spvor=jnp.asarray(spvor),
                             spdiv=jnp.asarray(spdiv),
                             spscalar=jnp.asarray(spsc), flags=flags)
        u1 = grid1[:NFLD_UV]
        v1 = grid1[NFLD_UV : 2 * NFLD_UV]
        s1 = grid1[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
        spec1 = et.dir_trans(res, u=u1, v=v1, scalars=s1)
        grid1_h = np.asarray(grid1)
        spec1_h = [np.asarray(x) for x in spec1]
        u1, v1, s1 = (np.asarray(x) for x in (u1, v1, s1))
    layout = FieldLayout.inv(NFLD_UV, NFLD_SC, flags)
    ok = True
    for w, v in MESHES:
        t0 = time.perf_counter()
        mesh = make_mesh(w, v, devices[:4])
        st = ShardedTransform(res, mesh, dtype=jnp.float32)
        kvsetuv = [0, v - 1]
        kvsetsc = [v - 1, 0, 0, v - 1, 0, 0]
        grid = st.inv_trans(spvor=spvor, spdiv=spdiv, spscalar=spsc,
                            flags=flags, kvsetuv=kvsetuv, kvsetsc=kvsetsc)
        spec = st.dir_trans(u=u1, v=v1, scalars=s1)
        jax.block_until_ready((grid, spec))
        print(f"mesh ({w},{v}): tables + compile + run seconds "
              f"{time.perf_counter() - t0:.3f}")

        # placement: nothing may sit whole on one card
        whole = [k for k, a in st.tables.items()
                 if len(a.sharding.device_set) < w * v]
        by_spec = {}
        for k, a in st.tables.items():
            by_spec.setdefault(str(a.sharding.spec), []).append(k)
        for spec_str, names in sorted(by_spec.items()):
            print(f"mesh ({w},{v}) tables sharding {spec_str} on "
                  f"{w * v} cards: {len(names)} arrays "
                  f"({', '.join(sorted(names)[:4])}...)")
        for name, a in (("grid", grid), ("spvor", spec[0]),
                        ("spdiv", spec[1]), ("spscalar", spec[2])):
            print(f"mesh ({w},{v}) output {name} {a.shape} sharding "
                  f"{a.sharding}")
            if len(a.sharding.device_set) < w * v:
                whole.append(name)
        if whole:
            print(f"mesh ({w},{v}) FAIL: on fewer than {w * v} cards: {whole}")
            ok = False

        grid_h = np.asarray(grid)
        rows = []
        for name, blk in layout.split(np.arange(layout.total_real)).items():
            r, g = grid1_h[blk], grid_h[blk]
            rows.append((f"grid {name}", float(np.abs(g - r).max()),
                         NCHECK * EPS32 * float(np.abs(r).max())))
        for name, r, g in zip(("spvor", "spdiv", "spscalar"), spec1_h, spec):
            g = np.asarray(g)
            rows.append((name, float(np.abs(g - r).max()),
                         NCHECK * EPS32 * float(np.abs(r).max())))
        _print_rows(f"mesh ({w},{v}) vs one card", rows)
        ok = ok and gate_ok(rows)
        del st, grid, spec
    if not ok:
        raise SystemExit("chip_smoke: sharded transform differs from one "
                         "card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only ShardedTransform over four cards")
    args = ap.parse_args(argv)

    import jax

    # -- 1. device check --------------------------------------------------
    devices = jax.devices()
    require_gpu(devices)
    from ectrans_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    label = card_label()
    print(f"device {devices[0].device_kind} x {len(devices)}; "
          f"compile cache {cache}")
    print(f"nvidia-smi name, power.limit: {label}")
    if args.four_cards:
        four_cards(label)
    else:
        one_card(label)
    print(f"nvidia-smi name, power.limit: {label}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
