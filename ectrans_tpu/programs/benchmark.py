"""Global spectral-transform benchmark driver.

Command-line mirror of the reference benchmark
(``src/programs/ectrans-benchmark.F90``): timed inverse/direct transform
loop with per-phase avg/min/max/median statistics (:874-945), optional
vor/div and derivative flags, spectral-norm printing (--norms) and the
analytic correctness gate (--check <mult>: max spectral-norm error vs the
initial condition must stay below mult * machine-eps, :850-860).

Usage:
    python -m ectrans_tpu.programs.benchmark -g O48 -t 47 -n 10 -f 4 -l 5 \
        --vordiv --scders --uvders --check 100 --dtype float32 --mesh 4x2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="ectrans_tpu benchmark (reference ectrans-benchmark equivalent)"
    )
    p.add_argument("-g", "--grid", default="O48",
                   help="grid spec: O<N> octahedral, F<N> full, TCO<S>, TL<S>")
    p.add_argument("-t", "--truncation", type=int, default=None,
                   help="spectral truncation (default: grid-implied)")
    p.add_argument("-n", "--niter", type=int, default=10)
    p.add_argument("-f", "--nfld", type=int, default=1,
                   help="number of scalar fields (per level)")
    p.add_argument("-l", "--nlev", type=int, default=1,
                   help="number of levels (scalar fields = nfld * nlev)")
    p.add_argument("--vordiv", action="store_true",
                   help="also transform vorticity/divergence -> winds")
    p.add_argument("--scders", action="store_true",
                   help="compute scalar derivatives")
    p.add_argument("--uvders", action="store_true",
                   help="compute E-W derivatives of u, v")
    p.add_argument("--vordiv-uv-gp", action="store_true", dest="vorgp",
                   help="output grid-point vor/div too")
    p.add_argument("--norms", action="store_true",
                   help="print spectral norms each iteration")
    p.add_argument("--check", type=float, default=0.0, metavar="MULT",
                   help="correctness gate: err < MULT * eps (0 = off)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "bf16"],
                   help="Legendre contraction precision tier")
    p.add_argument("--mesh", default=None, metavar="WxV",
                   help="distributed mesh, e.g. 4x2 (default: single device)")
    p.add_argument("--nproma", type=int, default=0, metavar="N",
                   help="grid-point blocking size: run outputs through the "
                        "(nproma, nfld, ngpblks) blocked layout each "
                        "iteration (reference --nproma / INIGPTR)")
    p.add_argument("--npromatr", type=int, default=0, metavar="N",
                   help="spectral field-packet cap per transform "
                        "(reference NPROMATR, 0 = off)")
    p.add_argument("--callmode", type=int, default=1, choices=[1, 2],
                   help="1 = combined PGP arrays; 2 = split PGPUV/PGP3A/PGP2 "
                        "families (reference ectrans-benchmark callmode)")
    p.add_argument("--meminfo", action="store_true",
                   help="print device memory stats + host peak RSS "
                        "(reference ectrans_memory / setup_trans meminfo)")
    p.add_argument("--dump-checksums", default=None, metavar="FILE",
                   help="write per-field output checksums (reference "
                        "--dump-checksums; decomposition invariance)")
    p.add_argument("--dump-values", default=None, metavar="FILE",
                   help="write final grid + spectral field values (npz) for "
                        "external comparison (reference --dump-values)")
    return p.parse_args(argv)


def _stats(times):
    t = np.asarray(times)
    return dict(avg=t.mean(), min=t.min(), max=t.max(), med=np.median(t))


def _print_stats(name, times):
    s = _stats(times)
    print(f"{name:28s} avg {s['avg']*1e3:9.3f} ms  min {s['min']*1e3:9.3f}"
          f"  max {s['max']*1e3:9.3f}  med {s['med']*1e3:9.3f}")


def main(argv=None):
    args = parse_args(argv)
    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ectrans_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import ectrans_tpu as et
    from ectrans_tpu import norms
    from ectrans_tpu.transform import InvFlags

    res = et.setup(args.grid, args.truncation)
    dtype = jnp.dtype(args.dtype)
    print(f"grid {res.grid.name}  T{res.nsmax}  ndgl {res.ndgl}  "
          f"ngptot {res.grid.ngptot}  nspec2 {res.nspec2}  dtype {dtype}")

    st = None
    if args.mesh:
        from ectrans_tpu.parallel import ShardedTransform, make_mesh

        w, v = (int(x) for x in args.mesh.lower().split("x"))
        st = ShardedTransform(res, make_mesh(w, v), dtype=dtype,
                              precision=args.precision)
        print(f"mesh {w}x{v} over {w*v} devices")

    split_api = None
    if args.callmode == 2:
        if args.mesh:
            sys.exit("--callmode 2 requires a single-device run")
        from ectrans_tpu.api import SpectralTransform

        split_api = SpectralTransform(args.grid, args.truncation, dtype=dtype,
                                      precision=args.precision)

    nsc = args.nfld * args.nlev
    nuv = args.nlev if args.vordiv else 0
    flags = InvFlags(scders=args.scders, uvders=args.uvders,
                     vorgp=args.vorgp, divgp=args.vorgp)

    rng = np.random.default_rng(0)

    def packed(n, scale=1.0):
        x = rng.standard_normal((n, res.nspec2)) * scale
        x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0  # m=0 imag = 0
        x[:, 0] = 0.0
        return jnp.asarray(x, dtype)

    spsc = packed(nsc)
    spvor = packed(nuv) if nuv else None
    spdiv = packed(nuv) if nuv else None
    norm0 = np.asarray(norms.specnorm(res, spsc))

    npromatr = args.npromatr or None

    def inv(sv, sd, ss):
        if st is not None:
            return st.inv_trans(spvor=sv, spdiv=sd, spscalar=ss, flags=flags,
                                npromatr=npromatr)
        return et.inv_trans(res, spvor=sv, spdiv=sd, spscalar=ss,
                            flags=flags, dtype=dtype, npromatr=npromatr,
                            precision=args.precision)

    def dirt(u, v, sc):
        if st is not None:
            return st.dir_trans(u=u, v=v, scalars=sc, npromatr=npromatr)
        return et.dir_trans(res, u=u, v=v, scalars=sc, dtype=dtype,
                            npromatr=npromatr, precision=args.precision)

    def inv_split(sv, sd, ss):
        # callmode 2: scalars as the SC3A (nfld, nlev) family
        out = split_api.inv_trans_split(
            spvor=sv, spdiv=sd,
            spsc3a=ss.reshape(args.nfld, args.nlev, res.nspec2),
            flags=flags, npromatr=npromatr)
        u = out.get("u")
        v = out.get("v")
        sc = out["sc3a"].reshape(nsc, res.ndgl, res.grid.ndlon)
        return u, v, sc

    def dirt_split(u, v, sc):
        sv, sd, fam = split_api.dir_trans_split(
            u=u, v=v,
            gp3a=sc.reshape(args.nfld, args.nlev, res.ndgl, res.grid.ndlon),
            npromatr=npromatr)
        return sv, sd, fam["sc3a"].reshape(nsc, res.nspec2)

    npre = nuv * (2 + (2 if args.vorgp else 0))
    t_inv, t_dir, t_rt = [], [], []
    sv, sd, ss = spvor, spdiv, spsc
    sc = None
    for it in range(args.niter + 1):  # first iteration = warmup/compile
        t0 = time.perf_counter()
        if split_api is not None:
            u, v, sc = inv_split(sv, sd, ss)
            jax.block_until_ready(sc)
            t1 = time.perf_counter()
            sv2, sd2, ss2 = dirt_split(u, v, sc)
        else:
            grid = inv(sv, sd, ss)
            jax.block_until_ready(grid)
            t1 = time.perf_counter()
            u = grid[nuv * (2 if args.vorgp else 0) : ][:nuv] if nuv else None
            v = grid[nuv * (2 if args.vorgp else 0) + nuv :][:nuv] if nuv else None
            sc = grid[npre : npre + nsc]
            sv2, sd2, ss2 = dirt(u, v, sc)
        jax.block_until_ready(ss2)
        t2 = time.perf_counter()
        if it > 0:
            t_inv.append(t1 - t0)
            t_dir.append(t2 - t1)
            t_rt.append(t2 - t0)
        if nuv:
            sv, sd = sv2, sd2
        ss = ss2
        if args.norms:
            nn = np.asarray(norms.specnorm(res, ss))
            print(f"iter {it:3d}  specnorm[0] {nn[0]:.9e}")

    _print_stats("inverse transform", t_inv)
    _print_stats("direct transform", t_dir)
    _print_stats("inv+dir roundtrip", t_rt)
    gpps = res.grid.ngptot * (nsc + 2 * nuv) / np.mean(t_rt)
    print(f"throughput {gpps:.3e} gridpoints*fields/s")

    if args.nproma:
        # NPROMA blocked-layout exercise (reference PGP(NPROMA,NFLD,NGPBLKS)
        # contract): round-trip the scalar outputs through the blocked
        # layout and require exactness.  XLA tiles internally, so NPROMA is
        # a caller-layout conversion here, not a compute-blocking knob.
        from ectrans_tpu.utils.blocking import (_point_index,
                                                blocked_to_fields,
                                                fields_to_blocked)

        sc_h = np.asarray(sc)
        blk = fields_to_blocked(sc_h, res.grid, args.nproma)
        back = blocked_to_fields(blk, res.grid)
        lat, lon = _point_index(res.grid)  # valid reduced-grid points
        ok = np.array_equal(back[:, lat, lon], sc_h[:, lat, lon])
        print(f"nproma {args.nproma}: ngpblks {blk.shape[2]}, blocked "
              f"round-trip {'exact' if ok else 'MISMATCH'}")
        if not ok:
            sys.exit(1)

    if args.meminfo:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"host peak RSS {ru.ru_maxrss/2**10:.0f} MiB "
              f"(reference ectrans_memory peak-heap analogue)")
        try:
            for d in jax.devices():
                ms = d.memory_stats() or {}
                print(f"{d}: in_use {ms.get('bytes_in_use', 0)/2**20:.0f} MiB, "
                      f"peak {ms.get('peak_bytes_in_use', 0)/2**20:.0f} MiB")
        except Exception as e:  # a backend may not expose memory_stats
            print(f"meminfo unavailable: {e}")

    if args.dump_values:
        # reference --dump-values: raw output fields for external diffing
        np.savez_compressed(
            args.dump_values,
            spscalar=np.asarray(ss, dtype=np.float64),
            grid_sc=np.asarray(sc, dtype=np.float64),
            **({"spvor": np.asarray(sv, np.float64),
                "spdiv": np.asarray(sd, np.float64)} if nuv else {}),
        )
        print(f"dumped values -> {args.dump_values}")

    if args.dump_checksums:
        from ectrans_tpu.utils import field_checksum

        with open(args.dump_checksums, "w") as fh:
            out = np.asarray(ss, dtype=np.float64)
            nn = np.asarray(norms.specnorm(res, jnp.asarray(out)))
            for f in range(out.shape[0]):
                fh.write(f"sc{f} {field_checksum(out[f])} {nn[f]:.14e}\n")

    if args.check:
        norm1 = np.asarray(norms.specnorm(res, ss))
        eps = float(jnp.finfo(dtype).eps)
        err = np.max(np.abs(norm1 - norm0) / np.maximum(norm0, 1e-30))
        gate = args.check * eps * args.niter
        ok = err < gate
        print(f"check: relative norm drift {err:.3e} "
              f"{'<' if ok else '>='} {gate:.3e} -> {'OK' if ok else 'FAIL'}")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
