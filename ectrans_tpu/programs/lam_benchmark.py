"""LAM bi-Fourier benchmark driver.

Mirror of the reference ``src/programs/ectrans-lam-benchmark.F90``
(--nlon/--nlat domain options, timed einv/edir loop, correctness gate).

Usage:
    python -m ectrans_tpu.programs.lam_benchmark --nlon 128 --nlat 96 \
        --nlon-ci 107 --nlat-ci 75 -n 10 -f 8 --vordiv --check 100
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ectrans_tpu LAM benchmark")
    p.add_argument("--nlon", type=int, default=128)
    p.add_argument("--nlat", type=int, default=96)
    p.add_argument("--nlon-ci", type=int, default=None,
                   help="C+I zone longitudes (default: nlon)")
    p.add_argument("--nlat-ci", type=int, default=None)
    p.add_argument("--truncx", type=int, default=None)
    p.add_argument("--truncy", type=int, default=None)
    p.add_argument("--dx", type=float, default=1000.0)
    p.add_argument("--dy", type=float, default=1000.0)
    p.add_argument("-n", "--niter", type=int, default=10)
    p.add_argument("-f", "--nfld", type=int, default=1)
    p.add_argument("--vordiv", action="store_true")
    p.add_argument("--scders", action="store_true")
    p.add_argument("--uvders", action="store_true")
    p.add_argument("--check", type=float, default=0.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ectrans_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ectrans_tpu.lam import (
        LamInvFlags, dir_trans_lam, especnorm, inv_trans_lam,
        make_lam_grid, setup_lam,
    )

    grid = make_lam_grid(args.nlon, args.nlat,
                         nxux=args.nlon_ci, nyux=args.nlat_ci,
                         msmax=args.truncx, nsmax=args.truncy,
                         dx=args.dx, dy=args.dy)
    res = setup_lam(grid)
    dtype = jnp.dtype(args.dtype)
    print(f"LAM {grid.nx}x{grid.ny} (C+I {grid.nxux}x{grid.nyux})  "
          f"trunc ({grid.msmax},{grid.nsmax})  nspec2 {grid.nspec2}")

    flags = LamInvFlags(scders=args.scders, uvders=args.uvders)
    rng = np.random.default_rng(0)
    pm = np.asarray(res.packed_m)
    pn = np.asarray(res.packed_n)
    pc = np.asarray(res.packed_c)
    kill = ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, kill] = 0.0
        return jnp.asarray(x, dtype)

    nsc = args.nfld
    nuv = args.nfld if args.vordiv else 0
    ss = packed(nsc)
    sv = packed(nuv) if nuv else None
    sd = packed(nuv) if nuv else None
    if nuv:
        sv = sv.at[:, 0:4].set(0)
        sd = sd.at[:, 0:4].set(0)
    norm0 = np.asarray(especnorm(res, ss))

    t_inv, t_dir, t_rt = [], [], []
    mu = mv = None
    for it in range(args.niter + 1):
        t0 = time.perf_counter()
        g = inv_trans_lam(res, sv, sd, ss, mu, mv, flags=flags, dtype=dtype)
        jax.block_until_ready(g)
        t1 = time.perf_counter()
        u = g[:nuv] if nuv else None
        v = g[nuv : 2 * nuv] if nuv else None
        sc = g[2 * nuv : 2 * nuv + nsc]
        sv2, sd2, ss2, mu2, mv2 = dir_trans_lam(res, u, v, sc, dtype=dtype)
        jax.block_until_ready(ss2)
        t2 = time.perf_counter()
        if it > 0:
            t_inv.append(t1 - t0)
            t_dir.append(t2 - t1)
            t_rt.append(t2 - t0)
        ss = ss2
        if nuv:
            sv, sd, mu, mv = sv2, sd2, mu2, mv2

    for name, ts in (("e-inverse transform", t_inv),
                     ("e-direct transform", t_dir),
                     ("roundtrip", t_rt)):
        a = np.asarray(ts)
        print(f"{name:22s} avg {a.mean()*1e3:8.3f} ms  min {a.min()*1e3:8.3f}"
              f"  max {a.max()*1e3:8.3f}  med {np.median(a)*1e3:8.3f}")
    gpps = grid.ngptot * (nsc + 2 * nuv) / np.mean(t_rt)
    print(f"throughput {gpps:.3e} gridpoints*fields/s")

    if args.check:
        norm1 = np.asarray(especnorm(res, ss))
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
