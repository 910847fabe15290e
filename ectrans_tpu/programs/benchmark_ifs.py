"""IFS-layout benchmark driver.

Mirror of ``src/programs/ectrans-benchmark-ifs.F90``: the field set of one
IFS time step — nlev levels of vorticity/divergence (transformed to winds
with derivatives), nlev levels each of temperature and humidity-like
scalars with derivatives, plus a single surface-pressure field — rather
than the synthetic field sets of the plain benchmark.

Usage:
    python -m ectrans_tpu.programs.benchmark_ifs -g TCO159 -l 137 -n 5
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ectrans_tpu IFS-layout benchmark")
    p.add_argument("-g", "--grid", default="O48")
    p.add_argument("-t", "--truncation", type=int, default=None)
    p.add_argument("-l", "--nlev", type=int, default=19,
                   help="model levels (vor/div/T/q per level)")
    p.add_argument("-n", "--niter", type=int, default=5)
    p.add_argument("--check", type=float, default=0.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--mesh", default=None, metavar="WxV")
    p.add_argument("--npromatr", type=int, default=8, metavar="NLEV",
                   help="levels per transform packet (the reference's "
                        "NPROMATR field-packet loop, inv_trans_ctl_mod."
                        "F90:143-276: bounds the padded grid-space working "
                        "set; 0 = single packet)")
    return p.parse_args(argv)


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
    nlev = args.nlev
    nsc = 2 * nlev + 1   # T, q per level + surface pressure
    print(f"IFS layout: {nlev} levels vor/div + {nsc} scalar fields at "
          f"{res.grid.name} T{res.nsmax}")

    st = None
    if args.mesh:
        from ectrans_tpu.parallel import ShardedTransform, make_mesh

        w, v = (int(x) for x in args.mesh.lower().split("x"))
        st = ShardedTransform(res, make_mesh(w, v), dtype=dtype)

    flags = InvFlags(scders=True, uvders=True)
    rng = np.random.default_rng(0)

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
        x[:, 0] = 0.0
        return jnp.asarray(x, dtype)

    sv, sd, ss = packed(nlev), packed(nlev), packed(nsc)
    norm0 = np.asarray(norms.specnorm(res, ss))

    def inv(sv, sd, ss):
        if st is not None:
            return st.inv_trans(spvor=sv, spdiv=sd, spscalar=ss, flags=flags)
        return et.inv_trans(res, spvor=sv, spdiv=sd, spscalar=ss,
                            flags=flags, dtype=dtype)

    def dirt(u, v, sc):
        if st is not None:
            return st.dir_trans(u=u, v=v, scalars=sc)
        return et.dir_trans(res, u=u, v=v, scalars=sc, dtype=dtype)

    pk = args.npromatr if args.npromatr > 0 else nlev
    ts = []
    for it in range(args.niter + 1):
        t0 = time.perf_counter()
        # packet loop over levels (NPROMATR): one inv+dir round trip per
        # packet keeps the padded grid-space working set bounded
        sv2, sd2, ss2 = [], [], []
        for lo in range(0, nlev, pk):
            hi = min(nlev, lo + pk)
            m = hi - lo
            # scalars for this packet: T and q levels [lo:hi] (+ sp in the
            # first packet)
            sc_idx = list(range(lo, hi)) + list(range(nlev + lo, nlev + hi))
            if lo == 0:
                sc_idx.append(2 * nlev)
            ssp = ss[np.asarray(sc_idx)]
            g = inv(sv[lo:hi], sd[lo:hi], ssp)
            u, v = g[:m], g[m : 2 * m]
            sc = g[2 * m : 2 * m + len(sc_idx)]
            pv, pd, psc = dirt(u, v, sc)
            sv2.append(pv)
            sd2.append(pd)
            ss2.append(psc)
        sv = jnp.concatenate(sv2, axis=0)
        sd = jnp.concatenate(sd2, axis=0)
        # reassemble scalar ordering: T blocks, q blocks, sp
        tpar, qpar, sp_f = [], [], None
        for blk, lo in zip(ss2, range(0, nlev, pk)):
            m = min(nlev, lo + pk) - lo
            tpar.append(blk[:m])
            qpar.append(blk[m : 2 * m])
            if lo == 0:
                sp_f = blk[2 * m :]
        ss = jnp.concatenate(tpar + qpar + [sp_f], axis=0)
        jax.block_until_ready(ss)
        if it > 0:
            ts.append(time.perf_counter() - t0)
    a = np.asarray(ts)
    print(f"roundtrip avg {a.mean()*1e3:.2f} ms  min {a.min()*1e3:.2f}  "
          f"max {a.max()*1e3:.2f}  med {np.median(a)*1e3:.2f}")
    gpps = res.grid.ngptot * (nsc + 2 * nlev) / a.mean()
    print(f"throughput {gpps:.3e} gridpoints*fields/s")

    if args.check:
        norm1 = np.asarray(norms.specnorm(res, ss))
        eps = float(jnp.finfo(dtype).eps)
        err = np.max(np.abs(norm1 - norm0) / np.maximum(norm0, 1e-30))
        gate = args.check * eps * args.niter
        ok = err < gate
        print(f"check: {err:.3e} {'<' if ok else '>='} {gate:.3e} -> "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
