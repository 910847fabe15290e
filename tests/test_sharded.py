"""Decomposition invariance: sharded transforms == single-device transforms.

The equivalent of the reference's checksum tests
(tests/compare_checksums.py: results must be identical across MPI x OMP
decompositions).  Here: every (w, v) mesh shape on 8 virtual CPU devices must
reproduce the single-device result to float tolerance.

Why allclose and not the reference's CRC64 bitwise identity: the reference
can demand bitwise equality because each (m, lat) GEMM is computed by
exactly one rank with one summation order regardless of decomposition
(suwavedi assigns whole m's; OMP threads split loop iterations, not dot
products).  Here a resharded mesh changes which XLA program computes each
contraction, and XLA re-tiles/reassociates fp reductions per program —
summation order is not decomposition-invariant by construction.  The
waiver is quantified, not assumed: test_cross_mesh_max_delta measures the
pairwise max relative delta across all 6 mesh shapes and pins it at
<= 1e-13 in fp64 (measured round 4: 2.1e-14 — pure reassociation noise,
~100 ULP; any layout/ownership bug would show up at O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ectrans_tpu as et
from ectrans_tpu.parallel import ShardedTransform, make_mesh


def _random_state(res, nuv, nsc, seed=0):
    rng = np.random.default_rng(seed)
    n0 = 2 * (res.nsmax + 1)

    def rp(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1:n0:2] = 0.0
        return x

    vor, div, sc = rp(nuv), rp(nsc and nuv or nuv), rp(nsc)
    vor[:, 0] = 0.0
    div[:, 0] = 0.0
    return vor, div, sc


MESHES = [(1, 1), (2, 1), (1, 2), (4, 2), (2, 4), (8, 1)]


@pytest.mark.parametrize("w,v", MESHES)
@pytest.mark.parametrize("gridname", ["F24", "O48"])
def test_inv_decomposition_invariance(w, v, gridname):
    res = et.setup(gridname, 47)
    vor, div, sc = _random_state(res, 2, 3)
    flags = et.InvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    ref = np.asarray(
        et.inv_trans(res, spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
                     spscalar=jnp.asarray(sc), flags=flags, dtype=jnp.float64)
    )
    st = ShardedTransform(res, make_mesh(w, v), dtype=jnp.float64)
    got = np.asarray(st.inv_trans(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
                                  spscalar=jnp.asarray(sc), flags=flags))
    assert got.shape == ref.shape
    # relative tolerance: vdtuv carries the a^2 inverse-Laplacian factor, so
    # O(1) random vorticity spectra yield O(1e7) winds; fp64 reassociation
    # (jit FMA fusion) then shows up at ~1e-9 of the field magnitude.
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-12, f"(w={w},v={v}) inv mismatch {err}"


@pytest.mark.parametrize("w,v", MESHES)
def test_dir_decomposition_invariance(w, v):
    res = et.setup("O48", 47)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, res.ndgl, res.grid.ndlon))
    vv = rng.standard_normal((3, res.ndgl, res.grid.ndlon))
    sc = rng.standard_normal((2, res.ndgl, res.grid.ndlon))
    ref = [np.asarray(x) for x in et.dir_trans(
        res, u=jnp.asarray(u), v=jnp.asarray(vv), scalars=jnp.asarray(sc),
        dtype=jnp.float64)]
    st = ShardedTransform(res, make_mesh(w, v), dtype=jnp.float64)
    got = st.dir_trans(u=jnp.asarray(u), v=jnp.asarray(vv), scalars=jnp.asarray(sc))
    for name, r, g in zip(("vor", "div", "sc"), ref, got):
        err = np.abs(np.asarray(g) - r).max() / np.abs(r).max()
        assert err < 1e-12, f"(w={w},v={v}) {name} mismatch {err}"


def test_cross_mesh_max_delta():
    """Quantifies the bitwise-checksum waiver (reference
    compare_checksums.py asserts CRC64 identity): the pairwise max
    relative delta across ALL mesh shapes must stay at fp64
    reassociation scale (<= 1e-13), far below any layout/ownership bug
    (which shows up at O(1)).  The measured value is recorded in
    PARITY.md next to the waiver rationale."""
    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, 2, 3, seed=3)
    flags = et.InvFlags(scders=True, uvders=True)
    outs = []
    for w, v in MESHES:
        st = ShardedTransform(res, make_mesh(w, v), dtype=jnp.float64)
        outs.append(np.asarray(st.inv_trans(
            spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
            spscalar=jnp.asarray(sc), flags=flags)))
    scale = max(np.abs(o).max() for o in outs)
    worst = max(np.abs(a - b).max() for i, a in enumerate(outs)
                for b in outs[i + 1:]) / scale
    print(f"cross-mesh max relative delta: {worst:.3e}")
    assert worst < 1e-13, worst


def test_sharded_roundtrip_fp32():
    """fp32 sharded round trip at reference single-precision tolerance."""
    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, 2, 3, seed=2)
    st = ShardedTransform(res, make_mesh(4, 2), dtype=jnp.float32)
    grid = st.inv_trans(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
                        spscalar=jnp.asarray(sc))
    u, vv, s = grid[0:2], grid[2:4], grid[4:7]
    sv, sd, ss = st.dir_trans(u=u, v=vv, scalars=s)
    assert np.abs(np.asarray(sv) - vor).max() < 2e-5
    assert np.abs(np.asarray(sd) - div).max() < 2e-5
    assert np.abs(np.asarray(ss) - sc).max() < 2e-5


def test_sharded_bf16_tier_relaxed_gate():
    """precision="bf16" on the mesh: bf16 shard-local tables + single-pass
    contraction stay inside the reference's relaxed FLT gate (1e6*eps)."""
    res = et.setup("O48", 47)
    _, _, sc = _random_state(res, 0, 3, seed=6)
    st = ShardedTransform(res, make_mesh(4, 2), dtype=jnp.float32,
                          precision="bf16")
    assert str(st.tables["lg0_psym_w"].dtype) == "bfloat16"
    grid = st.inv_trans(spscalar=jnp.asarray(sc))
    _, _, ss = st.dir_trans(scalars=grid)
    scale = np.abs(sc).max()
    err = np.abs(np.asarray(ss) - sc).max()
    assert err < 1e6 * np.finfo(np.float32).eps * scale, err


@pytest.mark.parametrize("w,v", [(1, 1), (2, 1), (4, 2)])
def test_sharded_dense_engine_roundtrip(w, v):
    """The sharded grouped-einsum path (dense spectral layout, per-element
    packed gather + psum) in fp32: full round trip vs the fp64
    single-device result on the CPU mesh."""
    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, 2, 2, seed=9)
    flags = et.InvFlags(scders=True, uvders=True)
    st = ShardedTransform(res, make_mesh(w, v), dtype=jnp.float32)
    assert any(k.startswith("lg") for k in st.tables)
    grid = st.inv_trans(spvor=jnp.asarray(vor, jnp.float32),
                        spdiv=jnp.asarray(div, jnp.float32),
                        spscalar=jnp.asarray(sc, jnp.float32), flags=flags)
    ref = np.asarray(et.inv_trans(
        res, spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
        spscalar=jnp.asarray(sc), flags=flags, dtype=jnp.float64))
    gerr = np.abs(np.asarray(grid) - ref).max() / np.abs(ref).max()
    assert gerr < 1e-5, f"(w={w},v={v}) fp32 inv mismatch {gerr}"
    gv, gd, gs = st.dir_trans(u=grid[:2], v=grid[2:4], scalars=grid[4:6])
    rv, rd, rs = et.dir_trans(res, u=jnp.asarray(ref[:2]),
                              v=jnp.asarray(ref[2:4]),
                              scalars=jnp.asarray(ref[4:6]),
                              dtype=jnp.float64)
    for name, g, r in (("vor", gv, rv), ("div", gd, rd), ("sc", gs, rs)):
        r = np.asarray(r)
        err = np.abs(np.asarray(g) - r).max() / np.abs(r).max()
        assert err < 1e-5, f"(w={w},v={v}) fp32 dir {name} mismatch {err}"


FLAG_CASES = [
    # (nuv, nsc, flags) — exercise every group-permutation branch
    (2, 0, et.InvFlags()),                          # uv only, no flags
    (0, 3, et.InvFlags()),                          # scalars only
    (0, 3, et.InvFlags(scders=True)),               # scalars + derivatives
    (2, 0, et.InvFlags(vorgp=True)),                # uv + vorgp
    (2, 0, et.InvFlags(divgp=True, uvders=True)),   # uv + divgp + uvders
    (1, 1, et.InvFlags(uvders=True)),               # odd counts, uv ders
    (3, 2, et.InvFlags(scders=True)),               # odd uv, sc ders
]


@pytest.mark.parametrize("nuv,nsc,flags", FLAG_CASES)
def test_inv_flag_matrix_sharded(nuv, nsc, flags):
    """Sharded == single-device for every flag family and uv/sc-only cases
    (the group-major/owner-major permutation logic per field group)."""
    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, max(nuv, 1), max(nsc, 1), seed=3)
    kw = {}
    skw = {}
    if nuv:
        kw = dict(spvor=jnp.asarray(vor[:nuv]), spdiv=jnp.asarray(div[:nuv]))
    if nsc:
        kw["spscalar"] = jnp.asarray(sc[:nsc])
    ref = np.asarray(et.inv_trans(res, flags=flags, dtype=jnp.float64, **kw))
    st = ShardedTransform(res, make_mesh(4, 2), dtype=jnp.float64)
    got = np.asarray(st.inv_trans(flags=flags, **kw))
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-12, f"flags={flags} nuv={nuv} nsc={nsc}: {err}"


@pytest.mark.parametrize("nuv,nsc,flags", [
    (1, 2, et.InvFlags(scders=True, uvders=True, vorgp=True, divgp=True)),
    (2, 1, et.InvFlags(scders=True)),
])
def test_inv_flag_matrix_sharded_O160(nuv, nsc, flags):
    """Flag-family decomposition invariance on a second grid with real
    latitude/m imbalance (O160/T159; VERDICT round-2 item 6)."""
    res = et.setup("O160", 159)
    vor, div, sc = _random_state(res, nuv, nsc, seed=9)
    kw = dict(spvor=jnp.asarray(vor), spdiv=jnp.asarray(div),
              spscalar=jnp.asarray(sc))
    ref = np.asarray(et.inv_trans(res, flags=flags, dtype=jnp.float64, **kw))
    st = ShardedTransform(res, make_mesh(4, 2), dtype=jnp.float64)
    got = np.asarray(st.inv_trans(flags=flags, **kw))
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-12, f"flags={flags} nuv={nuv} nsc={nsc}: {err}"


@pytest.mark.parametrize("nuv,nsc", [(2, 0), (0, 3), (1, 1), (3, 2)])
def test_dir_field_matrix_sharded(nuv, nsc):
    """Sharded dir_trans == single-device for uv-only / sc-only / odd counts."""
    res = et.setup("O48", 47)
    rng = np.random.default_rng(7)
    kw = {}
    if nuv:
        kw["u"] = jnp.asarray(rng.standard_normal((nuv, res.ndgl, res.grid.ndlon)))
        kw["v"] = jnp.asarray(rng.standard_normal((nuv, res.ndgl, res.grid.ndlon)))
    if nsc:
        kw["scalars"] = jnp.asarray(
            rng.standard_normal((nsc, res.ndgl, res.grid.ndlon)))
    ref = et.dir_trans(res, dtype=jnp.float64, **kw)
    st = ShardedTransform(res, make_mesh(2, 4), dtype=jnp.float64)
    got = st.dir_trans(**kw)
    for name, r, g in zip(("vor", "div", "sc"), ref, got):
        assert (r is None) == (g is None), name
        if r is not None:
            err = np.abs(np.asarray(g) - np.asarray(r)).max() / np.abs(np.asarray(r)).max()
            assert err < 1e-12, f"{name} nuv={nuv} nsc={nsc}: {err}"


def test_kvset_field_ownership():
    """KVSETUV/KVSETSC-style caller-controlled field->v-shard ownership
    (``inv_trans.F90:43-55``): arbitrary (unbalanced, scrambled) ownership
    vectors must reproduce the default layout's results in caller order."""
    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, 3, 5, seed=21)
    flags = et.InvFlags(scders=True, uvders=True)
    st = ShardedTransform(res, make_mesh(2, 4), dtype=jnp.float64)
    ref = np.asarray(st.inv_trans(jnp.asarray(vor), jnp.asarray(div),
                                  jnp.asarray(sc), flags))
    got = np.asarray(st.inv_trans(
        jnp.asarray(vor), jnp.asarray(div), jnp.asarray(sc), flags,
        kvsetuv=[3, 0, 3], kvsetsc=[2, 2, 2, 0, 1]))
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-12, err

    # direct with ownership vectors: round-trips the same spectra
    u, vv = ref[0:3], ref[3:6]
    s = ref[6:11]
    sv_r, sd_r, ss_r = st.dir_trans(jnp.asarray(u), jnp.asarray(vv),
                                    jnp.asarray(s))
    sv, sd, ss = st.dir_trans(jnp.asarray(u), jnp.asarray(vv), jnp.asarray(s),
                              kvsetuv=[1, 2, 0], kvsetsc=[0, 3, 1, 1, 2])
    for a, b in ((sv, sv_r), (sd, sd_r), (ss, ss_r)):
        err = np.abs(np.asarray(a) - np.asarray(b)).max()
        assert err < 1e-12, err


def test_dist_gath_roundtrip_through_transform():
    """DIST_SPEC -> sharded transform -> GATH_GRID vs the host path
    (the owner-scatter/gather cycle of dist_grid_ctl_mod.F90:186-215)."""
    from ectrans_tpu.api import SpectralTransform

    res = et.setup("O48", 47)
    vor, div, sc = _random_state(res, 2, 2, seed=22)
    h = SpectralTransform("O48", 47, mesh=make_mesh(4, 2), dtype=jnp.float64)
    # host reference
    ref = np.asarray(et.inv_trans(res, spvor=jnp.asarray(vor),
                                  spdiv=jnp.asarray(div),
                                  spscalar=jnp.asarray(sc),
                                  dtype=jnp.float64))
    dv = h.dist_spec(vor)
    dd = h.dist_spec(div)
    ds = h.dist_spec(sc)
    grid = h.inv_trans(spvor=dv, spdiv=dd, spscalar=ds)
    gathered = h.gath_grid(grid)
    assert np.abs(gathered - ref).max() / np.abs(ref).max() < 1e-12
    # and the reverse cycle: dist_grid -> dir_trans -> gath_spec
    gd = h.dist_grid(gathered)
    sv, sd, ss = h.dir_trans(u=gd[0:2], v=gd[2:4], scalars=gd[4:6])
    assert np.abs(h.gath_spec(ss) - sc).max() < 1e-8
