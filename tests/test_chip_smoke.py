"""``chip_smoke.py`` on the CPU: its checks, its refusal to run without a
GPU, and its phases driven at a small resolution.

The script itself runs on the card (README, Validation); here its helpers
are exercised directly, and its one-card and four-card phases run on the
8-virtual-device CPU mesh at TCO79 so that their control flow and gates
are covered without a GPU.
"""

import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import ectrans_tpu as et  # noqa: E402
from ectrans_tpu.utils import compile_cache  # noqa: E402


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_require_gpu_refuses_no_device():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu([])


def test_require_gpu_accepts_gpu():
    chip_smoke.require_gpu([types.SimpleNamespace(platform="gpu")])


def test_cache_dir_without_env_is_fixed_in_checkout():
    got = compile_cache.cache_dir({})
    assert got == ROOT / ".jax_cache" == compile_cache.cache_dir({})
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_dir_follows_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert compile_cache.cache_dir(env) == pathlib.Path("/some/cache")


@pytest.fixture(scope="module")
def spectra():
    res = et.setup("O48", 47)
    rng = np.random.default_rng(3)
    return res, [chip_smoke.packed_spectra(res, n, rng) for n in (2, 2, 3)]


def test_packed_spectra_are_valid_inputs(spectra):
    res, specs = spectra
    for x in specs:
        assert x.dtype == np.float32 and x.shape[1] == res.nspec2
        assert not x[:, 1 : 2 * (res.nsmax + 1) : 2].any()   # m=0 imaginary
        assert x[:, 0].tolist() == [0.0] * x.shape[0]


def test_family_gate_passes_clean(spectra):
    _, ref = spectra
    got = [x + 1e-7 * np.abs(x).max() for x in ref]
    rows = chip_smoke.family_errors(got, ref)
    assert [r[0] for r in rows] == ["vor", "div", "sc"]
    assert chip_smoke.gate_ok(rows)


@pytest.mark.parametrize("family", [0, 1, 2])
def test_family_gate_flags_corruption(spectra, family):
    _, ref = spectra
    got = [x.copy() for x in ref]
    got[family][1, 5] += 1e-3 * np.abs(ref[family]).max()
    rows = chip_smoke.family_errors(got, ref)
    bad = [name for name, err, gate in rows if not err <= gate]
    assert bad == [("vor", "div", "sc")[family]]
    assert not chip_smoke.gate_ok(rows)


def test_family_gate_flags_nan(spectra):
    _, ref = spectra
    got = [x.copy() for x in ref]
    got[2][0, 7] = np.nan
    assert not chip_smoke.gate_ok(chip_smoke.family_errors(got, ref))


def test_family_gate_skips_vordiv_global_mean(spectra):
    """(m=0, n=0) of vor/div carries no wind: the gate ignores it there,
    but not for scalars."""
    _, ref = spectra
    got = [x.copy() for x in ref]
    got[0][:, 0] += 1.0
    got[1][:, 0] += 1.0
    assert chip_smoke.gate_ok(chip_smoke.family_errors(got, ref))
    got[2][:, 0] += 1.0
    assert not chip_smoke.gate_ok(chip_smoke.family_errors(got, ref))


def test_legendre_reference_check_separates_tiers():
    """The fp64 check passes true fp32 and catches a reduced-precision
    product (the size of error a TF32 product would show)."""
    res = et.setup("O48", 47)
    gl = res.grouped_legendre("float32")
    tol = chip_smoke.NCHECK * chip_smoke.EPS32
    hi = chip_smoke.legendre_reference_check(
        res, gl, "highest", np.random.default_rng(1))
    lo = chip_smoke.legendre_reference_check(
        res, gl, "bf16", np.random.default_rng(1))
    assert hi <= tol < lo


def _run_smoke(cwd):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": str(cwd)}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_smoke_exits_nonzero_without_gpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_one_card_phases_at_small_size(capsys):
    chip_smoke.one_card("cpu", config="TCO79")
    text = capsys.readouterr().out
    assert "FAIL" not in text
    assert text.count(" ok") == 3                  # vor, div, scalars
    assert "round trip seconds" in text


def test_four_card_phase_at_small_size(capsys):
    chip_smoke.four_cards("cpu", config="TCO79")
    text = capsys.readouterr().out
    assert "FAIL" not in text
    for mesh in chip_smoke.MESHES:
        assert f"mesh {mesh}".replace(" ", "") in text.replace(" ", "")
