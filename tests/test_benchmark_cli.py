"""Benchmark CLI drivers: smoke runs + the reference's decomposition-
invariance checksum strategy (tests/compare_checksums.py: output checksums
across decompositions must match the serial run)."""

import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run_cli(args, tmp_path):
    env = {
        "PYTHONPATH": str(ROOT),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "ECTRANS_TPU_LEGPOL_DIR": "",
        "PATH": "/usr/bin:/bin",
        "HOME": str(tmp_path),
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache"),
    }
    out = subprocess.run(
        [sys.executable, "-m"] + args, capture_output=True, text=True,
        timeout=580, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_benchmark_cli_decomposition_invariant_checksums(tmp_path):
    base = ["ectrans_tpu.programs.benchmark", "-g", "F24", "-t", "47",
            "-n", "2", "-f", "2", "--check", "200", "--dtype", "float64"]
    f1 = tmp_path / "serial.sum"
    f2 = tmp_path / "mesh42.sum"
    out1 = run_cli(base + ["--dump-checksums", str(f1)], tmp_path)
    assert "check:" in out1 and "OK" in out1
    out2 = run_cli(base + ["--mesh", "4x2", "--dump-checksums", str(f2)],
                   tmp_path)
    assert "OK" in out2
    # deterministic reruns must be bit-identical (the reference's
    # checksum-equality property for a fixed decomposition)
    f1b = tmp_path / "serial2.sum"
    run_cli(base + ["--dump-checksums", str(f1b)], tmp_path)
    assert f1.read_text() == f1b.read_text()
    # across decompositions: spectral norms agree to fp64 reduction noise
    def norms_of(path):
        return [float(l.split()[2]) for l in path.read_text().splitlines()]
    n1, n2 = norms_of(f1), norms_of(f2)
    assert len(n1) == len(n2) == 2
    for a, b in zip(n1, n2):
        assert abs(a - b) < 1e-10 * max(1.0, abs(a))


def test_lam_benchmark_cli_smoke(tmp_path):
    out = run_cli(["ectrans_tpu.programs.lam_benchmark", "--nlon", "48",
                   "--nlat", "40", "-n", "2", "-f", "2", "--vordiv",
                   "--check", "200", "--dtype", "float64"], tmp_path)
    assert "OK" in out
