"""Card-only checks of the precision tiers (marker ``gpu``; they skip where
JAX finds no GPU).  A float32 matmul on a GPU may silently run in TF32
(~1e-3 relative); the "highest" tier must not."""

import sys
import pathlib

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import ectrans_tpu as et  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["O160", "TCO399"])
def test_highest_tier_is_true_fp32_on_gpu(gpu, config):
    res = et.setup(config)
    gl = res.grouped_legendre("float32")
    err = chip_smoke.legendre_reference_check(
        res, gl, "highest", np.random.default_rng(0))
    assert err <= chip_smoke.NCHECK * chip_smoke.EPS32, err


@pytest.mark.gpu
def test_round_trip_gate_on_gpu(gpu, capsys):
    chip_smoke.one_card(gpu.device_kind, config="TCO159")
    assert "FAIL" not in capsys.readouterr().out
