"""The benchmark's operation and byte counts against the hand counts
they were copied from (chip_smoke.py) and the bounds PERF.md quotes."""

import importlib
import os
import sys

import pytest
from conftest import ROOT

from futbench import counts

SHARES_5V5 = {"pairs_env": 0.1553, "walls_env": 0.1868}   # PERF.md §5, phase 6
SHARES_2V2 = {"pairs_env": 0.02639, "walls_env": 0.07966}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("ppt", [1, 2, 3, 5])
def test_env_step_ops_every_constraint_active(chip_smoke, ppt):
    from gym_futbol_tpu_torch import EnvParams

    assert counts.env_step_ops(ppt) == chip_smoke.env_step_ops(
        EnvParams(players_per_team=ppt))


def test_env_step_ops_at_shares(chip_smoke):
    from gym_futbol_tpu_torch import EnvParams

    assert counts.env_step_ops(5, shares=SHARES_5V5) == chip_smoke.env_step_ops(
        EnvParams(players_per_team=5), SHARES_5V5)


def test_k2_bound_config5():
    dims = counts.mlp_dims(46, (256, 256), 50)
    assert counts.k2_ops(5, dims, SHARES_5V5) == (370711, 360448)
    ms, by = counts.k2_bound(5, dims, 48, 65536, 64, SHARES_5V5)
    assert by == "operations" and round(ms / 64, 5) == 0.03392


def test_k3_bound_config5():
    dims = counts.mlp_dims(46, (256, 256), 50)
    m = 2 ** 21
    ms, by = counts.k3_bound(dims, 48, m, m // 1024)
    assert by == "operations" and round(ms, 3) == 1.145


def test_k1a_bound_config3():
    ms, by = counts.k1a_bound(2, 4096, 512, SHARES_2V2)
    assert by == "operations" and round(ms / 512, 6) == 0.000128


def test_model_flops_config5():
    dims = counts.mlp_dims(46, (256, 256), 50)
    flops = counts.ppo_model_flops(dims, 2 * 65536 * 64, 4)
    assert 1.9e13 < flops < 2.0e13   # 1.5e12 collect + 1.8e13 update (PERF.md)


def test_bound_is_the_larger_side():
    assert counts.bound(3.35e12)[0] == pytest.approx(1e3)
    assert counts.bound(0, f32_ops=67e12) == (pytest.approx(1e3), "operations")
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
