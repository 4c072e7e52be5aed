"""The recurrent PPO cell (traffic kind ``recurrent_ppo_iter``) and its
readers: the cell end to end on the host at a test's size (``--device
cpu``: the program's plain versions), correct, traced, and not correct
under the control and the ``unchanged`` fault; the counts of
``futbench/counts_recurrent.py`` by hand; each new reader exact on a
synthetic trace and silent on a run without its spans, kernels or
bounds; and on the card the cell's control at its own size."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
from conftest import ROOT, benchmark, run

from futbench import counts, counts_recurrent
from futbench import run as bench_run
from futbench.trace import Trace

SEED = 2**31 + 23
CELL = "rppo.tiny"
TINY_CONFIG = {
    "name": "tiny_lstm_2v2", "players_per_team": 2, "env_params": {"max_steps": 12},
    "hidden": [16, 16], "lstm_size": 8, "reduced": [], "compute_dtype": "bfloat16",
    "ppo": {"gamma": 0.99, "gae_lambda": 0.95, "clip_eps": 0.2, "lr": 0.00025,
            "epochs": 2, "minibatches": 2, "vf_coef": 0.5, "ent_coef": 0.01,
            "max_grad_norm": 0.5, "shuffle_block": 16},
}
TINY_TRAFFIC = {
    "kind": "recurrent_ppo_iter", "envs": 32, "steps": 6, "recorded_iterations": 2,
    "check_envs": 4, "trace_calls": 1,
    "limits": {"env_mismatches": 0, "logp_gap": 0.05, "value_gap": 0.05,
               "tie_gap": 0.05, "carry_gap": 0.05, "loss_gap": 0.05, "grad_gap": 0.05,
               "change_gap": 0.05},
}
READERS = ("k5_roofline", "rppo.mfu", "rppo.launches_per_iter", "rppo.collect.idle_ms",
           "rppo.gae.idle_ms", "rppo.update.idle_ms")


@pytest.fixture
def tiny(tmp_path):
    """A checkout of the benchmark alone with the tiny recurrent cell added
    as new files and entries, reporting every metric its entry lists."""
    shutil.copytree(os.path.join(ROOT, "futbench"), tmp_path / "futbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(tmp_path / "futbench" / "configs" / "tiny_lstm_2v2.json", "w") as f:
        json.dump(TINY_CONFIG, f)
    with open(tmp_path / "futbench" / "traffic" / f"{CELL}.json", "w") as f:
        json.dump(TINY_TRAFFIC, f)
    bench = benchmark()
    bench["workloads"].append({"name": CELL, "config": "tiny_lstm_2v2", "traffic": CELL,
                               "chips": 1, "why": "a test's size"})
    for m in bench["per_layer"]:
        if "recurrent_ppo_iter.3v3" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp_path


def reader(name):
    return bench_run.load_module("metrics", name).read


def test_the_cell_is_in_the_benchmark():
    spec = bench_run.cell_spec(ROOT, "recurrent_ppo_iter.3v3")
    assert spec["chips"] == 1
    assert {m["name"] for m in spec["per_layer"]} == set(READERS)
    assert {m["name"] for m in spec["e2e"]} == {"env_steps_per_s", "setup_s"}
    config = bench_run.load_json("configs", spec["config"])
    assert (config["hidden"], config["lstm_size"], config["reduced"]) == ([64, 64], 256, [])
    assert bench_run.load_json("traffic", spec["traffic"])["kind"] == "recurrent_ppo_iter"


def test_tiny_cell(tiny):
    rc, result, err = run(tiny, "--workload", CELL, "--seed", str(SEED), "--seconds", "0.2")
    assert rc == 0, err
    assert result["correct"] and result["attempted"] >= 1, err
    assert {"env_steps_per_s", "setup_s"} <= set(result["metrics"])
    assert set(result["checks"]) == set(TINY_TRAFFIC["limits"])
    assert result["checks"]["env_mismatches"]["value"] == 0


def test_traced_tiny_cell(tiny):
    """Traced on the host: correct; with no kernel on the host the
    device's readers have nothing to read, and the result says so by
    leaving them out."""
    rc, result, err = run(tiny, "--workload", CELL, "--seed", "7", "--seconds", "0.2",
                          "--trace", "1")
    assert rc == 0, err
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert not set(READERS) & set(result["metrics"])


@pytest.mark.parametrize("how", ["--control", "--fault=unchanged"])
def test_control_and_fault_come_out_not_correct(tiny, how):
    rc, result, err = run(tiny, "--workload", CELL, "--seed", "9", "--seconds", "0.1", how)
    assert rc == 0, err
    assert result["correct"] is False


def test_lstm_counts_by_hand():
    """3v3 (30 features), torso (64, 64), H = 256: 341,632 multiply-adds
    a sample (the issue's reckoning); K5's bf16 operations a view
    2 x 341,376 (all but the value head), its bytes the state, the
    weights, the obs buffer, the per-step rows and the carries."""
    dims = counts_recurrent.lstm_dims(30, (64, 64), 256, 30)
    assert dims == [(30, 64), (64, 64), (320, 1024), (256, 30), (256, 1)]
    assert counts.mlp_macs(dims) == 341632
    shares = {"pairs_env": 2.0, "walls_env": 3.0}
    ops_all, ops_bf16 = counts.k2_ops(3, dims, shares)
    assert ops_bf16 == 2 * 2 * 341376
    assert ops_all - ops_bf16 == counts.env_step_ops(3, shares=shares) + 2 * (
        64 + 64 + 1024 + 30 + 2 * 256 + 1)
    ms, what = counts_recurrent.k5_bound(3, dims, 256, 32, 16384, 128, shares)
    n_bytes = (2 * counts.state_bytes(3, 16384) + 4 * sum(a * b + b for a, b in dims)
               + 16 * 256 * 16384 + 4 * 2 * 16384 * (32 * 128 + 6 * 128 + 1))
    work = 16384 * 128
    want = max(n_bytes / counts.HBM_BYTES_PER_S,
               work * (ops_all - ops_bf16) / counts.F32_PER_S
               + work * ops_bf16 / counts.BF16_PER_S) * 1e3
    assert what == "operations" and ms == pytest.approx(want, rel=1e-12)
    flops = counts.ppo_model_flops(dims, 2 * work, 4)
    assert flops == pytest.approx(2 * 341632 * 2 * work * 13, rel=1e-12)


def synthetic(host, kernels):
    """Two calls in a 0.1 ms window (times in us)."""
    return Trace(list(kernels), list(host), 1e-4, 2)


KERNELS = [("recurrent_tc_kernel<7>", 0, 10), ("elementwise_kernel", 20, 40),
           ("Memcpy DtoH", 40, 45), ("recurrent_tc_kernel<7>", 90, 95)]
HOST = [("rppo.collect", 5, 25), ("ops.fused_recurrent_collect", 6, 22),
        ("rppo.gae", 45, 50), ("rppo.update", 50, 100), ("ppo.update", 0, 100)]
WORK = {"bounds": {"k5": (0.0015, "operations")}, "model_flops": 5e5}


@pytest.mark.parametrize("name, value", [
    ("k5_roofline", 100.0 * 0.0015e-3 * 2 / 15e-6),
    ("rppo.mfu", 100.0 * 5e5 * 2 / (1e-4 * counts.BF16_PER_S)),
    ("rppo.launches_per_iter", 1.5),
    ("rppo.collect.idle_ms", 0.005), ("rppo.gae.idle_ms", 0.0025),
    ("rppo.update.idle_ms", 0.0225)])
def test_reader_exact_on_a_synthetic_trace(name, value):
    got = reader(name)(SimpleNamespace(trace=synthetic(HOST, KERNELS), work=WORK))
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    """No trace; a trace of another program (the MLP learner's spans and
    kernels, no K5 bound); a trace without kernels: None, never 0."""
    read = reader(name)
    assert read(SimpleNamespace(trace=None, work=WORK)) is None
    other = synthetic([("ppo.collect", 0, 50), ("ppo.update", 50, 100)],
                      [("collect_tc_kernel<7>", 0, 10)])
    assert read(SimpleNamespace(trace=other, work={"bounds": {"k2": (1.0, "bytes")},
                                                   "model_flops": 1e9})) is None
    assert read(SimpleNamespace(trace=synthetic(HOST, ()), work={})) is None


@pytest.mark.cuda
def test_control_on_the_card(cuda):
    """The cell's control at its own size on the card: not correct."""
    proc = subprocess.run(
        [sys.executable, "-m", "futbench", "--workload", "recurrent_ppo_iter.3v3",
         "--seed", str(SEED), "--seconds", "1", "--control"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False
