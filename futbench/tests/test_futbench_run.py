"""The harness end to end on the host, at a test's size (``--device
cpu``: the program's plain versions): the result line's shape, cells,
configurations and metrics added as new files and entries alone, the
comparison failing under the control and under each fault of the timed
path, two ranks over gloo, and the refusals (no program, JAX loaded,
no card)."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT, run

SEED = 2**31 + 17


def assert_result_shape(result, trace):
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] >= 1
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["rollout.tiny", "ppo.tiny"])
def test_tiny_cell(tiny, cell):
    rc, result, err = run(tiny, "--workload", cell, "--seed", str(SEED), "--seconds", "0.2")
    assert rc == 0, err
    assert_result_shape(result, trace=False)
    assert result["correct"] and result["attempted"] >= 1
    assert {"env_steps_per_s", "setup_s"} <= set(result["metrics"])
    # the checks end standard error, each beside its limit
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in last)


def test_traced_tiny_cell(tiny):
    rc, result, err = run(tiny, "--workload", "rollout.tiny", "--seed", "5",
                          "--seconds", "0.2", "--trace", "1")
    assert rc == 0, err
    assert_result_shape(result, trace=True)
    assert result["correct"]


def test_added_by_files_alone(tiny):
    """A new configuration, traffic mix, cell and per-layer metric: new
    files and BENCHMARK.json entries, no file edited."""
    with open(tiny / "futbench" / "configs" / "tiny_2v2.json") as f:
        config = json.load(f)
    config.update(name="dummy_1v1", players_per_team=1)
    with open(tiny / "futbench" / "configs" / "dummy_1v1.json", "w") as f:
        json.dump(config, f)
    with open(tiny / "futbench" / "traffic" / "rollout.dummy.json", "w") as f:
        json.dump({"kind": "rollout", "envs": 32, "steps": 4, "warmup_calls": 1,
                   "check_within": 1, "check_envs": 4, "trace_calls": 1,
                   "limits": {"mismatches": 0}}, f)
    with open(tiny / "futbench" / "metrics" / "dummy.calls.py", "w") as f:
        f.write("def read(run):\n    return float(run.calls)\n")
    with open(tiny / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy_1v1", "source": "a test",
                             "file": "futbench/configs/dummy_1v1.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "rollout.dummy", "config": "dummy_1v1",
                               "traffic": "rollout.dummy", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy.calls", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["rollout.dummy"]})
    with open(tiny / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    rc, result, err = run(tiny, "--workload", "rollout.dummy", "--seed", "3",
                          "--seconds", "0.1")
    assert rc == 0, err
    assert result["correct"] and result["metrics"]["dummy.calls"]["value"] >= 1


@pytest.mark.parametrize("cell, how", [
    ("rollout.tiny", "--control"), ("rollout.tiny", "--fault=unchanged"),
    ("rollout.tiny", "--fault=half_batch"), ("rollout.tiny", "--fault=altered"),
    ("ppo.tiny", "--control"), ("ppo.tiny", "--fault=unchanged"),
    ("ppo.tiny", "--fault=half_batch"), ("ppo.tiny", "--fault=half_envs"),
    ("ppo.tiny", "--fault=altered")])
def test_control_and_faults_come_out_not_correct(tiny, cell, how):
    rc, result, err = run(tiny, "--workload", cell, "--seed", "9", "--seconds", "0.1", how)
    assert rc == 0, err
    assert result["correct"] is False


@pytest.mark.parametrize("how", [None, "--fault=no_exchange"])
def test_two_ranks(tiny, how):
    extra = [how] if how else []
    rc, result, err = run(tiny, "--workload", "ppo.tiny.x2", "--seed", "4",
                          "--seconds", "0.1", *extra)
    assert rc == 0, err
    assert result["device"]["count"] == 2 and "replica_gap" in result["checks"]
    assert result["correct"] is (how is None)


def test_no_program_no_result(tiny):
    rc, result, _ = run(tiny, "--workload", "rollout.tiny", "--seed", "1",
                        "--seconds", "0.1", program=False)
    assert rc != 0 and result is None


def test_jax_loaded_no_result(tiny):
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "from futbench.run import main; sys.exit(main(sys.argv[1:]))")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", "rollout.tiny", "--seed", "1",
         "--seconds", "0.1", "--device", "cpu"],
        cwd=tiny, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "jax" in proc.stderr


def test_no_card_no_result(tiny):
    proc = subprocess.run(
        [sys.executable, "-m", "futbench", "--workload", "rollout.tiny", "--seed", "1",
         "--seconds", "0.1"],
        cwd=tiny, env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rollout.2v2", "ppo_iter.5v5"])
def test_control_on_the_card(cuda, cell):
    """The cell's control at its own size on the card: not correct."""
    proc = subprocess.run(
        [sys.executable, "-m", "futbench", "--workload", cell, "--seed", str(SEED),
         "--seconds", "1", "--control"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is False
