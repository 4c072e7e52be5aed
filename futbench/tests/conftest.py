"""Shared pieces of the harness's tests: a copy of the benchmark with
cells small enough for the host, and a runner of its command.

    python -m pytest futbench/tests -q

Tests marked ``cuda`` run the harness on the card and skip without one.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_CONFIG = {
    "name": "tiny_2v2", "players_per_team": 2, "env_params": {"max_steps": 12},
    "hidden": [16, 16], "reduced": [],
    "ppo": {"gamma": 0.99, "gae_lambda": 0.95, "clip_eps": 0.2, "lr": 0.0003,
            "epochs": 4, "minibatches": 4, "vf_coef": 0.5, "ent_coef": 0.01,
            "max_grad_norm": 0.5, "shuffle_block": 128},
}
LIMITS = {"env_mismatches": 0, "logp_gap": 0.05, "value_gap": 0.05, "tie_gap": 0.05,
          "loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.05, "replica_gap": 0}
TINY_TRAFFIC = {
    "rollout.tiny": {"kind": "rollout", "envs": 64, "steps": 16, "warmup_calls": 1,
                     "check_within": 2, "check_envs": 8, "trace_calls": 2,
                     "limits": {"mismatches": 0}},
    "ppo.tiny": {"kind": "ppo_iter", "envs": 64, "steps": 8, "recorded_iterations": 3,
                 "check_envs": 4, "trace_calls": 1, "limits": LIMITS},
}
TINY_CELLS = [
    {"name": "rollout.tiny", "config": "tiny_2v2", "traffic": "rollout.tiny", "chips": 1},
    {"name": "ppo.tiny", "config": "tiny_2v2", "traffic": "ppo.tiny", "chips": 1},
    {"name": "ppo.tiny.x2", "config": "tiny_2v2", "traffic": "ppo.tiny", "chips": 2},
]


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    """A checkout of the benchmark alone (``BENCHMARK.json`` and
    ``futbench/``) with the tiny cells added as new files and entries."""
    shutil.copytree(os.path.join(ROOT, "futbench"), tmp_path / "futbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(tmp_path / "futbench" / "configs" / "tiny_2v2.json", "w") as f:
        json.dump(TINY_CONFIG, f)
    for name, traffic in TINY_TRAFFIC.items():
        with open(tmp_path / "futbench" / "traffic" / f"{name}.json", "w") as f:
            json.dump(traffic, f)
    bench = benchmark()
    bench["workloads"] += [dict(c, why="a test's size") for c in TINY_CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c["name"] for c in TINY_CELLS]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp_path


def run(cwd, *args, program=True, timeout=600):
    """The benchmark's command in ``cwd`` on the host (``--device cpu``):
    (exit code, the result line or None, standard error)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT if program else ""
    cmd = [sys.executable, "-m", "futbench", *args, "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    return proc.returncode, result, proc.stderr
