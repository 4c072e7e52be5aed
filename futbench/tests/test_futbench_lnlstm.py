"""The layer-normalised LSTM cell (traffic kind ``recurrent_ppo_iter_ln``)
and its readers: the loop builds the program's layer-normalised model
(the configuration's ``layer_norm`` read, not ignored) and refuses a
configuration without it; the reference's cell with its LayerNorms at
gains 1 and biases 0 is not the plain LSTM's; the cell end to end on the
host at a test's size, correct, and not correct under the control, the
``unchanged`` fault and a program that drops one LayerNorm; the
counts of ``futbench/counts_lnlstm.py`` by hand; each new reader exact on
a synthetic trace and silent without its spans, kernels or bounds."""

import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT, benchmark, run

from futbench import counts, counts_lnlstm, counts_recurrent
from futbench import run as bench_run
from futbench.reference import lnlstm as ref_ln
from futbench.reference import recurrent as ref_rec
from futbench.trace import Trace

SEED = 2**31 + 29
CELL = "lnrppo.tiny"
TINY_CONFIG = {
    "name": "tiny_lnlstm_2v2", "players_per_team": 2, "env_params": {"max_steps": 12},
    "hidden": [16, 16], "lstm_size": 12, "layer_norm": True, "reduced": [],
    "compute_dtype": "bfloat16",
    "ppo": {"gamma": 0.99, "gae_lambda": 0.95, "clip_eps": 0.2, "lr": 0.00025,
            "epochs": 2, "minibatches": 2, "vf_coef": 0.5, "ent_coef": 0.01,
            "max_grad_norm": 0.5, "shuffle_block": 16},
}
TINY_TRAFFIC = {
    "kind": "recurrent_ppo_iter_ln", "envs": 32, "steps": 6, "recorded_iterations": 2,
    "check_envs": 4, "trace_calls": 1, "lead_steps": 4,
    "limits": {"env_mismatches": 0, "lead_logp_gap": 0.05, "lead_value_gap": 0.05,
               "lead_tie_gap": 0.05, "loss_gap": 0.05, "grad_gap": 0.05,
               "change_gap": 0.05},
}
READERS = ("k5ln_roofline", "k6ln_roofline", "lnrppo.bptt.idle_ms", "lnrppo.mfu")
# a program whose update leaves out LN(t Wi): the gates' input side
# unnormalised (its gain and bias kept) in the BPTT node
DROP_LN = """
import runpy, sys
import torch

def no_norm(x, shape, w, b, eps):
    return x * w + b, x.new_zeros(x.shape[0], 1), x.new_ones(x.shape[0], 1)

torch.native_layer_norm = no_norm
sys.argv = ["futbench"] + sys.argv[1:]
runpy.run_module("futbench", run_name="__main__")
"""
# a program whose collect leaves out LN(c'): h' = o tanh(c') in K5's plain
# version (the host's route), the gates' LayerNorms kept
DROP_LN_C = """
import runpy, sys
from gym_futbol_tpu_torch.ops import fused_recurrent

real = fused_recurrent._ln_rows

def ln_rows(y, g, b):
    return y if y.shape[0] == %d else real(y, g, b)

fused_recurrent._ln_rows = ln_rows
sys.argv = ["futbench"] + sys.argv[1:]
runpy.run_module("futbench", run_name="__main__")
""" % TINY_CONFIG["lstm_size"]
LEAD = ("lead_logp_gap", "lead_value_gap", "lead_tie_gap")


@pytest.fixture
def tiny(tmp_path):
    """A checkout of the benchmark alone with the tiny LayerNorm cell added
    as new files and entries, reporting every metric its entry lists."""
    shutil.copytree(os.path.join(ROOT, "futbench"), tmp_path / "futbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(tmp_path / "futbench" / "configs" / "tiny_lnlstm_2v2.json", "w") as f:
        json.dump(TINY_CONFIG, f)
    with open(tmp_path / "futbench" / "traffic" / f"{CELL}.json", "w") as f:
        json.dump(TINY_TRAFFIC, f)
    bench = benchmark()
    bench["workloads"].append({"name": CELL, "config": "tiny_lnlstm_2v2",
                               "traffic": CELL, "chips": 1, "why": "a test's size"})
    for m in bench["per_layer"]:
        if "recurrent_ppo_iter_ln.3v3" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return tmp_path


def reader(name):
    return bench_run.load_module("metrics", name).read


def test_the_cell_is_in_the_benchmark():
    spec = bench_run.cell_spec(ROOT, "recurrent_ppo_iter_ln.3v3")
    assert spec["chips"] == 1
    assert {m["name"] for m in spec["per_layer"]} == set(READERS)
    assert {m["name"] for m in spec["e2e"]} == {"env_steps_per_s", "setup_s"}
    config = bench_run.load_json("configs", spec["config"])
    assert (config["hidden"], config["lstm_size"], config["layer_norm"],
            config["reduced"]) == ([64, 64], 256, True, [])
    plain = bench_run.load_json("configs", "futbol_3v3_mlplstm")
    assert {k: v for k, v in config.items() if k in ("ppo", "compute_dtype",
                                                     "players_per_team")} == {
        k: plain[k] for k in ("ppo", "compute_dtype", "players_per_team")}
    traffic = bench_run.load_json("traffic", spec["traffic"])
    assert traffic["kind"] == "recurrent_ppo_iter_ln"
    own = ("kind", "limits", "lead_steps")
    assert {k: v for k, v in traffic.items() if k not in own} == {
        k: v for k, v in bench_run.load_json("traffic", "rppo.16384x128").items()
        if k not in own}
    assert 0 < traffic["lead_steps"] <= traffic["steps"]


def _cell(config):
    loop = bench_run.load_module("loops", "recurrent_ppo_iter_ln")
    ctx = bench_run.Context(torch.device("cpu"), SEED, 0, 1, None)
    return loop.Cell(config, TINY_TRAFFIC, ctx)


def test_loop_builds_the_layer_normalised_model():
    """The loop's runner holds the program's layer-normalised model, its
    leaves the loop's weights (the six LayerNorm leaves last, drawn off 1
    and 0); a configuration without ``"layer_norm": true`` is refused."""
    cell = _cell(TINY_CONFIG)
    cell.setup()
    model = cell.runner.model
    assert model.layer_norm and len(model.layer_norms()) == 3
    names = [n for n, _ in model.named_parameters()]
    assert names[-6:] == ["ln_i.weight", "ln_i.bias", "ln_h.weight", "ln_h.bias",
                          "ln_c.weight", "ln_c.bias"]
    assert len(cell.w0) == len(names)
    gains, biases = cell.w0[-6::2], cell.w0[-5::2]
    assert all(0.5 < g.mean() < 1.5 and not torch.equal(g, torch.ones_like(g))
               for g in gains)
    assert all(b.abs().max() < 0.1 and b.abs().max() > 0 for b in biases)
    for bad in ({k: v for k, v in TINY_CONFIG.items() if k != "layer_norm"},
                dict(TINY_CONFIG, layer_norm=False)):
        with pytest.raises(ValueError, match="layer_norm"):
            _cell(bad)


def test_reference_is_not_the_plain_cell():
    """With its LayerNorms at gains 1 and biases 0 (stable-baselines'
    start) the reference's cell is still not the plain LSTM's: a
    reference that dropped the norms would read equal here."""
    gen = torch.Generator().manual_seed(1)
    hs, n_t = 8, 16
    plain = [torch.randn(30, n_t, generator=gen) * 0.3, torch.zeros(n_t),
             torch.randn(n_t, 4 * hs, generator=gen) * 0.3,
             torch.randn(hs, 4 * hs, generator=gen) * 0.3,
             torch.randn(4 * hs, generator=gen) * 0.1,
             torch.randn(hs, 10, generator=gen), torch.zeros(10),
             torch.randn(hs, 1, generator=gen), torch.zeros(1)]
    ln = [torch.ones(4 * hs), torch.zeros(4 * hs), torch.ones(4 * hs), torch.zeros(4 * hs),
          torch.ones(hs), torch.zeros(hs)]
    t = torch.tanh(torch.randn(5, n_t, generator=gen))
    c, h = (torch.randn(5, hs, generator=gen) for _ in range(2))
    got = ref_ln.cell(plain + ln, t, c, h, "f32")
    want = ref_rec.cell(plain, t, c, h, "f32")
    assert (got[0] - want[0]).abs().max() > 0.1
    assert (got[1] - want[1]).abs().max() > 0.1
    assert ref_ln.plain(plain + ln) == plain


def test_tiny_cell(tiny):
    rc, result, err = run(tiny, "--workload", CELL, "--seed", str(SEED), "--seconds", "0.2")
    assert rc == 0, err
    assert result["correct"] and result["attempted"] >= 1, err
    assert {"env_steps_per_s", "setup_s"} <= set(result["metrics"])
    assert set(result["checks"]) == set(TINY_TRAFFIC["limits"])


@pytest.mark.parametrize("how", ["--control", "--fault=unchanged"])
def test_control_and_fault_come_out_not_correct(tiny, how):
    """Not correct under the control (the reference in float8 in the
    program's place: its collect's lead numbers among those over their
    limits) and under a update that leaves the weights unchanged."""
    rc, result, err = run(tiny, "--workload", CELL, "--seed", "9", "--seconds", "0.1", how)
    assert rc == 0, err
    assert result["correct"] is False
    if how == "--control":
        checks = result["checks"]
        assert any(checks[k]["value"] > checks[k]["limit"] for k in LEAD), checks


def _faulty_run(tiny, source: str) -> dict:
    """The tiny cell's result under a program changed by ``source``."""
    script = tiny / "faulty.py"
    script.write_text(source)
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{tiny}")
    proc = subprocess.run([sys.executable, str(script), "--workload", CELL, "--seed", "9",
                           "--seconds", "0.1", "--device", "cpu"], cwd=tiny, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dropped_layer_norm_comes_out_not_correct(tiny):
    """The grader's own guard: a program whose update leaves out one
    LayerNorm (LN(t Wi) in the BPTT node) reads over at least one
    limit."""
    assert _faulty_run(tiny, DROP_LN)["correct"] is False


def test_collect_without_ln_c_comes_out_not_correct(tiny):
    """A collect that leaves out LN(c') reads over the collect's own lead
    numbers, which the update's buffers cannot hide."""
    checks = _faulty_run(tiny, DROP_LN_C)["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in LEAD), checks


def test_lnlstm_counts_by_hand():
    """3v3, torso (64, 64), H = 256: K5-LN's bound is K5's bytes and
    operations with both views' three LayerNorms (9H elements, 8
    operations each) a step in float32; K6-LN's the recurrence's two
    products (three bf16 each), its two recurrent LayerNorms forward and
    backward (5H elements, 18 operations each) and 15H x 4 bytes a row
    and step, over 16 minibatches of 8192 sequences."""
    dims = counts_recurrent.lstm_dims(30, (64, 64), 256, 30)
    shares = {"pairs_env": 2.0, "walls_env": 3.0}
    plain = counts_recurrent.k5_bound(3, dims, 256, 32, 16384, 128, shares)
    ms, what = counts_lnlstm.k5ln_bound(3, dims, 256, 32, 16384, 128, shares)
    work = 16384 * 128
    assert what == "operations"
    assert ms * 1e-3 == pytest.approx(plain[0] * 1e-3 + work * 2 * 9 * 256 * 8
                                      / counts.F32_PER_S, rel=1e-12)
    ms6, what6 = counts_lnlstm.k6ln_bound(256, 8192, 128, 16)
    rows = 8192 * 128 * 16
    t_ops = (rows * 6 * 2 * 256 * 1024 / counts.BF16_PER_S
             + rows * 5 * 256 * 18 / counts.F32_PER_S)
    t_bytes = rows * 4 * 15 * 256 / counts.HBM_BYTES_PER_S
    assert ms6 == pytest.approx(max(t_ops, t_bytes) * 1e3, rel=1e-12)
    assert what6 == ("bytes" if t_bytes >= t_ops else "operations")
    w = counts_lnlstm.work(3, 30, (64, 64), 256, 30, 32, 16384, 128, shares,
                           {"epochs": 4, "minibatches": 4})
    assert w["bounds"]["k6ln"] == (ms6, what6)
    assert w["model_flops"] == counts.ppo_model_flops(dims, 2 * work, 4)


def synthetic(host, kernels):
    """Two calls in a 0.1 ms window (times in us)."""
    return Trace(list(kernels), list(host), 1e-4, 2)


KERNELS = [("recurrent_ln_tc_kernel<7>", 0, 10), ("bptt_ln_forward_kernel", 55, 65),
           ("bptt_ln_backward_kernel", 70, 80), ("recurrent_tc_kernel<7>", 85, 86),
           ("bptt_forward_kernel", 86, 88)]
HOST = [("rppo.collect", 0, 20), ("rppo.update", 50, 100),
        ("ops.fused_lnlstm_bptt", 52, 66), ("ops.fused_lnlstm_bptt", 68, 84)]
WORK = {"bounds": {"k5ln": (0.0015, "operations"), "k6ln": (0.004, "bytes")},
        "model_flops": 5e5}


@pytest.mark.parametrize("name, value", [
    ("k5ln_roofline", 100.0 * 0.0015e-3 * 2 / 10e-6),
    ("k6ln_roofline", 100.0 * 0.004e-3 * 2 / 20e-6),
    ("lnrppo.mfu", 100.0 * 5e5 * 2 / (1e-4 * counts.BF16_PER_S)),
    ("lnrppo.bptt.idle_ms", (3 + 1 + 2 + 4) * 1e-3 / 2)])
def test_reader_exact_on_a_synthetic_trace(name, value):
    got = reader(name)(SimpleNamespace(trace=synthetic(HOST, KERNELS), work=WORK))
    assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    """No trace; a trace of the plain LSTM's program (its kernels and
    spans, K5's bound); a trace without kernels: None, never 0."""
    read = reader(name)
    assert read(SimpleNamespace(trace=None, work=WORK)) is None
    other = synthetic([("rppo.update", 0, 100), ("ops.fused_lstm_bptt", 10, 60)],
                      [("recurrent_tc_kernel<7>", 0, 10), ("bptt_forward_kernel", 20, 30)])
    assert read(SimpleNamespace(trace=other, work={"bounds": {"k5": (1.0, "bytes")},
                                                   "model_flops": 1e9})) is None
    assert read(SimpleNamespace(trace=synthetic(HOST, ()), work={})) is None
