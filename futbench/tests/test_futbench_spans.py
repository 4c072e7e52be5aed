"""The readers of device-idle time inside the program's spans
(``futbench/spans.py``; ``ppo.collect.idle_ms``, ``ppo.gae.idle_ms``,
``ppo.update.idle_ms``, ``ops.idle_ms``): exact on a synthetic trace,
nothing to read without spans, kernels or a trace; a traced tiny PPO
cell on the host; and on the card, the program's spans on the kernels'
clock and never among them."""

import re
from types import SimpleNamespace

import pytest
from conftest import ROOT, run

from futbench import run as bench_run
from futbench.spans import idle_s
from futbench.trace import Trace

READERS = ("ppo.collect.idle_ms", "ppo.gae.idle_ms", "ppo.update.idle_ms", "ops.idle_ms")


def reader(name):
    return bench_run.load_module("metrics", name).read


def synthetic(host, kernels=(("k", 0, 10), ("k", 20, 30), ("k", 25, 40), ("k", 90, 95))):
    """Busy [0, 10], [20, 40], [90, 95] (us), two calls, a 0.1 ms window."""
    return Trace(list(kernels), list(host), 1e-4, 2)


HOST = [
    ("ppo.collect", 5, 25),          # idle 10..20: 10 us
    ("aten::mul", 6, 8),
    ("ppo.gae", 40, 50),             # all idle: 10 us
    ("ppo.update", 50, 100),         # busy 90..95: 45 us idle
    ("ops.fused_collect", 8, 22),    # idle 10..20: 10 us
    ("ops.fused_minibatch_grad", 60, 70),
    ("ops.fused_minibatch_grad", 65, 92),   # union 60..92: idle 30 us
]


@pytest.mark.parametrize("name, ms", [
    ("ppo.collect.idle_ms", 0.005), ("ppo.gae.idle_ms", 0.005),
    ("ppo.update.idle_ms", 0.0225), ("ops.idle_ms", 0.020)])
def test_reader_exact_on_a_synthetic_trace(name, ms):
    got = reader(name)(SimpleNamespace(trace=synthetic(HOST)))
    assert got == pytest.approx(ms, rel=1e-12)


def test_idle_inside_a_busy_span_is_zero():
    assert idle_s(synthetic([("ppo.gae", 0, 10), ("ppo.gae", 22, 38)]), "ppo.gae") == 0.0


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    read = reader(name)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(SimpleNamespace(trace=synthetic([("aten::mul", 0, 50)]))) is None
    assert read(SimpleNamespace(trace=synthetic(HOST, kernels=()))) is None


def test_traced_tiny_ppo_cell(tiny):
    """The tiny PPO cell traced on the host: exit 0, correct; with no
    kernel on the host the span readers have nothing to read."""
    rc, result, err = run(tiny, "--workload", "ppo.tiny", "--seed", str(2**31 + 5),
                          "--seconds", "0.2", "--trace", "1")
    assert rc == 0, err
    assert result["correct"]
    assert not set(READERS) & set(result["metrics"])


@pytest.mark.cuda
def test_spans_share_the_kernels_clock(cuda):
    """A traced window of ``ppo_iter.5v5`` (its configuration and traffic
    as they are) in this process: no program span among the trace's
    kernels; each K2 and K3 launch starts on the device after its
    wrapper's span opened on the host; the readers read."""
    import torch

    from futbench.trace import traced_window

    spec = bench_run.cell_spec(ROOT, "ppo_iter.5v5")
    config = bench_run.load_json("configs", spec["config"])
    traffic = bench_run.load_json("traffic", spec["traffic"])
    cell = bench_run.load_module("loops", traffic["kind"]).Cell(
        config, dict(traffic, recorded_iterations=1),
        bench_run.Context(cuda, 2**31 + 11, 0, 1, None))
    cell.setup()
    torch.cuda.synchronize()
    trace = traced_window(cell.traced_call, 2, 60.0, lambda stop: stop, True)
    spans = re.compile(r"^(ppo|ops|futbench)\.")
    assert not [n for n, _, _ in trace.kernels if spans.match(n)]

    def starts(names, pattern):
        rx = re.compile(pattern)
        return sorted(s for n, s, _ in names if rx.search(n))

    pairs = {"ops.fused_collect": r"^collect_(tc_)?kernel",
             "ops.fused_minibatch_grad": r"^tc_forward_kernel"}
    for wrapper, kernel in pairs.items():
        opened = starts(trace.host, f"^{re.escape(wrapper)}$")
        ran = starts(trace.kernels, kernel)
        assert len(opened) == len(ran) > 0, (wrapper, len(opened), len(ran))
        lead_us = [k - s for s, k in zip(opened, ran)]
        assert min(lead_us) >= 0, (wrapper, lead_us)
        print(f"{wrapper}: {len(ran)} launches, span open to kernel start "
              f"{min(lead_us):.1f}-{max(lead_us):.1f} us")
    run_ = SimpleNamespace(trace=trace)
    for name in READERS:
        value = reader(name)(run_)
        assert value is not None and value >= 0, name
        print(f"{name} {value:.4f}")
    idle_ms = (trace.window_s - trace.busy_s) * 1e3 / trace.calls
    print(f"device idle {idle_ms:.4f} ms an iteration, {trace.calls} iterations")
    assert sum(reader(n)(run_) for n in READERS[:3]) <= idle_ms
