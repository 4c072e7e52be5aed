"""The port's bench (``python -m gym_futbol_tpu_torch.bench``) against the
JAX package's (the root ``bench.py``): the same presets, the same flags
and defaults (read from bench.py's source), the same last line, and the
JAX bench's timing loop: two warm-ups, then ``--iters`` calls, each on
the state the call before returned. On the CPU at tiny sizes with
``--device cpu``, where every kernel wrapper runs its plain version.

Deliberate differences, each tested here: ``--device`` (default the
card, an error without one); ``--impl auto`` is ``fused`` with no
fallback to the plain path; ``--scaling`` sweeps process groups of a
torchrun launch (gloo ranks here) where JAX sweeps devices of one mesh.
"""

import argparse
import ast
import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402  (the JAX bench: argparse, json, time)

from gym_futbol_tpu_torch import bench, ops, ppo, vector  # noqa: E402

# Tiny sizes per config. The fused update (config 5, --scaling) needs
# 2 x envs x T a multiple of PPOConfig.shuffle_block (1024) with at
# least one block per minibatch: 2 x 128 x 16 = 4096.
TINY = {
    2: ["--envs", "8", "--steps", "4"],
    3: ["--envs", "8", "--steps", "4"],
    4: ["--envs", "16", "--steps", "4"],
    5: ["--envs", "128", "--steps", "16", "--ppt", "1"],
    6: ["--envs", "8", "--steps", "4"],
}
SCALING = ["--scaling", "--envs", "128", "--steps", "16", "--ppt", "1"]
# (config, impl) pairs the JAX bench has: config 6 has one path
CASES = [(c, i) for c in (2, 3, 4, 5) for i in ("fused", "jnp")] + [(6, "fused")]
TIMEOUT = 240


def _source_tree():
    with open(BENCH_PY) as f:
        return ast.parse(f.read())


def _jax_parser() -> argparse.ArgumentParser:
    """An ArgumentParser built by replaying every ``add_argument`` call of
    bench.py's source, evaluated against its module's names."""
    ap = argparse.ArgumentParser()
    names = {**vars(jbench), "ap": ap}
    for node in ast.walk(_source_tree()):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            node.func.value = ast.Name("ap", ast.Load())
            expr = ast.fix_missing_locations(ast.Expression(node))
            eval(compile(expr, BENCH_PY, "eval"), names)
    return ap


def _dict_keys(fn_name: str) -> list[str]:
    """The keys, in order, of the first dict literal with a ``metric`` key
    in bench.py's function ``fn_name``: the JAX bench's record."""
    fn = next(n for n in ast.walk(_source_tree())
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                return keys
    raise AssertionError(f"no record in bench.py:{fn_name}")


def _actions(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in ap._actions if a.dest != "help"}


JAX_FLAGS = sorted(_actions(_jax_parser()))


def run_bench(argv: list[str]) -> list[str]:
    """The port's bench in this process on the CPU; its stdout lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(argv + ["--device", "cpu"])
    return out.getvalue().splitlines()


def _json_lines(lines: list[str]) -> list[dict]:
    return [json.loads(x) for x in lines if x.startswith("{")]


def _check_last_line(lines: list[str]) -> dict:
    """Exactly one JSON line, the last; every other line a ``#`` line."""
    assert len(_json_lines(lines)) == 1, lines
    assert all(x.startswith("# ") for x in lines[:-1]), lines
    return json.loads(lines[-1])


def test_configs_equal_jax():
    assert bench.CONFIGS == jbench.CONFIGS


@pytest.mark.parametrize("path", [BENCH_PY, bench.__file__],
                         ids=["bench.py", "port"])
def test_module_level_imports(path):
    """Both benches import only argparse, json and time at module level
    (the rest inside the functions that run), so importing either one
    pulls in no JAX and no torch."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names <= {"__future__", "argparse", "json", "time"}, names


@pytest.mark.parametrize("dest", JAX_FLAGS)
def test_flag_matches_jax(dest):
    """Each of bench.py's flags, parsed from its source: the same option
    strings, default, choices, type and action in the port's parser."""
    want = _actions(_jax_parser())[dest]
    got = _actions(bench.build_parser())[dest]
    for field in ("option_strings", "default", "choices", "type", "nargs",
                  "const"):
        assert getattr(got, field) == getattr(want, field), field
    assert type(got) is type(want)


def test_port_adds_only_device():
    jax_flags = {s for a in _actions(_jax_parser()).values()
                 for s in a.option_strings}
    port = _actions(bench.build_parser())
    added = {s for a in port.values() for s in a.option_strings} - jax_flags
    assert added == {"--device"}
    assert port["device"].default == "cuda"


@pytest.mark.parametrize("config,impl", CASES)
def test_last_line(config, impl):
    """One JSON line, the last, with the JAX bench's keys in its order
    and its rounding; every other line a ``#`` line (--verbose). On the
    CPU no kernel launches."""
    lines = run_bench(["--config", str(config), "--impl", impl, "--iters", "1",
                       "--verbose", *TINY[config]])
    rec = _check_last_line(lines)
    assert list(rec) == _dict_keys("main")
    assert rec["metric"] == "env_steps_per_sec" and rec["unit"] == "steps/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 1e6, 3)
    launches = json.loads(next(x for x in lines if "kernel launches" in x)
                          .split(": ", 1)[1])
    assert set(launches) == set(ops.LAUNCHES) and not any(launches.values())


def test_jax_bench_same_keys(tmp_path):
    """The JAX bench itself (JAX on the CPU, its compilation cache in
    ``tmp_path``) at the same tiny size: its last line has the port's
    keys."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "GFT_COMPILATION_CACHE": str(tmp_path / "cache")}
    argv = ["--config", "3", "--impl", "jnp", "--iters", "1", *TINY[3]]
    # the fake 8-device mesh tests/conftest.py forces: 8 envs divide over it
    proc = subprocess.run([sys.executable, BENCH_PY, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.splitlines()[-1])
    got = _check_last_line(run_bench(argv))
    assert list(got) == list(want)


@pytest.mark.parametrize("floor,ok", [(0.0, True), (1e15, False)])
def test_assert_floor(floor, ok):
    """--assert-floor adds ``floor`` and ``ok``; below it the exit code is
    1, with the JSON line still last."""
    argv = ["--config", "3", "--iters", "1", "--assert-floor", str(floor),
            *TINY[3]]
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            bench.main(argv + ["--device", "cpu"])
        except SystemExit as e:
            code = e.code
    rec = _check_last_line(out.getvalue().splitlines())
    assert code == (0 if ok else 1)
    assert list(rec) == _dict_keys("main") + ["floor", "ok"]
    assert rec["floor"] == floor and rec["ok"] is ok


@pytest.mark.parametrize("config,module,name", [
    (3, ops, "fused_rollout"), (4, ppo, "collect_rollout_fused"),
    (5, ppo, "update_epochs_fused"), (6, ops, "fused_selfplay_rollout")])
def test_no_fallback(monkeypatch, config, module, name):
    """With a kernel path failing, --impl auto (the default) ends with
    that error and prints no JSON line: no fallback to the plain path,
    unlike the JAX bench's auto (bench.py:362-388)."""
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(module, name, broken)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="kernel launch failed"):
        bench.main(["--config", str(config), "--iters", "1", "--device", "cpu",
                    *TINY[config]])
    assert not _json_lines(out.getvalue().splitlines())


def test_no_card_is_an_error(monkeypatch, capsys):
    """--device cuda (the default) without a card exits nonzero with no
    JSON line; it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--config", "3", *TINY[3]])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert not _json_lines(capsys.readouterr().out.splitlines())


def _spy_rollout(calls):
    real = ops.fused_rollout

    def spy(sf, si, seed, params, n_steps, **kw):
        out = real(sf, si, seed, params, n_steps, **kw)
        calls.append(((sf, si), seed, out[:2]))
        return out
    return ops, "fused_rollout", spy


def _spy_selfplay(calls):
    real = ops.fused_selfplay_rollout

    def spy(sf, si, wa, wb, seed, params, n_steps, **kw):
        out = real(sf, si, wa, wb, seed, params, n_steps, **kw)
        calls.append(((sf, si), seed, out[:2]))
        return out
    return ops, "fused_selfplay_rollout", spy


def _spy_plain_rollout(calls):
    real = vector.rollout

    def spy(state, policy, gen, params, n_steps):
        out = real(state, policy, gen, params, n_steps)
        calls.append(((state,), gen.initial_seed(), out[:1]))
        return out
    return vector, "rollout", spy


def _spy_runner(name):
    def make(calls):
        real = getattr(ppo, name)

        def spy(runner, *a, **k):
            out = real(runner, *a, **k)
            calls.append(((runner,), k, out[:1]))
            return out
        return ppo, name, spy
    return make


@pytest.mark.parametrize("config,impl,make_spy,seeded", [
    (2, "fused", _spy_rollout, True),
    (3, "fused", _spy_rollout, True),
    (3, "jnp", _spy_plain_rollout, True),
    (6, "fused", _spy_selfplay, True),
    (4, "fused", _spy_runner("collect_rollout_fused"), False),
    (4, "jnp", _spy_runner("collect_rollout"), False),
    (5, "fused", _spy_runner("train_iteration"), False),
    (5, "jnp", _spy_runner("train_iteration"), False),
], ids=["2-fused", "3-fused", "3-jnp", "6-fused", "4-fused", "4-jnp",
        "5-fused", "5-jnp"])
def test_timed_loop_chains_state(monkeypatch, config, impl, make_spy, seeded):
    """iters + 2 calls (two warm-ups, then the timed loop), each on the
    state the call before returned; the rollouts' seeds 1, 1, then 2 + i
    (bench.py:43-85); config 5 iterates on the kernels, or on the plain
    collect and the autograd update with --impl jnp."""
    iters, calls = 3, []
    monkeypatch.setattr(*make_spy(calls))
    run_bench(["--config", str(config), "--impl", impl, "--iters", str(iters),
               *TINY[config]])
    assert len(calls) == iters + 2
    for (_, _, out), (state, _, _) in zip(calls, calls[1:]):
        assert all(a is b for a, b in zip(state, out))
    if seeded:
        assert [c[1] for c in calls] == [1, 1, *range(2, iters + 2)]
    if config == 5:
        fused = impl == "fused"
        for _, kw, _ in calls:
            assert kw["collect_fn"] is (ppo.collect_rollout_fused if fused
                                        else ppo.collect_rollout)
            assert kw["update_fn"] is (ppo.update_epochs_fused if fused
                                       else ppo.update_epochs)
            assert kw["group"] is None


def test_scaling_one_rank():
    """Without torchrun one rank: efficiency 1.0, the JAX sweep's keys."""
    lines = run_bench(SCALING + ["--iters", "1"])
    rec = _check_last_line(lines)
    assert list(rec) == _dict_keys("bench_scaling")
    assert rec["metric"] == "weak_scaling_efficiency"
    assert rec["value"] == 1.0 and rec["vs_baseline"] == round(1 / 0.9, 3)
    assert list(rec["steps_per_sec"]) == ["1"] and rec["steps_per_sec"]["1"] > 0
    assert [x for x in lines if x.startswith("# scaling")] == [lines[0]]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_scaling_two_gloo_ranks():
    """--scaling over two gloo ranks, one process each with torchrun's
    environment: rank 0 prints a ``# scaling`` line for groups of 1 and 2
    and the last line with the JAX sweep's keys; rank 1 prints nothing."""
    world, port = 2, _free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r),
               "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gym_futbol_tpu_torch.bench", *SCALING,
             "--iters", "1", "--device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{out}\n{err[-4000:]}"
    lines = logs[0][0].splitlines()
    rec = _check_last_line(lines)
    assert list(rec) == _dict_keys("bench_scaling")
    assert list(rec["steps_per_sec"]) == ["1", "2"]
    assert all(v > 0 for v in rec["steps_per_sec"].values())
    assert rec["value"] > 0
    assert rec["unit"] == "fraction of linear at 2 devices (128 envs/device)"
    assert [x.split(":")[0] for x in lines[:-1]] == [
        "# scaling   1 dev x 128 envs", "# scaling   2 dev x 128 envs"]
    assert logs[1][0] == ""


def test_module_run_imports_no_jax():
    """``python -m gym_futbol_tpu_torch.bench`` as a user runs it: exit 0,
    the JSON line last, and no module of JAX, flax, optax or the JAX
    package among everything it imported (``-X importtime`` lists each)."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gym_futbol_tpu_torch.bench",
         "--config", "3", "--iters", "1", "--device", "cpu", *TINY[3]],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _check_last_line(proc.stdout.splitlines())
    imported = {line.split("|")[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    assert "torch" in imported
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "gym_futbol_tpu"))
    assert not bad, bad
