"""The port's learning gates (``gym_futbol_tpu_torch.check_learning`` and
``check_recurrent_learning``) and ``make_normalized_policy_fn``, on the
CPU at smoke sizes.

- Both gates end to end as ``python -m`` processes (MLP with and without
  ``--normalize``; recurrent ``ppo`` and ``a2c`` with ``--fused-collect``
  on K5's plain version): the last line has the keys of the JAX
  package's gate (read from its source), the exit code is the verdict's
  (0 when it passed, else 1; at these sizes no goal is scored, so the
  strict final-beats-1/3 test fails and the verdict is 1), the curves,
  records, snapshots and league land under ``--out-dir`` and nothing
  under ``parity/`` changes.
- Split calls: ``--max-new-seeds 1`` twice (the first exits 2) gives the
  one call's last line, but for ``train_seconds_total``.
- A seed record written under other flags is refused, the flags named.
- A seed's snapshots equal bitwise the training CLI's checkpoints at the
  same flags and seed (``--lr-anneal --fused-collect``, with
  ``--normalize-obs --normalize-reward`` for ``--normalize``).
- A seed record trained by other code (the package's sources or the
  torch version) is refused.
- Both gates against the JAX package's own (``parity/check_learning.py``
  and ``parity/check_recurrent_learning.py``, loaded and run in process),
  training and evaluation stubbed in both with one table of canned
  metrics and win rates: the same runner inits (seeds, envs, widths,
  rates, normalisation), the same anneal, the same evaluations in the
  same order (snapshot, opponent, envs, steps, seed: the 1/3 snapshot,
  the seeds ``seed + 7`` / ``seed + 11`` / ``9000 + 17 i + j``, the 1024
  envs of the plain check), the same per-seed records, curves and league
  file, and the same last line but for ``train_seconds_total`` and the
  port's extra hyperparameters.
- The league's points and the 4-sigma consistency band against values
  worked out by hand from the JAX gate's formulas.
- ``make_normalized_policy_fn`` against JAX's: the same weights, the same
  frozen statistics and the same uniforms give the same actions; the
  z-scored observation within atol 1e-6 (f32 rounding: the two
  frameworks' ``sqrt`` and division may differ in the last bit).

The MLP gates run 512 envs x T=4: the fused update needs a buffer of
whole 1024-sample blocks, at least one per minibatch, and on the CPU a
wide short rollout costs less than a narrow long one.
"""

import ast
import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import types
import zlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import env as jenv  # noqa: E402
from gym_futbol_tpu.models import policy as jpolicy  # noqa: E402
from gym_futbol_tpu.wrappers import RunningNorm as JRunningNorm  # noqa: E402
from gym_futbol_tpu_torch import a2c as ta2c  # noqa: E402
from gym_futbol_tpu_torch import check_learning as gate  # noqa: E402
from gym_futbol_tpu_torch import check_recurrent_learning as rgate  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    running_norm_from_numpy,
)
from gym_futbol_tpu_torch import evaluate as tevaluate  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as trppo  # noqa: E402
from gym_futbol_tpu_torch import wrappers as twrappers  # noqa: E402
from gym_futbol_tpu_torch.models import policy as tpolicy  # noqa: E402
from gym_futbol_tpu_torch.models import recurrent as trecurrent  # noqa: E402
# the module, which ops/__init__ shadows with its function of that name
tfused_collect = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

MLP_ARGV = ["--device", "cpu", "--ppt", "1", "--envs", "512",
            "--rollout-steps", "4", "--iters", "3", "--hidden", "16", "16",
            "--eval-envs", "16", "--max-steps", "12", "--seeds", "2",
            "--win-threshold", "0"]
RECURRENT_ARGV = ["--device", "cpu", "--ppt", "1", "--envs", "8", "--iters",
                  "3", "--hidden", "16", "--lstm-size", "8", "--eval-envs",
                  "8", "--max-steps", "12", "--seeds", "2",
                  "--win-threshold", "0", "--fused-collect"]


def _jax_final_keys(script: str) -> set[str]:
    """The keys of the dict the JAX gate prints last: the dict literal in
    its source that holds "metric"."""
    with open(os.path.join(REPO, "parity", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError(f"no final dict in {script}")


def _parity_files() -> dict:
    """(size, mtime) of every file under parity/ but Python's bytecode
    caches (the JAX package's own tests run its scripts)."""
    out = {}
    for root, dirs, files in os.walk(os.path.join(REPO, "parity")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(root, name)
            st = os.stat(path)
            out[path] = (st.st_size, st.st_mtime_ns)
    return out


def _run(module: str, argv: list[str]):
    """``python -m gym_futbol_tpu_torch.<module> argv`` from the repo
    root: (exit code, stdout lines, the last line as JSON)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"gym_futbol_tpu_torch.{module}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT, env=env)
    lines = proc.stdout.splitlines()
    assert lines, proc.stderr[-3000:]
    try:
        last = json.loads(lines[-1])
    except json.JSONDecodeError:
        raise AssertionError(proc.stderr[-3000:]) from None
    return proc.returncode, lines, last


def _check_verdict(rc, last, script):
    assert set(last) == _jax_final_keys(script)
    assert rc == (0 if last["ok"] else 1)
    ok = last["value"] >= last["threshold"] and last["monotonic_all"]
    assert not last["ok"] or ok


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """One call of the MLP gate, unnormalised and normalised, each in its
    own --out-dir: {normalize: (out_dir, exit code, lines, last line)}."""
    before = _parity_files()
    runs = {}
    for norm in (False, True):
        out = str(tmp_path_factory.mktemp("norm" if norm else "plain"))
        argv = MLP_ARGV + ["--out-dir", out] + (["--normalize"] if norm else [])
        runs[norm] = (out, *_run("check_learning", argv))
    assert _parity_files() == before, "the gate wrote under parity/"
    return runs


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "normalize"])
def test_mlp_gate_end_to_end(mlp_runs, norm):
    out, rc, lines, last = mlp_runs[norm]
    _check_verdict(rc, last, "check_learning.py")
    suffix = "_norm" if norm else ""
    assert last["metric"] == ("normalized_" if norm else "") + \
        "trained_vs_random_win_rate_mean"
    assert last["ppt"] == 1 and len(last["per_seed"]) == 2
    assert last["train_env_steps_per_seed"] == 3 * 512 * 4
    assert last["hyperparams"]["normalize"] is norm
    assert len(last["league_points"]) == 2
    # a league of two: each point total is its matches' wins plus half
    # the draws over 2 (n - 1) = 2 matches, so the two sum to 1
    assert sum(last["league_points"]) == pytest.approx(1.0, abs=1e-4)
    files = set(os.listdir(out))
    for k in range(2):
        assert {f"learning_curve_ppt1{suffix}_seed{k}.jsonl",
                f"learning_ppt1{suffix}_seed{k}.json",
                f"learning_ppt1{suffix}_seed{k}.pt"} <= files
        with open(os.path.join(out, f"learning_curve_ppt1{suffix}_seed{k}.jsonl")) as f:
            curve = [json.loads(x) for x in f]
        assert [r["iter"] for r in curve] == [0, 2]      # --log-every 10
        assert all(np.isfinite(r["loss"]) for r in curve)
    with open(os.path.join(out, f"league_ppt1{suffix}.json")) as f:
        league = json.load(f)
    assert league["points"] == last["league_points"]
    assert [(p["a"], p["b"]) for p in league["pairs"]] == [(0, 1), (1, 0)]
    seed0 = json.loads(next(x for x in lines if x.startswith("# seed 0: {"))
                       .split(": ", 1)[1])
    # the seed-0 check of the kernel evaluator against the plain one
    assert "plain_eval_win_rate" in seed0 and seed0["fused_plain_consistent"]


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_recurrent_gate_end_to_end(tmp_path, algo):
    before = _parity_files()
    rc, lines, last = _run("check_recurrent_learning",
                           RECURRENT_ARGV + ["--algo", algo, "--out-dir",
                                             str(tmp_path)])
    assert _parity_files() == before, "the gate wrote under parity/"
    _check_verdict(rc, last, "check_recurrent_learning.py")
    assert last["metric"] == f"recurrent_{algo}_trained_vs_random_win_rate_mean"
    assert last["hyperparams"]["algo"] == algo
    assert last["hyperparams"]["lr"] == (7e-4 if algo == "a2c" else 3e-4)
    assert last["train_env_steps_per_seed"] == 3 * 8 * 16
    assert len(last["per_seed"]) == 2 and len(last["league_points"]) == 2
    files = set(os.listdir(tmp_path))
    for k in range(2):
        assert {f"recurrent_curve_ppt1_{algo}_seed{k}.jsonl",
                f"recurrent_ppt1_{algo}_seed{k}.json",
                f"recurrent_ppt1_{algo}_seed{k}.pt"} <= files
    assert f"recurrent_league_ppt1_{algo}.json" in files


def test_split_calls_match_one_call(mlp_runs, tmp_path):
    """Two calls of one seed each give the one call's verdict; the second
    loads seed 0 and trains only seed 1."""
    _, _, _, whole = mlp_runs[False]
    argv = MLP_ARGV + ["--out-dir", str(tmp_path)]
    rc, lines, first = _run("check_learning", argv + ["--max-new-seeds", "1"])
    assert rc == 2
    assert first["complete"] is False and first["seeds_done"] == 1
    assert first["trained_now"] == 1 and len(first["per_seed"]) == 1
    assert {x.split()[2] for x in lines if " iter " in x} == {"0"}
    assert not any(n.startswith("learning_ppt1_seed1") for n in os.listdir(tmp_path))
    rc, lines, last = _run("check_learning", argv + ["--max-new-seeds", "1"])
    assert {x.split()[2] for x in lines if " iter " in x} == {"1000"}
    assert any(x.startswith("# seed 0: loaded from") for x in lines)
    assert rc == (0 if last["ok"] else 1)
    assert last.pop("train_seconds_total") > 0
    whole = dict(whole)
    whole.pop("train_seconds_total")
    assert last == whole


def test_refuses_a_record_of_other_flags(mlp_runs, tmp_path):
    out = str(tmp_path / "gate")
    shutil.copytree(mlp_runs[False][0], out)
    argv = MLP_ARGV + ["--out-dir", out]
    with pytest.raises(SystemExit, match="--iters 3 there, 2 here") as e:
        gate.main([*argv, "--iters", "2"])
    assert "learning_ppt1_seed0.json" in str(e.value)
    with pytest.raises(SystemExit, match="--lr 0.0003 there, 0.001 here"):
        gate.main([*argv, "--lr", "1e-3"])
    # flags that only decide which seeds run, and the verdict, are free
    # (no seed trains: both are done, and --no-league ends the call)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = gate.main([*argv, "--win-threshold", "0.5", "--no-league"])
    last = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 1 and last["threshold"] == 0.5 and last["league_points"] is None


def test_refuses_a_record_of_other_code(mlp_runs, tmp_path):
    """A record whose code identity differs, in the sources' hash or the
    torch version, is refused with both values named."""
    argv = MLP_ARGV + ["--out-dir", str(tmp_path)]
    for name, other in (("sources", "0" * 16), ("torch", "0.0.0")):
        shutil.rmtree(tmp_path)
        shutil.copytree(mlp_runs[False][0], tmp_path)
        path = tmp_path / "learning_ppt1_seed0.json"
        saved = json.loads(path.read_text())
        assert saved["code"] == gate.code_identity()
        here = saved["code"][name]
        saved["code"][name] = other
        path.write_text(json.dumps(saved))
        with pytest.raises(SystemExit, match=re.escape(
                f"trained by other code: {name} '{other}' there, '{here}' here")):
            gate.main([*argv, "--no-league"])


def test_code_identity_follows_the_sources(tmp_path, monkeypatch):
    """The hash changes with a source's content and with its path, and not
    with a bytecode cache."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("// k\n")
    monkeypatch.setattr(gate, "PACKAGE_DIR", str(pkg))
    first = gate.code_identity()
    assert first["torch"] == torch.__version__
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "a.cpython-312.pyc").write_bytes(b"\0")
    assert gate.code_identity() == first
    (pkg / "csrc" / "k.cu").write_text("// k2\n")
    second = gate.code_identity()
    assert second["sources"] != first["sources"]
    (pkg / "csrc" / "k.cu").rename(pkg / "csrc" / "k.cuh")
    assert gate.code_identity()["sources"] != second["sources"]


def test_recurrent_refuses_a_record_of_other_flags(tmp_path):
    store = gate.SeedStore(str(tmp_path), "recurrent_ppt1_ppo",
                           "recurrent_curve_ppt1_ppo", {"--lstm-size": 8})
    store.save(0, {"seed": 0}, {"train": 1.0, "eval": 1.0},
               {"final": {"model": {}}, "third": {"model": {}}}, [])
    argv = RECURRENT_ARGV + ["--out-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--lstm-size 8 there, 4 here"):
        rgate.main([*argv, "--lstm-size", "4"])


def _spy_collect_dtype(monkeypatch):
    """The route each fused recurrent collect call takes, recorded (the
    CPU path: K5's plain version in that dtype, no launch)."""
    seen = []
    real = ta2c.collect_recurrent_rollout_fused

    def spy(*args, compute_dtype=torch.bfloat16, **kw):
        seen.append(compute_dtype)
        return real(*args, compute_dtype=compute_dtype, **kw)

    monkeypatch.setattr(ta2c, "collect_recurrent_rollout_fused", spy)
    return seen


def test_recurrent_gate_collect_dtype(monkeypatch, tmp_path):
    """--collect-dtype reaches the fused collect and is among a seed's
    flags, so a stored seed trained on the other route is refused; the
    default follows ``a2c.FUSED_COLLECT_DTYPE`` per algorithm, float32 on
    the plain collect, which takes nothing else."""
    seen = _spy_collect_dtype(monkeypatch)
    argv = RECURRENT_ARGV + ["--algo", "a2c", "--seeds", "1", "--no-league",
                             "--out-dir", str(tmp_path)]
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rgate.main(argv + ["--collect-dtype", "float32"])
    assert seen == [torch.float32] * 3
    last = json.loads(buf.getvalue().splitlines()[-1])
    assert last["hyperparams"]["collect_dtype"] == "float32"
    saved = json.loads((tmp_path / "recurrent_ppt1_a2c_seed0.json").read_text())
    assert saved["flags"]["--collect-dtype"] == "float32"
    with pytest.raises(SystemExit, match="--collect-dtype 'float32' there, "
                                         "'bfloat16' here"):
        rgate.main(argv + ["--collect-dtype", "bfloat16"])
    for algo in ("a2c", "ppo"):
        args = rgate.parse_args(["--algo", algo, "--fused-collect"])
        assert args.collect_dtype == ta2c.FUSED_COLLECT_DTYPE[algo]
        assert rgate.parse_args(["--algo", algo]).collect_dtype == "float32"
    with contextlib.redirect_stderr(io.StringIO()) as err:
        with pytest.raises(SystemExit) as e:
            rgate.parse_args(["--algo", "a2c", "--collect-dtype", "bfloat16"])
    assert e.value.code == 2 and "needs --fused-collect" in err.getvalue()


@pytest.mark.parametrize("algo", ["a2c", "ppo"])
def test_cli_recurrent_fused_collect_route(monkeypatch, algo):
    """``train --recurrent --algo {a2c,ppo} --fused-collect`` collects on
    the route ``a2c.FUSED_COLLECT_DTYPE`` names for the algorithm, as the
    gate does by default."""
    seen = _spy_collect_dtype(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(["--device", "cpu", "--recurrent", "--algo", algo,
                     "--fused-collect", "--ppt", "1", "--iters", "1", "--envs",
                     "8", "--hidden", "16", "--lstm-size", "8", "--max-steps",
                     "12"])
    assert seen == [getattr(torch, ta2c.FUSED_COLLECT_DTYPE[algo])]
    # A2C on K5's exact route, PPO on its tensor cores
    assert ta2c.FUSED_COLLECT_DTYPE == {"a2c": "float32", "ppo": "bfloat16"}


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "normalize"])
def test_seed_training_equals_cli(mlp_runs, tmp_path, norm):
    """Seed 0's final and 1/3 snapshots (iterations 3 and 1 of 3) equal
    bitwise the training CLI's checkpoints at those iterations."""
    out = mlp_runs[norm][0]
    suffix = "_norm" if norm else ""
    snaps = torch.load(os.path.join(out, f"learning_ppt1{suffix}_seed0.pt"),
                       weights_only=True)
    argv = ["--device", "cpu", "--ppt", "1", "--envs", "512",
            "--rollout-steps", "4", "--iters", "3", "--hidden", "16", "16",
            "--max-steps", "12", "--seed", "0", "--lr-anneal",
            "--fused-collect", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "1"]
    if norm:
        argv += ["--normalize-obs", "--normalize-reward"]
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(argv)
    for step, name in ((1, "third"), (3, "final")):
        blob = torch.load(tmp_path / f"checkpoint_{step}.pt", weights_only=True)
        model = blob["runner"]["model"]
        assert set(model) == set(snaps[name]["model"])
        for key, value in model.items():
            assert torch.equal(value, snaps[name]["model"][key]), (name, key)
        norm_saved = blob["runner"]["obs_norm"]
        if norm:
            for key in ("mean", "var", "count"):
                assert torch.equal(norm_saved[key], snaps[name]["obs_norm"][key])
        else:
            assert norm_saved is None and snaps[name]["obs_norm"] is None


def test_round_robin_points_by_hand():
    """Three seeds; pair (i, j) with i as team 0 wins, loses and draws at
    the rates below. Points: wins plus half the draws over 2 (n - 1) = 4
    matches, rounded to 4 places, the JAX gate's sums."""
    rates = {(0, 1): (0.5, 0.3), (0, 2): (0.2, 0.6), (1, 0): (0.4, 0.4),
             (1, 2): (0.1, 0.1), (2, 0): (0.7, 0.2), (2, 1): (0.3, 0.5)}
    seeds = []

    def play(i, j, seed):
        seeds.append(seed)
        wa, wb = rates[(i, j)]
        return {"win_rate_a": wa, "win_rate_b": wb, "draw_rate": 1 - wa - wb}

    with contextlib.redirect_stdout(io.StringIO()):
        league = gate.round_robin(3, play)
    assert seeds == [9001, 9002, 9017, 9019, 9034, 9035]
    # seed 0: 0.5+0.1 | 0.2+0.1 | (b of 1v0) 0.4+0.1 | (b of 2v0) 0.2+0.05
    #   = 1.65 / 4 = 0.4125
    # seed 1: 0.3+0.1 | 0.4+0.1 | 0.1+0.4 | (b of 2v1) 0.5+0.1 = 2.0 / 4
    # seed 2: 0.6+0.1 | 0.1+0.4 | 0.7+0.05 | 0.3+0.1 = 2.35 / 4 = 0.5875
    assert league["points"] == [0.4125, 0.5, 0.5875]
    assert league["pairs"][0] == {"a": 0, "b": 1, "win_a": 0.5, "win_b": 0.3,
                                  "draw": 0.2}


@pytest.mark.parametrize("win,other,band", [
    # p = 0.725, p(1-p) = 0.199375, 1/4096 + 1/1024 = 0.001220703125:
    # 0.199375 x 0.001220703125 = 0.000243377685546875, its root
    # 0.0156005668: x 4 = 0.0624023
    (0.75, 0.70, 0.0624023),
    # p(1-p) = 0.0004998 below the 0.01 floor: 0.01 x 0.001220703125 =
    # 1.220703125e-5, its root 0.0034938562: x 4 = 0.0139754
    (0.999, 1.0, 0.0139754),
])
def test_consistency_band_by_hand(win, other, band):
    assert gate.consistency_band(win, other, 4096, 1024) == pytest.approx(
        band, abs=1e-7)


def test_gates_default_to_the_card():
    """With no --device both gates ask for the card, and on a machine
    without one they fail rather than fall back to the CPU."""
    assert gate.parse_args([]).device == "cuda"
    assert rgate.parse_args([]).device == "cuda"
    assert gate.parse_args(["--ppt", "3"]).envs == 16384
    assert rgate.parse_args(["--algo", "a2c"]).iters == 4000
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module in (gate, rgate):
        with pytest.raises((RuntimeError, AssertionError)):
            with contextlib.redirect_stdout(io.StringIO()):
                module.main(["--envs", "8", "--iters", "1", "--seeds", "1"])


@pytest.mark.parametrize("ppt", [1, 2, 3])
def test_make_normalized_policy_fn_matches_jax(monkeypatch, ppt):
    """The same weights, frozen statistics and uniforms: JAX's actions,
    and the z-scored observation the model sees within f32 rounding."""
    ref = JEnvParams(players_per_team=ppt)
    model = jpolicy.ActorCritic(n_players=ppt, hidden=(32, 16))
    variables = jax.tree.map(np.asarray, jpolicy.init_params(
        jax.random.PRNGKey(ppt), model, ref))
    f = jenv.obs_size(ref)
    rng = np.random.default_rng(ppt)
    batch = 128
    mean = rng.normal(0.0, 0.5, f).astype(np.float32)
    var = rng.uniform(0.05, 3.0, f).astype(np.float32)
    count = np.float32(4096.0)
    # raw observations, some far enough out that the clip at 10 acts
    obs = (mean + rng.normal(0.0, 4.0, (batch, f)) * np.sqrt(var)).astype(np.float32)
    jnorm = JRunningNorm(mean=jnp.asarray(mean), var=jnp.asarray(var),
                         count=jnp.asarray(count))
    key = jax.random.PRNGKey(100 + ppt)
    jact = jpolicy.make_normalized_policy_fn(model, variables, jnorm)(
        key, jnp.asarray(obs))
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, (2 * ppt, batch), jnp.float32)))
    jz = np.asarray(jnorm.normalize(jnp.asarray(obs)))
    assert (np.abs(jz) == 10.0).any()

    tmodel = actor_critic_from_flax(variables, ppt, device="cpu")
    seen = []
    tmodel.torso[0].register_forward_pre_hook(lambda m, x: seen.append(x[0]))
    tnorm = running_norm_from_numpy(mean, var, count, device="cpu")

    def rand(shape, generator=None, dtype=None, device=None):
        assert tuple(shape) == tuple(u.shape)
        return u.clone()

    monkeypatch.setattr(torch, "rand", rand)
    act = tpolicy.make_normalized_policy_fn(tmodel, tnorm)(
        torch.Generator().manual_seed(0), torch.from_numpy(obs))
    monkeypatch.undo()
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    np.testing.assert_allclose(seen[0].numpy(), jz, rtol=0, atol=1e-6)
    # the statistics stay frozen
    assert torch.equal(tnorm.count, torch.tensor(count))


# -- the gates against the JAX package's, training and evaluation stubbed --


def _snap_of(tag):
    """The ``("snap", seed, iteration)`` a weights or policy tag holds, or
    None (the uniform random opponent)."""
    if isinstance(tag, tuple):
        if tag and tag[0] == "snap":
            return tag
        for part in tag:
            found = _snap_of(part)
            if found is not None:
                return found
    return None


def _fn_label(fn):
    """A collect or update function by name and normalisation keywords
    (both packages' normalised collects are partials of
    ``collect_rollout_fused``)."""
    if fn is None:
        return None
    kw = fn.keywords if isinstance(fn, functools.partial) else {}
    while isinstance(fn, functools.partial):
        fn = fn.func
    return (fn.__name__, bool(kw.get("normalize_obs")),
            bool(kw.get("normalize_reward")))


class _Table:
    """One table of canned training metrics and match results for both
    packages' gates, and the record of what each gate asked of it. A
    match's rates follow from its snapshots and seed alone, so the same
    match gives the same rates in either gate and on either evaluator
    (but for ``plain_shift``, added to the plain evaluator's win rate):
    against random play team 0 wins 0.55-0.75; a later snapshot beats an
    earlier one; a snapshot and itself win at equal rates."""

    def __init__(self, plain_shift: float = 0.0):
        self.plain_shift = plain_shift
        self.calls, self.anneal, self.fns = [], set(), set()

    @staticmethod
    def metrics(seed, it):
        return {"loss": 0.001 * seed + 0.25 * it, "entropy": 2.0 - 0.003 * it}

    def init(self, seed, n_envs, env_params, hidden, cfg, *extra):
        self.calls.append(("init", seed, n_envs, env_params.players_per_team,
                           env_params.max_steps, tuple(hidden),
                           type(cfg).__name__, cfg.rollout_steps, cfg.lr,
                           cfg.ent_coef, *extra))

    def match(self, kind, a, b, n_envs, n_steps, seed):
        sa, sb = _snap_of(a), _snap_of(b)
        self.calls.append((kind, a, b, n_envs, n_steps, seed))
        rng = np.random.default_rng(zlib.crc32(repr((sa, sb, seed)).encode()))
        if sb is None:
            wa, wb = rng.uniform(0.55, 0.75), rng.uniform(0.0, 0.05)
        else:
            hi, lo = rng.uniform(0.35, 0.6), rng.uniform(0.05, 0.3)
            wa, wb = (hi, lo) if sa[2] > sb[2] else (lo, hi) if sa[2] < sb[2] \
                else (lo, lo)
        if kind == "plain":
            wa = min(1.0 - wb, wa + self.plain_shift)
        return {"win_rate_a": wa, "win_rate_b": wb, "draw_rate": 1.0 - wa - wb,
                "goals_per_episode": [rng.uniform(0, 4), rng.uniform(0, 4)]}


class _JNorm:
    """JAX side: the frozen statistics of snapshot (seed, it), a leaf of
    ``jax.tree.map``."""

    def __init__(self, seed, it):
        self.tag = ("norm", seed, it)

    def copy(self):
        return self

    def normalize(self, obs):
        return (self.tag, obs)


class _JRunner:
    def __init__(self, seed, it, norm=False):
        self.seed, self.it = seed, it
        self.params = {"seed": np.array(seed), "it": np.array(it)}
        self.obs_norm = _JNorm(seed, it) if norm else None


def _jtag(params):
    return ("snap", int(params["seed"]), int(params["it"]))


class _TModel:
    """Port side: a model whose state is its snapshot's (seed, it)."""

    def __init__(self, *args, **kwargs):
        self.args, self.sd = args, {}

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = dict(sd)


class _TNorm:
    def __init__(self, mean, var, count):
        self.mean, self.var, self.count = mean, var, count
        self.tag = ("norm", int(mean), int(var))


class _TRunner:
    def __init__(self, seed, it, norm=False):
        self.seed, self.it = seed, it
        self.model = _TModel()
        self.model.sd = {"seed": torch.tensor(seed), "it": torch.tensor(it)}
        self.obs_norm = (_TNorm(torch.tensor(seed), torch.tensor(it),
                                torch.tensor(0.0)) if norm else None)


def _ttag(model):
    return ("snap", int(model.sd["seed"]), int(model.sd["it"]))


def _fold(w, *scales):
    return ("fold", w, scales)


def _scales(norm):
    return (norm.tag,)


def _load_jax_gate(monkeypatch, name):
    """The JAX package's gate script as a module, its compilation cache
    left off and ``jax.jit`` an identity (the stubbed iteration returns
    plain Python objects)."""
    from gym_futbol_tpu.utils import cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"_parity_{name}", os.path.join(REPO, "parity", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "jax", types.SimpleNamespace(
        jit=lambda fn: fn, random=jax.random, tree=jax.tree))
    return module


def _run_main(monkeypatch, main, argv, prog):
    monkeypatch.setattr(sys, "argv", [prog, *argv])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = main()
    lines = buf.getvalue().splitlines()
    return rc, lines, json.loads(lines[-1])


def _seed_records(lines):
    """The per-seed record lines and the league lines a gate printed."""
    recs = [json.loads(x.split(": ", 1)[1]) for x in lines
            if x.startswith("# seed ") and ": {" in x and " iter " not in x]
    return recs, [x for x in lines if x.startswith("# league:")]


def _same_files(jax_dir, port_dir, names):
    for name in names:
        with open(os.path.join(jax_dir, name)) as f:
            want = f.read()
        with open(os.path.join(port_dir, name)) as f:
            assert f.read() == want, name


def _compare_last_lines(jl, pl, extras):
    jl, pl = dict(jl), dict(pl)
    assert jl.pop("train_seconds_total") >= 0 and pl.pop("train_seconds_total") >= 0
    assert pl.pop("hyperparams") == {**jl.pop("hyperparams"), **extras}
    assert pl == jl


MLP_CASES = {
    # id: (argv of both, JAX's own, the port's own, plain_shift, ok)
    "default": (["--iters", "7", "--win-threshold", "0.5"], [], [], 0.0, True),
    "normalize": (["--iters", "7", "--win-threshold", "0.5", "--normalize"],
                  [], [], 0.0, True),
    "plain-eval": (["--iters", "7", "--win-threshold", "0.5"], ["--jnp-eval"],
                   ["--plain-eval"], 0.0, True),
    # the plain evaluator 0.2 above the kernel's: outside the 4-sigma band
    "inconsistent": (["--iters", "7", "--win-threshold", "0.5"], [], [], 0.2,
                     False),
    # iters // 3 == 0: the 1/3 snapshot is the final one, which does not
    # beat itself strictly
    "one-iter": (["--iters", "1", "--win-threshold", "0.5"], [], [], 0.0, False),
    "ppt3-two-seeds": (["--ppt", "3", "--iters", "5", "--seeds", "2",
                        "--seed", "3", "--no-league", "--log-every", "2"],
                       [], [], 0.0, None),
}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_gate_matches_jax_gate(monkeypatch, tmp_path, case):
    both, jax_only, port_only, shift, ok = MLP_CASES[case]
    jgate = _load_jax_gate(monkeypatch, "check_learning")
    from gym_futbol_tpu import ppo as jppo

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    tables = {}
    for side in ("jax", "port"):
        table = tables[side] = _Table(shift)
        if side == "jax":
            def init_runner(key, model, env_params, cfg, n_envs, tx,
                            normalize_obs=False, normalize_reward=False,
                            table=table):
                seed = int(np.asarray(key)[-1])
                table.init(seed, n_envs, env_params, model.hidden, cfg,
                           normalize_obs, normalize_reward)
                return _JRunner(seed, 0, normalize_obs)

            def train_iteration(r, model, env_params, cfg, tx, collect_fn=None,
                                update_fn=None, table=table):
                table.fns.add((_fn_label(collect_fn), _fn_label(update_fn)))
                return (_JRunner(r.seed, r.it + 1, r.obs_norm is not None),
                        table.metrics(r.seed, r.it))

            def make_optimizer(cfg, total_iters=None, table=table):
                table.anneal.add(total_iters)

            def evaluate(env_params, policy_a, policy_b=None, *, n_envs,
                         n_steps, seed, table=table):
                return table.match("plain", policy_a(None, "obs"),
                                   policy_b and policy_b(None, "obs"),
                                   n_envs, n_steps, seed)

            def evaluate_fused(env_params, wa, wb, *, n_envs, n_steps, seed,
                               table=table):
                return table.match("fused", wa, wb, n_envs, n_steps, seed)

            for name, fn in (
                    ("init_runner", init_runner),
                    ("train_iteration", train_iteration),
                    ("make_optimizer", make_optimizer),
                    ("evaluate", evaluate), ("evaluate_fused", evaluate_fused),
                    ("uniform_random_weights_like", lambda w: "random"),
                    ("actor_critic_policy_weights",
                     lambda params, model: ("w", _jtag(params))),
                    ("make_policy_fn", lambda model, params: (
                        lambda key, obs: ("pi", _jtag(params), obs))),
                    ("ART_DIR", str(jax_dir))):
                monkeypatch.setattr(jgate, name, fn)
            monkeypatch.setattr(jppo, "fold_obs_norm", _fold)
            monkeypatch.setattr(jppo, "_obs_norm_scales", _scales)
            jrc, jlines, jl = _run_main(monkeypatch, jgate.main,
                                        both + jax_only, "check_learning.py")
        else:
            def init_runner(gen, model, env_params, cfg, n_envs,
                            total_iters=None, normalize_obs=False,
                            normalize_reward=False, table=table):
                seed = gen.initial_seed()
                table.init(seed, n_envs, env_params, model.args[2], cfg,
                           normalize_obs, normalize_reward)
                table.anneal.add(total_iters)
                return _TRunner(seed, 0, normalize_obs)

            def train_iteration(r, env_params, cfg, collect_fn=None,
                                update_fn=None, table=table):
                table.fns.add((_fn_label(collect_fn), _fn_label(update_fn)))
                return (_TRunner(r.seed, r.it + 1, r.obs_norm is not None),
                        table.metrics(r.seed, r.it))

            def evaluate(env_params, policy_a, policy_b=None, *, n_envs,
                         n_steps, seed, device=None, table=table):
                return table.match("plain", policy_a(None, "obs"),
                                   policy_b and policy_b(None, "obs"),
                                   n_envs, n_steps, seed)

            def evaluate_fused(env_params, wa, wb, *, n_envs, n_steps, seed,
                               table=table):
                return table.match("fused", wa, wb, n_envs, n_steps, seed)

            for module, name, fn in (
                    (tppo, "init_runner", init_runner),
                    (tppo, "train_iteration", train_iteration),
                    (tppo, "fold_obs_norm", _fold),
                    (tppo, "_obs_norm_scales", _scales),
                    (tevaluate, "evaluate", evaluate),
                    (tevaluate, "evaluate_fused", evaluate_fused),
                    (tevaluate, "uniform_random_weights_like", lambda w: "random"),
                    (tfused_collect, "actor_critic_policy_weights",
                     lambda model: ("w", _ttag(model))),
                    (tpolicy, "ActorCritic", _TModel),
                    (tpolicy, "make_policy_fn", lambda model: (
                        lambda gen, obs: ("pi", _ttag(model), obs))),
                    (tpolicy, "make_normalized_policy_fn", lambda model, norm: (
                        lambda gen, obs: ("pi", _ttag(model), (norm.tag, obs)))),
                    (twrappers, "RunningNorm", _TNorm)):
                monkeypatch.setattr(module, name, fn)
            prc, plines, pl = _run_main(
                monkeypatch, functools.partial(gate.main, both + port_only + [
                    "--device", "cpu", "--out-dir", str(port_dir)]), [],
                "check_learning")
    jt, pt = tables["jax"], tables["port"]
    assert pt.calls == jt.calls and pt.anneal == jt.anneal and pt.fns == jt.fns
    # the kernel evaluator, and the plain one for seed 0's check alone
    kinds = [c[0] for c in jt.calls if c[0] != "init"]
    if "plain-eval" in case:
        assert set(kinds) == {"plain"}
    else:
        assert kinds.count("plain") == 1 and "fused" in kinds
    jrecs, jleague = _seed_records(jlines)
    precs, pleague = _seed_records(plines)
    rename = {"plain_eval_win_rate": "jnp_eval_win_rate",
              "fused_plain_consistent": "fused_jnp_consistent"}
    assert [{rename.get(k, k): v for k, v in r.items()} for r in precs] == jrecs
    assert pleague == jleague
    plain_eval = "--plain-eval" in port_only
    _compare_last_lines(jl, pl, {
        "hidden": [128, 128], "max_steps": 300, "plain_collect": False,
        "plain_eval": plain_eval})
    assert prc == jrc == (0 if jl["ok"] else 1)
    if ok is not None:
        assert jl["ok"] is ok
    suffix = "_norm" if "--normalize" in both else ""
    names = [f"learning_curve_ppt{jl['ppt']}{suffix}_seed{k}.jsonl"
             for k in range(len(jl["per_seed"]))]
    if jl["league_points"] is not None:
        names.append(f"league_ppt{jl['ppt']}{suffix}.json")
    _same_files(jax_dir, port_dir, names)


RECURRENT_CASES = {
    "ppo": (["--algo", "ppo", "--iters", "7", "--win-threshold", "0.5"], True),
    "a2c-fused": (["--algo", "a2c", "--fused-collect", "--iters", "7",
                   "--win-threshold", "0.5"], True),
    "ppo-one-iter": (["--algo", "ppo", "--iters", "1", "--win-threshold", "0.5"],
                     False),
    # the JAX gate's defaults: 1000 iterations at 8192 envs (ppo), 6000 at
    # 16384 (a2c, 3v3), 2048 evaluation envs, the rates 3e-4 / 7e-4
    "ppo-defaults": (["--algo", "ppo"], None),
    "a2c-ppt3-defaults": (["--algo", "a2c", "--ppt", "3", "--fused-collect"],
                          None),
    "two-seeds": (["--algo", "a2c", "--iters", "5", "--seeds", "2", "--seed",
                   "11", "--no-league", "--lstm-size", "32", "--hidden", "64",
                   "32"], None),
}


@pytest.mark.parametrize("case", list(RECURRENT_CASES))
def test_recurrent_gate_matches_jax_gate(monkeypatch, tmp_path, case):
    argv, ok = RECURRENT_CASES[case]
    jgate = _load_jax_gate(monkeypatch, "check_recurrent_learning")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    tables = {}
    for side in ("jax", "port"):
        table = tables[side] = _Table()

        def train_iteration(r, *args, collect_fn=None, table=table,
                            runner=_JRunner if side == "jax" else _TRunner):
            label = _fn_label(collect_fn)
            table.fns.add("fused" if label and "fused" in label[0] else "plain")
            return runner(r.seed, r.it + 1), table.metrics(r.seed, r.it)

        if side == "jax":
            def init_recurrent_runner(key, model, env_params, cfg, n_envs, tx,
                                      table=table):
                seed = int(np.asarray(key)[-1])
                table.init(seed, n_envs, env_params, model.hidden, cfg,
                           model.lstm_size)
                return _JRunner(seed, 0)

            def evaluate_recurrent(env_params, model, params, variables_b=None,
                                   *, n_envs, n_steps, seed, table=table):
                return table.match("recurrent", _jtag(params),
                                   variables_b and _jtag(variables_b),
                                   n_envs, n_steps, seed)

            for module, name, fn in (
                    (jgate.a2c, "init_recurrent_runner", init_recurrent_runner),
                    (jgate.a2c, "train_iteration_recurrent", train_iteration),
                    (jgate.rppo, "train_iteration_recurrent_ppo",
                     train_iteration),
                    (jgate.a2c, "make_optimizer",
                     lambda cfg, table=table: table.anneal.add(None)),
                    (jgate.rppo, "make_optimizer",
                     lambda cfg, total_iters=None, table=table:
                     table.anneal.add(total_iters)),
                    (jgate, "evaluate_recurrent", evaluate_recurrent),
                    (jgate, "ART_DIR", str(jax_dir))):
                monkeypatch.setattr(module, name, fn)
            jrc, jlines, jl = _run_main(monkeypatch, jgate.main, argv,
                                        "check_recurrent_learning.py")
        else:
            def init_runner(gen, model, env_params, cfg, n_envs,
                            total_iters=None, table=table):
                seed = gen.initial_seed()
                table.init(seed, n_envs, env_params, model.args[2], cfg,
                           model.args[3])
                table.anneal.add(total_iters)
                return _TRunner(seed, 0)

            def evaluate_recurrent(env_params, model, model_b=None, *, n_envs,
                                   n_steps, seed, table=table):
                return table.match("recurrent", _ttag(model),
                                   model_b and _ttag(model_b),
                                   n_envs, n_steps, seed)

            for module, name, fn in (
                    (ta2c, "init_recurrent_runner", init_runner),
                    (trppo, "init_recurrent_ppo_runner", init_runner),
                    (ta2c, "train_iteration_recurrent", train_iteration),
                    (trppo, "train_iteration_recurrent_ppo", train_iteration),
                    (tevaluate, "evaluate_recurrent", evaluate_recurrent),
                    (trecurrent, "RecurrentActorCritic", _TModel)):
                monkeypatch.setattr(module, name, fn)
            prc, plines, pl = _run_main(
                monkeypatch, functools.partial(rgate.main, argv + [
                    "--device", "cpu", "--out-dir", str(port_dir)]), [],
                "check_recurrent_learning")
    jt, pt = tables["jax"], tables["port"]
    assert pt.calls == jt.calls and pt.anneal == jt.anneal and pt.fns == jt.fns
    assert _seed_records(plines) == _seed_records(jlines)
    fused = "--fused-collect" in argv
    _compare_last_lines(jl, pl, {
        "max_steps": 300, "fused_collect": fused,
        "collect_dtype": (ta2c.FUSED_COLLECT_DTYPE[jl["hyperparams"]["algo"]]
                          if fused else "float32")})
    assert prc == jrc == (0 if jl["ok"] else 1)
    if ok is not None:
        assert jl["ok"] is ok
    stem = f"ppt{jl['ppt']}_{jl['hyperparams']['algo']}"
    names = [f"recurrent_curve_{stem}_seed{k}.jsonl"
             for k in range(len(jl["per_seed"]))]
    if jl["league_points"] is not None:
        names.append(f"recurrent_league_{stem}.json")
    _same_files(jax_dir, port_dir, names)
