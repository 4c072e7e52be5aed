"""Checkpoints, the metrics log and the training CLI's remaining flags:
``utils.checkpoint.Checkpointer``, ``utils.metrics.MetricsLogger``, and
``train.main`` with ``--normalize-obs``, ``--normalize-reward``,
``--checkpoint-dir``, ``--checkpoint-every``, ``--log-dir``,
``--debug-nans`` and ``--eval-episodes`` on normalised runs, all on the
CPU.

Resume is held bitwise (the JAX package's tests/test_utils.py holds its
own so): a run interrupted, saved, restored into a freshly built runner
and continued ends in exactly the state of the run that went on, for
normalised PPO, recurrent A2C with a live carry and recurrent PPO.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gym_futbol_tpu_torch import a2c, obs_size, ppo  # noqa: E402
from gym_futbol_tpu_torch import recurrent_ppo as rppo  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.evaluate import (  # noqa: E402
    evaluate_fused,
    uniform_random_weights_like,
)
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops.fused_collect import (  # noqa: E402
    actor_critic_policy_weights,
)
from gym_futbol_tpu_torch.types import EnvParams  # noqa: E402
from gym_futbol_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402
from gym_futbol_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

# max_steps 9 > 2 iterations x 4 steps: the checkpoint falls mid-episode
P = EnvParams(players_per_team=1, max_steps=9)
N_ENVS = 64


def _leaves(x, name="runner"):
    """Every tensor and number a runner holds, with its path: the model's
    and the optimiser's state, the env state, obs, carries, the
    normalisers' statistics and the generator's state."""
    if isinstance(x, torch.Generator):
        yield name, x.get_state()
    elif isinstance(x, (torch.Tensor, int, float)) or x is None:
        yield name, x
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}[{i}]")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{name}.{k}")
    elif hasattr(x, "state_dict"):
        yield from _leaves(x.state_dict(), name)
    else:
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{name}.{f.name}")


def _assert_bitwise(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k, va in la.items():
        vb = lb[k]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(va, vb), k
        else:
            assert va == vb, k


def _build(kind, seed):
    """(fresh runner, one-iteration step) of each runner type under each
    of its optimisers."""
    gen = torch.Generator().manual_seed(seed)
    f = obs_size(P)
    if kind in ("ppo", "a2c"):
        model = ActorCritic(1, f, (16,), device="cpu")
        if kind == "ppo":
            cfg = ppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2,
                                shuffle_block=64)
            runner = ppo.init_runner(gen, model, P, cfg, N_ENVS, total_iters=5,
                                     normalize_obs=True, normalize_reward=True)
            return runner, lambda r: ppo.train_iteration(
                r, P, cfg, collect_fn=ppo.make_normalized_collect())
        cfg = a2c.A2CConfig(rollout_steps=4)
        return (a2c.init_runner(gen, model, P, cfg, N_ENVS),
                lambda r: a2c.train_iteration(r, P, cfg))
    model = RecurrentActorCritic(1, f, (16,), 8, device="cpu")
    if kind == "recurrent_a2c":
        cfg = a2c.A2CConfig(rollout_steps=3)
        return (a2c.init_recurrent_runner(gen, model, P, cfg, N_ENVS),
                lambda r: a2c.train_iteration_recurrent(r, P, cfg))
    cfg = rppo.RecurrentPPOConfig(rollout_steps=3, epochs=1, minibatches=2,
                                  shuffle_block=32)
    return (rppo.init_recurrent_ppo_runner(gen, model, P, cfg, N_ENVS),
            lambda r: rppo.train_iteration_recurrent_ppo(r, P, cfg))


KINDS = ["ppo", "a2c", "recurrent_a2c", "recurrent_ppo"]


@pytest.mark.parametrize("kind", KINDS)
def test_runner_round_trip(kind, tmp_path):
    """Save after one iteration, restore into a runner built from another
    seed: every leaf equal bitwise (PPO's Adam moments, step counts and
    count; RMSProp's nu; env state, obs, carries; obs_norm and rew_norm
    with ret; the generator's state), the model's tensors still the
    template's own objects."""
    runner, step = _build(kind, 0)
    runner, _ = step(runner)
    ck = Checkpointer(str(tmp_path))
    ck.save(runner, 1)
    ck.wait()
    template, _ = _build(kind, 1)
    weight = next(template.model.parameters())
    restored, it = ck.restore_latest(template)
    assert it == 1
    _assert_bitwise(restored, runner)
    assert next(restored.model.parameters()) is weight
    assert restored.optimizer.count == runner.optimizer.count > 0
    if kind == "ppo":
        assert float(restored.rew_norm.ret.abs().sum()) > 0
    if kind.startswith("recurrent"):
        assert float(restored.carry[1].abs().max()) > 0


def test_restore_empty_dir_and_refusals(tmp_path):
    ck = Checkpointer(str(tmp_path / "none"))
    runner, _ = _build("ppo", 0)
    assert ck.restore_latest(runner) == (None, 0)
    ck.save(runner, 3)
    other, _ = _build("recurrent_a2c", 0)
    with pytest.raises(ValueError, match="RunnerState"):
        ck.restore_latest(other)
    plain = runner.replace(obs_norm=None)          # un-normalised template
    with pytest.raises(ValueError, match="obs_norm"):
        ck.restore_latest(plain)


def test_max_to_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    runner, _ = _build("a2c", 0)
    for s in (1, 2, 5, 3):
        ck.save(runner, s)
    assert ck.steps() == [3, 5]
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3.pt", "checkpoint_5.pt"]
    assert ck.restore_latest(_build("a2c", 1)[0])[1] == 5


@pytest.mark.parametrize("kind", ["ppo", "recurrent_a2c", "recurrent_ppo"])
def test_resume_bitwise(kind, tmp_path):
    """3 iterations against 2 + save + restore into a fresh runner + 1:
    bitwise equal, from a checkpoint taken mid-episode (normalised PPO on
    the plain path; the recurrent runners with live carries)."""
    ref, step = _build(kind, 0)
    for _ in range(3):
        ref, _ = step(ref)
    run, step = _build(kind, 0)
    for _ in range(2):
        run, _ = step(run)
    assert int(run.env_state.t.max()) > 0            # mid-episode
    if kind.startswith("recurrent"):
        assert float(run.carry[0].abs().max()) > 0
    ck = Checkpointer(str(tmp_path))
    ck.save(run, 2)
    fresh, step = _build(kind, 7)
    resumed, it = ck.restore_latest(fresh)
    assert it == 2
    resumed, _ = step(resumed)
    _assert_bitwise(resumed, ref)


def test_metrics_logger(tmp_path):
    """JSONL records with step, wall_s and the metrics as Python numbers
    (0-dim tensors converted); TensorBoard scalars beside them; without a
    directory nothing is written."""
    log = MetricsLogger(str(tmp_path))
    rec = log.write(0, {"loss": torch.tensor(0.5), "n": 3})
    log.write(1, {"loss": torch.tensor(0.25, dtype=torch.float64), "n": 4})
    log.close()
    assert rec["step"] == 0 and rec["loss"] == 0.5 and rec["n"] == 3
    assert isinstance(rec["loss"], float) and rec["wall_s"] >= 0
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [0, 1] and lines[1]["loss"] == 0.25
    assert os.path.isdir(tmp_path / "tb") and os.listdir(tmp_path / "tb")
    quiet = MetricsLogger(None)
    assert quiet.write(2, {"x": torch.tensor(1.0)})["x"] == 1.0
    quiet.close()
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl", "tb"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner = ttrain.main(["--device", "cpu", "--ppt", "2", "--hidden", "16",
                              "--rollout-steps", "4", "--max-steps", "12", *argv])
    text = out.getvalue().splitlines()
    return runner, [json.loads(s) for s in text if s.startswith("{")], text


@pytest.mark.parametrize("argv", [
    ["--envs", "64", "--normalize-obs", "--normalize-reward"],
    ["--envs", "512", "--fused-collect", "--normalize-obs", "--normalize-reward"],
    ["--envs", "512", "--fused-collect", "--normalize-reward"],
], ids=["plain", "fused", "fused-reward"])
def test_cli_normalized_cpu(argv):
    """Normalised runs on either collect: records with finite metrics,
    the statistics on the runner, moved from their start."""
    runner, records, _ = _main(["--iters", "2", *argv])
    assert [r.get("step") for r in records[:2]] == [0, 1] and records[2]["done"]
    assert all(np.isfinite(v) for r in records[:2] for v in r.values())
    assert runner.rew_norm is not None and float(runner.rew_norm.count) > 1
    assert (runner.obs_norm is not None) == ("--normalize-obs" in argv)
    if runner.obs_norm is not None:
        assert float(runner.obs_norm.count) > 1
    assert runner.optimizer.count == 2 * 16


@pytest.mark.parametrize("argv", [
    ["--algo", "a2c", "--normalize-obs"],
    ["--recurrent", "--normalize-reward"],
    ["--fused-collect", "--no-fused-update", "--normalize-obs"],
], ids=["a2c", "recurrent", "no-fused-update"])
def test_cli_normalized_refusals(argv):
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--iters", "0", *argv])


def test_cli_resume_numbering_and_saves(tmp_path):
    """A standing divergence from the reference CLI, which restores
    iteration N and then runs --iters more numbered from 0, saving
    nothing new at steps orbax already holds (gym_futbol_tpu/train.py:
    253-293): here the resumed run goes on from N to --iters, numbered on,
    saves every --checkpoint-every and at the end, and logs on in the same
    metrics.jsonl. 2 iterations, then resumed to 5: the runner equals an
    uninterrupted 5-iteration run bitwise."""
    d = str(tmp_path / "run")
    flags = ["--envs", "64", "--normalize-obs", "--normalize-reward",
             "--checkpoint-dir", d, "--checkpoint-every", "2", "--log-dir", d]
    _, first, text = _main(["--iters", "3", *flags])
    assert not any(s.startswith("#") for s in text)
    assert sorted(os.listdir(d)) == ["checkpoint_2.pt", "checkpoint_3.pt",
                                     "metrics.jsonl", "tb"]
    resumed, second, text = _main(["--iters", "5", *flags])
    assert text[0] == "# resumed from iteration 3"
    assert [r["step"] for r in second[:-1]] == [3, 4]
    assert second[-1]["total_env_steps"] == 2 * 64 * 4
    assert Checkpointer(d).steps() == [3, 4, 5]
    logged = [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]
    assert [r["step"] for r in logged] == [0, 1, 2, 3, 4]
    assert logged[:3] == first[:3] and logged[3:] == second[:2]
    _, again, text = _main(["--iters", "5", *flags])    # nothing left to run
    assert text[0] == "# resumed from iteration 5" and again[0]["done"]
    assert again[0]["total_env_steps"] == 0 and Checkpointer(d).steps() == [3, 4, 5]
    straight, _, _ = _main(["--iters", "5", "--envs", "64", "--normalize-obs",
                            "--normalize-reward"])
    _assert_bitwise(resumed, straight)


def test_cli_eval_folds_obs_norm():
    """--eval-episodes after a normalised run evaluates the policy with
    the final statistics folded in: its record equals evaluate_fused on
    the folded weights (and the run's statistics are not the identity)."""
    runner, records, _ = _main(["--iters", "1", "--envs", "512", "--fused-collect",
                                "--normalize-obs", "--eval-episodes", "64"])
    w = ppo.fold_obs_norm(actor_critic_policy_weights(runner.model),
                          *ppo._obs_norm_scales(runner.obs_norm))
    res = evaluate_fused(EnvParams(players_per_team=2, max_steps=12), w,
                         uniform_random_weights_like(w), n_envs=64, n_steps=12,
                         seed=0)
    ev = records[1]["eval_vs_random"]
    assert ev == {"episodes": 64, "win": res["win_rate_a"], "loss": res["win_rate_b"],
                  "draw": res["draw_rate"],
                  "goals_per_episode": [round(float(g), 4)
                                        for g in res["goals_per_episode"]]}
    assert not torch.allclose(runner.obs_norm.var, torch.ones(obs_size(
        EnvParams(players_per_team=2))))


def test_cli_debug_nans(monkeypatch):
    """--debug-nans: a NaN put into the model after the second iteration
    stops the run there, naming the iteration and the parameter; autograd
    anomaly mode is on during the run and off after it."""
    real = ppo.train_iteration
    calls = []

    def poisoned(runner, env_params, cfg, **kw):
        runner, metrics = real(runner, env_params, cfg, **kw)
        calls.append(torch.is_anomaly_enabled())
        if len(calls) == 2:
            with torch.no_grad():
                runner.model.torso[0].bias[3] = float("nan")
        return runner, metrics

    monkeypatch.setattr(ppo, "train_iteration", poisoned)
    with pytest.raises(FloatingPointError,
                       match=r"iteration 1: non-finite model\.torso\.0\.bias"):
        _main(["--iters", "3", "--envs", "64", "--debug-nans"])
    assert calls == [True, True] and not torch.is_anomaly_enabled()
    _main(["--iters", "2", "--envs", "64"])             # without: no check
    assert calls[2:] == [False, False]
