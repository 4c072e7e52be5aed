"""The distribution layer (``gym_futbol_tpu_torch.parallel``, the
``group`` of the learners and normalisers, per-rank checkpoints and the
CLI's ``--distributed``): the port's 2-rank sharded iterations against
the JAX package's ``shard_train_iteration`` on a 2-device mesh of the
fake CPU devices tests/conftest.py forces.

The port's ranks are two processes (tests/_torch_dist_worker.py) joined
in a gloo group through a file store in ``tmp_path``, each on its share
of the envs, on the kernels' plain versions. Both packages start from
the same weights and env states at zero kick and placement noise, and
each port rank is fed its shard's action uniforms and block permutations
rebuilt from JAX's per-shard keys (``fold_in`` of the split runner key,
gym_futbol_tpu/parallel/rollout.py:146-152), as
tests/test_torch_fused_collect.py and tests/test_torch_ppo_update.py
feed the unsharded paths. Bounds, the unsharded tests' own, with their
reasons:
- parameters and the update's metrics after 2 iterations: rtol 5e-3 /
  atol 5e-5 (Adam and RMSProp divide by the gradients' own scale, so
  last-bit differences grow over the steps; tests/test_torch_ppo_update.py);
- env positions rtol 1e-4 / atol 1e-3, observations rtol 1e-4 / atol
  1e-4, rewards (``mean_reward``) rtol 1e-5 / atol 1e-5, clocks exact
  (XLA contracts multiply-adds into FMAs on the CPU;
  tests/test_torch_fused_collect.py);
- the normalisers' statistics rtol 1e-5, the per-env return accumulator
  rtol 1e-5 / atol 1e-5 (tests/test_torch_normalized_ppo.py);
- across the port's ranks, the replicated leaves bitwise equal, and the
  averaged gradient exactly the mean of each rank's own (one rounding
  each for the sum of two and the halving, in the all-reduce and here);
- the sharded rollouts bitwise equal to the unsharded plain versions
  with the folded seed (the same operations on the same inputs).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import a2c as ja2c  # noqa: E402
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu import recurrent_ppo as jrppo  # noqa: E402
from gym_futbol_tpu.models.policy import ActorCritic as JActorCritic  # noqa: E402
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic as JRAC  # noqa: E402
from gym_futbol_tpu.parallel import make_mesh, ppo_runner_specs as jspecs  # noqa: E402
from gym_futbol_tpu.parallel import shard_env_state as jshard_env_state  # noqa: E402
from gym_futbol_tpu.parallel import shard_train_iteration as jshard_iter  # noqa: E402
from gym_futbol_tpu_torch import ops, vector  # noqa: E402
from gym_futbol_tpu_torch import train as ttrain  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from gym_futbol_tpu_torch.parallel import rollout as trollout  # noqa: E402
from gym_futbol_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REPO = os.path.dirname(HERE)

P = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
               substeps=2, solver_iterations=4, max_steps=6)
WORLD = 2
B = 64                     # envs in all, 32 a rank
T = 4
ITERS = 2
G = 2 * P.players_per_team  # action groups per view
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)
POS_TOL = dict(rtol=1e-4, atol=1e-3)
REW_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-7)
SEED = 2_000_000_000       # rank 1's fold wraps past 2**31
TIMEOUT = 120              # seconds, for every child process


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    """A nested dict of arrays -> {"a/b": tensor}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = _t(v)
    return out


def _mesh():
    return make_mesh(jax.devices()[:WORLD])


def _shard_key(key, shard):
    """The key shard ``shard`` runs an iteration on (rollout.py:146-148)."""
    return jax.random.fold_in(jax.random.split(key)[0], shard)


def _shard_draws(key, n_blocks=None, epochs=0):
    """Each shard's action uniforms [T, G, 2b] (the collects' key splits,
    ppo.py collect_rollout) and, with ``n_blocks``, its block
    permutations [epochs, n_blocks] (the update's key split)."""
    us, ps = [], []
    for s in range(WORLD):
        k = _shard_key(key, s)
        u = []
        for _ in range(T):
            k, k_act = jax.random.split(k)
            u.append(_np(jax.random.uniform(k_act, (G, 2 * B // WORLD))))
        us.append(_t(np.stack(u)))
        if n_blocks:
            _, k_update = jax.random.split(k)
            ps.append(torch.from_numpy(np.stack([
                _np(jax.random.permutation(kk, n_blocks))
                for kk in jax.random.split(k_update, epochs)]).astype(np.int64)))
    return us, ps


def _env_params_dict(ref):
    return dataclasses.asdict(params_from_reference(ref))


def _jax_run(runner, step_fn, n_blocks=None, epochs=0):
    """ITERS sharded JAX iterations; per iteration each shard's draws and
    the metrics."""
    us, ps, metrics = [[] for _ in range(WORLD)], [[] for _ in range(WORLD)], []
    for _ in range(ITERS):
        u, p = _shard_draws(jnp.asarray(_np(runner.key)), n_blocks, epochs)
        runner, m = step_fn(runner)
        metrics.append({k: float(v) for k, v in m.items()})
        if getattr(runner, "obs_norm", None) is not None:
            metrics[-1]["norms"] = jax.tree.map(np.array, (runner.obs_norm,
                                                           runner.rew_norm))
        for s in range(WORLD):
            us[s].append(u[s])
            if p:
                ps[s].append(p[s])
    return runner, us, ps, metrics


def _start_stats(seed):
    """Statistics after a few updates on numpy data (inv_std far from 1),
    as tests/test_torch_normalized_ppo.py starts them: fresh ones would
    take the variance of the first step's obs, near 0 where every env
    starts from the same kickoff, and z-scoring would then blow last-bit
    differences up into other actions."""
    from gym_futbol_tpu import wrappers as jw

    rng = np.random.default_rng(seed)
    f = 4 * P.n_bodies + 2
    on = jw.RunningNorm.init(f)
    for _ in range(3):
        x = rng.normal(0.0, 1.0, (64, f)) * rng.uniform(0.05, 4.0, f) + 0.7
        on = on.update(jnp.asarray(x, jnp.float32))
    rn = jw.RewardNorm.init(B)
    for _ in range(4):
        rn = rn.update(jnp.asarray(rng.normal(0.0, 0.3, B), jnp.float32),
                       jnp.asarray(rng.random(B) < 0.2), 0.99)
    return {"obs_norm": on, "rew_norm": rn}


def _case(runner, variables, cfg, us, ps=None):
    st = runner.env_state
    case = {"env_params": _env_params_dict(P), "variables": _flat(variables),
            "state": {k: _t(getattr(st, k)) for k in
                      ("pos", "vel", "possession", "score", "t")},
            "obs": _t(runner.obs), "cfg": cfg, "iters": ITERS,
            "uniforms": us}
    if ps:
        case["perms"] = ps
    return case


def _build_cases(tmp):
    """Every scenario's inputs for the port's ranks, and what JAX's
    sharded runs give."""
    mesh = _mesh()
    cases, want = {}, {}

    # PPO (plain collect, autograd update)
    kw = dict(rollout_steps=T, epochs=2, minibatches=2, shuffle_block=64)
    jcfg = jppo.PPOConfig(**kw, remat=False)
    model = JActorCritic(n_players=P.players_per_team, hidden=(16,))
    tx = jppo.make_optimizer(jcfg)
    runner = jppo.init_runner(jax.random.PRNGKey(1), model, P, jcfg, n_envs=B,
                              tx=tx)
    start = jax.tree.map(np.array, runner)     # the call donates runner
    variables = start.params
    runner = runner.replace(env_state=jshard_env_state(runner.env_state, mesh))
    n_blocks = T * 2 * (B // WORLD) // 64
    runner, us, ps, metrics = _jax_run(
        runner, jshard_iter(mesh, model, P, jcfg, tx), n_blocks, 2)
    cases["ppo"] = _case(start, variables, kw, us, ps)
    want["ppo"] = (runner, metrics)

    # PPO through the plain normalised collect: one global normaliser
    collect = jppo.make_normalized_collect(True, True, axis_name="env")
    import functools

    runner = jppo.init_runner(jax.random.PRNGKey(2), model, P, jcfg, n_envs=B,
                              tx=tx, normalize_obs=True, normalize_reward=True)
    runner = runner.replace(**_start_stats(8))
    start = jax.tree.map(np.array, runner)     # the call donates runner
    variables = start.params
    runner = runner.replace(env_state=jshard_env_state(runner.env_state, mesh))
    runner, us, ps, metrics = _jax_run(runner, jshard_iter(
        mesh, model, P, jcfg, tx,
        iteration_fn=functools.partial(jppo.train_iteration, collect_fn=collect),
        runner_specs=jspecs(True, True)), n_blocks, 2)
    cases["norm"] = _case(start, variables, kw, us, ps)
    cases["norm"]["obs_norm"] = {k: _t(getattr(start.obs_norm, k))
                                 for k in ("mean", "var", "count")}
    cases["norm"]["rew_norm"] = {k: _t(getattr(start.rew_norm, k))
                                 for k in ("ret", "mean", "var", "count")}
    want["norm"] = (runner, metrics)

    # A2C (RMSProp, one full-batch step)
    a2c_kw = dict(rollout_steps=T)
    acfg = ja2c.A2CConfig(**a2c_kw)
    atx = ja2c.make_optimizer(acfg)
    runner = jppo.init_runner(jax.random.PRNGKey(3), model, P, acfg, n_envs=B,
                              tx=atx)
    start = jax.tree.map(np.array, runner)     # the call donates runner
    variables = start.params
    runner = runner.replace(env_state=jshard_env_state(runner.env_state, mesh))
    runner, us, _, metrics = _jax_run(runner, jshard_iter(
        mesh, model, P, acfg, atx, iteration_fn=ja2c.train_iteration))
    cases["a2c"] = _case(start, variables, a2c_kw, us)
    want["a2c"] = (runner, metrics)

    # recurrent PPO (sequence minibatches, BPTT)
    r_kw = dict(rollout_steps=T, epochs=2, minibatches=2, shuffle_block=8)
    rcfg = jrppo.RecurrentPPOConfig(**r_kw, remat=False)
    rmodel = JRAC(n_players=P.players_per_team, hidden=(16,), lstm_size=8)
    rtx = jrppo.make_optimizer(rcfg)
    runner = ja2c.init_recurrent_runner(jax.random.PRNGKey(4), rmodel, P, rcfg,
                                        n_envs=B, tx=rtx)
    start = jax.tree.map(np.array, runner)     # the call donates runner
    variables = start.params
    runner = runner.replace(env_state=jshard_env_state(runner.env_state, mesh))
    runner, us, ps, metrics = _jax_run(runner, jshard_iter(
        mesh, rmodel, P, rcfg, rtx,
        iteration_fn=jrppo.train_iteration_recurrent_ppo,
        runner_specs=ja2c.recurrent_runner_specs()), 2 * (B // WORLD) // 8, 2)
    cases["rppo"] = _case(start, variables, r_kw, us, ps)
    want["rppo"] = (runner, metrics)

    # the sharded fused path (plain K2 and K3)
    n_envs = 128                           # K3 takes blocks of 128 samples
    cases["fused"] = {
        "env_params": _env_params_dict(P), "obs_dim": 4 * P.n_bodies + 2,
        "hidden": [16], "n_envs": n_envs,
        "cfg": dict(rollout_steps=T, epochs=1, minibatches=2, shuffle_block=128),
        "perms": torch.randperm(T * 2 * n_envs // WORLD // 128,
                                generator=torch.Generator().manual_seed(3))[None]}

    # the sharded rollouts: both ranks hold the same envs, so only their
    # streams differ
    rng = np.random.default_rng(7)
    params = params_from_reference(P)
    half, _ = vector.reset_batch(torch.Generator().manual_seed(6),
                                 params.replace(placement_noise=0.3), 8,
                                 device="cpu")
    whole = dataclasses.replace(half, **{
        f.name: torch.cat([getattr(half, f.name)] * 2)
        for f in dataclasses.fields(half)})
    actions = torch.from_numpy(rng.integers(
        0, 5, (T, 2 * P.n_players, 16)).astype(np.int32))
    cases["rollout"] = {
        "env_params": _env_params_dict(P.replace(kick_noise=0.1,
                                                 placement_noise=0.3)),
        "state": {k: getattr(whole, k) for k in
                  ("pos", "vel", "possession", "score", "t")},
        "n_steps": 8, "seed": SEED, "actions": actions}
    want["rollout"] = whole

    cases["checks"] = {"env_params": _env_params_dict(P)}

    # the CLI
    base = ["--ppt", "2", "--envs", "1024", "--rollout-steps", "4", "--hidden",
            "16", "--max-steps", "6"]
    small = ["--ppt", "2", "--envs", "64", "--rollout-steps", "4", "--hidden",
             "16", "--max-steps", "6"]
    cases["cli"] = {
        "argv": base + ["--fused-collect", "--normalize-obs",
                        "--normalize-reward"],
        "dirs": [str(tmp / "cli_resumed"), str(tmp / "cli_whole")],
        "algos": {
            "ppo": small,
            "ppo_fused": base + ["--fused-collect"],
            "ppo_normalized": small + ["--normalize-obs", "--normalize-reward"],
            "a2c": small + ["--algo", "a2c"],
            "a2c_fused": small + ["--algo", "a2c", "--fused-collect"],
            "a2c_recurrent": small + ["--algo", "a2c", "--recurrent",
                                      "--lstm-size", "8"],
            "a2c_recurrent_fused": small + ["--algo", "a2c", "--recurrent",
                                            "--lstm-size", "8",
                                            "--fused-collect"],
            "ppo_recurrent": small + ["--recurrent", "--lstm-size", "8"],
            "ppo_recurrent_fused": small + ["--recurrent", "--lstm-size", "8",
                                            "--fused-collect"],
        }}
    return cases, want


def run_ranks(tmp, cases, world=WORLD):
    """Run the scenarios on ``world`` worker processes; their outputs, one
    dict per rank. Every child is killed when the timeout expires."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "in.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp), str(r),
                               str(world)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for r in range(world)]
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
        assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err[-4000:]}"
    return [torch.load(tmp / f"out{r}.pt", weights_only=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    cases, want = _build_cases(tmp)
    return run_ranks(tmp, cases), want, cases


# ---------------------------------------------------------------------------
# The sharded iterations against JAX's shard_train_iteration
# ---------------------------------------------------------------------------


def _assert_kernels(got, jparams, what):
    for name, (w, b) in got.items():
        np.testing.assert_allclose(w.numpy(), _np(jparams["params"][name]["kernel"]),
                                   **PARAM_TOL, err_msg=f"{what} {name}")
        np.testing.assert_allclose(b.numpy(), _np(jparams["params"][name]["bias"]),
                                   **PARAM_TOL, err_msg=f"{what} {name}")


def _assert_metrics(got, want, what):
    assert len(got) == len(want) == ITERS
    for it, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (g, w)
        for k in set(g) - {"norms"}:
            tol = REW_TOL if k == "mean_reward" else PARAM_TOL
            np.testing.assert_allclose(g[k], w[k], **tol,
                                       err_msg=f"{what} iteration {it} {k}")


def _assert_envs(out, jrunner, rank, what):
    b = B // WORLD
    sl = slice(rank * b, (rank + 1) * b)
    st = jrunner.env_state
    np.testing.assert_allclose(out["pos"].numpy(), _np(st.pos)[sl], **POS_TOL,
                               err_msg=what)
    if "t" in out:
        np.testing.assert_array_equal(out["t"].numpy(), _np(st.t)[sl])
    if "obs" in out:
        np.testing.assert_allclose(out["obs"].numpy(), _np(jrunner.obs)[sl],
                                   rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("name", ["ppo", "a2c"])
def test_sharded_iteration_matches_jax(dist_run, name):
    """2 iterations of the port's sharded PPO (plain collect, autograd
    update) and A2C (RMSProp) on 2 gloo ranks against JAX's
    shard_train_iteration on a 2-device mesh: each rank's envs, the
    replicated parameters (bitwise equal across the ranks) and the
    metrics averaged over the ranks."""
    outs, want, _ = dist_run
    jrunner, jmetrics = want[name]
    for rank, out in enumerate(outs):
        _assert_kernels(out[name]["kernels"], jrunner.params, f"{name} rank {rank}")
        _assert_metrics(out[name]["metrics"], jmetrics, f"{name} rank {rank}")
        _assert_envs(out[name], jrunner, rank, f"{name} rank {rank}")
    for (w0, b0), (w1, b1) in zip(outs[0][name]["kernels"].values(),
                                  outs[1][name]["kernels"].values()):
        assert torch.equal(w0, w1) and torch.equal(b0, b1)
    assert outs[0][name]["metrics"] == outs[1][name]["metrics"]


def test_sharded_recurrent_ppo_matches_jax(dist_run):
    """2 iterations of sharded recurrent PPO (sequence minibatches of each
    rank's own sequences, BPTT) against JAX's: parameters, metrics, each
    rank's envs and LSTM carries ([2, B, H], the envs on dim 1)."""
    from gym_futbol_tpu_torch.interop import recurrent_actor_critic_from_flax

    outs, want, _ = dist_run
    jrunner, jmetrics = want["rppo"]
    ref = recurrent_actor_critic_from_flax(
        jax.tree.map(np.asarray, jrunner.params), P.players_per_team, device="cpu")
    b = B // WORLD
    for rank, out in enumerate(outs):
        o = out["rppo"]
        for k, v in ref.named_parameters():
            np.testing.assert_allclose(o["params"][k].numpy(), v.detach().numpy(),
                                       **PARAM_TOL, err_msg=f"rank {rank} {k}")
        _assert_metrics(o["metrics"], jmetrics, f"rppo rank {rank}")
        _assert_envs(o, jrunner, rank, f"rppo rank {rank}")
        for got, jc in zip(o["carry"], jrunner.carry):
            np.testing.assert_allclose(got.numpy(),
                                       _np(jc)[:, rank * b:(rank + 1) * b],
                                       rtol=1e-4, atol=1e-4)
    for k in outs[0]["rppo"]["params"]:
        assert torch.equal(outs[0]["rppo"]["params"][k], outs[1]["rppo"]["params"][k])


def test_sharded_normalized_collect_global_stats(dist_run):
    """The plain normalised collect with ``group`` (the counterpart of
    tests/test_sharding.py::test_normalized_training_global_stats): after
    each of 2 iterations every rank carries one global normaliser, equal
    to JAX's sharded one, its count grown by T * 2 * B, a collect over
    all ranks' envs; the return accumulator stays with its rank's
    envs."""
    outs, want, cases = dist_run
    jrunner, jmetrics = want["norm"]
    count0 = float(cases["norm"]["obs_norm"]["count"])
    b = B // WORLD
    for rank, out in enumerate(outs):
        for it in range(ITERS):
            on, rn = out["norm"]["metrics"][it]["norms"]
            jon, jrn = jmetrics[it]["norms"]
            assert abs(float(on["count"]) - count0 - (it + 1) * T * 2 * B) < 1.0
            for k in ("mean", "var", "count"):
                np.testing.assert_allclose(on[k].numpy(), getattr(jon, k),
                                           **STAT_TOL, err_msg=f"{it} obs_norm.{k}")
                np.testing.assert_allclose(rn[k].numpy(), getattr(jrn, k),
                                           **STAT_TOL, err_msg=f"{it} rew_norm.{k}")
            assert rn["ret"].shape == (b,)
            np.testing.assert_allclose(rn["ret"].numpy(),
                                       jrn.ret[rank * b:(rank + 1) * b], **REW_TOL)
        _assert_kernels(out["norm"]["kernels"], jrunner.params, f"norm rank {rank}")
        _assert_metrics(out["norm"]["metrics"], jmetrics, f"norm rank {rank}")
        _assert_envs(out["norm"], jrunner, rank, f"norm rank {rank}")
    for m0, m1 in zip(outs[0]["norm"]["metrics"], outs[1]["norm"]["metrics"]):
        for a, b_ in zip(m0["norms"], m1["norms"]):
            for k in ("mean", "var", "count"):
                assert torch.equal(a[k], b_[k])


# ---------------------------------------------------------------------------
# The sharded fused path (plain K2 and K3)
# ---------------------------------------------------------------------------


def test_sharded_fused_gradient_is_mean_of_ranks(dist_run):
    """update_epochs_fused with ``group`` hands the optimiser, at every
    minibatch, exactly the mean of the gradients each rank computes
    alone (the same on both ranks), and the metrics' means."""
    outs, _, _ = dist_run
    f0, f1 = outs[0]["fused"], outs[1]["fused"]
    assert len(f0["mean"]) == len(f0["own"]) == 2
    for step in range(2):
        for g0, g1, own0, own1 in zip(f0["mean"][step], f1["mean"][step],
                                      f0["own"][step], f1["own"][step]):
            assert torch.equal(g0, g1)
            assert torch.equal(g0, (own0 + own1) / 2)
            assert not torch.equal(own0, own1)
    for k, v in f0["mean_metrics"].items():
        assert v == f1["mean_metrics"][k]
        np.testing.assert_allclose(
            v, (f0["own_metrics"][k] + f1["own_metrics"][k]) / 2, rtol=1e-6)


def test_sharded_fused_iteration_keeps_replicas_equal(dist_run):
    """Two sharded iterations of collect_rollout_fused + update_epochs_fused
    (the plain versions on the CPU, no kernel launched): the worker's
    check_replicated passed, the metrics are finite and equal on both
    ranks."""
    outs, _, _ = dist_run
    m0, m1 = outs[0]["fused"]["iteration"], outs[1]["fused"]["iteration"]
    assert m0 == m1 and all(np.isfinite(v) for v in m0.values())
    assert outs[0]["fused"]["launches"] == outs[1]["fused"]["launches"] == 0


# ---------------------------------------------------------------------------
# The sharded rollouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 600_000_000, SEED, 2**31 - 1, -5])
def test_fold_seed_matches_jax_int32(seed):
    """fold_seed is the JAX package's int32 ``seed + axis_index *
    0x1F123BB5`` (rollout.py:78) for ranks 0-7, the wrap included."""
    for rank in range(8):
        want = int(jnp.int32(seed) + jnp.int32(rank) * jnp.int32(0x1F123BB5))
        assert tmesh.fold_seed(seed, rank) == want, (seed, rank)
    assert tmesh.fold_seed(600_000_000, 3) < 0     # wraps at rank 3


def test_shard_fused_rollout_per_rank_seed(dist_run):
    """Each rank's shard_fused_rollout (the plain version on the CPU)
    equals one unsharded rollout of its envs with its folded seed, rank
    1's wrapped past 2**31; the ranks hold the same envs and part."""
    outs, want, cases = dist_run
    c = cases["rollout"]
    params = params_from_reference(P).replace(kick_noise=0.1, placement_noise=0.3)
    whole = want["rollout"]
    assert tmesh.fold_seed(SEED, 1) < 0
    for rank, out in enumerate(outs):
        sl = slice(rank * 8, (rank + 1) * 8)
        state = dataclasses.replace(whole, **{
            f.name: getattr(whole, f.name)[sl] for f in dataclasses.fields(whole)})
        sf, si = ops.pack_state(state, params)
        ref = ops.fused_rollout(sf, si, tmesh.fold_seed(SEED, rank), params,
                                c["n_steps"])
        for got, w in zip(out["rollout"]["fused"], ref):
            assert torch.equal(got, w)
    assert not torch.equal(outs[0]["rollout"]["fused"][2],
                           outs[1]["rollout"]["fused"][2])


def test_sharded_replay_matches_unsharded(dist_run):
    """The sharded replay (fused_rollout_replay's plain version on each
    rank's envs and actions, both from shard_env_state) equals the
    rank's slice of one unsharded replay."""
    outs, want, cases = dist_run
    params = params_from_reference(P).replace(kick_noise=0.1, placement_noise=0.3)
    sf, si = ops.pack_state(want["rollout"], params)
    ref = ops.fused_rollout_replay(sf, si, cases["rollout"]["actions"], params)
    for rank, out in enumerate(outs):
        sl = slice(rank * 8, (rank + 1) * 8)
        for got, w in zip(out["rollout"]["replay"], ref):
            assert torch.equal(got, w[..., sl])


def test_shard_rollout_matches_vector_rollout(dist_run):
    """shard_rollout: vector.rollout of the rank's envs from a generator
    seeded with the folded seed."""
    outs, want, cases = dist_run
    params = params_from_reference(P).replace(kick_noise=0.1, placement_noise=0.3)
    whole = want["rollout"]
    for rank, out in enumerate(outs):
        sl = slice(rank * 8, (rank + 1) * 8)
        state = dataclasses.replace(whole, **{
            f.name: getattr(whole, f.name)[sl] for f in dataclasses.fields(whole)})
        gen = torch.Generator().manual_seed(tmesh.fold_seed(SEED, rank) % 2**32)
        st, o = vector.rollout(state, vector.random_policy(params), gen, params,
                               cases["rollout"]["n_steps"])
        assert torch.equal(out["rollout"]["plain_pos"], st.pos)
        assert torch.equal(out["rollout"]["plain_reward"], o.reward)


# ---------------------------------------------------------------------------
# Checks and refusals across ranks
# ---------------------------------------------------------------------------


def test_check_replicated_and_unequal_shares(dist_run):
    """check_replicated passes on equal replicas and raises on both ranks
    once rank 1's parameters move; a normaliser update over unequal
    shares raises on both ranks."""
    outs, _, _ = dist_run
    for rank, out in enumerate(outs):
        c = out["checks"]
        assert c["equal"] == "ok"
        assert "replicated leaves differ" in c["moved"]
        assert ("model" in c["moved"]) == (rank == 1)
        assert "differ in size" in c["unequal"]


# ---------------------------------------------------------------------------
# The CLI's --distributed
# ---------------------------------------------------------------------------


def test_cli_rank0_alone_logs(dist_run, tmp_path_factory):
    """Rank 0 prints the records and writes metrics.jsonl (steps 0-2
    across the first run and its resume); rank 1 prints nothing; each
    rank saved its own checkpoints."""
    outs, _, cases = dist_run
    c0, c1 = outs[0]["cli"], outs[1]["cli"]
    recs = [json.loads(x) for x in c0["first"]]
    assert [r.get("step") for r in recs] == [0, 1, None]
    assert recs[-1]["done"] and recs[-1]["total_env_steps"] == 2 * 1024 * 4
    assert c0["resumed"][0] == "# resumed from iteration 2"
    assert json.loads(c0["resumed"][1])["step"] == 2
    assert c1["first"] == c1["resumed"] == c1["whole"] == []
    d1 = cases["cli"]["dirs"][0]
    with open(os.path.join(d1, "metrics.jsonl")) as fh:
        assert [json.loads(x)["step"] for x in fh] == [0, 1, 2]
    names = sorted(os.listdir(d1))
    for step in (1, 2, 3):
        for rank in range(WORLD):
            assert f"checkpoint_{step}.rank{rank}-of-{WORLD}.pt" in names


def test_cli_resume_bitwise(dist_run):
    """On each rank the run resumed at 2 and taken to 3 equals the
    uninterrupted run of 3 bitwise, every leaf: its own envs, generator
    and return accumulator, and the replicated model, Adam state and
    statistics."""
    outs, _, _ = dist_run
    for rank, out in enumerate(outs):
        a, b = out["cli"]["resumed_leaves"], out["cli"]["whole_leaves"]
        assert a.keys() == b.keys() and len(a) > 20
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        assert not differ, (rank, differ)
    gens = [out["cli"]["whole_leaves"]["runner.generator"] for out in outs]
    assert not torch.equal(*gens)              # each rank its own stream


def test_cli_world_size_change_refused(dist_run):
    """Resuming the 2-rank checkpoints without --distributed (one rank)
    is refused with a clear error."""
    _, _, cases = dist_run
    c = cases["cli"]
    with pytest.raises(ValueError, match="resume with as many ranks"):
        with contextlib.redirect_stdout(io.StringIO()):
            ttrain.main(c["argv"] + ["--iters", "3", "--device", "cpu",
                                     "--checkpoint-dir", c["dirs"][0]])


@pytest.mark.parametrize("algo", [
    "ppo", "ppo_fused", "ppo_normalized", "a2c", "a2c_fused", "a2c_recurrent",
    "a2c_recurrent_fused", "ppo_recurrent", "ppo_recurrent_fused"])
def test_cli_shards_every_algorithm(dist_run, algo):
    """Every algorithm and collect the JAX CLI shards runs one iteration
    under --distributed on 2 ranks: rank 0 prints one record and the done
    record over all the envs, rank 1 nothing; the replicas agreed."""
    outs, _, cases = dist_run
    lines = outs[0]["cli"]["algos"][algo]
    argv = cases["cli"]["algos"][algo]
    recs = [json.loads(x) for x in lines]
    assert len(recs) == 2 and recs[0]["step"] == 0 and recs[1]["done"]
    n_envs = int(argv[argv.index("--envs") + 1])
    assert recs[1]["total_env_steps"] == n_envs * T
    assert all(np.isfinite(v) for k, v in recs[0].items() if k != "step")
    assert outs[1]["cli"]["algos"][algo] == []


# ---------------------------------------------------------------------------
# Single-process pieces
# ---------------------------------------------------------------------------


def test_init_distributed_is_a_noop_without_a_launch(monkeypatch):
    """Without torchrun's environment, keyword arguments or ``force``,
    init_distributed touches nothing; ``force`` outside a launch names
    torchrun."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed(device="cpu") is False
    assert tmesh.env_group() is None
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.init_distributed(force=True, device="cpu")
    assert not torch.distributed.is_initialized()


def test_backend_and_device_choice(monkeypatch):
    """NCCL when every local rank has a card, gloo when ranks share one
    or run on the CPU; the rank's card is LOCAL_RANK modulo the cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh.default_backend("cuda") == "gloo"
    assert tmesh.default_backend("cpu") == "gloo"
    assert tmesh.rank_device("cuda") == torch.device("cuda", 0)
    assert tmesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.default_backend("cuda") == "nccl"
    assert tmesh.rank_device("cuda") == torch.device("cuda", 1)


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(tmesh, "rank_and_size", lambda group: (rank, world))
    monkeypatch.setattr(trollout, "rank_and_size", lambda group: (rank, world))


def test_shard_runner_shares_and_streams(monkeypatch):
    """shard_runner cuts every env leaf (the carries on dim 1) to the
    rank's contiguous share, keeps the replicated leaves (the same
    objects) and gives rank 0 the runner's generator, any other rank a
    stream of its own; an uneven split raises."""
    from gym_futbol_tpu_torch import a2c, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic

    params = params_from_reference(P)
    f = 4 * P.n_bodies + 2
    cfg = ppo.PPOConfig(rollout_steps=T)
    whole = ppo.init_runner(torch.Generator().manual_seed(0),
                            ActorCritic(2, f, (8,), device="cpu"), params, cfg, 12,
                            normalize_obs=True, normalize_reward=True)
    for rank in range(3):
        _as_rank(monkeypatch, rank, 3)
        r = trollout.shard_runner(whole, "g")
        sl = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(r.env_state.pos, whole.env_state.pos[sl])
        assert torch.equal(r.obs, whole.obs[sl])
        assert torch.equal(r.rew_norm.ret, whole.rew_norm.ret[sl])
        assert r.model is whole.model and r.optimizer is whole.optimizer
        assert r.obs_norm.mean is whole.obs_norm.mean
        assert r.rew_norm.var is whole.rew_norm.var
        assert (r.generator is whole.generator) == (rank == 0)
    rec = a2c.init_recurrent_runner(
        torch.Generator().manual_seed(0),
        RecurrentActorCritic(2, f, (8,), 4, device="cpu"), params,
        a2c.A2CConfig(), 12)
    rec = rec.replace(carry=tuple(torch.randn(2, 12, 4) for _ in range(2)))
    _as_rank(monkeypatch, 1, 3)
    r = trollout.shard_runner(rec, "g")
    assert torch.equal(r.carry[0], rec.carry[0][:, 4:8])
    assert r.generator.initial_seed() == tmesh.fold_seed(0, 1)
    _as_rank(monkeypatch, 0, 5)
    with pytest.raises(ValueError, match="divide evenly"):
        trollout.shard_runner(whole, "g")


def test_runner_specs_match_jax():
    """ppo_runner_specs and a2c.recurrent_runner_specs mark as env shards
    the leaves JAX's specs shard over 'env' and as replicated those it
    replicates; the runner's generator (JAX's replicated key, split per
    shard each iteration) is each rank's own stream."""
    from gym_futbol_tpu_torch import a2c

    def kinds(spec):
        return "env" if spec == jax.sharding.PartitionSpec("env") or (
            spec == jax.sharding.PartitionSpec(None, "env", None)) else "rep"

    for norms in ((False, False), (True, True)):
        j, t = jspecs(*norms), trollout.ppo_runner_specs(*norms)
        assert kinds(j.params) == "rep" and t.model == trollout.REPLICATED
        assert kinds(j.opt_state) == "rep" and t.optimizer == trollout.REPLICATED
        assert kinds(j.obs) == "env" and t.obs == trollout.ENV
        for k in ("pos", "vel", "possession", "score", "t"):
            assert kinds(getattr(j.env_state, k)) == "env"
            assert getattr(t.env_state, k) == trollout.ENV
        assert t.generator == trollout.PER_RANK
        if norms[0]:
            for k in ("mean", "var", "count"):
                assert kinds(getattr(j.obs_norm, k)) == "rep"
                assert getattr(t.obs_norm, k) == trollout.REPLICATED
                assert kinds(getattr(j.rew_norm, k)) == "rep"
                assert getattr(t.rew_norm, k) == trollout.REPLICATED
            assert kinds(j.rew_norm.ret) == "env" and t.rew_norm.ret == trollout.ENV
        else:
            assert j.obs_norm is t.obs_norm is None
    jr, tr = ja2c.recurrent_runner_specs(), a2c.recurrent_runner_specs()
    assert [kinds(c) for c in jr.carry] == ["env", "env"]
    assert tr.carry == (trollout.Sharded(1), trollout.Sharded(1))


def test_checkpointer_files_per_rank(monkeypatch, tmp_path):
    """With several ranks each saves its own file and restores the newest
    step every rank saved; checkpoints of another world size are
    refused."""
    from gym_futbol_tpu_torch import ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    params = params_from_reference(P)
    cfg = ppo.PPOConfig(rollout_steps=T)

    def runner(seed):
        return ppo.init_runner(torch.Generator().manual_seed(seed),
                               ActorCritic(2, 4 * P.n_bodies + 2, (8,),
                                           device="cpu"), params, cfg, 4)

    for rank, steps in ((0, (1, 2, 3)), (1, (1, 2))):
        _as_rank(monkeypatch, rank, 2)
        ck = Checkpointer(str(tmp_path), group="g")
        for s in steps:
            ck.save(runner(10 * rank + s), s)
        assert ck.steps() == list(steps)
    _as_rank(monkeypatch, 0, 2)
    got, step = Checkpointer(str(tmp_path), group="g").restore_latest(runner(99))
    assert step == 2                                # rank 1 has no step 3
    want = runner(2)
    for a, b in zip(got.model.parameters(), want.model.parameters()):
        assert torch.equal(a, b)
    for rank, world in ((0, 1), (0, 3)):
        _as_rank(monkeypatch, rank, world)
        with pytest.raises(ValueError, match="resume with as many ranks"):
            Checkpointer(str(tmp_path), group=None if world == 1 else "g"
                         ).restore_latest(runner(0))
