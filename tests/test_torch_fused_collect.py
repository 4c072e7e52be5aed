"""The self-play policy path (kernels K2 ``fused_collect`` and K4
``fused_selfplay_rollout``): the port's plain versions against the JAX
package on the CPU, their pieces against the JAX kernels' own jnp
helpers, GAE, the wrappers' CPU path and checks, and the kernel
library's build hash.

JAX's fused kernels cannot run here (``pltpu.prng_seed`` does not lower
in interpret mode, tests/test_ops.py), so the whole slice is held
against JAX's plain paths instead, fed the same uniforms: JAX's
per-step action draws are rebuilt from its key splits
(``ppo.collect_rollout``, ``vector.rollout`` with ``joint_policy``) and
handed to the port's plain kernel versions as their uniforms table, at
zero kick and placement noise (the parameters of tests/test_ops.py:26)
so the env's own draws do not matter.

Tolerances, with their reasons: states pos/vel rtol 1e-4 / atol 1e-3
and observations rtol 1e-4 / atol 1e-5 (XLA contracts multiply-adds
into FMAs on the CPU, so trajectories part in the last bits, see
tests/test_torch_physics.py); rewards rtol 1e-5 / atol 1e-5 (as
tests/test_torch_fused_rollout.py's replay); logp and value atol 1e-5
(the same last-bit drift through a small MLP, summed in another order
than XLA's matmul); integers and sampled actions exact. Pieces fed
identical inputs: observation rows exact, MLP rows rtol 1e-5 / atol
1e-6 (summation order), logp 1e-6 (exp and log differ in the last bit).
"""

import importlib
import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu import evaluate as jeval  # noqa: E402
from gym_futbol_tpu.models import policy as jpolicy  # noqa: E402
from gym_futbol_tpu.vector import reset_batch as jreset_batch  # noqa: E402
from gym_futbol_tpu.vector import rollout as jrollout  # noqa: E402
from gym_futbol_tpu_torch import evaluate as teval  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    mlp_weights_from_numpy,
    params_from_reference,
    state_from_numpy,
)
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

from _torch_cases import custom_params, game_states  # noqa: E402

# the modules, which each package's ops/__init__ shadows with a function
jfa = importlib.import_module("gym_futbol_tpu.ops.fused_actor")
jfc = importlib.import_module("gym_futbol_tpu.ops.fused_collect")
tfa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
tfc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")

P = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
               substeps=2, solver_iterations=4, max_steps=6)
CUSTOM = custom_params(JEnvParams, JRewardConfig)
B, T = 128, 7
HIDDEN = (32, 16)
POS_TOL = dict(rtol=1e-4, atol=1e-3)
OBS_TOL = dict(rtol=1e-4, atol=1e-5)
REW_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _table(ref, draws_a, draws_b):
    """A [T, n_draws, B] uniforms table: each step's view-0 and view-1
    group draws in front, the env's draws (unused at zero noise) 0.5."""
    g = 2 * ref.players_per_team
    n_draws = tfa.n_draws_per_step(params_from_reference(ref))
    u = np.full((len(draws_a), n_draws, draws_a[0].shape[1]), 0.5, np.float32)
    for k, (a, b) in enumerate(zip(draws_a, draws_b)):
        u[k, :g], u[k, g:2 * g] = a, b
    return torch.from_numpy(u)


def _state_rows(px_list):
    return [torch.from_numpy(np.asarray(r)) for r in px_list]


# ---------------------------------------------------------------------------
# The kernels' pieces against the JAX kernels' own jnp helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref", [JEnvParams(players_per_team=3), CUSTOM],
                         ids=["3v3", "custom"])
@pytest.mark.parametrize("mirror", [False, True])
def test_obs_matrix_matches_jax(ref, mirror):
    params = params_from_reference(ref)
    rng = np.random.default_rng(1)
    pos, vel, poss, _, _ = game_states(rng, ref, B)
    n = ref.n_bodies
    rows = [pos[:, i, 0] for i in range(n)], [pos[:, i, 1] for i in range(n)], \
        [vel[:, i, 0] for i in range(n)], [vel[:, i, 1] for i in range(n)]
    want = jfa._obs_matrix(*[[jnp.asarray(r) for r in rr] for rr in rows],
                           jnp.asarray(poss), ref, mirror, B)
    got = tfa.obs_matrix(*[_state_rows(rr) for rr in rows],
                         torch.from_numpy(poss), params, mirror)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_mlp_sampling_and_unmirror_match_jax_helpers():
    ref = JEnvParams(players_per_team=2)
    rng = np.random.default_rng(2)
    weights = [_np(w) for w in jfa.init_mlp(jax.random.PRNGKey(0), ref, HIDDEN)]
    x = rng.normal(0.0, 1.0, (22, B)).astype(np.float32)
    want = jfa._mlp_logit_rows(jnp.asarray(x), [jnp.asarray(w) for w in weights], B)
    got = tfa.mlp_logit_rows(torch.from_numpy(x),
                             mlp_weights_from_numpy(weights, device="cpu"))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)

    logits = rng.normal(0.0, 2.0, (20, B)).astype(np.float32)
    u = rng.random((4, B), dtype=np.float32)
    draws = iter(u)
    idx, logp = jfc._sample_with_logp(
        jnp.asarray(logits), 4, B, B // 128,
        uniform=lambda: jnp.asarray(next(draws)).reshape(B // 128, 128))
    tidx, tlogp = tfc.sample_with_logp(torch.from_numpy(logits), 4,
                                       torch.from_numpy(u))
    for a, b in zip(tidx, idx):
        np.testing.assert_array_equal(a.numpy(), _np(b).reshape(B))
    np.testing.assert_allclose(tlogp.numpy(), _np(logp), atol=1e-6)
    for a, b in zip(tfa.sample_rows(torch.from_numpy(logits), 4,
                                    torch.from_numpy(u)), tidx):
        assert torch.equal(a, b)

    d = np.arange(-2, 8, dtype=np.int32)
    np.testing.assert_array_equal(tfa.unmirror_dir(torch.from_numpy(d)).numpy(),
                                  _np(jfa._unmirror_dir(jnp.asarray(d))))


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def _jax_runner(ref, seed):
    model = jpolicy.ActorCritic(n_players=ref.players_per_team, hidden=HIDDEN)
    cfg = jppo.PPOConfig(rollout_steps=T)
    runner = jppo.init_runner(jax.random.PRNGKey(seed), model, ref, cfg,
                              n_envs=B, tx=jppo.make_optimizer(cfg))
    return model, cfg, runner


def _port_runner(runner, ref):
    params = params_from_reference(ref)
    st = runner.env_state
    model = actor_critic_from_flax(jax.tree.map(np.asarray, runner.params),
                                   ref.players_per_team, device="cpu")
    state = state_from_numpy(st.pos, st.vel, st.possession, st.score, st.t,
                             device="cpu")
    return params, tppo.RunnerState(
        model=model, env_state=state, obs=torch.from_numpy(np.array(runner.obs)),
        generator=torch.Generator().manual_seed(0))


def test_collect_matches_jax_collect_rollout():
    """(a) fused_collect_reference in table mode, and the port's plain
    collect_rollout, against JAX's plain collect_rollout with its own
    action draws."""
    model, cfg, runner = _jax_runner(P, 3)
    g = 2 * P.players_per_team
    key, draws = runner.key, []
    for _ in range(T):                    # ppo.py collect_rollout's splits
        key, k_act = jax.random.split(key)
        draws.append(_np(jax.random.uniform(k_act, (g, 2 * B), jnp.float32)))
    jrun2, jtraj, jlast = jppo.collect_rollout(runner, model, P, cfg)

    params, trunner = _port_runner(runner, P)
    w = tfc.flatten_actor_critic(trunner.model)
    sf, si = ops.pack_state(trunner.env_state, params)
    table = _table(P, [d[:, :B] for d in draws], [d[:, B:] for d in draws])
    (sf2, si2, obs, dirs, acts, logp, value, reward, done,
     last_v) = tfc.fused_collect_reference(sf, si, w, params, uniforms=table)

    f = 4 * P.n_bodies + 2
    jobs = _np(jtraj.obs).reshape(T, 2, B, f).transpose(1, 3, 0, 2)
    np.testing.assert_allclose(obs[:, :f].numpy(), jobs, **OBS_TOL)
    assert obs.shape[1] == 24 and (obs[:, f:] == 0).all()
    for got, want in ((dirs, jtraj.dirs), (acts, jtraj.acts),
                      (done, jtraj.done.astype(np.int32))):
        np.testing.assert_array_equal(got.reshape(T, 2 * B).numpy(), _np(want))
    np.testing.assert_allclose(logp.reshape(T, 2 * B).numpy(), _np(jtraj.logp),
                               atol=1e-5)
    np.testing.assert_allclose(value.reshape(T, 2 * B).numpy(),
                               _np(jtraj.value), atol=1e-5)
    np.testing.assert_allclose(reward.reshape(T, 2 * B).numpy(),
                               _np(jtraj.reward), **REW_TOL)
    np.testing.assert_allclose(last_v.reshape(2 * B).numpy(), _np(jlast),
                               atol=1e-5)
    jst = jrun2.env_state
    state = ops.unpack_state(sf2, si2, params)
    np.testing.assert_allclose(state.pos.numpy(), _np(jst.pos), **POS_TOL)
    np.testing.assert_array_equal(state.t.numpy(), _np(jst.t))
    # both teams' actions and an episode end were reached
    assert done.any() and len(np.unique(dirs.numpy())) > 4

    # the plain per-step collector, fed the same draws
    trun2, ttraj, tlast = tppo.collect_rollout(
        trunner, params, cfg, action_uniforms=torch.from_numpy(np.stack(draws)))
    np.testing.assert_allclose(ttraj.obs.numpy(), _np(jtraj.obs), **OBS_TOL)
    for name in ("dirs", "acts", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      _np(getattr(jtraj, name)))
    np.testing.assert_allclose(ttraj.logp.numpy(), _np(jtraj.logp), atol=1e-5)
    np.testing.assert_allclose(ttraj.value.numpy(), _np(jtraj.value), atol=1e-5)
    np.testing.assert_allclose(ttraj.reward.numpy(), _np(jtraj.reward), **REW_TOL)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), atol=1e-5)
    np.testing.assert_allclose(trun2.obs.numpy(), _np(jrun2.obs), **OBS_TOL)


def test_collect_fused_layout_matches_jax_wrapper(monkeypatch):
    """(b) collect_rollout_fused's buffer layout against JAX's wrapper
    around its kernel, the JAX kernel replaced by the port's outputs in
    JAX's tile layout (tests/test_ops.py's pattern)."""
    model, cfg, runner = _jax_runner(P, 4)
    params, trunner = _port_runner(runner, P)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.random(
        (T, tfa.n_draws_per_step(params), B), dtype=np.float32))
    sf, si = ops.pack_state(trunner.env_state, params)
    outs = tfc.fused_collect_reference(
        sf, si, tfc.flatten_actor_critic(trunner.model), params, uniforms=table)

    def tiles(x):
        return jnp.asarray(x.numpy().reshape(*x.shape[:-1], B // 128, 128))

    def fake_kernel(sf_, si_, w_, seed_, env_params, n_steps, block=None,
                    interpret=False):
        assert n_steps == T
        return tuple(tiles(x) for x in outs)

    monkeypatch.setattr(jfc, "fused_collect", fake_kernel)
    jrun2, jtraj, jlast = jppo.collect_rollout_fused(runner, model, P, cfg)
    trun2, ttraj, tlast = tppo.collect_rollout_fused(trunner, params, cfg,
                                                     uniforms=table)
    assert ttraj.obs.shape == (24, 2 * T * B)
    for name in ("obs", "dirs", "acts", "logp", "value", "reward", "done"):
        got, want = getattr(ttraj, name), _np(getattr(jtraj, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(tlast.numpy(), _np(jlast))
    np.testing.assert_array_equal(trun2.obs.numpy(), _np(jrun2.obs))
    np.testing.assert_array_equal(trun2.env_state.pos.numpy(),
                                  _np(jrun2.env_state.pos))
    np.testing.assert_array_equal(trun2.env_state.t.numpy(),
                                  _np(jrun2.env_state.t))


def _jax_selfplay_draws(key, ref, n_steps):
    """vector.rollout + evaluate.joint_policy + mlp_team_policy's draws:
    per step (ua, ub) [G, B]."""
    g = 2 * ref.players_per_team
    ua, ub = [], []
    for _ in range(n_steps):
        key, k_act = jax.random.split(key)
        ka, kb = jax.random.split(k_act)
        ua.append(_np(jax.random.uniform(ka, (g, B), jnp.float32)))
        ub.append(_np(jax.random.uniform(kb, (g, B), jnp.float32)))
    return ua, ub


def _mlps(ref):
    wa = jfa.init_mlp(jax.random.PRNGKey(1), ref, HIDDEN)
    wb = jfa.init_mlp(jax.random.PRNGKey(2), ref, HIDDEN)
    return (wa, wb, mlp_weights_from_numpy(wa, device="cpu"),
            mlp_weights_from_numpy(wb, device="cpu"))


def test_selfplay_reference_matches_jax_rollout():
    """(c) fused_selfplay_rollout_reference in table mode against JAX's
    vector.rollout under joint_policy(mlp_team_policy A, B), from
    game-like states (goals, episode ends)."""
    params = params_from_reference(P)
    wa, wb, twa, twb = _mlps(P)
    pos, vel, poss, score, t = game_states(np.random.default_rng(7), P, B)
    jstate, _ = jreset_batch(jax.random.PRNGKey(8), P, B)
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            possession=jnp.asarray(poss),
                            score=jnp.asarray(score), t=jnp.asarray(t))
    key = jax.random.PRNGKey(9)
    policy = jeval.joint_policy(P, jfa.mlp_team_policy(wa, P),
                                jfa.mlp_team_policy(wb, P))
    jfinal, jouts = jrollout(jstate, policy, key, P, T)

    sf, si = ops.pack_state(
        state_from_numpy(pos, vel, poss, score, t, device="cpu"), params)
    sf2, si2, rew, goals = tfa.fused_selfplay_rollout_reference(
        sf, si, twa, twb, params,
        uniforms=_table(P, *_jax_selfplay_draws(key, P, T)))
    # free-running from contact-heavy states: the drift grows over T
    # steps (1.8e-5 measured)
    np.testing.assert_allclose(rew.numpy(), _np(jouts.team_reward[..., 0]),
                               rtol=1e-5, atol=1e-4)
    jgoals = _np(jouts.info["goal"]).sum(0).T
    np.testing.assert_array_equal(goals.numpy(), jgoals)
    state = ops.unpack_state(sf2, si2, params)
    np.testing.assert_allclose(state.pos.numpy(), _np(jfinal.pos), **POS_TOL)
    np.testing.assert_array_equal(state.possession.numpy(),
                                  _np(jfinal.possession))
    assert jgoals.sum() > 0 and (_np(jouts.done)).any()


def test_evaluate_metrics_match_jax():
    """(c) the metrics of the plain version's rollout against JAX's
    evaluate with the same MLPs, draws and start."""
    params = params_from_reference(P)
    wa, wb, twa, twb = _mlps(P)
    want = jeval.evaluate(P, jfa.mlp_team_policy(wa, P),
                          jfa.mlp_team_policy(wb, P), n_envs=B, n_steps=T,
                          seed=3)
    k_reset, k_roll = jax.random.split(jax.random.PRNGKey(3))
    jstate, _ = jreset_batch(k_reset, P, B)
    sf, si = ops.pack_state(state_from_numpy(
        jstate.pos, jstate.vel, jstate.possession, jstate.score, jstate.t,
        device="cpu"), params)
    _, _, rew, goals = tfa.fused_selfplay_rollout_reference(
        sf, si, twa, twb, params,
        uniforms=_table(P, *_jax_selfplay_draws(k_roll, P, T)))
    got = teval._match_metrics(goals, rew.mean(), B)
    assert set(got) == set(want)
    for name in ("goals", "goals_per_episode", "win_rate_a", "win_rate_b",
                 "draw_rate"):
        np.testing.assert_array_equal(got[name], _np(want[name]), err_msg=name)
    np.testing.assert_allclose(got["mean_team0_reward"],
                               _np(want["mean_team0_reward"]), rtol=1e-5,
                               atol=1e-6)


def test_compute_gae_matches_jax():
    """(d) GAE over [T, 2B] fields with episode ends: rtol/atol 1e-6
    (XLA may fuse the multiply-adds of the recursion)."""
    rng = np.random.default_rng(10)
    shape = (T, 2 * B)
    value = rng.normal(0.0, 1.0, shape).astype(np.float32)
    reward = rng.normal(0.0, 0.1, shape).astype(np.float32)
    done = rng.random(shape) < 0.1
    last = rng.normal(0.0, 1.0, 2 * B).astype(np.float32)
    cfg = jppo.PPOConfig()
    z = np.zeros(shape, np.int32)
    jtraj = jppo.Transition(obs=z, dirs=z, acts=z, logp=value, value=value,
                            reward=reward, done=done)
    jadv, jret = jppo.compute_gae(jtraj, jnp.asarray(last), cfg)
    tz = torch.zeros(shape, dtype=torch.int32)
    ttraj = tppo.Transition(
        obs=tz, dirs=tz, acts=tz, logp=torch.from_numpy(value),
        value=torch.from_numpy(value), reward=torch.from_numpy(reward),
        done=torch.from_numpy(done))
    adv, ret = tppo.compute_gae(ttraj, torch.from_numpy(last),
                                tppo.PPOConfig())
    np.testing.assert_allclose(adv.numpy(), _np(jadv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), _np(jret), rtol=1e-6, atol=1e-6)


def test_ppo_config_defaults_match_jax():
    """The port's PPOConfig holds what collection, GAE and the update
    read (JAX's fields but ``remat``, which has no counterpart), with
    the JAX package's defaults."""
    import dataclasses

    tcfg, jcfg = tppo.PPOConfig(), jppo.PPOConfig()
    names = [f.name for f in dataclasses.fields(tcfg)]
    assert names == [f.name for f in dataclasses.fields(jcfg)
                     if f.name != "remat"]
    for name in names:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


# ---------------------------------------------------------------------------
# Wrappers, draws and the build
# ---------------------------------------------------------------------------


def _port_setup(ppt=2, n_envs=B, hidden=HIDDEN, seed=0):
    params = params_from_reference(P.replace(players_per_team=ppt))
    gen = torch.Generator().manual_seed(seed)
    model = ActorCritic(ppt, 4 * params.n_bodies + 2, hidden, generator=gen,
                        device="cpu")
    cfg = tppo.PPOConfig(rollout_steps=4)
    runner = tppo.init_runner(gen, model, params, cfg, n_envs)
    return params, cfg, runner


def test_empty_torso_raises():
    """The JAX kernel applies a tanh to the raw observation when the
    torso is empty (ROADMAP, faults found); the port refuses the case."""
    params, cfg, runner = _port_setup(hidden=())
    w = tfc.flatten_actor_critic(runner.model)
    sf, si = ops.pack_state(runner.env_state, params)
    with pytest.raises(ValueError, match="torso"):
        ops.fused_collect(sf, si, w, 0, params, 2)
    with pytest.raises(ValueError, match="torso"):
        tppo.collect_rollout_fused(runner, params, cfg)


def test_cpu_path_never_builds(monkeypatch):
    """On CPU tensors the wrappers run the plain versions: no nvcc, no
    library, no launch counted; the seed determines the draws."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launch_counts()
    params, cfg, runner = _port_setup(n_envs=32)
    w = tfc.flatten_actor_critic(runner.model)
    sf, si = ops.pack_state(runner.env_state, params)
    c1 = ops.fused_collect(sf, si, w, 3, params, 3)
    c2 = ops.fused_collect(sf, si, w, 3, params, 3)
    c3 = ops.fused_collect(sf, si, w, 4, params, 3)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    assert not torch.equal(c1[3], c3[3])
    mlp = tfc.actor_critic_policy_weights(runner.model)
    e1 = teval.evaluate_fused(params, mlp, n_envs=32, n_steps=3, seed=1)
    e2 = teval.evaluate_fused(params, mlp, n_envs=32, n_steps=3, seed=1)
    assert e1["mean_team0_reward"] == e2["mean_team0_reward"]
    assert set(e1) == set(teval.evaluate(params, n_envs=8, n_steps=2,
                                         device="cpu"))
    assert ops.LAUNCHES == {"fused_rollout": 0, "fused_rollout_replay": 0,
                            "fused_collect": 0, "fused_selfplay_rollout": 0,
                            "fused_minibatch_grad": 0}


def test_philox_sampling_statistics():
    """The plain version's Philox draws sample each group's softmax: per
    group and choice, the empirical frequency is within 5 standard
    errors of the mean probability recomputed from its own obs."""
    params, cfg, runner = _port_setup(n_envs=512, hidden=(16,))
    w = tfc.flatten_actor_critic(runner.model)
    with torch.no_grad():               # make the choices uneven
        for t in w[-4:-2]:
            t.mul_(8.0)
    sf, si = ops.pack_state(runner.env_state, params)
    out = ops.fused_collect(sf, si, w, 21, params, 4)
    obs, dirs, acts = out[2], out[3], out[4]
    f = 4 * params.n_bodies + 2
    x = obs[:, :f].permute(0, 2, 3, 1).reshape(-1, f)      # (view, step, env)
    logits = tfc._forward(x.T, w)[0].T
    probs = torch.softmax(logits.reshape(-1, 4, 5).double(), -1)
    packed = (dirs.transpose(0, 1).reshape(-1), acts.transpose(0, 1).reshape(-1))
    for gi in range(4):
        a = (packed[gi % 2] >> (3 * (gi // 2))) & 7
        onehot = torch.nn.functional.one_hot(a.long(), 5).double()
        p = probs[:, gi]
        se = (p * (1 - p)).sum(0).sqrt() / p.shape[0]
        diff = (onehot.mean(0) - p.mean(0)).abs()
        assert (diff <= 5 * se).all(), (gi, diff, se)


def test_wrappers_validate_inputs():
    params, cfg, runner = _port_setup(n_envs=16)
    w = tfc.flatten_actor_critic(runner.model)
    mlp = w[:-2]
    sf, si = ops.pack_state(runner.env_state, params)
    with pytest.raises(ValueError):          # value head of width 2
        ops.fused_collect(sf, si, (*w[:-2], torch.zeros(16, 2),
                                   torch.zeros(2, 1)), 0, params, 2)
    with pytest.raises(ValueError):          # uniforms of the wrong shape
        ops.fused_collect(sf, si, w, 0, params, 2, uniforms=torch.zeros(2, 3, 16))
    with pytest.raises(ValueError):          # no steps
        ops.fused_collect(sf, si, w, 0, params, 0)
    with pytest.raises(ValueError):          # policies of unequal depth
        ops.fused_selfplay_rollout(sf, si, mlp, mlp[2:], 0, params, 2)
    with pytest.raises(ValueError):          # logits of the wrong width
        ops.fused_selfplay_rollout(sf, si, w[:-4], w[:-4], 0, params, 2)
    with pytest.raises(TypeError):
        ops.fused_selfplay_rollout(sf, si, tuple(t.double() for t in mlp), mlp,
                                   0, params, 2)


def test_pack_mlp_layout():
    """The kernel's flat layout: W padded with zero columns to a multiple
    of 16, then its bias; offsets in the table."""
    w1, b1 = torch.arange(6.0).reshape(2, 3), torch.tensor([[7.0], [8.0], [9.0]])
    w2, b2 = torch.ones(3, 17), torch.full((17, 1), 2.0)
    flat, table = tfa.pack_mlp([(w1, b1), (w2, b2)])
    assert list(table) == [2, 16, 0, 32, 3, 32, 48, 144]
    assert flat.shape == (176,)
    assert torch.equal(flat[:32].reshape(2, 16)[:, :3], w1)
    assert (flat[:32].reshape(2, 16)[:, 3:] == 0).all()
    assert torch.equal(flat[32:35], b1[:, 0]) and (flat[35:48] == 0).all()
    assert torch.equal(flat[48:144].reshape(3, 32)[:, :17], w2)
    assert (flat[144:161] == 2.0).all() and (flat[161:] == 0).all()
    with pytest.raises(ValueError):
        tfa.pack_mlp([(torch.zeros(4, 513), torch.zeros(513, 1))])


def test_library_path_hashes_headers(tmp_path):
    """The library's name hashes the shared headers too: a copy of csrc
    with one byte of futbol_step.cuh changed names another library."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    assert _build.library_path(str(src)) == _build.library_path()
    header = src / "futbol_step.cuh"
    data = bytearray(header.read_bytes())
    data[-2] = ord(" ") if data[-2] != ord(" ") else ord("\t")
    header.write_bytes(bytes(data))
    assert _build.library_path(str(src)) != _build.library_path()
