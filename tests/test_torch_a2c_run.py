"""Whole A2C runs: several iterations of the port's recurrent and
feed-forward A2C against the JAX package's on the CPU.

Both start from the same weights (JAX's init, converted with the
interop), the same env states and carries, and run several iterations
each: JAX's ``a2c.train_iteration_recurrent`` / ``a2c.train_iteration``
on its plain collect and optax's RMSProp; the port's on its plain
collect, fed the action uniforms JAX draws, rebuilt from its runner key
chain (``key, k_act = split(key)`` each step, ``uniform(k_act, (G,
2B))``), and its :class:`~gym_futbol_tpu_torch.a2c.RMSProp`. Kick and
placement noise are zero, so the action draws are the only randomness.
The recurrent learner also runs on the fused collect: JAX's K5 in
interpret mode against the port's plain version of K5, both reading the
table JAX's kernel draws. After every iteration: every parameter,
RMSProp's ``nu``, the env state, the carries (recurrent) and the five
metrics.

Tolerances, with their reasons: parameters, ``nu`` and carries atol
1e-5, the collect tests' bound (XLA contracts multiply-adds into FMAs
on the CPU, so the two forwards part in the last bits,
tests/test_torch_fused_recurrent.py); RMSProp's step ``lr * g /
sqrt(nu + eps)`` is about ``lr * sign(g)`` for every gradient that is
not tiny, so last-bit gradient differences stay last-bit in the weights.
Metrics rtol 1e-4 / atol 1e-5 (sums over the batch in another order);
positions rtol 1e-4 / atol 1e-3 (tests/test_torch_env.py); sampled
actions, dones and possession exact.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import a2c as ja2c  # noqa: E402
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu.models.policy import ActorCritic as JAC  # noqa: E402
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic as JRAC  # noqa: E402
from gym_futbol_tpu_torch import a2c as ta2c  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    params_from_reference,
    recurrent_actor_critic_from_flax,
    state_from_numpy,
)
from gym_futbol_tpu_torch.ops import n_draws_per_step  # noqa: E402

P0 = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
                substeps=2, solver_iterations=4, max_steps=6)
B, H, HIDDEN, ITERS = 16, 8, (16,), 4
TOL = dict(atol=1e-5, rtol=0)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
POS_TOL = dict(rtol=1e-4, atol=1e-3)
METRICS = ("loss", "pg_loss", "v_loss", "entropy", "mean_reward")


def _np(x):
    return np.asarray(x)


def _uniforms(key, t, g):
    """The action uniforms of JAX's plain collect over a window of ``t``
    steps from runner key ``key``: ``[t, g, 2B]``."""
    draws = []
    for _ in range(t):
        key, k_act = jax.random.split(key)
        draws.append(_np(jax.random.uniform(k_act, (g, 2 * B), jnp.float32)))
    return torch.from_numpy(np.stack(draws))


def _kernel_table(key, t, n_draws, b):
    """The uniforms table JAX's K5 reads in interpret mode for the window
    that starts from runner key ``key``: its wrapper splits ``key, k_seed,
    k_state`` and draws the kernel's int seed from ``k_seed``; the kernel
    reads ``uniform(PRNGKey(seed), (t, n_draws, nb, 128))``. ``[t,
    n_draws, b]``."""
    _, k_seed, _ = jax.random.split(key, 3)
    seed = int(jax.random.randint(k_seed, (1,), 0, 2**31 - 1, dtype=jnp.int32)[0])
    table = jax.random.uniform(jax.random.PRNGKey(seed),
                               (t, n_draws, b // 128, 128), jnp.float32)
    return torch.from_numpy(np.array(table).reshape(t, n_draws, b))


def _nu(opt_state):
    """optax's rmsprop ``nu`` from the chain's state (clip, rms, scale)."""
    return opt_state[1][0].nu


def _assert_model(model, variables, convert, what):
    want = convert(jax.tree.map(np.asarray, variables), P0.players_per_team,
                   device="cpu").state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   **TOL, err_msg=f"{what} {name}")


def _assert_nu(opt, nu_tree, model, convert):
    """The port's ``nu``, in ``model.parameters()`` order, against optax's
    ``nu`` tree (the params' structure, so the same converter maps it)."""
    want = convert(jax.tree.map(np.asarray, nu_tree), P0.players_per_team,
                   device="cpu")
    for (name, _), got, ref in zip(model.named_parameters(), opt.nu,
                                   want.parameters(), strict=True):
        np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), **TOL,
                                   err_msg=f"nu {name}")


def _assert_metrics(got, want):
    assert set(got) == set(METRICS) == set(want)
    for name in METRICS:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   **METRIC_TOL, err_msg=name)


def _assert_env(trun, jrun):
    np.testing.assert_allclose(trun.env_state.pos.numpy(),
                               _np(jrun.env_state.pos), **POS_TOL)
    np.testing.assert_array_equal(trun.env_state.possession.numpy(),
                                  _np(jrun.env_state.possession))
    np.testing.assert_array_equal(trun.env_state.t.numpy(), _np(jrun.env_state.t))


def _port_state(st):
    return state_from_numpy(st.pos, st.vel, st.possession, st.score, st.t,
                            device="cpu")


@pytest.mark.parametrize("t,iters", [(5, ITERS), (16, 8)], ids=["T5", "T16"])
def test_recurrent_a2c_run_matches_jax(t, iters):
    """Recurrent A2C iterations (2v2, 16 envs, hidden (16,), H=8,
    episodes of 6 steps, so carries reset inside and across windows): 4
    at T=5, and 8 at the gate's T=16. The BPTT step from each window's
    first carry, the carry handed from one window to the next, RMSProp's
    state."""
    cfg_j = ja2c.A2CConfig(rollout_steps=t)
    tx = ja2c.make_optimizer(cfg_j)
    model = JRAC(n_players=2, hidden=HIDDEN, lstm_size=H)
    jrun = ja2c.init_recurrent_runner(jax.random.PRNGKey(0), model, P0, cfg_j,
                                      B, tx)
    step = jax.jit(lambda r: ja2c.train_iteration_recurrent(r, model, P0,
                                                            cfg_j, tx))
    params = params_from_reference(P0)
    cfg = ta2c.A2CConfig(rollout_steps=t)
    tmodel = recurrent_actor_critic_from_flax(
        jax.tree.map(np.asarray, jrun.params), 2, device="cpu")
    trun = ta2c.RecurrentRunnerState(
        model=tmodel, env_state=_port_state(jrun.env_state),
        obs=torch.from_numpy(np.array(jrun.obs)),
        carry=tuple(torch.from_numpy(np.array(c)) for c in jrun.carry),
        generator=torch.Generator().manual_seed(0),
        optimizer=ta2c.make_optimizer(tmodel, cfg))
    g = 2 * P0.players_per_team
    for it in range(iters):
        u = _uniforms(jrun.key, cfg.rollout_steps, g)
        jrun, jm = step(jrun)
        trun, tm = ta2c.train_iteration_recurrent(
            trun, params, cfg, collect_fn=functools.partial(
                ta2c.collect_recurrent_rollout, action_uniforms=u))
        _assert_metrics(tm, jm)
        _assert_model(trun.model, jrun.params, recurrent_actor_critic_from_flax,
                      f"iteration {it}")
        _assert_nu(trun.optimizer, _nu(jrun.opt_state), trun.model,
                   recurrent_actor_critic_from_flax)
        for a, b in zip(trun.carry, jrun.carry):
            np.testing.assert_allclose(a.numpy(), _np(b), **TOL,
                                       err_msg=f"carry, iteration {it}")
        _assert_env(trun, jrun)
        assert trun.optimizer.count == it + 1
    # every episode ended inside the run (the clock restarted), so the
    # carry resets were exercised
    assert int(_np(jrun.env_state.t).max()) < iters * cfg.rollout_steps


def test_recurrent_a2c_fused_run_matches_jax():
    """3 recurrent A2C iterations on the fused collect (2v2 with kick and
    placement noise, 128 envs, T=7, episodes of 6 steps): JAX's K5 in
    interpret mode against the port's plain version of K5 on the same
    uniforms table (float32), so K5's output carry becomes the next
    window's BPTT carry on both sides."""
    ref = JEnvParams(players_per_team=2, substeps=2, solver_iterations=3,
                     max_steps=6)
    b, t, n_iters = 128, 7, 3
    cfg_j = ja2c.A2CConfig(rollout_steps=t)
    tx = ja2c.make_optimizer(cfg_j)
    model = JRAC(n_players=2, hidden=HIDDEN, lstm_size=H)
    jrun = ja2c.init_recurrent_runner(jax.random.PRNGKey(2), model, ref, cfg_j,
                                      b, tx)
    collect = functools.partial(ja2c.collect_recurrent_rollout_fused,
                                interpret=True)
    step = jax.jit(lambda r: ja2c.train_iteration_recurrent(
        r, model, ref, cfg_j, tx, collect_fn=collect))
    params = params_from_reference(ref)
    cfg = ta2c.A2CConfig(rollout_steps=t)
    tmodel = recurrent_actor_critic_from_flax(
        jax.tree.map(np.asarray, jrun.params), 2, device="cpu")
    trun = ta2c.RecurrentRunnerState(
        model=tmodel, env_state=_port_state(jrun.env_state),
        obs=torch.from_numpy(np.array(jrun.obs)),
        carry=tuple(torch.from_numpy(np.array(c)) for c in jrun.carry),
        generator=torch.Generator().manual_seed(0),
        optimizer=ta2c.make_optimizer(tmodel, cfg))
    n_draws = n_draws_per_step(params)
    for it in range(n_iters):
        table = _kernel_table(jrun.key, t, n_draws, b)
        jrun, jm = step(jrun)
        trun, tm = ta2c.train_iteration_recurrent(
            trun, params, cfg, collect_fn=functools.partial(
                ta2c.collect_recurrent_rollout_fused, uniforms=table,
                compute_dtype=torch.float32))
        _assert_metrics(tm, jm)
        _assert_model(trun.model, jrun.params, recurrent_actor_critic_from_flax,
                      f"iteration {it}")
        _assert_nu(trun.optimizer, _nu(jrun.opt_state), trun.model,
                   recurrent_actor_critic_from_flax)
        for a, c in zip(trun.carry, jrun.carry):
            assert a.abs().sum() > 0
            np.testing.assert_allclose(a.numpy(), _np(c), **TOL,
                                       err_msg=f"carry, iteration {it}")
        _assert_env(trun, jrun)


def test_feedforward_a2c_run_matches_jax():
    """4 feed-forward A2C iterations (2v2, 16 envs, T=8, hidden (16,)),
    the plain collect on both sides."""
    cfg_j = ja2c.A2CConfig()
    assert cfg_j.rollout_steps == 8
    tx = ja2c.make_optimizer(cfg_j)
    model = JAC(n_players=2, hidden=HIDDEN)
    jrun = jppo.init_runner(jax.random.PRNGKey(1), model, P0, cfg_j, B, tx)
    step = jax.jit(lambda r: ja2c.train_iteration(r, model, P0, cfg_j, tx))
    params = params_from_reference(P0)
    cfg = ta2c.A2CConfig()
    tmodel = actor_critic_from_flax(jax.tree.map(np.asarray, jrun.params), 2,
                                    device="cpu")
    trun = tppo.RunnerState(
        model=tmodel, env_state=_port_state(jrun.env_state),
        obs=torch.from_numpy(np.array(jrun.obs)),
        generator=torch.Generator().manual_seed(0),
        optimizer=ta2c.make_optimizer(tmodel, cfg))
    g = 2 * P0.players_per_team
    for it in range(ITERS):
        u = _uniforms(jrun.key, cfg.rollout_steps, g)
        jrun, jm = step(jrun)
        trun, tm = ta2c.train_iteration(
            trun, params, cfg, collect_fn=functools.partial(
                tppo.collect_rollout, action_uniforms=u))
        _assert_metrics(tm, jm)
        _assert_model(trun.model, jrun.params, actor_critic_from_flax,
                      f"iteration {it}")
        _assert_nu(trun.optimizer, _nu(jrun.opt_state), trun.model,
                   actor_critic_from_flax)
        _assert_env(trun, jrun)
