"""The recurrent collect (kernel K5 ``fused_recurrent_collect``): the
port's plain version against JAX's K5 itself on the CPU, the collectors'
layouts against JAX's, and the wrapper's CPU path and checks.

JAX's K5 runs in interpret mode (``interpret=True``), where it draws
from the table ``jax.random.uniform(PRNGKey(seed), (T, n_draws, nb,
128))`` instead of the TPU's bits; the port's plain version is fed that
same table, reshaped to ``[T, n_draws, B]``, from game-like states and
non-zero initial carries, with ``max_steps`` small enough that episodes
end (and carries reset) inside the window.

Tolerances, with their reasons: integers, dones and sampled actions
exact; obs rtol 1e-4 / atol 1e-5, states pos/vel rtol 1e-4 / atol 1e-3,
logp, value, bootstrap values and the carries atol 1e-5
(tests/test_torch_fused_collect.py's bounds: XLA contracts multiply-adds
into FMAs on the CPU, so the trajectories part in the last bits, and
the cell sums its two products apart where the port sums one stacked
column); rewards rtol 1e-5 / atol 1e-4, as that file's self-play test
from contact-heavy states (4.6e-5 measured at the custom params). The
plain per-step collector against JAX's, at zero kick and placement
noise so that only the action draws (rebuilt from JAX's key splits)
matter: the same bounds.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu import a2c as ja2c  # noqa: E402
from gym_futbol_tpu.models.recurrent import RecurrentActorCritic as JRAC  # noqa: E402
from gym_futbol_tpu.models.recurrent import init_recurrent_params  # noqa: E402
from gym_futbol_tpu.ops import pack_state as jpack_state  # noqa: E402
from gym_futbol_tpu.vector import reset_batch as jreset_batch  # noqa: E402
from gym_futbol_tpu_torch import a2c as ta2c  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    params_from_reference,
    recurrent_actor_critic_from_flax,
    state_from_numpy,
)
from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic  # noqa: E402
from gym_futbol_tpu_torch.ops import _build  # noqa: E402

from _torch_cases import custom_params, game_states  # noqa: E402

jfr = importlib.import_module("gym_futbol_tpu.ops.fused_recurrent")
tfr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")
tpol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")

P = JEnvParams(players_per_team=2, substeps=2, solver_iterations=3, max_steps=6)
P0 = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
                substeps=2, solver_iterations=4, max_steps=6)
CUSTOM = custom_params(JEnvParams, JRewardConfig)
B, T, H = 128, 9, 16
HIDDEN = (32,)
POS_TOL = dict(rtol=1e-4, atol=1e-3)
OBS_TOL = dict(rtol=1e-4, atol=1e-5)
REW_TOL = dict(rtol=1e-5, atol=1e-4)
NAMES = ("statef", "statei", "obs", "dirs", "acts", "logp", "value", "reward",
         "done", "last_value", "carry_c", "carry_h")
TOLS = dict(statef=POS_TOL, obs=OBS_TOL, reward=REW_TOL)


def _np(x):
    return np.asarray(x)


def _flax(ref, seed=0):
    model = JRAC(n_players=ref.players_per_team, hidden=HIDDEN, lstm_size=H)
    variables = init_recurrent_params(jax.random.PRNGKey(seed), model, ref)
    return model, variables


def _port_model(variables, ref):
    return recurrent_actor_critic_from_flax(jax.tree.map(np.asarray, variables),
                                            ref.players_per_team, device="cpu")


def _assert_outputs(got, want):
    """Port outputs against JAX's (reshaped to the port's shapes)."""
    for name, g, w in zip(NAMES, got, want):
        g, w = g.numpy(), _np(w).reshape(g.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, **TOLS.get(name, dict(atol=1e-5)),
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# The plain version against JAX's kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ref", [P, CUSTOM], ids=["2v2", "custom"])
def test_reference_matches_jax_kernel(ref):
    """fused_recurrent_collect_reference on JAX's own uniform table
    against JAX's K5 in interpret mode, from game-like states (goals,
    episode ends) and non-zero initial carries."""
    params = params_from_reference(ref)
    model, variables = _flax(ref)
    rng = np.random.default_rng(1)
    pos, vel, poss, score, t = game_states(rng, ref, B)
    jstate, _ = jreset_batch(jax.random.PRNGKey(2), ref, B)
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            possession=jnp.asarray(poss),
                            score=jnp.asarray(score), t=jnp.asarray(t))
    cc, hh = (rng.normal(0.0, 0.5, (2, H, B)).astype(np.float32)
              for _ in range(2))
    seed = 7
    want = jfr.fused_recurrent_collect(
        *jpack_state(jstate, ref), jfr.flatten_recurrent_actor_critic(variables, model),
        jnp.asarray(cc.reshape(2, H, 1, 128)), jnp.asarray(hh.reshape(2, H, 1, 128)),
        jnp.asarray([seed], jnp.int32), ref, T, hidden=HIDDEN, lstm_size=H,
        block=B, interpret=True)
    n_draws = tfr.n_draws_per_step(params)
    assert n_draws == jfr.n_draws_per_step(ref)
    table = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (T, n_draws, 1, 128), jnp.float32)).reshape(
            T, n_draws, B))
    sf, si = ops.pack_state(state_from_numpy(pos, vel, poss, score, t,
                                             device="cpu"), params)
    got = tfr.fused_recurrent_collect_reference(
        sf, si, tfr.flatten_recurrent_actor_critic(_port_model(variables, ref)),
        torch.from_numpy(cc), torch.from_numpy(hh), params, uniforms=table,
        compute_dtype=torch.float32)
    _assert_outputs(got, want)
    done = got[8].numpy()
    assert done.any() and len(np.unique(got[3].numpy())) > 4
    # the reset reached the carries: an env done at the last step carries 0
    last_done = done[-1, 0].astype(bool)
    assert last_done.any() and (got[10][:, :, last_done] == 0).all()


def test_flatten_matches_jax():
    """The kernel-order tuple from the port's module equals JAX's from
    the flax variables it was loaded from."""
    model, variables = _flax(P, seed=3)
    want = jfr.flatten_recurrent_actor_critic(variables, model)
    got = tfr.flatten_recurrent_actor_critic(_port_model(variables, P))
    assert len(got) == len(want) == 2 * len(HIDDEN) + 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


# ---------------------------------------------------------------------------
# The collectors against JAX's
# ---------------------------------------------------------------------------


def _runners(ref, seed, carry_seed=None):
    """JAX's recurrent runner (non-zero carries when ``carry_seed``) and
    the port's with the same weights, state, obs and carries."""
    model = JRAC(n_players=ref.players_per_team, hidden=HIDDEN, lstm_size=H)
    cfg = ja2c.A2CConfig(rollout_steps=T)
    jrun = ja2c.init_recurrent_runner(jax.random.PRNGKey(seed), model, ref, cfg,
                                      B, ja2c.make_optimizer(cfg))
    if carry_seed is not None:
        rng = np.random.default_rng(carry_seed)
        jrun = jrun.replace(carry=tuple(
            jnp.asarray(rng.normal(0.0, 0.5, (2, B, H)).astype(np.float32))
            for _ in range(2)))
    params = params_from_reference(ref)
    st = jrun.env_state
    trun = ta2c.RecurrentRunnerState(
        model=_port_model(jrun.params, ref),
        env_state=state_from_numpy(st.pos, st.vel, st.possession, st.score, st.t,
                                   device="cpu"),
        obs=torch.from_numpy(np.array(jrun.obs)),
        carry=tuple(torch.from_numpy(np.array(c)) for c in jrun.carry),
        generator=torch.Generator().manual_seed(0))
    return model, cfg, jrun, params, trun


def test_collect_recurrent_rollout_matches_jax():
    """The plain per-step collector against JAX's
    collect_recurrent_rollout with its own action draws, at zero noise."""
    model, cfg, jrun, params, trun = _runners(P0, 3, carry_seed=4)
    g = 2 * P0.players_per_team
    key, draws = jrun.key, []
    for _ in range(T):                        # a2c.py's per-step splits
        key, k_act = jax.random.split(key)
        draws.append(_np(jax.random.uniform(k_act, (g, 2 * B), jnp.float32)))
    jrun2, jtraj, jlast = ja2c.collect_recurrent_rollout(jrun, model, P0, cfg)
    trun2, ttraj, tlast = ta2c.collect_recurrent_rollout(
        trun, params, cfg, action_uniforms=torch.from_numpy(np.stack(draws)))
    np.testing.assert_allclose(ttraj.obs.numpy(), _np(jtraj.obs), **OBS_TOL)
    for name in ("dirs", "acts", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      _np(getattr(jtraj, name)), err_msg=name)
    for name in ("logp", "value"):
        np.testing.assert_allclose(getattr(ttraj, name).numpy(),
                                   _np(getattr(jtraj, name)), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ttraj.reward.numpy(), _np(jtraj.reward), **REW_TOL)
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), atol=1e-5)
    for a, b in zip(trun2.carry, jrun2.carry):
        assert a.shape == (2, B, H)
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    np.testing.assert_allclose(trun2.obs.numpy(), _np(jrun2.obs), **OBS_TOL)
    assert jtraj.done.any()


def test_collect_fused_layout_matches_jax_wrapper(monkeypatch):
    """collect_recurrent_rollout_fused's layouts (obs to [T, 2B, F], the
    [T, 2B] fields, the carries [2, B, H] <-> [2, H, B], the bootstrap
    values) against JAX's wrapper, its kernel replaced by the port's
    outputs in JAX's tile layout."""
    model, cfg, jrun, params, trun = _runners(P, 4, carry_seed=5)
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.random((T, tfr.n_draws_per_step(params), B),
                                        dtype=np.float32))
    sf, si = ops.pack_state(trun.env_state, params)
    cc, hh = (c.transpose(1, 2).contiguous() for c in trun.carry)
    outs = tfr.fused_recurrent_collect_reference(
        sf, si, tfr.flatten_recurrent_actor_critic(trun.model), cc, hh, params,
        uniforms=table)

    def fake_kernel(sf_, si_, w_, cc_, hh_, seed_, env_params, n_steps, hidden,
                    lstm_size, block=None, interpret=False):
        assert n_steps == T and lstm_size == H
        np.testing.assert_array_equal(_np(cc_).reshape(2, H, B), cc.numpy())
        np.testing.assert_array_equal(_np(hh_).reshape(2, H, B), hh.numpy())
        return tuple(jnp.asarray(x.numpy().reshape(*x.shape[:-1], B // 128, 128))
                     for x in outs)

    monkeypatch.setattr(jfr, "fused_recurrent_collect", fake_kernel)
    jrun2, jtraj, jlast = ja2c.collect_recurrent_rollout_fused(jrun, model, P, cfg)
    trun2, ttraj, tlast = ta2c.collect_recurrent_rollout_fused(
        trun, params, cfg, uniforms=table)
    for name in ("obs", "dirs", "acts", "logp", "value", "reward", "done"):
        got, want = getattr(ttraj, name), _np(getattr(jtraj, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(tlast.numpy(), _np(jlast))
    for a, b in zip(trun2.carry, jrun2.carry):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(trun2.obs.numpy(), _np(jrun2.obs))
    np.testing.assert_array_equal(trun2.env_state.pos.numpy(),
                                  _np(jrun2.env_state.pos))


# ---------------------------------------------------------------------------
# The wrapper's CPU path and checks
# ---------------------------------------------------------------------------


def _port_setup(ppt=2, n_envs=B, hidden=HIDDEN, lstm=H, seed=0):
    params = params_from_reference(P.replace(players_per_team=ppt))
    gen = torch.Generator().manual_seed(seed)
    model = RecurrentActorCritic(ppt, 4 * params.n_bodies + 2, hidden, lstm,
                                 device="cpu")
    cfg = ta2c.A2CConfig(rollout_steps=4)
    runner = ta2c.init_recurrent_runner(gen, model, params, cfg, n_envs)
    sf, si = ops.pack_state(runner.env_state, params)
    carries = [torch.randn(2, lstm, n_envs, generator=gen) for _ in range(2)]
    return params, cfg, runner, sf, si, carries


def test_empty_torso_raises():
    """The JAX kernel feeds tanh(obs) to the cell when the torso is empty
    (ROADMAP, faults found); the port refuses the case."""
    params, cfg, runner, sf, si, (cc, hh) = _port_setup(hidden=())
    w = tfr.flatten_recurrent_actor_critic(runner.model)
    with pytest.raises(ValueError, match="torso"):
        ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, 2)
    with pytest.raises(ValueError, match="torso"):
        ta2c.collect_recurrent_rollout_fused(runner, params, cfg)


def test_input_carries_unchanged_and_cpu_path_never_builds(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no nvcc, no
    launch counted, the seed determines the draws, and the input carries
    come back unchanged (the update needs them)."""
    def refuse():
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launch_counts()
    params, cfg, runner, sf, si, (cc, hh) = _port_setup(n_envs=32)
    w = tfr.flatten_recurrent_actor_critic(runner.model)
    before = (cc.clone(), hh.clone())
    c1 = ops.fused_recurrent_collect(sf, si, w, cc, hh, 3, params, 3)
    c2 = ops.fused_recurrent_collect(sf, si, w, cc, hh, 3, params, 3)
    c3 = ops.fused_recurrent_collect(sf, si, w, cc, hh, 4, params, 3)
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    assert not torch.equal(c1[3], c3[3])
    assert torch.equal(cc, before[0]) and torch.equal(hh, before[1])
    assert not torch.equal(c1[10], cc) and c1[10].data_ptr() != cc.data_ptr()
    carry = tuple(c.clone() for c in runner.carry)
    runner2, traj, _ = ta2c.collect_recurrent_rollout_fused(runner, params, cfg)
    assert all(torch.equal(a, b) for a, b in zip(runner.carry, carry))
    assert traj.obs.shape == (4, 64, 4 * params.n_bodies + 2)
    assert ops.LAUNCHES["fused_recurrent_collect"] == 0
    assert sum(ops.LAUNCHES.values()) == 0


def test_philox_sampling_statistics():
    """The plain version's Philox draws sample each group's softmax: per
    group and choice, the empirical frequency is within 5 standard
    errors of the mean probability, the logits recomputed by replaying
    the module over the collect's own obs from its initial carries."""
    params, cfg, runner, sf, si, (cc, hh) = _port_setup(n_envs=512, hidden=(16,),
                                                        lstm=8)
    model = runner.model
    with torch.no_grad():                     # make the choices uneven
        model.logits.weight.mul_(8.0)
    w = tfr.flatten_recurrent_actor_critic(model)
    out = ops.fused_recurrent_collect(sf, si, w, cc, hh, 21, params, 4)
    obs, dirs, acts, done = out[2], out[3], out[4], out[8]
    f = 4 * params.n_bodies + 2
    x = obs[:, :f].permute(2, 0, 3, 1).reshape(4, -1, f)       # [T, 2B, F]
    carry = tuple(c.transpose(1, 2).reshape(-1, 8) for c in (cc, hh))
    with torch.no_grad():
        _, (logits, _) = model.unroll(carry, x, done.reshape(4, -1).bool())
    probs = torch.softmax(logits.reshape(-1, 4, 5).double(), -1)
    packed = (dirs.reshape(-1), acts.reshape(-1))
    for gi in range(4):
        a = (packed[gi % 2] >> (3 * (gi // 2))) & 7
        onehot = torch.nn.functional.one_hot(a.long(), 5).double()
        p = probs[:, gi]
        se = (p * (1 - p)).sum(0).sqrt() / p.shape[0]
        diff = (onehot.mean(0) - p.mean(0)).abs()
        assert (diff <= 5 * se).all(), (gi, diff, se)


def test_wrapper_validates_inputs():
    params, cfg, runner, sf, si, (cc, hh) = _port_setup(n_envs=16)
    w = tfr.flatten_recurrent_actor_critic(runner.model)
    with pytest.raises(ValueError):          # carries of the wrong size
        ops.fused_recurrent_collect(sf, si, w, cc[:, :8], hh, 0, params, 2)
    with pytest.raises(ValueError):          # the cell's Wh of the wrong size
        ops.fused_recurrent_collect(sf, si, (*w[:3], w[3][:8], *w[4:]), cc, hh,
                                    0, params, 2)
    with pytest.raises(ValueError):          # uniforms of the wrong shape
        ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, 2,
                                    uniforms=torch.zeros(2, 3, 16))
    with pytest.raises(ValueError):          # no steps
        ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, 0)
    with pytest.raises(TypeError):
        ops.fused_recurrent_collect(sf, si, tuple(t.double() for t in w), cc, hh,
                                    0, params, 2)
    # the kernel's unit-major cell columns: column 4u + g is gate g of unit u
    perm = tpol.unit_major(torch.arange(12))
    assert perm.tolist() == [0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11]
