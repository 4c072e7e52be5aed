"""Normalised PPO (observation z-scoring and reward scaling through the
collect and the update, on the plain path and through kernels K2 and
K3): the port's plain versions against the JAX package on the CPU.

Every input is made with numpy from a seed and handed to both packages.
JAX's fused collect cannot run here (``pltpu.prng_seed`` does not lower
in interpret mode), so its wrapper is held with its kernel replaced by
the port's outputs, as tests/test_torch_fused_collect.py does; JAX's K3
runs in interpret mode, as tests/test_ops.py runs it. Bounds, with their
reasons:
- the fold and its gradients, fed identical inputs: forward rtol 1e-5 /
  atol 1e-5 (float32 products summed in another order), the unfold of
  JAX's gradients rtol 1e-5 / atol 1e-6 (JAX's own bound for its fold
  against ``jax.grad``), of the port's autograd 1e-5 of each leaf's
  largest entry;
- the post-hoc reward scaling: against the port's in-loop sequence rtol
  1e-6 (the same operations), against JAX's 1e-5 (reductions in another
  order);
- the plain normalised collect against JAX's on JAX's action draws, at
  zero kick and placement noise: z-scored obs and scaled rewards rtol
  1e-4 / atol 1e-4 (the env's last-bit drift from XLA's FMAs, divided by
  a standard deviation), logp and value atol 1e-4 (that drift through
  the MLP), statistics rtol 1e-5, the return accumulator rtol 1e-5 /
  atol 1e-5 (the raw rewards' bound, tests/test_torch_fused_collect.py),
  integers and actions exact;
- the fused collect's wrapper on the port's kernel outputs: raw obs,
  actions and the frozen statistics exact, the merged statistics and
  the scaled rewards rtol 1e-5 (reductions in another order);
- ``update_epochs_fused`` with ``traj.norm`` against JAX's on JAX's
  permutations, float32: parameters and loss rtol 5e-3 / atol 5e-5
  (tests/test_torch_ppo_update.py's bound: Adam divides by the
  gradients' own scale); folded against the buffer pre-z-scored, both in
  the port: rtol 1e-4 / atol 1e-5, the JAX package's own bound for this
  check (tests/test_ops.py).
"""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import ppo as jppo  # noqa: E402
from gym_futbol_tpu import wrappers as jw  # noqa: E402
from gym_futbol_tpu.models import policy as jpolicy  # noqa: E402
from gym_futbol_tpu_torch import ops  # noqa: E402
from gym_futbol_tpu_torch import ppo as tppo  # noqa: E402
from gym_futbol_tpu_torch import wrappers as tw  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    actor_critic_from_flax,
    params_from_reference,
    reward_norm_from_numpy,
    running_norm_from_numpy,
    state_from_numpy,
)
from gym_futbol_tpu_torch.models.policy import ActorCritic  # noqa: E402

jfc = importlib.import_module("gym_futbol_tpu.ops.fused_collect")
tfa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
tfc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")

P = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
               substeps=2, solver_iterations=4, max_steps=6)
F = 4 * P.n_bodies + 2          # 22 obs rows
F_PAD = -(-F // 8) * 8          # 24
B, T = 128, 7
HIDDEN = (32, 16)
NORM_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_stats(seed, n_envs=B):
    """A JAX RunningNorm over F features and a RewardNorm over n_envs
    envs, each after a few updates on numpy data (inv_std far from 1)."""
    rng = np.random.default_rng(seed)
    on = jw.RunningNorm.init(F)
    for _ in range(3):
        x = rng.normal(0.0, 1.0, (64, F)) * rng.uniform(0.05, 4.0, F) + 0.7
        on = on.update(jnp.asarray(x, jnp.float32))
    rn = jw.RewardNorm.init(n_envs)
    for _ in range(4):
        rn = rn.update(jnp.asarray(rng.normal(0.0, 0.3, n_envs), jnp.float32),
                       jnp.asarray(rng.random(n_envs) < 0.2), 0.99)
    return on, rn


def _port_norms(on, rn):
    return (running_norm_from_numpy(_np(on.mean), _np(on.var), _np(on.count),
                                    device="cpu"),
            reward_norm_from_numpy(_np(rn.ret), _np(rn.mean), _np(rn.var),
                                   _np(rn.count), device="cpu"))


def _assert_norm(got, want, tol=None, what="", ret_tol=None):
    """Each statistic of a RunningNorm / RewardNorm against JAX's; the
    return accumulator ``ret`` within ``ret_tol`` when given."""
    for name in ("mean", "var", "count", "ret"):
        if hasattr(got, name):
            t = ret_tol if name == "ret" and ret_tol else (
                tol or dict(rtol=1e-5, atol=1e-7))
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       _np(getattr(want, name)), **t,
                                       err_msg=f"{what}.{name}")


# ---------------------------------------------------------------------------
# The fold, its gradients, the post-hoc reward scaling, interop
# ---------------------------------------------------------------------------


def _flat_case(seed, s=64):
    """Flat kernel-order weights (W [in, out], b [out, 1]), raw obs
    [F, s], and (mean, inv_std) as numpy."""
    rng = np.random.default_rng(seed)
    dims = [F, *HIDDEN]
    shapes = list(zip(dims[:-1], dims[1:])) + [(dims[-1], 20), (dims[-1], 1)]
    w = []
    for a, b in shapes:
        w += [rng.normal(0.0, a ** -0.5, (a, b)).astype(np.float32),
              rng.normal(0.0, 0.1, (b, 1)).astype(np.float32)]
    x = (rng.normal(0.0, 3.0, (F, s)) + 1.0).astype(np.float32)
    mean = rng.normal(0.0, 1.0, F).astype(np.float32)
    var = (np.abs(rng.normal(0.0, 1.0, F)) + 0.1).astype(np.float32)
    inv_std = np.asarray(jax.lax.rsqrt(jnp.asarray(var) + 1e-8))
    return w, x, mean, inv_std


def _jax_mlp(w, x):
    h = x
    for i in range(0, len(w) - 4, 2):
        h = jnp.tanh(w[i].T @ h + w[i + 1])
    return w[-4].T @ h + w[-3], (w[-2].T @ h + w[-1])[0]


def test_fold_forward_matches_jax_and_prenormalized():
    """The folded weights equal JAX's fold of the same weights, and the
    network with them on raw obs equals the original on z-scored obs."""
    w, x, mean, inv_std = _flat_case(0)
    got = tppo.fold_obs_norm(tuple(map(_t, w)), _t(mean), _t(inv_std))
    want = jppo.fold_obs_norm(tuple(map(jnp.asarray, w)), jnp.asarray(mean),
                              jnp.asarray(inv_std))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)
    lf, vf = tfc._forward(_t(x), got)
    lz, vz = tfc._forward(_t((x - mean[:, None]) * inv_std[:, None]),
                          tuple(map(_t, w)))
    np.testing.assert_allclose(lf.numpy(), lz.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vf.numpy(), vz.numpy(), rtol=1e-5, atol=1e-5)
    scales = tppo._obs_norm_scales(tw.RunningNorm(
        mean=_t(mean), var=_t(np.float32(1.0) / inv_std ** 2 - 1e-8),
        count=torch.tensor(1.0)))
    np.testing.assert_allclose(scales[1].numpy(), inv_std, rtol=1e-5)


def test_unfold_grads_match_jax_grad():
    """The gradient at the folded weights of a loss of the raw-obs
    network (jax.grad), chained back by the port's
    unfold_obs_norm_grads, against jax.grad through JAX's fold; and the
    same with the port's autograd at the folded weights, against the
    largest entry of each leaf (its dW1' - mean db1' cancels, so the
    summation order of the two frameworks shows relative to the terms,
    not the result)."""
    w, x, mean, inv_std = _flat_case(1)
    jm, ji, jx = jnp.asarray(mean), jnp.asarray(inv_std), jnp.asarray(x)

    def loss(wj, fold):
        lg, v = _jax_mlp(jppo.fold_obs_norm(wj, jm, ji) if fold else wj, jx)
        return jnp.sum(jnp.sin(lg)) + jnp.sum(v * v)

    want = jax.grad(loss)(tuple(map(jnp.asarray, w)), True)
    at_folded = jax.grad(loss)(jppo.fold_obs_norm(tuple(map(jnp.asarray, w)),
                                                  jm, ji), False)
    got = tppo.unfold_obs_norm_grads(tuple(_t(_np(g)) for g in at_folded),
                                     _t(mean), _t(inv_std))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)

    folded = [t.clone().requires_grad_(True) for t in tppo.fold_obs_norm(
        tuple(map(_t, w)), _t(mean), _t(inv_std))]
    lg, v = tfc._forward(_t(x), tuple(folded))
    (torch.sin(lg).sum() + (v * v).sum()).backward()
    got = tppo.unfold_obs_norm_grads(tuple(p.grad for p in folded), _t(mean),
                                     _t(inv_std))
    for a, b in zip(got, want):
        b = _np(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_posthoc_reward_norm_matches_inloop_and_jax():
    rng = np.random.default_rng(2)
    t, b, gamma = 7, 16, 0.97
    reward = rng.normal(0.0, 1.0, (t, 2 * b)).astype(np.float32)
    done = rng.random((t, 2 * b)) < 0.2
    _, jrn0 = _jax_stats(3, b)
    rn0 = _port_norms(jw.RunningNorm.init(F), jrn0)[1]
    got_rn, got = tppo.posthoc_reward_norm(rn0, _t(reward), _t(done), gamma)
    rn, rows = rn0, []
    for i in range(t):                          # the plain collect's sequence
        rn = rn.update(_t(reward[i, :b]), _t(done[i, :b]), gamma)
        rows.append(torch.cat([rn.normalize(_t(reward[i, :b])),
                               rn.normalize(_t(reward[i, b:]))]))
    np.testing.assert_allclose(got.numpy(), torch.stack(rows).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got_rn.var.numpy(), rn.var.numpy(), rtol=1e-6)
    jrn, jscaled = jppo.posthoc_reward_norm(jrn0, jnp.asarray(reward),
                                            jnp.asarray(done), gamma)
    np.testing.assert_allclose(got.numpy(), _np(jscaled), rtol=1e-5, atol=1e-6)
    _assert_norm(got_rn, jrn, what="rew_norm")


def test_interop_norms():
    """JAX's RunningNorm / RewardNorm fields carried over exactly."""
    on, rn = _jax_stats(4)
    ton, trn = _port_norms(on, rn)
    _assert_norm(ton, on, dict(rtol=0, atol=0), "obs_norm")
    _assert_norm(trn, rn, dict(rtol=0, atol=0), "rew_norm")
    assert ton.count.shape == () and trn.ret.shape == (B,)
    assert all(t.dtype == torch.float32 for t in (ton.mean, trn.ret, trn.count))


@pytest.mark.parametrize("obs,rew", [(True, True), (True, False), (False, True),
                                     (False, False)])
def test_init_runner_flags(obs, rew):
    """Each flag starts its statistics (RunningNorm over the obs
    features, RewardNorm over the envs), as JAX's init_runner does; off,
    the field is None and the normalised collect refuses."""
    params = params_from_reference(P)
    model = ActorCritic(2, F, (8,), device="cpu")
    runner = tppo.init_runner(torch.Generator().manual_seed(0), model, params,
                              tppo.PPOConfig(rollout_steps=2), 16,
                              normalize_obs=obs, normalize_reward=rew)
    jrunner = jppo.init_runner(
        jax.random.PRNGKey(0), jpolicy.ActorCritic(n_players=2, hidden=(8,)), P,
        jppo.PPOConfig(), 16, jppo.make_optimizer(jppo.PPOConfig()),
        normalize_obs=obs, normalize_reward=rew)
    for name, on in (("obs_norm", obs), ("rew_norm", rew)):
        got, want = getattr(runner, name), getattr(jrunner, name)
        assert (got is None) == (not on) == (want is None)
        if on:
            _assert_norm(got, want, dict(rtol=0, atol=0), name)
    if not (obs and rew):
        with pytest.raises(ValueError, match="init_runner"):
            tppo.make_normalized_collect()(runner, params,
                                           tppo.PPOConfig(rollout_steps=2))


# ---------------------------------------------------------------------------
# The collects
# ---------------------------------------------------------------------------


def _jax_runner(seed, obs=True, rew=True):
    model = jpolicy.ActorCritic(n_players=P.players_per_team, hidden=HIDDEN)
    cfg = jppo.PPOConfig(rollout_steps=T)
    runner = jppo.init_runner(jax.random.PRNGKey(seed), model, P, cfg, n_envs=B,
                              tx=jppo.make_optimizer(cfg), normalize_obs=obs,
                              normalize_reward=rew)
    on, rn = _jax_stats(seed)
    return model, cfg, runner.replace(obs_norm=on if obs else None,
                                      rew_norm=rn if rew else None)


def _port_runner(runner):
    params = params_from_reference(P)
    st = runner.env_state
    on, rn = _port_norms(*(runner.obs_norm or jw.RunningNorm.init(F),
                           runner.rew_norm or jw.RewardNorm.init(B)))
    return params, tppo.RunnerState(
        model=actor_critic_from_flax(jax.tree.map(np.asarray, runner.params),
                                     P.players_per_team, device="cpu"),
        env_state=state_from_numpy(st.pos, st.vel, st.possession, st.score, st.t,
                                   device="cpu"),
        obs=_t(runner.obs), generator=torch.Generator().manual_seed(0),
        obs_norm=on if runner.obs_norm is not None else None,
        rew_norm=rn if runner.rew_norm is not None else None)


@pytest.mark.parametrize("obs,rew", [(True, True), (True, False), (False, True)],
                         ids=["both", "obs", "reward"])
def test_normalized_collect_matches_jax(obs, rew):
    """make_normalized_collect against JAX's on JAX's own action draws
    (its key splits): the stored z-scored obs and scaled rewards, the
    actions, logp, value, bootstrap value and the statistics after T
    steps."""
    model, cfg, runner = _jax_runner(5, obs, rew)
    key, draws = runner.key, []
    for _ in range(T):                    # make_normalized_collect's splits
        key, k_act = jax.random.split(key)
        draws.append(_np(jax.random.uniform(k_act, (2 * P.players_per_team, 2 * B),
                                            jnp.float32)))
    jrun2, jtraj, jlast = jppo.make_normalized_collect(obs, rew)(runner, model,
                                                                  P, cfg)
    params, trunner = _port_runner(runner)
    trun2, ttraj, tlast = tppo.make_normalized_collect(obs, rew)(
        trunner, params, tppo.PPOConfig(rollout_steps=T),
        action_uniforms=_t(np.stack(draws)))
    np.testing.assert_allclose(ttraj.obs.numpy(), _np(jtraj.obs), **NORM_TOL)
    for name in ("dirs", "acts", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      _np(getattr(jtraj, name)), err_msg=name)
    np.testing.assert_allclose(ttraj.reward.numpy(), _np(jtraj.reward), **NORM_TOL)
    for got, want in ((ttraj.logp, jtraj.logp), (ttraj.value, jtraj.value),
                      (tlast, jlast)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    assert ttraj.norm is None and bool(ttraj.done.any())
    for name, on in (("obs_norm", obs), ("rew_norm", rew)):
        if on:    # the return accumulator sums raw rewards: their bound
            _assert_norm(getattr(trun2, name), getattr(jrun2, name), what=name,
                         ret_tol=dict(rtol=1e-5, atol=1e-5))
        else:
            assert getattr(trun2, name) is getattr(trunner, name)
    if obs:       # the stored obs are z-scored, not raw
        assert not np.allclose(ttraj.obs.numpy(), tppo.collect_rollout(
            trunner, params, tppo.PPOConfig(rollout_steps=T),
            action_uniforms=_t(np.stack(draws)))[1].obs.numpy(), atol=1e-2)


def test_collect_fused_normalized_matches_jax_wrapper(monkeypatch):
    """collect_rollout_fused(normalize_obs=True, normalize_reward=True)
    against JAX's wrapper, its kernel replaced by the port's outputs (the
    plain version's on the weights the port folded): the folded weights
    each hands its kernel, traj.norm (the lagged statistics), the raw
    buffer, the merged obs statistics (pad rows excluded) and the scaled
    rewards."""
    model, cfg, runner = _jax_runner(6)
    params, trunner = _port_runner(runner)
    rng = np.random.default_rng(7)
    table = _t(rng.random((T, tfa.n_draws_per_step(params), B), dtype=np.float32))
    seen = {}
    real = tfc.fused_collect

    def recording(sf, si, w, seed, env_params, n_steps, uniforms=None,
                  compute_dtype=torch.bfloat16):
        seen["w"] = w
        seen["out"] = real(sf, si, w, seed, env_params, n_steps,
                           uniforms=uniforms, compute_dtype=compute_dtype)
        return seen["out"]

    monkeypatch.setattr(tfc, "fused_collect", recording)
    trun2, ttraj, tlast = tppo.make_fused_normalized_collect()(
        trunner, params, tppo.PPOConfig(rollout_steps=T), uniforms=table,
        compute_dtype=torch.float32)

    def tiles(x):
        return jnp.asarray(x.numpy().reshape(*x.shape[:-1], B // 128, 128))

    def fake_kernel(sf_, si_, w_, seed_, env_params, n_steps, block=None,
                    interpret=False):
        seen["jw"] = w_
        return tuple(tiles(x) for x in seen["out"])

    monkeypatch.setattr(jfc, "fused_collect", fake_kernel)
    jrun2, jtraj, jlast = jppo.make_fused_normalized_collect()(runner, model, P,
                                                                cfg)
    for a, b in zip(seen["w"], seen["jw"]):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)
    assert not np.allclose(seen["w"][0].numpy(),
                           tfc.flatten_actor_critic(trunner.model)[0].numpy())
    _assert_norm(ttraj.norm, jtraj.norm, dict(rtol=0, atol=0), "traj.norm")
    assert ttraj.norm is trunner.obs_norm
    for name in ("obs", "dirs", "acts", "logp", "value", "done"):
        np.testing.assert_array_equal(getattr(ttraj, name).numpy(),
                                      _np(getattr(jtraj, name)), err_msg=name)
    np.testing.assert_allclose(ttraj.reward.numpy(), _np(jtraj.reward),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tlast.numpy(), _np(jlast))
    _assert_norm(trun2.obs_norm, jrun2.obs_norm, what="obs_norm")
    _assert_norm(trun2.rew_norm, jrun2.rew_norm, what="rew_norm")
    assert trun2.obs_norm.mean.shape == (F,)
    # the merged moments are those of the real rows alone
    rows = ttraj.obs[:F].double()
    want = tw.RunningNorm(*(x.double() for x in (
        trunner.obs_norm.mean, trunner.obs_norm.var, trunner.obs_norm.count)))
    want = want.update_moments(rows.mean(1), rows.var(1, correction=0),
                               torch.tensor(float(rows.shape[1]), dtype=torch.float64))
    np.testing.assert_allclose(trun2.obs_norm.var.numpy(), want.var.numpy(),
                               rtol=1e-5)


def test_plain_fused_collect_carries_no_norm():
    """Without the flags the fused collect hands K2 the weights as they
    are and leaves the runner's statistics alone."""
    _, _, runner = _jax_runner(8)
    params, trunner = _port_runner(runner)
    trun2, ttraj, _ = tppo.collect_rollout_fused(
        trunner, params, tppo.PPOConfig(rollout_steps=2),
        compute_dtype=torch.float32)
    assert ttraj.norm is None
    assert trun2.obs_norm is trunner.obs_norm and trun2.rew_norm is trunner.rew_norm


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------


def _packed(rng, shape):
    a = rng.integers(0, 5, (2, *shape))
    return (a[0] | (a[1] << 3)).astype(np.int32)


def _update_case(seed=9, t=2, b2=256):
    """A [t, b2] trajectory with a RAW feature-major obs buffer (zero pad
    rows), the JAX statistics it was collected through, and hidden (16,)
    weights."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((F_PAD, t * b2), np.float32)
    obs[:F] = rng.normal(0.0, 2.0, (F, t * b2)) + 1.0
    traj = dict(
        obs=obs, dirs=_packed(rng, (t, b2)), acts=_packed(rng, (t, b2)),
        logp=-np.abs(rng.normal(0.0, 1.0, (t, b2))).astype(np.float32) * 4,
        value=rng.normal(0.0, 1.0, (t, b2)).astype(np.float32),
        reward=rng.normal(0.0, 1.0, (t, b2)).astype(np.float32),
        done=rng.random((t, b2)) < 0.1,
    )
    dims = [F, 16]
    shapes = list(zip(dims[:-1], dims[1:])) + [(16, 20), (16, 1)]
    variables = {"params": {f"Dense_{i}": {
        "kernel": rng.normal(0.0, a ** -0.5, (a, b)).astype(np.float32),
        "bias": rng.normal(0.0, 0.1, (b,)).astype(np.float32)}
        for i, (a, b) in enumerate(shapes)}}
    return variables, traj, _jax_stats(seed)[0]


def _layers_close(model, other, **tol):
    for a, b in zip(model.dense_layers(), other):
        np.testing.assert_allclose(a.weight.detach().numpy(), b[0], **tol)
        np.testing.assert_allclose(a.bias.detach().numpy(), b[1], **tol)


def test_update_epochs_fused_norm_matches_jax():
    """update_epochs_fused on a trajectory with traj.norm (float32, the
    fold before each K3 launch and the unfold after it) against JAX's in
    interpret mode, fed JAX's block permutations."""
    variables, traj, jnorm = _update_case()
    block = 128
    jcfg = jppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2,
                          shuffle_block=block, remat=False)
    tcfg = tppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2,
                          shuffle_block=block)
    key = jax.random.PRNGKey(12)
    n_blocks = traj["reward"].size // block
    perms = torch.from_numpy(np.stack([
        _np(jax.random.permutation(k, n_blocks))
        for k in jax.random.split(key, jcfg.epochs)]).astype(np.int64))
    jmodel = jpolicy.ActorCritic(n_players=2, hidden=(16,))
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in traj.items()},
                            norm=jnorm)
    jadv, jret = jppo.compute_gae(jtraj, jnp.zeros(256), jcfg)
    tx = jppo.make_optimizer(jcfg)
    params = jax.tree.map(jnp.asarray, variables)
    jparams, _, jm = jppo.update_epochs_fused(
        params, tx.init(params), jtraj, jadv, jret, key, jmodel, tx, jcfg,
        interpret=True, compute_dtype=jnp.float32)

    ttraj = tppo.Transition(**{k: _t(v) for k, v in traj.items()},
                            norm=_port_norms(jnorm, jw.RewardNorm.init(1))[0])
    tadv, tret = tppo.compute_gae(ttraj, torch.zeros(256), tcfg)
    model = actor_critic_from_flax(variables, 2, device="cpu")
    m = tppo.update_epochs_fused(model, tppo.make_optimizer(model, tcfg), ttraj,
                                 tadv, tret, torch.Generator(), tcfg, perms=perms,
                                 compute_dtype=torch.float32)
    dense = jparams["params"]
    _layers_close(model, [(_np(dense[f"Dense_{i}"]["kernel"]).T,
                           _np(dense[f"Dense_{i}"]["bias"])) for i in range(3)],
                  rtol=5e-3, atol=5e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=5e-3,
                               atol=5e-5)


@pytest.mark.parametrize("mode", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_update_epochs_fused_folded_matches_prenormalized(mode):
    """The raw buffer with traj.norm trains as the same buffer z-scored
    by those statistics with no norm (tests/test_ops.py:542's check), in
    float32 at the JAX package's bound; in bfloat16 the two round
    different operands (the folded weights and raw obs, or the weights
    and z-scores), so only the direction of training is compared there:
    every leaf's update rel-L2 within 0.1 of the float32 one."""
    variables, traj, jnorm = _update_case(10)
    cfg = tppo.PPOConfig(rollout_steps=2, epochs=2, minibatches=2,
                         shuffle_block=128)
    norm = _port_norms(jnorm, jw.RewardNorm.init(1))[0]
    mean, inv_std = tppo._obs_norm_scales(norm)
    z = traj["obs"].copy()
    z[:F] = ((_t(traj["obs"][:F]) - mean[:, None]) * inv_std[:, None]).numpy()
    perms = torch.tensor([[3, 0, 2, 1], [1, 2, 0, 3]])
    out = {}
    for name, obs, nrm, dtype in (("folded", traj["obs"], norm, mode),
                                  ("pre", z, None, mode),
                                  ("f32", traj["obs"], norm, torch.float32)):
        ttraj = tppo.Transition(**{**{k: _t(v) for k, v in traj.items()},
                                   "obs": _t(obs)}, norm=nrm)
        adv, ret = tppo.compute_gae(ttraj, torch.zeros(256), cfg)
        model = actor_critic_from_flax(variables, 2, device="cpu")
        m = tppo.update_epochs_fused(model, tppo.make_optimizer(model, cfg), ttraj,
                                     adv, ret, torch.Generator(), cfg, perms=perms,
                                     compute_dtype=dtype)
        out[name] = ([(a.weight.detach().numpy(), a.bias.detach().numpy())
                      for a in model.dense_layers()], float(m["loss"]))
    if mode is torch.float32:
        for (wa, ba), (wb, bb) in zip(out["folded"][0], out["pre"][0]):
            np.testing.assert_allclose(wa, wb, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(ba, bb, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["folded"][1], out["pre"][1], rtol=1e-4,
                                   atol=1e-6)
        return
    start = [(np.asarray(variables["params"][f"Dense_{i}"]["kernel"]).T,
              np.asarray(variables["params"][f"Dense_{i}"]["bias"]))
             for i in range(3)]
    for name in ("folded", "pre"):
        for (w0, _), (w, _), (wf, _) in zip(start, out[name][0], out["f32"][0]):
            step, ref = w - w0, wf - w0
            assert np.linalg.norm(step - ref) <= 0.1 * np.linalg.norm(ref), name


def test_update_epochs_refuses_normalized_traj():
    """update_epochs would train a normalised fused trajectory's raw obs
    without the fold: it refuses and names update_epochs_fused."""
    variables, traj, jnorm = _update_case(11)
    ttraj = tppo.Transition(**{k: _t(v) for k, v in traj.items()},
                            norm=_port_norms(jnorm, jw.RewardNorm.init(1))[0])
    model = actor_critic_from_flax(variables, 2, device="cpu")
    cfg = tppo.PPOConfig(rollout_steps=2, epochs=1, minibatches=2,
                         shuffle_block=128)
    adv = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="update_epochs_fused"):
        tppo.update_epochs(model, tppo.make_optimizer(model, cfg), ttraj, adv, adv,
                           torch.Generator(), cfg)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_normalized_train_iteration_cpu(fused):
    """Two normalised iterations at 2v2, 256 envs, T=4 with either pair
    of collect and update: finite metrics, parameters and statistics
    moved, the obs statistics counting every sample of both views, no
    kernel launched."""
    params = params_from_reference(P)
    model = ActorCritic(2, F, (16,), device="cpu")
    cfg = tppo.PPOConfig(rollout_steps=4, shuffle_block=128)
    runner = tppo.init_runner(torch.Generator().manual_seed(0), model, params, cfg,
                              256, normalize_obs=True, normalize_reward=True)
    kw = (dict(collect_fn=tppo.make_fused_normalized_collect(),
               update_fn=tppo.update_epochs_fused) if fused else
          dict(collect_fn=tppo.make_normalized_collect()))
    before = [p.detach().clone() for p in model.parameters()]
    ops.reset_launch_counts()
    for _ in range(2):
        runner, metrics = tppo.train_iteration(runner, params, cfg, **kw)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    np.testing.assert_allclose(float(runner.obs_norm.count),
                               2 * 2 * 4 * 256 + 1e-4, rtol=1e-6)
    np.testing.assert_allclose(float(runner.rew_norm.count), 2 * 4 * 256 + 1e-4,
                               rtol=1e-6)
    assert (runner.obs_norm.var.numpy() != 1.0).all()
    assert sum(ops.LAUNCHES.values()) == 0
