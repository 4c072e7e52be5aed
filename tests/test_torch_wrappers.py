"""The env wrappers (episode statistics, observation and reward
normalisation): the port's against the JAX package's on the CPU, and
the running moments against numpy.

Every input is made with numpy from a seed and handed to both packages.
Bounds, with their reasons:
- the statistics and the normalised values fed identical inputs: rtol
  1e-5 (float32 reductions in another order than XLA's; the merge's own
  operations are the JAX package's, in its order);
- the wrapped steps, both packages stepping the same actions from the
  same state at zero kick and placement noise: observations rtol 1e-4 /
  atol 1e-5 and rewards rtol 1e-5 / atol 1e-5, as
  tests/test_torch_fused_collect.py (XLA contracts multiply-adds into
  FMAs on the CPU, so trajectories part in the last bits); z-scored
  observations and scaled rewards rtol 1e-4 / atol 1e-4 (those last
  bits divided by a standard deviation down to ~0.1 here); the
  statistics rtol 1e-5 / atol 1e-6; integers exact;
- against numpy in float64: rtol 1e-5 for the mean and the variance (the
  prior of count 1e-4, mean 0, variance 1 moves them by ~1e-7 at 640
  samples).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import wrappers as jw  # noqa: E402
from gym_futbol_tpu.vector import reset_batch as jreset_batch  # noqa: E402
from gym_futbol_tpu_torch import wrappers as tw  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    params_from_reference,
    state_from_numpy,
)

P = JEnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
               substeps=2, solver_iterations=4, max_steps=5)
B, STEPS = 32, 7
OBS_TOL = dict(rtol=1e-4, atol=1e-5)
REW_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
NORM_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_running_norm_matches_jax():
    """update, update_moments and normalize over several batches of
    shifted, scaled features (one feature near constant, so inv_std is
    large), then normalize with its ±10 clip reached."""
    rng = np.random.default_rng(0)
    scale = np.array([3.0, 0.5, 1e-3, 10.0, 1.0, 2.0], np.float32)
    batches = [(rng.normal(0.0, 1.0, (64, 6)) * scale + 1.5).astype(np.float32)
               for _ in range(5)]
    jn, tn = jw.RunningNorm.init(6), tw.RunningNorm.init(6, device="cpu")
    for i, x in enumerate(batches):
        if i % 2:
            jn = jn.update(jnp.asarray(x))
            tn = tn.update(_t(x))
        else:
            jn = jn.update_moments(jnp.asarray(x.mean(0)), jnp.asarray(x.var(0)),
                                   jnp.asarray(64.0))
            tn = tn.update_moments(_t(x.mean(0)), _t(x.var(0)),
                                   torch.tensor(64.0))
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(tn, name).numpy(),
                                       _np(getattr(jn, name)), rtol=1e-5,
                                       err_msg=f"batch {i} {name}")
    probe = (rng.normal(0.0, 1.0, (16, 6)) * scale * 30 + 1.5).astype(np.float32)
    got, want = tn.normalize(_t(probe)).numpy(), _np(jn.normalize(jnp.asarray(probe)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (np.abs(got) == 10.0).any()                  # the clip was reached


def test_reward_norm_matches_jax():
    """Several steps of update with dones (the accumulator restarts
    where done), then normalize of both views' rewards."""
    rng = np.random.default_rng(1)
    jn, tn = jw.RewardNorm.init(B), tw.RewardNorm.init(B, device="cpu")
    for step in range(9):
        r = (rng.normal(0.0, 2.0, B) + (step % 3)).astype(np.float32)
        d = rng.random(B) < 0.2
        jn = jn.update(jnp.asarray(r), jnp.asarray(d), 0.97)
        tn = tn.update(_t(r), _t(d), 0.97)
        for name in ("ret", "mean", "var", "count"):
            np.testing.assert_allclose(getattr(tn, name).numpy(),
                                       _np(getattr(jn, name)), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {step} {name}")
        assert (tn.ret.numpy()[d] == 0).all()
        z = rng.normal(0.0, 5.0, (2, B)).astype(np.float32)
        np.testing.assert_allclose(tn.normalize(_t(z)).numpy(),
                                   _np(jn.normalize(jnp.asarray(z))), rtol=1e-5)


def test_moments_match_numpy():
    """RunningNorm over ten batches against numpy's float64 mean and
    population variance of all samples; the batch moments agree with
    update_moments'."""
    rng = np.random.default_rng(2)
    data = (rng.normal(0.0, 1.0, (10, 64, 6)) * 3 + 1.5).astype(np.float32)
    norm = tw.RunningNorm.init(6, device="cpu")
    for x in data:
        norm = norm.update(_t(x))
    flat = data.reshape(-1, 6).astype(np.float64)
    np.testing.assert_allclose(norm.mean.numpy(), flat.mean(0), rtol=1e-5)
    np.testing.assert_allclose(norm.var.numpy(), flat.var(0), rtol=1e-5)
    np.testing.assert_allclose(float(norm.count), 640.0001, rtol=1e-7)
    by_moments = tw.RunningNorm.init(6, device="cpu")
    for x in data:
        xx = x.astype(np.float64)
        by_moments = by_moments.update_moments(
            _t(xx.mean(0).astype(np.float32)), _t(xx.var(0).astype(np.float32)),
            torch.tensor(64.0))
    np.testing.assert_allclose(by_moments.var.numpy(), norm.var.numpy(), rtol=1e-5)


def _states(seed):
    """The same reset batch in both packages (JAX's reset, carried over)."""
    jstate, _ = jreset_batch(jax.random.PRNGKey(seed), P, B)
    tstate = state_from_numpy(*(_np(getattr(jstate, k)) for k in (
        "pos", "vel", "possession", "score", "t")), device="cpu")
    return jstate, tstate


def _actions(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, (STEPS, B, P.n_players, 2)).astype(np.int32)


@pytest.mark.parametrize("kind", ["stats", "obs", "reward"])
def test_wrapped_steps_match_jax(kind):
    """step_with_stats, step_normalized and step_reward_normalized over
    7 steps of the same actions (max_steps 5: every env finishes an
    episode): outputs and wrapper state against JAX's."""
    params = params_from_reference(P)
    jstate, tstate = _states(3)
    acts = _actions(4)
    gen = torch.Generator().manual_seed(0)
    if kind == "stats":
        jx, tx = jw.EpisodeStats.init(B), tw.EpisodeStats.init(B, device="cpu")
    elif kind == "obs":
        jx, tx = jw.RunningNorm.init(4 * P.n_bodies + 2), tw.RunningNorm.init(
            4 * P.n_bodies + 2, device="cpu")
    else:
        jx, tx = jw.RewardNorm.init(B), tw.RewardNorm.init(B, device="cpu")
    for step, a in enumerate(acts):
        if kind == "stats":
            jstate, jx, jout = jw.step_with_stats(jstate, jx, jnp.asarray(a), P)
            tstate, tx, tout = tw.step_with_stats(tstate, tx, _t(a), params, gen)
        elif kind == "obs":
            jstate, jx, jout = jw.step_normalized(jstate, jx, jnp.asarray(a), P)
            tstate, tx, tout = tw.step_normalized(tstate, tx, _t(a), params, gen)
        else:
            jstate, jx, jout = jw.step_reward_normalized(
                jstate, jx, jnp.asarray(a), P, gamma=0.97)
            tstate, tx, tout = tw.step_reward_normalized(
                tstate, tx, _t(a), params, gen, gamma=0.97)
        np.testing.assert_array_equal(tout.done.numpy(), _np(jout.done))
        np.testing.assert_allclose(tout.obs.numpy(), _np(jout.obs),
                                   **(NORM_TOL if kind == "obs" else OBS_TOL),
                                   err_msg=f"step {step} obs")
        rew_tol = NORM_TOL if kind == "reward" else REW_TOL
        np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), **rew_tol)
        np.testing.assert_allclose(tout.team_reward.numpy(),
                                   _np(jout.team_reward), **rew_tol)
        for f in dataclasses.fields(tx):
            got, want = getattr(tx, f.name).numpy(), _np(getattr(jx, f.name))
            if got.dtype.kind == "i":
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                np.testing.assert_allclose(got, want, **STAT_TOL,
                                           err_msg=f"step {step} {f.name}")
    if kind == "stats":
        assert (tx.episodes.numpy() >= 1).all()         # every env finished one
        assert np.abs(tx.last_return.numpy()).max() > 0


def test_step_normalized_without_update():
    """update=False (evaluation) leaves the statistics as they were and
    normalises with them."""
    params = params_from_reference(P)
    _, tstate = _states(5)
    norm = tw.RunningNorm.init(4 * P.n_bodies + 2, device="cpu").update(
        torch.rand(64, 4 * P.n_bodies + 2, generator=torch.Generator().manual_seed(1)))
    a = _t(_actions(6)[0])
    _, same, out = tw.step_normalized(tstate, norm, a, params,
                                      torch.Generator().manual_seed(0), update=False)
    assert same is norm
    _, raw = tw.step_with_stats(tstate, tw.EpisodeStats.init(B, device="cpu"), a,
                                params, torch.Generator().manual_seed(0))[1:]
    torch.testing.assert_close(out.obs, norm.normalize(raw.obs), rtol=0, atol=0)
