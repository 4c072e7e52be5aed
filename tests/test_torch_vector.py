"""The port's vectorized env: shapes, determinism per generator seed,
and the exact auto-reset done count (the JAX package's verify recipe:
B envs with max_steps=50 stepped 60 times end exactly B episodes and
leave every clock at 10)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from gym_futbol_tpu_torch import EnvParams, vector  # noqa: E402
from gym_futbol_tpu_torch.env import obs_size  # noqa: E402

# The done count does not depend on the physics; one substep and one
# solver iteration keep the 60 steps short.
FAST = dict(substeps=1, solver_iterations=1)


def test_reset_and_rollout_shapes():
    params = EnvParams(players_per_team=2)
    gen = torch.Generator().manual_seed(0)
    state, obs = vector.reset_batch(gen, params, 16)
    assert obs.shape == (16, obs_size(params)) and obs.dtype == torch.float32
    assert state.pos.shape == (16, params.n_bodies, 2)
    assert state.possession.dtype == torch.int32 and state.score.shape == (16, 2)
    state, out = vector.rollout(state, vector.random_policy(params), gen,
                                params, 4)
    assert out.reward.shape == (4, 16) and out.team_reward.shape == (4, 16, 2)
    assert out.obs.shape == (4, 16, obs_size(params))
    assert out.done.dtype == torch.bool and out.info["goal"].shape == (4, 16, 2)
    assert torch.isfinite(out.reward).all() and torch.isfinite(out.obs).all()
    assert (state.t == 4).all()


def test_determinism_per_generator_seed():
    params = EnvParams(players_per_team=1, **FAST)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        state, _ = vector.reset_batch(gen, params, 8)
        return vector.rollout(state, vector.random_policy(params), gen,
                              params, 5)

    (s1, o1), (s2, o2), (s3, o3) = run(3), run(3), run(4)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(o1.reward, o2.reward)
    assert not torch.equal(s1.pos, s3.pos)


def test_auto_reset_done_count_exact():
    n_envs = 64
    params = EnvParams(players_per_team=2, max_steps=50, **FAST)
    env = vector.VectorFutbolEnv(n_envs, params, seed=1)
    policy = vector.random_policy(params)
    gen = torch.Generator().manual_seed(2)
    obs, dones = env.reset(), 0
    for _ in range(60):
        obs, reward, done, info = env.step(policy(gen, obs))
        dones += int(done.sum())
        assert np.isfinite(reward.numpy()).all()
    assert dones == n_envs
    assert (env.state.t == 10).all()
    assert (env.state.score >= 0).all()


def test_step_before_reset_raises():
    env = vector.VectorFutbolEnv(4, EnvParams())
    with pytest.raises(RuntimeError):
        env.step(torch.zeros((4, 4, 2), dtype=torch.int32))
