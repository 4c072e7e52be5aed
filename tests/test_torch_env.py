"""The port's batched ``env.step(auto_reset=True)`` against the JAX
package's vmapped ``env.step``, in lockstep for 9 steps: each step
starts both from JAX's state, so each comparison is of one step.

The port takes JAX's own draws: the test repeats the key split of
``gym_futbol_tpu/env.py:150`` to form theta = normal(k_kick) *
kick_noise and the kickoff noise uniform(k_kickoff, (n, 2), -1, 1).
States are game-like (bids, kicks, dribbles, goals, clocks running out)
and actions include out-of-range ints. Tolerances: pos/vel rtol 1e-4 /
atol 1e-3, integers exact (the floats differ only in the last bits:
XLA contracts multiply-adds into FMAs, see test_torch_physics.py).
Rewards: the shaping term is a coefficient times a difference of
distances of the field's scale, so one f32 ulp of such a distance moves
it by coefficient * ulp(width); the bound is 4 such ulps (2.4e-5 at
the default params, 9.0e-5 at the custom ones).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu import env as jenv  # noqa: E402
from gym_futbol_tpu.vector import reset_batch as jreset_batch  # noqa: E402
from gym_futbol_tpu_torch import env as tenv  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    params_from_reference,
    state_from_numpy,
)

from _torch_cases import custom_params, game_states, random_actions  # noqa: E402

CUSTOM = custom_params(JEnvParams, JRewardConfig)
B, T = 128, 9


def _jax_draws(keys, ref):
    """theta [B] and kickoff noise [B, n, 2] exactly as env.step draws."""
    def one(k):
        k_kick, k_kickoff, _ = jax.random.split(k, 3)
        theta = jax.random.normal(k_kick, (), jnp.float32) * jnp.asarray(
            ref.kick_noise, jnp.float32)
        noise = jax.random.uniform(k_kickoff, (ref.n_bodies, 2), jnp.float32,
                                   -1.0, 1.0)
        return theta, noise
    theta, noise = jax.vmap(one)(keys)
    return torch.from_numpy(np.array(theta)), torch.from_numpy(np.array(noise))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize(
    "ref",
    [JEnvParams(players_per_team=2, max_steps=8), CUSTOM],
    ids=["default", "custom"],
)
def test_step_matches_jax(ref):
    params = params_from_reference(ref)
    rew_tol = 4 * ref.rewards.ball_to_goal_delta * float(
        np.spacing(np.float32(ref.width)))
    rng = np.random.default_rng(5)
    pos, vel, poss, score, t = game_states(rng, ref, B)
    actions = random_actions(rng, ref, (T, B))

    jstate, _ = jreset_batch(jax.random.PRNGKey(3), ref, B)
    jstate = jstate.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            possession=jnp.asarray(poss),
                            score=jnp.asarray(score), t=jnp.asarray(t))
    jstep = jax.jit(jax.vmap(
        lambda s, a: jenv.step(s, a, ref, auto_reset=True)))

    goals = dones = oob = 0
    for k in range(T):
        theta, noise = _jax_draws(jstate.key, ref)
        tstate = state_from_numpy(jstate.pos, jstate.vel, jstate.possession,
                                  jstate.score, jstate.t)
        jstate, jout = jstep(jstate, jnp.asarray(actions[k]))
        tstate, tout = tenv.step(tstate, torch.from_numpy(actions[k]), theta,
                                 noise, params, auto_reset=True)

        _close(tstate.pos, jstate.pos, rtol=1e-4, atol=1e-3)
        _close(tstate.vel, jstate.vel, rtol=1e-4, atol=1e-3)
        _close(tout.team_reward, jout.team_reward, rtol=1e-5, atol=rew_tol)
        _close(tout.reward, jout.reward, rtol=1e-5, atol=rew_tol)
        _close(tout.obs, jout.obs, rtol=1e-4, atol=1e-5)
        for name, got, want in (
            ("possession", tstate.possession, jstate.possession),
            ("score", tstate.score, jstate.score),
            ("t", tstate.t, jstate.t),
            ("done", tout.done, jout.done),
            *((f"info.{k_}", tout.info[k_], jout.info[k_])
              for k_ in ("score", "possession", "goal", "ball_oob", "t")),
        ):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
        goals += int(np.asarray(jout.info["goal"]).sum())
        dones += int(np.asarray(jout.done).sum())
        oob += int(np.asarray(jout.info["ball_oob"]).sum())
    # the case reached the goal, episode-end and out-of-bounds paths
    assert goals > 0 and dones > 0 and oob > 0


def test_out_of_range_actions_decode_as_jax():
    """Direction 7 / -3 is no direction, act 7 / -3 a plain move: the
    same forces and bids as JAX's where-chains give them."""
    from gym_futbol_tpu import game as jgame
    from gym_futbol_tpu_torch import game as tgame

    ref = JEnvParams(players_per_team=2)
    params = params_from_reference(ref)
    acts = np.array([[7, 7], [-3, 1], [2, -3], [4, 7]], np.int32)
    jf = jgame.decode_forces(jnp.asarray(acts), ref, jnp.float32)
    dirs = [torch.tensor([a[0]]) for a in acts]
    act = [torch.tensor([a[1]]) for a in acts]
    fx, fy = tgame.decode_forces_scalars(dirs, act, params, torch.float32)
    got = np.stack([torch.cat(fx).numpy(), torch.cat(fy).numpy()], -1)
    np.testing.assert_array_equal(got, np.asarray(jf))
    assert (got[1:3] == 0).all() and got[3, 0] == params.move_force
