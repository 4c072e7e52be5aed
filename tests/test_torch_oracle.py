"""The port's float64 physics and env step against the C++ oracle
(``native/oracle.cpp``, driven through ``native/build.py``).

The oracle implements the normative spec sequentially in double; the
JAX package reaches about 1e-13 against it. The port, run eagerly in
float64, is held to 1e-9 in lockstep: each step starts both from the
oracle's state and both consume the same draws (theta, kickoff noise),
made with numpy. The cases reach goals, kicks, possession changes and
auto-resets, and the test asserts that they did.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from gym_futbol_tpu_torch import env as tenv  # noqa: E402
from gym_futbol_tpu_torch.interop import state_from_numpy  # noqa: E402
from gym_futbol_tpu_torch.physics import physics_step  # noqa: E402
from gym_futbol_tpu_torch.types import EnvParams, RewardConfig  # noqa: E402

from _torch_cases import (  # noqa: E402
    custom_params,
    game_states,
    random_bodies,
    random_forces,
)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain for the oracle")
GATE = 1e-9


@pytest.fixture(scope="module")
def oracle():
    from native.build import load_oracle

    return load_oracle()


def striker_actions(pos, possession, params, rng):
    """Random actions, with player 0 of every env playing striker: run
    at the ball, press within reach, carry it forward and shoot."""
    b = pos.shape[0]
    acts = rng.integers(0, 5, (b, params.n_players, 2))
    for e in range(b):
        d = pos[e, 0] - pos[e, 1]
        if abs(d[0]) > abs(d[1]):
            dir_ = 2 if d[0] > 0 else 4
        else:
            dir_ = 1 if d[1] > 0 else 3
        if possession[e] == 1:
            acts[e, 0] = (2, 4 if pos[e, 1, 0] > 0.6 * params.width else 1)
        elif np.hypot(*d) <= params.possession_radius:
            acts[e, 0] = (dir_, 2)
        else:
            acts[e, 0] = (dir_, 1)
    return acts.astype(np.int32)


@pytest.mark.parametrize(
    "params", [EnvParams(), custom_params(EnvParams, RewardConfig)],
    ids=["default", "custom"])
def test_env_step_matches_oracle(oracle, params):
    from native.build import oracle_env_step

    b, n_steps = 16, 30
    rng = np.random.default_rng(21)
    pos, vel, poss, score, t = game_states(rng, params, b)
    pos, vel = pos.astype(np.float64), vel.astype(np.float64)
    worst, goals, dones, kicks, owned = 0.0, 0, 0, 0, 0
    for _ in range(n_steps):
        actions = striker_actions(pos, poss, params, rng)
        theta = rng.normal(size=b) * params.kick_noise
        noise = rng.uniform(-1.0, 1.0, (b, params.n_bodies, 2))
        state = state_from_numpy(pos, vel, poss, score, t, device="cpu")
        tstate, out = tenv.step(state, torch.from_numpy(actions),
                                torch.from_numpy(theta),
                                torch.from_numpy(noise), params,
                                auto_reset=True)
        res = [oracle_env_step(oracle, pos[e], vel[e], poss[e], score[e], t[e],
                               actions[e], theta[e], noise[e], params,
                               auto_reset=True) for e in range(b)]
        opos, ovel = np.stack([r[0] for r in res]), np.stack([r[1] for r in res])
        oposs = np.array([r[2] for r in res], np.int32)
        oscore = np.stack([r[3] for r in res])
        ot = np.array([r[4] for r in res], np.int32)
        orew = np.stack([r[5] for r in res])
        odone = np.array([r[6] for r in res])
        worst = max(worst,
                    np.abs(tstate.pos.numpy() - opos).max(),
                    np.abs(tstate.vel.numpy() - ovel).max(),
                    np.abs(out.team_reward.numpy() - orew).max())
        np.testing.assert_array_equal(tstate.possession.numpy(), oposs)
        np.testing.assert_array_equal(tstate.score.numpy(), oscore)
        np.testing.assert_array_equal(tstate.t.numpy(), ot)
        np.testing.assert_array_equal(out.done.numpy(), odone)
        goals += int(out.info["goal"].sum())
        dones += int(odone.sum())
        kicks += int(((poss > 0) & np.isin(
            actions[np.arange(b), np.clip(poss - 1, 0, None), 1], (3, 4))).sum())
        owned += int((oposs > 0).sum())
        pos, vel, poss, score, t = opos, ovel, oposs, oscore, ot
    assert tstate.pos.dtype == torch.float64
    assert worst < GATE, worst
    assert goals > 0 and dones > 0 and kicks > 0 and owned > 0


@pytest.mark.parametrize("ppt", [1, 2, 5])
def test_physics_step_matches_oracle(oracle, ppt):
    from native.build import oracle_physics_step

    params = EnvParams(players_per_team=ppt)
    rng = np.random.default_rng(ppt)
    pos, vel = (x.astype(np.float64) for x in random_bodies(rng, params, 8))
    forces = random_forces(rng, params, 8).astype(np.float64)
    tpos, tvel = physics_step(torch.from_numpy(pos), torch.from_numpy(vel),
                              torch.from_numpy(forces), params)
    for e in range(8):
        opos, ovel = oracle_physics_step(oracle, pos[e], vel[e], forces[e],
                                         params)
        assert np.abs(tpos[e].numpy() - opos).max() < GATE
        assert np.abs(tvel[e].numpy() - ovel).max() < GATE
