"""The port's types and the CUDA kernel's constants against the JAX
package's.

Kernel constants are f32 values formed on the host; each must equal,
bit for bit, the value the JAX step forms from the same ``EnvParams``
(``gym_futbol_tpu/physics.py`` and ``game.py``), so that a constant
formed another way (in double where JAX uses f32, or baked in) fails
here on the CPU.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import types as jtypes  # noqa: E402
from gym_futbol_tpu_torch import types as ttypes  # noqa: E402
from gym_futbol_tpu_torch.interop import (  # noqa: E402
    params_from_reference,
    state_from_numpy,
)
from gym_futbol_tpu_torch.ops.fused_rollout import (  # noqa: E402
    KERNEL_CONSTANT_NAMES,
    kernel_constants,
)

CUSTOM = jtypes.EnvParams(
    players_per_team=3, kick_noise=0.12, placement_noise=0.06,
    substeps=7, solver_iterations=6, max_steps=70,
    width=900.0, height=300.0, goal_size=60.0,
    player_radius=12.0, ball_radius=14.0,
    player_mass=35.0, ball_mass=2.5,
    player_elasticity=0.5, ball_elasticity=0.3,
    wall_elasticity=0.95, friction=0.7,
    dt=0.08, damping=0.9, collision_slop=0.05,
    baumgarte=0.3, max_speed=350.0,
    move_force=3500.0, dash_multiplier=1.5,
    possession_radius=55.0, dribble_offset=5.0,
    pass_power=450.0, shoot_power=900.0,
    rewards=jtypes.RewardConfig(
        goal=25.0, concede=-5.0, ball_to_goal_delta=0.37,
        player_to_ball_delta=0.045, possession_bonus=0.013,
        oob_penalty=-0.55, time_penalty=-0.002,
    ),
)


@pytest.mark.parametrize("cls", ["RewardConfig", "EnvParams"])
def test_fields_and_defaults_match(cls):
    jcls, tcls = getattr(jtypes, cls), getattr(ttypes, cls)
    assert ([f.name for f in dataclasses.fields(tcls)]
            == [f.name for f in dataclasses.fields(jcls)])
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("ref", [jtypes.EnvParams(), CUSTOM],
                         ids=["default", "custom"])
def test_derived_properties_and_interop(ref):
    p = params_from_reference(ref)
    assert dataclasses.asdict(p) == dataclasses.asdict(ref)
    for prop in ("n_players", "n_bodies", "goal_y_lo", "goal_y_hi"):
        assert getattr(p, prop) == getattr(ref, prop)
    assert p.replace(max_steps=9).max_steps == 9
    assert hash(p) == hash(params_from_reference(ref))


def test_state_from_numpy_layout():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(4, 5, 2)).astype(np.float32)
    vel = rng.normal(size=(4, 5, 2)).astype(np.float32)
    st = state_from_numpy(pos, vel, np.array([-1, 1, 2, 3]),
                          np.zeros((4, 2), np.int64), np.arange(4))
    assert st.pos.dtype == torch.float32 and st.possession.dtype == torch.int32
    assert st.score.dtype == torch.int32 and tuple(st.score.shape) == (4, 2)
    np.testing.assert_array_equal(st.pos.numpy(), pos)
    np.testing.assert_array_equal(st.ball_vel.numpy(), vel[:, 0])


def _jax_constants(p: jtypes.EnvParams) -> dict:
    """Each constant as the JAX step forms it (file:line of the form)."""
    f32 = jnp.float32
    a = lambda x: jnp.asarray(x, f32)  # noqa: E731
    dt_sub = p.dt / p.substeps
    inv_b, inv_p = a(1.0 / p.ball_mass), a(1.0 / p.player_mass)
    e_b, e_p = a(p.ball_elasticity), a(p.player_elasticity)
    rc = p.rewards
    out = {
        "dt_sub": a(dt_sub),                                   # physics.py:381
        # physics.py:382, folded inside jit as the step does
        "damp": jax.jit(lambda: a(p.damping) ** a(dt_sub))(),
        "max_speed": a(p.max_speed),
        "inv_m_ball": inv_b, "inv_m_player": inv_p,           # physics.py:371
        "r_ball": a(p.ball_radius), "r_player": a(p.player_radius),
        "rr_bp": a(p.ball_radius) + a(p.player_radius),       # physics.py:189
        "rr_pp": a(p.player_radius) + a(p.player_radius),
        "nkn_bp": -(a(1.0) / (inv_b + inv_p)),                # physics.py:201
        "nkn_pp": -(a(1.0) / (inv_p + inv_p)),
        "e_bp": e_b * e_p, "e_pp": e_p * e_p,                 # physics.py:193
        "ew_ball": e_b * a(p.wall_elasticity),                # physics.py:226
        "ew_player": e_p * a(p.wall_elasticity),
        "mu": a(p.friction), "slop": a(p.collision_slop),
        "bias_coef": a(p.baumgarte / dt_sub),                 # physics.py:176
        "width": a(p.width), "height": a(p.height),
        "goal_y_lo": a(p.goal_y_lo), "goal_y_hi": a(p.goal_y_hi),
        "move_force": a(p.move_force),
        "move_force_dash": a(p.move_force * p.dash_multiplier),  # game.py:109
        "possession_radius": a(p.possession_radius),
        "half_height": a(p.height / 2.0),                     # game.py:258
        "shoot_power": a(p.shoot_power), "pass_power": a(p.pass_power),
        "ball_mass": a(p.ball_mass),
        "dribble_offset": a(                                  # game.py:367
            p.player_radius + p.ball_radius + p.dribble_offset),
        "clamp_x_ball": a(p.width) - a(p.ball_radius),        # game.py:442
        "clamp_y_ball": a(p.height) - a(p.ball_radius),
        "clamp_x_player": a(p.width) - a(p.player_radius),
        "clamp_y_player": a(p.height) - a(p.player_radius),
        "kick_amp": a(p.placement_noise * p.height),          # game.py:491
        "center_x": a(p.width / 2.0),
        "base_x0": a(p.width / 4.0), "base_x1": a(3.0 * p.width / 4.0),
        "kick_noise": a(p.kick_noise),
        "r_time": a(rc.time_penalty), "r_goal": a(rc.goal),
        "r_concede": a(rc.concede), "r_btg": a(rc.ball_to_goal_delta),
        "r_ptb": a(rc.player_to_ball_delta),
        "r_poss": a(rc.possession_bonus), "r_oob": a(rc.oob_penalty),
    }
    ppt = p.players_per_team
    for k in range(5):                                        # game.py:498
        out[f"y0_{k}"] = a((k + 1.0) * (p.height / (ppt + 1.0))
                           if k < ppt else 0.0)
    return out


@pytest.mark.parametrize("ref", [jtypes.EnvParams(), CUSTOM],
                         ids=["default", "custom"])
def test_kernel_constants_equal_jax(ref):
    got = kernel_constants(params_from_reference(ref))
    want = _jax_constants(ref)
    assert tuple(got) == KERNEL_CONSTANT_NAMES
    assert set(want) == set(KERNEL_CONSTANT_NAMES)
    for name in KERNEL_CONSTANT_NAMES:
        assert np.float32(got[name]) == np.float32(want[name]), name
