"""Inputs shared by the port's tests (tests/test_torch_*.py): parameter
sets and game-like random states, all made with numpy from a seed.
Imports neither package, so the card's tests (which run where JAX is
not installed) can use it too."""

import numpy as np


def custom_params(env_params_cls, reward_config_cls):
    """Non-default geometry, material, integration, action and reward
    constants, as either package's ``EnvParams``: a constant baked into
    the port passes every default-params case and fails on this one."""
    return env_params_cls(
        players_per_team=2, kick_noise=0.12, placement_noise=0.06,
        substeps=3, solver_iterations=5, max_steps=7,
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
        rewards=reward_config_cls(
            goal=25.0, concede=-5.0, ball_to_goal_delta=0.37,
            player_to_ball_delta=0.045, possession_bonus=0.013,
            oob_penalty=-0.55, time_penalty=-0.002,
        ),
    )


def random_bodies(rng, params, b, near_ball=False):
    """Game-like positions ``[b, n, 2]``: each body anywhere on the field
    or touching an earlier body (penetration up to 5, so contacts are
    active but not degenerate); with ``near_ball`` every player starts
    within reach of the ball. Velocities ~ N(0, 150)."""
    n = params.n_bodies
    radii = np.array([params.ball_radius] + [params.player_radius] * (n - 1))
    pos = np.zeros((b, n, 2))
    for e in range(b):
        for k in range(n):
            while True:
                if k > 0 and (near_ball or rng.random() < 0.6):
                    j = 0 if near_ball else rng.integers(k)
                    ang = rng.uniform(0.0, 2 * np.pi)
                    dist = radii[j] + radii[k] - rng.uniform(-20.0 * near_ball, 5.0)
                    p = pos[e, j] + dist * np.array([np.cos(ang), np.sin(ang)])
                else:
                    p = np.array([rng.uniform(0.0, params.width),
                                  rng.uniform(0.0, params.height)])
                gap = np.linalg.norm(pos[e, :k] - p, axis=-1) - (
                    radii[:k] + radii[k])
                if (gap > -5.0).all():
                    break
            pos[e, k] = p
    vel = rng.normal(0.0, 150.0, (b, n, 2))
    return pos.astype(np.float32), vel.astype(np.float32)


def contact_states(params, b, seed):
    """``b`` envs (pos, vel [b, n, 2] numpy) in four kinds, interleaved in
    runs of 7 so that warps mix them: crowded (every body within a few
    radii of the centre, overlapping), on the walls (each body touching
    or pressed into a side), the ball in either goal mouth moving out, and
    game-like spreads (random_bodies)."""
    rng = np.random.default_rng(seed)
    n, r = params.n_bodies, params.player_radius
    pos, vel = random_bodies(rng, params, b)
    w, h, mid = params.width, params.height, params.height / 2.0
    for e in range(b):
        kind = e // 7 % 4
        if kind == 0:
            pos[e] = [w / 2, mid] + rng.uniform(-2.5 * r, 2.5 * r, (n, 2))
        elif kind == 1:
            side = rng.integers(0, 4, n)
            depth = rng.uniform(-2.0, 2.0, n) + r
            along = rng.uniform(0.0, 1.0, n)
            pos[e, :, 0] = np.where(side == 0, depth, np.where(
                side == 1, w - depth, along * w))
            pos[e, :, 1] = np.where(side == 2, depth, np.where(
                side == 3, h - depth, along * h))
        elif kind == 2:
            gx = w - 2.0 if e % 2 else 2.0
            pos[e, 0] = [gx, mid + rng.uniform(-0.4, 0.4) * params.goal_size]
            vel[e, 0] = [300.0 if e % 2 else -300.0, rng.normal(0.0, 50.0)]
    vel[rng.random((b, n)) < 0.1] = 0.0                 # resting bodies
    return pos.astype(np.float32), vel.astype(np.float32)


def random_forces(rng, params, b):
    """Per-body forces from the action magnitudes, ball zero."""
    mf = params.move_force
    forces = rng.choice([-mf * params.dash_multiplier, -mf, 0.0, mf,
                         mf * params.dash_multiplier], (b, params.n_bodies, 2))
    forces[:, 0] = 0.0
    return forces.astype(np.float32)


def game_states(rng, params, b):
    """A batch that reaches every branch of the step within a few steps:
    players around the ball (bids, kicks, dribbles), owners set, balls
    about to cross either goal line, clocks about to run out. Returns
    numpy (pos, vel, possession, score, t)."""
    half = b // 2
    pos0, vel0 = random_bodies(rng, params, half, near_ball=True)
    pos1, vel1 = random_bodies(rng, params, b - half)
    pos, vel = np.concatenate([pos0, pos1]), np.concatenate([vel0, vel1])
    possession = np.where(rng.random(b) < 0.5,
                          rng.integers(1, params.n_players + 1, b), -1)
    # loose balls about to score: every 8th env for team 0, the next
    # one for team 1
    mid = params.height / 2.0
    for first, x, vx in ((0, params.width - 3.0, 250.0), (1, 3.0, -250.0)):
        for e in range(first, b, 8):
            pos[e, 0], vel[e, 0], possession[e] = (x, mid), (vx, 0.0), -1
    score = rng.integers(0, 3, (b, 2))
    t = np.where(rng.random(b) < 0.5,
                 rng.integers(params.max_steps - 4, params.max_steps, b), 0)
    return (pos, vel, possession.astype(np.int32), score.astype(np.int32),
            t.astype(np.int32))


def random_actions(rng, params, shape, out_of_range=0.05):
    """int32 actions ``shape + (n_players, 2)`` in [0, 5), with a share
    of out-of-range values (7, -3) that decode as no direction / a plain
    move."""
    a = rng.integers(0, 5, shape + (params.n_players, 2))
    bad = rng.random(a.shape) < out_of_range
    a = np.where(bad, rng.choice([7, -3], a.shape), a)
    return a.astype(np.int32)
