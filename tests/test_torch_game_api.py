"""The array-form game, physics and types API (the JAX package's per-env
functions) against the JAX package on the CPU, batched against single
envs, and JAX's own scenario tests for them run on the port.

Inputs are made with numpy from a seed, at 1v1, 2v2, 3v3, 5v5 and the
custom params of ``_torch_cases.custom_params``: game-like states
(bodies crowded round the ball, pressed into the walls, the ball in a
goal mouth or past a goal line), a third of the envs with bodies
scattered in and outside the field, possession -1 or an owner, actions with out-of-range ints. JAX's
functions take one env and are vmapped; the port's take the batch.
``apply_kick`` gets JAX's own angular noise, drawn from its per-env
keys; ``kickoff_positions`` JAX's own uniforms.

Tolerances, with their reasons (ROADMAP's numerical facts: XLA on the
CPU contracts ``a*b + c`` into FMAs and its ``rsqrt`` is not IEEE
``1/sqrt``; the port rounds every operation): integers, bools and
possession exact; positions, velocities and forces rtol 1e-4 / atol
1e-3 (tests/test_torch_env.py's state bound), except the contact solve's
velocities, rtol 1e-5 / atol 2e-3 (tests/test_torch_physics.py: the
sequential solver spreads last-bit differences over bodies in contact);
rewards rtol 1e-5 / atol 1e-4 (tests/test_torch_env.py). A batched call
equals the stack of single-env calls bitwise.
"""

import zlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gym_futbol_tpu import EnvParams as JEnvParams  # noqa: E402
from gym_futbol_tpu import RewardConfig as JRewardConfig  # noqa: E402
from gym_futbol_tpu import game as jgame  # noqa: E402
from gym_futbol_tpu import physics as jphysics  # noqa: E402
from gym_futbol_tpu import types as jtypes  # noqa: E402
from gym_futbol_tpu_torch import game, physics  # noqa: E402
from gym_futbol_tpu_torch import types as ttypes  # noqa: E402
from gym_futbol_tpu_torch.interop import params_from_reference  # noqa: E402
from gym_futbol_tpu_torch.physics import circle_pairs, physics_step  # noqa: E402
from gym_futbol_tpu_torch.types import EnvParams  # noqa: E402

from _torch_cases import (  # noqa: E402
    contact_states,
    custom_params,
    random_actions,
    random_forces,
)

B = 48
F32 = torch.float32
STATE_TOL = dict(rtol=1e-4, atol=1e-3)
SOLVE_TOL = dict(rtol=1e-5, atol=2e-3)
REW_TOL = dict(rtol=1e-5, atol=1e-4)
REFS = {
    "1v1": JEnvParams(players_per_team=1),
    "2v2": JEnvParams(players_per_team=2),
    "3v3": JEnvParams(players_per_team=3),
    "5v5": JEnvParams(players_per_team=5),
    "custom": custom_params(JEnvParams, JRewardConfig),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(ref, seed):
    """numpy (pos, vel, possession, actions, pos_after, goals, clamped,
    forces) for B envs: ``contact_states`` (crowded round the centre, so
    bids are in reach; on the walls; the ball in a goal mouth; spread),
    a third of the envs scattered in and outside the field, and every
    fourth ball past a goal line, in the mouth or beside it."""
    params = params_from_reference(ref)
    rng = np.random.default_rng(seed)
    pos, vel = contact_states(params, B, seed)
    possession = rng.integers(0, ref.n_bodies, B).astype(np.int32)
    possession[possession == 0] = -1
    scatter = rng.random(B) < 1 / 3
    lo, hi = np.array([-40.0, -40.0]), np.array([ref.width + 40, ref.height + 40])
    pos[scatter] = rng.uniform(lo, hi, (int(scatter.sum()), ref.n_bodies, 2))
    for e in range(0, B, 4):
        side = rng.integers(2)
        pos[e, 0, 0] = ref.width + rng.uniform(0, 20) if side else -rng.uniform(0, 20)
        pos[e, 0, 1] = ref.height / 2 + rng.uniform(-0.7, 0.7) * ref.goal_size
    pos_after = (pos + rng.normal(0.0, 8.0, pos.shape)).astype(np.float32)
    actions = random_actions(rng, params, (B,))
    goals = rng.random((B, 2)) < 0.2
    clamped = rng.random(B) < 0.3
    forces = random_forces(rng, params, B)
    return (pos, vel, possession, actions, pos_after, goals, clamped, forces)


def _close(got, want, tol, what):
    got = got.numpy()
    want = _np(want)
    assert got.shape == want.shape, what
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got.dtype == want.dtype, what
        np.testing.assert_allclose(got, want, **tol, err_msg=what)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def _bodies(ref, dtype=jnp.float32):
    return (1.0 / jtypes.body_masses(ref, dtype), jtypes.body_radii(ref, dtype),
            jtypes.body_elasticities(ref, dtype))


# Each case: (JAX call on the batch, the port's call on the batch, the
# tolerance of each output). Inputs: the refs, the numpy batch.

def _decode(ref, params, x):
    want = jax.vmap(lambda a: jgame.decode_forces(a, ref, jnp.float32))(x[3])
    return (want,), (game.decode_forces(_t(x[3]), params, F32),), (STATE_TOL,)


def _possession(ref, params, x):
    want = jax.vmap(lambda p, o, a: jgame.update_possession(p, o, a, ref))(
        x[0], x[2], x[3])
    got = game.update_possession(_t(x[0]), _t(x[2]), _t(x[3]), params)
    return (want,), (got,), (None,)


def _kick(ref, params, x):
    keys = _keys(7)
    want = jax.vmap(lambda p, v, o, a, k: jgame.apply_kick(p, v, o, a, k, ref))(
        x[0], x[1], x[2], x[3], keys)
    theta = jax.vmap(lambda k: jax.random.normal(k, (), jnp.float32)
                     * jnp.asarray(ref.kick_noise, jnp.float32))(keys)
    got = game.apply_kick(_t(x[0]), _t(x[1]), _t(x[2]), _t(x[3]),
                          _t(_np(theta)), params)
    return want, got, (STATE_TOL, None)


def _dribble(ref, params, x):
    want = jax.vmap(lambda p, v, o, a: jgame.apply_dribble(p, v, o, a, ref))(
        x[0], x[1], x[2], x[3])
    got = game.apply_dribble(_t(x[0]), _t(x[1]), _t(x[2]), _t(x[3]), params)
    return want, got, (STATE_TOL, STATE_TOL)


def _goal(ref, params, x):
    want = jax.vmap(lambda p: jgame.detect_goal(p, ref))(x[0])
    return (want,), (game.detect_goal(_t(x[0]), params),), (None,)


def _clamp(ref, params, x):
    want = jax.vmap(lambda p, v: jgame.clamp_oob(p, v, ref))(x[0], x[1])
    got = game.clamp_oob(_t(x[0]), _t(x[1]), params)
    return want, got, (STATE_TOL, STATE_TOL, None)


def _kickoff(ref, params, x):
    keys = _keys(9)
    want = jax.vmap(lambda k: jgame.kickoff_positions(k, ref))(keys)
    noise = jax.vmap(lambda k: jax.random.uniform(
        k, (ref.n_bodies, 2), jnp.float32, -1.0, 1.0))(keys)
    got = game.kickoff_positions(_t(_np(noise)), params)
    return want, got, (STATE_TOL, STATE_TOL)


def _rewards(ref, params, x):
    want = jax.vmap(lambda p0, p1, o, g, c: jgame.shaped_rewards(
        p0, p1, o, g, c, ref))(x[0], x[4], x[2], x[5], x[6])
    got = game.shaped_rewards(_t(x[0]), _t(x[4]), _t(x[2]), _t(x[5]), _t(x[6]),
                              params)
    return (want,), (got,), (REW_TOL,)


def _integrate(ref, params, x):
    inv_m = _np(_bodies(ref)[0])
    dt_sub = ref.dt / ref.substeps
    want = jax.vmap(lambda v, f: jphysics.integrate_velocity(
        v, f, inv_m, ref, dt_sub))(x[1], x[7])
    got = physics.integrate_velocity(_t(x[1]), _t(x[7]), _t(inv_m), params, dt_sub)
    return (want,), (got,), (STATE_TOL,)


def _solve(ref, params, x):
    bodies = [_np(b) for b in _bodies(ref)]
    want = jax.vmap(lambda p, v: jphysics.solve_contacts(p, v, ref, *bodies))(
        x[0], x[1])
    got = physics.solve_contacts(_t(x[0]), _t(x[1]), params,
                                 *(_t(b) for b in bodies))
    return (want,), (got,), (SOLVE_TOL,)


def _solve_other_bodies(ref, params, x):
    """Per-body inverse masses, radii and elasticities other than the
    env's, as JAX's solve_contacts takes any."""
    rng = np.random.default_rng(ref.n_bodies)
    n = ref.n_bodies
    bodies = [(1.0 / rng.uniform(0.5, 60.0, n)).astype(np.float32),
              rng.uniform(4.0, 20.0, n).astype(np.float32),
              rng.uniform(0.0, 1.0, n).astype(np.float32)]
    want = jax.vmap(lambda p, v: jphysics.solve_contacts(p, v, ref, *bodies))(
        x[0], x[1])
    got = physics.solve_contacts(_t(x[0]), _t(x[1]), params,
                                 *(_t(b) for b in bodies))
    return (want,), (got,), (SOLVE_TOL,)


CASES = {
    "decode_forces": _decode,
    "update_possession": _possession,
    "apply_kick": _kick,
    "apply_dribble": _dribble,
    "detect_goal": _goal,
    "clamp_oob": _clamp,
    "kickoff_positions": _kickoff,
    "shaped_rewards": _rewards,
    "integrate_velocity": _integrate,
    "solve_contacts": _solve,
    "solve_contacts_other_bodies": _solve_other_bodies,
}


@pytest.mark.parametrize("ref", list(REFS))
@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case, ref):
    jref = REFS[ref]
    params = params_from_reference(jref)
    x = _inputs(jref, zlib.crc32(f"{case} {ref}".encode()))
    want, got, tols = CASES[case](jref, params, x)
    assert len(want) == len(got) == len(tols)
    for k, (g, w, tol) in enumerate(zip(got, want, tols)):
        _close(g, w, tol, f"{case} output {k}")


@pytest.mark.parametrize("ref", list(REFS))
def test_body_tables_match_jax(ref):
    jref = REFS[ref]
    params = params_from_reference(jref)
    for name in ("body_masses", "body_radii", "body_elasticities"):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float16, torch.float16)):
            got = getattr(ttypes, name)(params, tdt, device="cpu")
            want = getattr(jtypes, name)(jref, jdt)
            assert got.dtype == tdt and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), _np(want), err_msg=name)
    got = ttypes.team_of_body(params)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(jtypes.team_of_body(jref)))


# ---------------------------------------------------------------------------
# A batched call equals the stack of single-env calls, bitwise
# ---------------------------------------------------------------------------

def _port_calls(params, x, theta, noise):
    """Each array-form function on the inputs ``x`` (torch, with or
    without the batch dim): name -> tuple of outputs."""
    pos, vel, poss, acts, pos1, goals, clamped, forces = x
    bodies = (1.0 / ttypes.body_masses(params), ttypes.body_radii(params),
              ttypes.body_elasticities(params))
    return {
        "decode_forces": (game.decode_forces(acts, params, F32),),
        "update_possession": (game.update_possession(pos, poss, acts, params),),
        "apply_kick": game.apply_kick(pos, vel, poss, acts, theta, params),
        "apply_dribble": game.apply_dribble(pos, vel, poss, acts, params),
        "detect_goal": (game.detect_goal(pos, params),),
        "clamp_oob": game.clamp_oob(pos, vel, params),
        "kickoff_positions": game.kickoff_positions(noise, params),
        "shaped_rewards": (game.shaped_rewards(pos, pos1, poss, goals, clamped,
                                               params),),
        "integrate_velocity": (physics.integrate_velocity(
            vel, forces, bodies[0], params, params.dt / params.substeps),),
        "solve_contacts": (physics.solve_contacts(pos, vel, params, *bodies),),
    }


@pytest.mark.parametrize("ref", ["1v1", "3v3", "custom"])
def test_batched_equals_single_envs(ref):
    jref = REFS[ref]
    params = params_from_reference(jref)
    x = [_t(a) for a in _inputs(jref, 11)]
    rng = np.random.default_rng(12)
    theta = _t(rng.normal(0.0, 0.3, B).astype(np.float32))
    noise = _t(rng.uniform(-1.0, 1.0, (B, jref.n_bodies, 2)).astype(np.float32))
    batched = _port_calls(params, x, theta, noise)
    singles = [_port_calls(params, [a[e] for a in x], theta[e], noise[e])
               for e in range(B)]
    for name, outs in batched.items():
        for k, out in enumerate(outs):
            stacked = torch.stack([s[name][k] for s in singles])
            assert stacked.shape == out.shape, name
            assert torch.equal(stacked, out), f"{name} output {k}"


@pytest.mark.parametrize("ref", ["2v2", "5v5", "custom"])
def test_body_tables_give_the_constants_path(ref):
    """The physics array forms fed the env's body tables equal, bitwise,
    the scalar forms on the constants ``physics_constants`` rounds once
    (the path the env step and the kernels take), as chip_smoke.py's
    phase 22 checks on the card."""
    jref = REFS[ref]
    params = params_from_reference(jref)
    pos, vel, *_, forces = (_t(a) for a in _inputs(jref, 13))
    inv_mass = 1.0 / ttypes.body_masses(params)
    radii, elas = ttypes.body_radii(params), ttypes.body_elasticities(params)
    c = physics.physics_constants(params, F32)
    n = params.n_bodies
    px, py = physics.split_xy(pos)
    vx, vy = physics.split_xy(vel)
    want = physics.stack_xy(*physics._solve_contacts_scalar(px, py, vx, vy, params,
                                                            F32))
    assert torch.equal(physics.solve_contacts(pos, vel, params, inv_mass, radii,
                                              elas), want)
    want = physics.stack_xy(*physics.integrate_velocity_scalars(
        vx, vy, *physics.split_xy(forces), [c.inv_m_ball] + [c.inv_m_player] * (n - 1),
        c.damp, c.dt_sub, c.max_speed))
    assert torch.equal(physics.integrate_velocity(
        vel, forces, inv_mass, params, params.dt / params.substeps), want)


# ---------------------------------------------------------------------------
# JAX's scenario tests (tests/test_game.py, tests/test_physics.py) on the
# port's API
# ---------------------------------------------------------------------------

P = EnvParams(players_per_team=2)


def mk_pos(ball, players):
    return torch.tensor([ball] + players, dtype=F32)


def actions_of(*pairs):
    return torch.tensor(pairs, dtype=torch.int32)


def owner_of(b):
    return torch.tensor(b, dtype=torch.int32)


def test_decode_directions_and_dash():
    p = EnvParams(players_per_team=1)
    f = game.decode_forces(actions_of([1, 0], [2, 1]), p, F32)
    np.testing.assert_allclose(f[0].numpy(), [0.0, 0.0])
    np.testing.assert_allclose(f[1].numpy(), [0.0, p.move_force])
    np.testing.assert_allclose(f[2].numpy(), [p.move_force * p.dash_multiplier, 0.0])


def test_decode_noop_zero_force():
    p = EnvParams(players_per_team=1)
    f = game.decode_forces(actions_of([0, 0], [0, 4]), p, F32)
    np.testing.assert_allclose(f.numpy(), 0.0)


POSSESSION_CASES = {
    # id: (players' positions, owner before, actions, owner after)
    "nearest_bidder_wins": ([[310.0, 200.0], [330.0, 200.0], [500.0, 100.0],
                             [520.0, 100.0]], -1, ([0, 2], [0, 2], [0, 0], [0, 0]),
                            1),
    "tie_breaks_to_lowest_index": ([[310.0, 200.0], [290.0, 200.0],
                                    [500.0, 100.0], [520.0, 100.0]], -1,
                                   ([0, 2], [0, 2], [0, 0], [0, 0]), 1),
    "out_of_range_bid_ignored": ([[300.0 + P.possession_radius + 1, 200.0],
                                  [100.0, 100.0], [500.0, 100.0], [520.0, 100.0]],
                                 -1, ([0, 2], [0, 0], [0, 0], [0, 0]), -1),
    "owner_keeps_without_bid": ([[310.0, 200.0], [100.0, 100.0], [500.0, 100.0],
                                 [520.0, 100.0]], 1,
                                ([0, 0], [0, 0], [0, 0], [0, 0]), 1),
    "owner_loses_when_out_of_reach": ([[300.0 + P.possession_radius + 5, 200.0],
                                       [100.0, 100.0], [500.0, 100.0],
                                       [520.0, 100.0]], 1,
                                      ([0, 0], [0, 0], [0, 0], [0, 0]), -1),
    "steal_by_closer_opponent": ([[320.0, 200.0], [100.0, 100.0], [305.0, 200.0],
                                  [520.0, 100.0]], 1,
                                 ([0, 0], [0, 0], [0, 2], [0, 0]), 3),
}


@pytest.mark.parametrize("case", list(POSSESSION_CASES))
def test_possession(case):
    players, before, acts, after = POSSESSION_CASES[case]
    owner = game.update_possession(mk_pos([300.0, 200.0], players),
                                   owner_of(before), actions_of(*acts), P)
    assert owner.dtype == torch.int32 and int(owner) == after


def _kick(p, ball, players, owner, acts):
    vel = torch.zeros((p.n_bodies, 2), dtype=F32)
    return game.apply_kick(mk_pos(ball, players), vel, owner_of(owner),
                           actions_of(*acts), torch.zeros(()), p)


def test_kick_shoot_toward_opponent_goal():
    p = EnvParams(players_per_team=1, kick_noise=0.0)
    new_vel, owner = _kick(p, [310.0, 200.0], [[300.0, 200.0], [500.0, 200.0]],
                           1, ([0, 4], [0, 0]))
    assert int(owner) == -1
    bv = new_vel[0].numpy()
    assert bv[0] > 0
    np.testing.assert_allclose(np.linalg.norm(bv), p.shoot_power / p.ball_mass,
                               rtol=1e-5)


def test_kick_team1_shoots_left():
    p = EnvParams(players_per_team=1, kick_noise=0.0)
    new_vel, _ = _kick(p, [310.0, 200.0], [[500.0, 200.0], [300.0, 200.0]], 2,
                       ([0, 0], [0, 4]))
    assert float(new_vel[0, 0]) < 0


def test_kick_pass_toward_nearest_teammate():
    p = EnvParams(players_per_team=2, kick_noise=0.0)
    new_vel, _ = _kick(p, [210.0, 200.0], [[200.0, 200.0], [200.0, 300.0],
                                           [500.0, 100.0], [520.0, 100.0]], 1,
                       ([0, 3], [0, 0], [0, 0], [0, 0]))
    bv = new_vel[0].numpy()
    assert bv[1] > abs(bv[0])
    np.testing.assert_allclose(np.linalg.norm(bv), p.pass_power / p.ball_mass,
                               rtol=1e-5)


def test_kick_non_owner_cannot_kick():
    new_vel, owner = _kick(P, [210.0, 200.0], [[200.0, 200.0], [200.0, 300.0],
                                               [500.0, 100.0], [520.0, 100.0]],
                           -1, ([0, 4], [0, 4], [0, 4], [0, 4]))
    np.testing.assert_allclose(new_vel.numpy(), 0.0)
    assert int(owner) == -1


def test_dribble_ball_carried_in_commanded_direction():
    p = EnvParams(players_per_team=1)
    pos = mk_pos([290.0, 200.0], [[300.0, 200.0], [500.0, 200.0]])
    vel = torch.tensor([[0.0, 0.0], [25.0, 0.0], [0.0, 0.0]], dtype=F32)
    new_pos, new_vel = game.apply_dribble(pos, vel, owner_of(1),
                                          actions_of([2, 0], [0, 0]), p)
    off = p.player_radius + p.ball_radius + p.dribble_offset
    np.testing.assert_allclose(new_pos[0].numpy(), [300.0 + off, 200.0], rtol=1e-5)
    np.testing.assert_allclose(new_vel[0].numpy(), [25.0, 0.0])


def test_dribble_free_ball_untouched():
    pos = mk_pos([290.0, 200.0], [[300.0, 200.0], [100.0, 100.0], [500.0, 100.0],
                                  [520.0, 100.0]])
    new_pos, _ = game.apply_dribble(pos, torch.ones((5, 2), dtype=F32),
                                    owner_of(-1),
                                    torch.zeros((4, 2), dtype=torch.int32), P)
    np.testing.assert_allclose(new_pos.numpy(), pos.numpy())


GOAL_CASES = {
    # id: (ball, (team 0 scored, team 1 scored)); JAX's tests assert the
    # named flags, and the others follow from the mouth's geometry
    "goal_only_inside_mouth": ([P.width + 1.0, P.height / 2.0], (True, False)),
    "no_goal_outside_mouth": ([P.width + 1.0, P.goal_y_hi + 5.0], (False, False)),
    "goal_line_not_crossed": ([P.width, P.height / 2.0], (False, False)),
    "left_goal_scores_for_team1": ([-1.0, P.height / 2.0], (False, True)),
}


@pytest.mark.parametrize("case", list(GOAL_CASES))
def test_goal(case):
    ball, want = GOAL_CASES[case]
    g = game.detect_goal(mk_pos(ball, [[0, 0]] * 4), P)
    assert g.dtype == torch.bool and tuple(bool(v) for v in g) == want


def test_oob_player_clamped():
    pos = mk_pos([300.0, 200.0], [[-20.0, 200.0], [300.0, 500.0], [400.0, 100.0],
                                  [500.0, 100.0]])
    out, _, ball_clamped = game.clamp_oob(pos, torch.full((5, 2), -5.0), P)
    assert out[1, 0] == P.player_radius
    assert out[2, 1] == P.height - P.player_radius
    assert not bool(ball_clamped)


def test_oob_ball_free_in_mouth():
    pos = mk_pos([P.width + 3.0, P.height / 2.0], [[100, 100]] * 4)
    out, _, clamped = game.clamp_oob(pos, torch.zeros((5, 2)), P)
    assert float(out[0, 0]) == P.width + 3.0
    assert not bool(clamped)


def test_oob_ball_clamped_outside_mouth():
    pos = mk_pos([P.width + 3.0, P.goal_y_hi + 20.0], [[100, 100]] * 4)
    out, _, clamped = game.clamp_oob(pos, torch.zeros((5, 2)), P)
    assert float(out[0, 0]) == P.width - P.ball_radius
    assert bool(clamped)


def _rewards(pos0, pos1, owner, goals):
    return game.shaped_rewards(pos0, pos1, owner_of(owner), torch.tensor(goals),
                               torch.tensor(False), P).numpy()


def test_rewards_goal_signs():
    pos = mk_pos([300.0, 200.0], [[100, 100], [200, 100], [400, 100], [500, 100]])
    r = _rewards(pos, pos, -1, [True, False])
    assert r[0] >= P.rewards.goal - 1e-5
    assert r[1] <= P.rewards.concede + 1e-5


def test_rewards_ball_progress_shaping_zero_sum_direction():
    players = [[100, 100], [200, 100], [400, 100], [500, 100]]
    r = _rewards(mk_pos([300.0, 200.0], players), mk_pos([320.0, 200.0], players),
                 -1, [False, False])
    assert r[0] > 0 and r[1] < 0


def test_rewards_possession_bonus():
    pos = mk_pos([300.0, 200.0], [[300, 200], [200, 100], [400, 100], [500, 100]])
    r_own = _rewards(pos, pos, 1, [False, False])
    r_no = _rewards(pos, pos, -1, [False, False])
    assert r_own[0] - r_no[0] == np.float32(P.rewards.possession_bonus)


def test_velocity_update_closed_form():
    """v' = v * damping^dt + (f/m) dt, the Chipmunk rule."""
    p = EnvParams()
    dt = 0.01
    out = physics.integrate_velocity(torch.tensor([[3.0, -2.0]]),
                                     torch.tensor([[10.0, 20.0]]),
                                     torch.tensor([0.5]), p, dt)
    expected = (np.array([[3.0, -2.0]]) * (p.damping ** dt)
                + np.array([[10.0, 20.0]]) * 0.5 * dt)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5)


def test_speed_clamp():
    p = EnvParams(max_speed=10.0)
    out = physics.integrate_velocity(torch.tensor([[100.0, 0.0]]),
                                     torch.zeros((1, 2)), torch.tensor([1.0]), p,
                                     0.01)
    assert np.linalg.norm(out.numpy()) <= 10.0 + 1e-5


def test_free_body_trajectory():
    """No contacts, no force: x advances by v*dt each substep."""
    p = EnvParams(players_per_team=1, damping=1.0, substeps=4)
    pos = torch.tensor([[[300.0, 200.0], [100.0, 100.0], [500.0, 300.0]]])
    vel = torch.tensor([[[10.0, 5.0], [0.0, 0.0], [0.0, 0.0]]])
    new_pos, new_vel = physics_step(pos, vel, torch.zeros_like(pos), p)
    np.testing.assert_allclose(new_pos[0, 0].numpy(),
                               [300.0 + 10 * p.dt, 200.0 + 5 * p.dt], rtol=1e-5)
    np.testing.assert_allclose(new_vel[0, 0].numpy(), [10.0, 5.0], rtol=1e-5)


def test_pair_order_is_lexicographic():
    assert circle_pairs(3) == [(0, 1), (0, 2), (1, 2)]


def _solve(p, pos, vel):
    return physics.solve_contacts(
        torch.tensor(pos, dtype=F32), torch.tensor(vel, dtype=F32), p,
        1.0 / ttypes.body_masses(p), ttypes.body_radii(p),
        ttypes.body_elasticities(p)).numpy()


@pytest.mark.parametrize("e,want", [(1.0, 10.0), (0.0, 0.0)],
                         ids=["head_on_elastic_swap", "inelastic_rest"])
def test_head_on_equal_mass(e, want):
    """Two equal circles approaching: e=1 swaps their velocities, e=0
    stops both (momentum conserved)."""
    p = EnvParams(players_per_team=1, player_elasticity=e, friction=0.0,
                  baumgarte=0.0)
    out = _solve(p, [[50.0, 350.0], [100.0, 100.0], [129.0, 100.0]],
                 [[0.0, 0.0], [10.0, 0.0], [-10.0, 0.0]])
    np.testing.assert_allclose(out[1], [-want, 0.0], atol=0.2)
    np.testing.assert_allclose(out[2], [want, 0.0], atol=0.2)


def test_momentum_conserved_pairwise():
    p = EnvParams(players_per_team=2, friction=0.3, baumgarte=0.0)
    masses = ttypes.body_masses(p).numpy()
    pos = [[300.0, 200.0], [310.0, 205.0], [290.0, 195.0], [305.0, 185.0],
           [285.0, 210.0]]
    vel = (np.random.default_rng(3).normal(size=(5, 2)) * 30.0).astype(np.float32)
    out = _solve(p, pos, vel)
    np.testing.assert_allclose((out * masses[:, None]).sum(0),
                               (vel * masses[:, None]).sum(0), rtol=1e-3, atol=1e-2)


def test_no_contact_is_identity():
    p = EnvParams(players_per_team=1)
    vel = [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]
    out = _solve(p, [[300.0, 200.0], [100.0, 100.0], [500.0, 300.0]], vel)
    np.testing.assert_allclose(out, vel, rtol=1e-6)


def test_wall_bounce():
    """Ball into the bottom wall reflects with restitution e_ball*e_wall."""
    p = EnvParams(players_per_team=1, friction=0.0, baumgarte=0.0)
    out = _solve(p, [[300.0, 9.0], [100.0, 200.0], [500.0, 200.0]],
                 [[0.0, -50.0], [0.0, 0.0], [0.0, 0.0]])
    np.testing.assert_allclose(out[0, 1], 50.0 * p.ball_elasticity
                               * p.wall_elasticity, rtol=0.05)


def test_ball_passes_through_goal_mouth():
    p = EnvParams(players_per_team=1)
    out = _solve(p, [[5.0, p.height / 2.0], [300.0, 100.0], [400.0, 300.0]],
                 [[-80.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
    np.testing.assert_allclose(out[0], [-80.0, 0.0], rtol=1e-6)


def test_player_blocked_at_goal_mouth():
    p = EnvParams(players_per_team=1, friction=0.0, baumgarte=0.0)
    out = _solve(p, [[300.0, 100.0], [10.0, p.height / 2.0], [400.0, 300.0]],
                 [[0.0, 0.0], [-50.0, 0.0], [0.0, 0.0]])
    assert out[1, 0] > -50.0 * 0.5
