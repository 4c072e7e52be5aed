"""The contact solver's culling (csrc/futbol_step.cuh, solve_contacts):
the kernels run a pair or (wall, body) update only where some env of the
warp needs it, because an inactive constraint's update is an exact no-op.
Both halves of that claim, on the CPU:

- a plain-torch emulation of the warp-culled sweep (groups of 32
  consecutive envs, as a warp; a ragged tail is lanes that are not there;
  and groups of one env, the most culling there can be) equals the
  port's plain physics step exactly (``torch.equal``: a skipped no-op can
  only leave the sign of a zero where the update would have flipped it,
  and signed zeros compare equal), for 1v1-5v5 and the parity script's
  custom constants, in float32 and float64, from crowded states, bodies
  on every wall and balls in the goal mouth;
- one pair or wall update with the inactive sentinel (``pen`` or ``d`` at
  most 0, ``pen`` exactly 0 included) leaves the velocities and
  accumulators ``==`` their inputs, at edge values (zero velocities,
  ``max_speed``), over hypothesis-drawn inputs.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from gym_futbol_tpu_torch import EnvParams, RewardConfig  # noqa: E402
from gym_futbol_tpu_torch import physics  # noqa: E402

from _torch_cases import contact_states, custom_params, random_forces  # noqa: E402

GEOMETRY = EnvParams(
    players_per_team=2, max_steps=80, width=900.0, height=300.0, goal_size=60.0,
    player_radius=12.0, ball_radius=14.0, player_mass=35.0, ball_mass=2.5,
    player_elasticity=0.5, ball_elasticity=0.3, wall_elasticity=0.95,
    friction=0.7, dt=0.08, substeps=7, damping=0.9, solver_iterations=6,
    collision_slop=0.05, baumgarte=0.3, max_speed=350.0)
CASES = {
    "1v1": EnvParams(players_per_team=1),
    "2v2": EnvParams(players_per_team=2),
    "3v3": EnvParams(players_per_team=3),
    "5v5": EnvParams(players_per_team=5),
    "custom": custom_params(EnvParams, RewardConfig),
    "custom-geometry": GEOMETRY,
}


def _group_any(mask: torch.Tensor, group: int) -> torch.Tensor:
    """Per env, whether any env of its group of ``group`` consecutive envs
    has ``mask`` set; the ragged tail's missing envs add nothing."""
    b = mask.shape[0]
    pad = mask.new_zeros((-b) % group)
    return torch.cat([mask, pad]).reshape(-1, group).any(1).repeat_interleave(
        group)[:b]


def _culled_solver(group: int, counts: dict):
    """The kernels' sweep in plain torch: each update runs for the groups
    in which some env has the constraint active (every env of such a
    group takes it, as every lane of the warp runs it); the others keep
    their velocities and accumulators. ``counts`` tallies (group,
    constraint) updates run and skipped per iteration."""
    def solve(px, py, vx, vy, params, dtype):
        mu = physics.physics_constants(params, dtype).mu
        n = len(px)
        k = physics._contact_setup(px, py, vx, vy, params, dtype)
        runs = [_group_any(on, group) for on in k.pair_on]
        wall_runs = [[_group_any(on, group) for on in row] for row in k.wall_on]
        vx, vy = list(vx), list(vy)
        zl = torch.zeros_like(vx[0])
        jn, jt = [zl] * len(k.pairs), [zl] * len(k.pairs)
        jv, jtv = [[zl] * n for _ in range(4)], [[zl] * n for _ in range(4)]
        n_groups = -(-vx[0].shape[0] // group)

        def masked(run, bodies, update):
            ran = int(run[::group].sum())
            counts["run"] += ran
            counts["skipped"] += n_groups - ran
            if ran == 0:
                return None
            old = [(vx[i], vy[i]) for i in bodies]
            acc = update()
            for i, (ox, oy) in zip(bodies, old):
                vx[i] = torch.where(run, vx[i], ox)
                vy[i] = torch.where(run, vy[i], oy)
            return acc

        for _ in range(params.solver_iterations):
            for p in range(len(k.pairs)):
                acc = masked(runs[p], k.pairs[p], lambda: physics._pair_update(
                    k, p, vx, vy, jn[p], jt[p], mu))
                if acc is not None:
                    jn[p] = torch.where(runs[p], acc[0], jn[p])
                    jt[p] = torch.where(runs[p], acc[1], jt[p])
            for wi in range(4):
                for i in range(n):
                    run = wall_runs[wi][i]
                    acc = masked(run, (i,), lambda: physics._wall_update(
                        k, wi, i, vx, vy, jv[wi][i], jtv[wi][i], mu))
                    if acc is not None:
                        jv[wi][i] = torch.where(run, acc[0], jv[wi][i])
                        jtv[wi][i] = torch.where(run, acc[1], jtv[wi][i])
        return vx, vy

    return solve


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("group", [32, 1], ids=["warp", "env"])
@pytest.mark.parametrize("case", list(CASES))
def test_culled_sweep_equals_plain_step(case, group, dtype, monkeypatch):
    """The physics step with the culled sweep equals the plain step in
    every position and velocity, over two steps from states where contacts
    of every kind are active in some envs and inactive in others, on a
    batch that is not a multiple of 32; and the culling skipped updates."""
    params = CASES[case]
    b = 32 * 5 + 13
    pos, vel = contact_states(params, b, seed=len(case) + group)
    forces = random_forces(np.random.default_rng(3), params, b)
    n = params.n_bodies

    def rows(a, c):
        return [torch.from_numpy(a[:, i, c]).to(dtype) for i in range(n)]

    state = (rows(pos, 0), rows(pos, 1), rows(vel, 0), rows(vel, 1))
    fx, fy = rows(forces, 0), rows(forces, 1)
    plain, culled = state, state
    counts = {"run": 0, "skipped": 0}
    for _ in range(2):
        plain = physics.physics_step_scalars(*plain, fx, fy, params, dtype)
        with monkeypatch.context() as m:
            m.setattr(physics, "_solve_contacts_scalar", _culled_solver(group, counts))
            culled = physics.physics_step_scalars(*culled, fx, fy, params, dtype)
        for name, a, c in zip(("px", "py", "vx", "vy"), plain, culled):
            for i in range(n):
                assert torch.equal(a[i], c[i]), f"{name}[{i}]"
    assert counts["run"] > 0 and counts["skipped"] > 0, counts


# ---------------------------------------------------------------------------
# One inactive update is a no-op
# ---------------------------------------------------------------------------

_P = EnvParams(players_per_team=2)
_MAX = float(_P.max_speed)
_speeds = st.one_of(st.sampled_from([0.0, -0.0, _MAX, -_MAX]),
                    st.floats(-_MAX, _MAX, allow_nan=False, width=32))
_dtypes = st.sampled_from([torch.float32, torch.float64])


def _t(x, dtype):
    return torch.tensor([x], dtype=dtype)


@settings(max_examples=300, deadline=None)
@given(v=st.lists(_speeds, min_size=4, max_size=4),
       angle=st.one_of(st.just(None), st.floats(0.0, 2 * math.pi)),
       pen=st.one_of(st.just(0.0), st.floats(-200.0, 0.0)),
       ball=st.booleans(), dtype=_dtypes)
def test_inactive_pair_update_is_a_noop(v, angle, pen, ball, dtype):
    """Pair (i, j)'s update with ``pen <= 0`` (the set-up's sentinel
    ``bmv = 1e20``, chosen by the solver's own activity test) leaves both
    bodies' velocities and the accumulators (0 before the first
    iteration, so 0 for an inactive pair ever after) equal to its inputs.
    ``angle`` None: coincident centres, a zero normal."""
    c = physics.physics_constants(_P, dtype)
    nx, ny = (0.0, 0.0) if angle is None else (math.cos(angle), math.sin(angle))
    nx, ny = _t(nx, dtype), _t(ny, dtype)
    inv_i = c.inv_m_ball if ball else c.inv_m_player
    active = physics._pair_active(_t(pen, dtype))
    k = SimpleNamespace(
        pairs=[(0, 1)], nx=[nx], ny=[ny], nxi=[nx * inv_i], nyi=[ny * inv_i],
        nxj=[nx * c.inv_m_player], nyj=[ny * c.inv_m_player],
        nkn=[c.nkn_bp if ball else c.nkn_pp],
        bmv=[torch.where(active, _t(-5.0, dtype), physics._BIG)])
    vx = [_t(v[0], dtype), _t(v[1], dtype)]
    vy = [_t(v[2], dtype), _t(v[3], dtype)]
    before = [x.clone() for x in (*vx, *vy)]
    zero = _t(0.0, dtype)
    jn, jt = physics._pair_update(k, 0, vx, vy, zero, zero, c.mu)
    assert not bool(active)
    assert all(bool(a == b) for a, b in zip((*vx, *vy), before))
    assert bool(jn == 0) and bool(jt == 0)


@settings(max_examples=300, deadline=None)
@given(v=st.lists(_speeds, min_size=2, max_size=2),
       d=st.one_of(st.just(0.0), st.floats(-500.0, 0.0)),
       wall=st.integers(0, 3), dtype=_dtypes)
def test_inactive_wall_update_is_a_noop(v, d, wall, dtype):
    """Wall ``wall``'s update on a body with ``d <= 0`` (sentinel ``wn =
    -1e20`` from the solver's activity test) leaves the body's velocity
    and the accumulators equal to its inputs."""
    c = physics.physics_constants(_P, dtype)
    active = physics._wall_active(_t(d, dtype))
    wn = [[None] for _ in range(4)]
    wn[wall][0] = torch.where(active, _t(3.0, dtype), -physics._BIG)
    k = SimpleNamespace(wn=wn)
    vx, vy = [_t(v[0], dtype)], [_t(v[1], dtype)]
    before = (vx[0].clone(), vy[0].clone())
    zero = _t(0.0, dtype)
    jv, jtv = physics._wall_update(k, wall, 0, vx, vy, zero, zero, c.mu)
    assert not bool(active)
    assert bool(vx[0] == before[0]) and bool(vy[0] == before[1])
    assert bool(jv == 0) and bool(jtv == 0)
