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
- a plain-torch emulation of the replay kernel's order (per-env lists
  of active constraints, each env walking its own in the plain order up
  to its warp's longest, 32 / G envs a warp for G lanes an env) equals
  the plain physics step exactly, over the same cases, and each warp
  walks no more slots than its envs' union of constraints;
- the math the replay kernel skips is decided: a pair farther apart
  than its far bound is inactive, and a body slower than its slow bound
  keeps its speed through the clamp, as the plain version computes them
  in float32 (hypothesis-drawn values at and beyond the bounds);
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
# The replay kernel's order: per-env lists, G lanes per env
# ---------------------------------------------------------------------------


def _env_lists(on: torch.Tensor):
    """Each env's list of its active constraints (``on`` ``[C, B]``, the
    constraint's plain index first) in increasing index, padded with -1,
    and its length."""
    c = on.shape[0]
    idx = torch.arange(c)[:, None].expand_as(on)
    order = torch.where(on, idx, c + idx).argsort(0)
    length = on.sum(0)
    return torch.where(torch.arange(c)[:, None] < length, order, -1), length


def _warp_reduce(x: torch.Tensor, per_warp: int, op) -> torch.Tensor:
    """``op`` (max or any) over each warp's ``per_warp`` consecutive envs,
    one value per warp; the ragged tail's missing envs add nothing."""
    b = x.shape[-1]
    pad = x.new_zeros((*x.shape[:-1], (-b) % per_warp))
    return op(torch.cat([x, pad], -1).reshape(*x.shape[:-1], -1, per_warp), -1)


def _lists_solver(lanes: int, counts: dict):
    """The replay kernel's solve (csrc/futbol_step_lanes.cuh) in plain
    torch: envs in warps of 32 // ``lanes``; in each iteration every env
    walks its own list of active pairs in the plain (i, j) order, slot by
    slot up to the longest list of its warp, then its list of active
    walls in (w, i) order the same way; an env whose list has ended does
    nothing. Each update is the plain version's (physics._pair_update,
    _wall_update) on the env's own bodies, gathered per env. ``counts``
    tallies, per warp and substep, the slots walked (pairs + walls) and
    the union of the warp's envs' constraints, which the warp-union sweep
    runs."""
    per_warp = 32 // lanes

    def solve(px, py, vx, vy, params, dtype):
        mu = physics.physics_constants(params, dtype).mu
        n = len(px)
        k = physics._contact_setup(px, py, vx, vy, params, dtype)
        b = vx[0].shape[0]
        env = torch.arange(b)
        pair_on = torch.stack(k.pair_on)
        wall_on = torch.stack([k.wall_on[w][i] for w in range(4) for i in range(n)])
        plist, plen = _env_lists(pair_on)
        wlist, wlen = _env_lists(wall_on)
        p_slots = _warp_reduce(plen, per_warp, lambda x, d: x.max(d).values)
        w_slots = _warp_reduce(wlen, per_warp, lambda x, d: x.max(d).values)
        union = (_warp_reduce(pair_on, per_warp, lambda x, d: x.any(d)).sum(0)
                 + _warp_reduce(wall_on, per_warp, lambda x, d: x.any(d)).sum(0))
        counts["slots"].append(p_slots + w_slots)
        counts["union"].append(union)
        pi = torch.tensor([i for i, _ in k.pairs], dtype=torch.long)
        pj = torch.tensor([j for _, j in k.pairs], dtype=torch.long)
        rows = {name: torch.stack(getattr(k, name)) for name in (
            "nx", "ny", "nxi", "nyi", "nxj", "nyj", "bmv")}
        nkn = torch.tensor(k.nkn, dtype=dtype)
        wn = torch.stack([k.wn[w][i] for w in range(4) for i in range(n)])
        vxt, vyt = torch.stack(list(vx)), torch.stack(list(vy))
        jn, jt = torch.zeros_like(rows["nx"]), torch.zeros_like(rows["nx"])
        jv, jtv = torch.zeros_like(wn), torch.zeros_like(wn)

        for _ in range(params.solver_iterations):
            for slot in range(int(p_slots.max()) if b else 0):
                p = plist[slot]
                live = p >= 0
                q = p.clamp_min(0)
                i, j = pi[q], pj[q]
                kk = SimpleNamespace(pairs=[(0, 1)], nkn=[nkn[q]], **{
                    name: [r[q, env]] for name, r in rows.items()})
                lx, ly = [vxt[i, env], vxt[j, env]], [vyt[i, env], vyt[j, env]]
                a, t = physics._pair_update(kk, 0, lx, ly, jn[q, env], jt[q, env], mu)
                jn[q, env] = torch.where(live, a, jn[q, env])
                jt[q, env] = torch.where(live, t, jt[q, env])
                for body, nvx, nvy in ((i, lx[0], ly[0]), (j, lx[1], ly[1])):
                    vxt[body, env] = torch.where(live, nvx, vxt[body, env])
                    vyt[body, env] = torch.where(live, nvy, vyt[body, env])
            for slot in range(int(w_slots.max()) if b else 0):
                bit = wlist[slot]
                q = bit.clamp_min(0)
                w, i = q // n, q % n
                for wi in range(4):
                    live = (bit >= 0) & (w == wi)
                    wl = [[None] for _ in range(4)]
                    wl[wi][0] = wn[q, env]
                    lx, ly = [vxt[i, env]], [vyt[i, env]]
                    a, t = physics._wall_update(SimpleNamespace(wn=wl), wi, 0, lx, ly,
                                                jv[q, env], jtv[q, env], mu)
                    jv[q, env] = torch.where(live, a, jv[q, env])
                    jtv[q, env] = torch.where(live, t, jtv[q, env])
                    vxt[i, env] = torch.where(live, lx[0], vxt[i, env])
                    vyt[i, env] = torch.where(live, ly[0], vyt[i, env])
        return list(vxt), list(vyt)

    return solve


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("case", list(CASES))
def test_env_lists_equal_plain_step(case, lanes, dtype, monkeypatch):
    """The physics step with the replay kernel's solve order (per-env
    lists, 32 / G envs a warp) equals the plain step in every position
    and velocity, over two steps from contact states on a ragged batch;
    each warp walks no more slots than its envs' union holds, and fewer
    somewhere (both printed)."""
    params = CASES[case]
    b = 32 * 5 + 13
    pos, vel = contact_states(params, b, seed=len(case) + lanes)
    forces = random_forces(np.random.default_rng(5), params, b)
    n = params.n_bodies

    def rows(a, c):
        return [torch.from_numpy(a[:, i, c]).to(dtype) for i in range(n)]

    state = (rows(pos, 0), rows(pos, 1), rows(vel, 0), rows(vel, 1))
    fx, fy = rows(forces, 0), rows(forces, 1)
    plain, lists = state, state
    counts = {"slots": [], "union": []}
    for _ in range(2):
        plain = physics.physics_step_scalars(*plain, fx, fy, params, dtype)
        with monkeypatch.context() as m:
            m.setattr(physics, "_solve_contacts_scalar", _lists_solver(lanes, counts))
            lists = physics.physics_step_scalars(*lists, fx, fy, params, dtype)
        for name, a, c in zip(("px", "py", "vx", "vy"), plain, lists):
            for i in range(n):
                assert torch.equal(a[i], c[i]), f"{name}[{i}]"
    slots, union = torch.stack(counts["slots"]), torch.stack(counts["union"])
    print(f"{case} G={lanes}: per warp and substep, slots {slots.double().mean():.4g}, "
          f"union {union.double().mean():.4g}")
    assert bool((slots <= union).all()) and bool((slots < union).any())


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


# ---------------------------------------------------------------------------
# The replay kernel's skipped math is decided
# ---------------------------------------------------------------------------

_MARGIN = 2.0 ** -16     # kMargin in csrc/futbol_step_lanes.cuh
_F32 = torch.float32


def _f32(x):
    return torch.tensor(x, dtype=_F32)


def _bound(x, factor):
    """x * x * factor in float32, rounded at each product as the kernel
    forms its bounds."""
    x = _f32(x)
    return x * x * _f32(factor)


@settings(max_examples=400, deadline=None)
@given(case=st.sampled_from(["2v2", "custom"]), ball=st.booleans(),
       above=st.floats(0.0, 2.0 ** -8), ulps=st.integers(0, 64))
def test_far_pair_is_inactive(case, ball, above, ulps):
    """A pair whose squared distance (float32) is at least the kernel's
    far bound, (r_i + r_j)^2 (1 + 2^-16), is inactive as the plain set-up
    decides it (``pen = rr - d2 * (1 / sqrt(d2))`` in float32, at most
    0): the bound itself, a few ulps above it, and farther."""
    c = physics.physics_constants(CASES[case], _F32)
    rr = c.rr_bp if ball else c.rr_pp
    far = _bound(rr, 1.0 + _MARGIN)
    d2 = far * _f32(1.0 + above)
    for _ in range(ulps):
        d2 = torch.nextafter(d2, _f32(math.inf))
    d2 = d2.reshape(1)
    inv_d = physics._rsqrt(d2.clamp_min(physics._EPS2))
    pen = _f32(rr) - d2 * inv_d
    assert bool(d2 >= far) and not bool(physics._pair_active(pen))


@settings(max_examples=400, deadline=None)
@given(case=st.sampled_from(["2v2", "custom"]), below=st.floats(0.0, 1.0),
       ulps=st.integers(1, 64))
def test_slow_body_keeps_its_speed(case, below, ulps):
    """A body whose squared speed (float32) is below the kernel's slow
    bound, max_speed^2 (1 - 2^-16), gets the speed clamp's scale 1 as the
    plain integration computes it (``min(1, max_speed * (1 /
    sqrt(max(s2, 1e-12))))`` in float32): just under the bound, and down
    to 0."""
    c = physics.physics_constants(CASES[case], _F32)
    slow = _bound(c.max_speed, 1.0 - _MARGIN)
    s2 = slow * _f32(1.0 - below)
    for _ in range(ulps):
        s2 = torch.nextafter(s2, _f32(-math.inf))
    s2 = s2.clamp_min(0.0).reshape(1)
    scale = (c.max_speed * physics._rsqrt(s2.clamp_min(physics._EPS2))).clamp_max(1.0)
    assert bool(s2 < slow) and bool(scale == 1.0)
