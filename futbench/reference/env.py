"""The plain FutbolEnv step that the benchmark holds the program to.

A frozen copy of the scalar-SSA step (physics, game rules, shaped
rewards, kickoff and auto-reset) written out in plain PyTorch, with the
Philox4x32-10 stream that the kernels draw from. It imports nothing of
the program. Each per-body quantity is its own ``[S]`` tensor of the
sampled envs, in a Python list; the arithmetic is operation for
operation the published step's, so in float32 it reproduces the
kernels' bits.

Two changes from the copied text, neither of which moves a bit:

* The contact solver skips a constraint that is inactive in every env of
  the batch. An inactive update is a no-op up to the sign of a zero (the
  ``1e20`` sentinel clamps its impulse to 0), which the kernels skip too.
* The step takes the cosine and sine of the kick angle, and the kick
  angle comes from :func:`step_noise`, so that the transcendental
  functions run where the caller puts them: on the card, CUDA's
  ``logf``/``cosf``/``sinf`` round as the kernels' do, which the host's
  need not. The square root is taken in float64 and rounded, the
  nearest float as on the card (:func:`exact_sqrt`); everything else is
  +, -, *, / and comparisons, which IEEE rounds alike everywhere.

``ACTIVE`` counts the active constraints per env and substep over the
steps run since :func:`reset_active`: the shares the roofline counts use.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

N_CHOICES = 5
ACT_DASH, ACT_PRESS, ACT_PASS, ACT_SHOOT = 1, 2, 3, 4
_EPS2 = 1e-12
_BIG = 1e20
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Rewards:
    goal: float = 10.0
    concede: float = -10.0
    ball_to_goal_delta: float = 0.1
    player_to_ball_delta: float = 0.01
    possession_bonus: float = 0.001
    oob_penalty: float = -0.1
    time_penalty: float = 0.0


@dataclasses.dataclass(frozen=True)
class Params:
    """FutbolEnv's settings and their published defaults."""

    players_per_team: int = 2
    width: float = 600.0
    height: float = 400.0
    goal_size: float = 100.0
    player_radius: float = 15.0
    ball_radius: float = 10.0
    player_mass: float = 20.0
    ball_mass: float = 1.0
    player_elasticity: float = 0.2
    ball_elasticity: float = 0.6
    wall_elasticity: float = 0.8
    friction: float = 0.4
    dt: float = 0.1
    substeps: int = 5
    damping: float = 0.95
    solver_iterations: int = 10
    collision_slop: float = 0.1
    baumgarte: float = 0.2
    max_speed: float = 500.0
    move_force: float = 2000.0
    dash_multiplier: float = 2.5
    possession_radius: float = 40.0
    dribble_offset: float = 2.0
    pass_power: float = 300.0
    shoot_power: float = 600.0
    kick_noise: float = 0.05
    placement_noise: float = 0.02
    max_steps: int = 300
    rewards: Rewards = dataclasses.field(default_factory=Rewards)

    @classmethod
    def from_config(cls, players_per_team: int, overrides: dict) -> "Params":
        kw = dict(overrides)
        if "rewards" in kw:
            kw["rewards"] = Rewards(**kw["rewards"])
        return cls(players_per_team=players_per_team, **kw)

    @property
    def n_players(self) -> int:
        return 2 * self.players_per_team

    @property
    def n_bodies(self) -> int:
        return 1 + 2 * self.players_per_team

    @property
    def goal_y_lo(self) -> float:
        return (self.height - self.goal_size) / 2.0

    @property
    def goal_y_hi(self) -> float:
        return (self.height + self.goal_size) / 2.0


def obs_size(p: Params) -> int:
    return 4 * p.n_bodies + 2


def n_draws_per_step(p: Params) -> int:
    """A dir and an act per player, two for the kick angle's normal, an
    (x, y) kickoff draw per body."""
    return 2 * p.n_players + 2 + 2 * p.n_bodies


def _scalar(x: float, dtype) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float64).to(dtype)


def _r(x: float, dtype) -> float:
    return _scalar(x, dtype).item()


_CONSTS: dict = {}
_EXACT_SQRT = [True]


def exact_sqrt(on: bool) -> None:
    """Whether the step's square roots are IEEE-rounded (the card's and
    the kernels', computed here through float64) or the host library's
    float32 ``sqrt``, which is not always the nearest float: the program
    runs its plain version on the host only in the harness's tests."""
    _EXACT_SQRT[0] = on


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    if _EXACT_SQRT[0]:
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def constants(p: Params, dtype) -> SimpleNamespace:
    key = (p, dtype)
    if key in _CONSTS:
        return _CONSTS[key]
    dt_sub = p.dt / p.substeps
    inv_ball = _scalar(1.0 / p.ball_mass, dtype)
    inv_player = _scalar(1.0 / p.player_mass, dtype)
    e_ball = _scalar(p.ball_elasticity, dtype)
    e_player = _scalar(p.player_elasticity, dtype)
    wall_e = _scalar(p.wall_elasticity, dtype)
    one = _scalar(1.0, dtype)
    c = SimpleNamespace(
        dt_sub=_r(dt_sub, dtype),
        damp=(_scalar(p.damping, dtype) ** _scalar(dt_sub, dtype)).item(),
        max_speed=_r(p.max_speed, dtype),
        inv_m_ball=inv_ball.item(), inv_m_player=inv_player.item(),
        r_ball=_r(p.ball_radius, dtype), r_player=_r(p.player_radius, dtype),
        rr_bp=(_scalar(p.ball_radius, dtype) + _scalar(p.player_radius, dtype)).item(),
        rr_pp=(_scalar(p.player_radius, dtype) + _scalar(p.player_radius, dtype)).item(),
        nkn_bp=(-(one / (inv_ball + inv_player))).item(),
        nkn_pp=(-(one / (inv_player + inv_player))).item(),
        e_bp=(e_ball * e_player).item(), e_pp=(e_player * e_player).item(),
        ew_ball=(e_ball * wall_e).item(), ew_player=(e_player * wall_e).item(),
        mu=_r(p.friction, dtype), slop=_r(p.collision_slop, dtype),
        bias_coef=_r(p.baumgarte / dt_sub, dtype),
        width=_r(p.width, dtype), height=_r(p.height, dtype),
        goal_y_lo=_r(p.goal_y_lo, dtype), goal_y_hi=_r(p.goal_y_hi, dtype),
    )
    _CONSTS[key] = c
    return c


# ---------------------------------------------------------------------------
# Philox4x32-10 and the draws
# ---------------------------------------------------------------------------


def _mulhilo(a: torch.Tensor, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on uint32 values in int64."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, n_steps: int, n_draws: int,
                    envs: torch.Tensor) -> torch.Tensor:
    """The kernels' draws for steps 0..T-1 of the envs ``envs`` (global
    indices, int64): f32 ``[T, n_draws, S]``. Counter (env, step, group,
    0), key (seed, 0); draw d is word d % 4 of group d // 4, as ``(bits
    >> 8) * 2**-24``."""
    groups = (n_draws + 3) // 4
    s = envs.numel()
    c0 = envs.reshape(1, 1, s).expand(n_steps, groups, s)
    c1 = torch.arange(n_steps, dtype=torch.int64).reshape(-1, 1, 1).expand_as(c0) & _MASK32
    c2 = torch.arange(groups, dtype=torch.int64).reshape(1, -1, 1).expand_as(c0)
    words = philox4x32_10(c0, c1, c2, torch.zeros_like(c0), seed & _MASK32, 0)
    bits = torch.stack(words, 2).reshape(n_steps, 4 * groups, s)[:, :n_draws]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def step_noise(u: torch.Tensor, p: Params, first: int, device) -> tuple:
    """The env's draws from uniforms ``[T, n_draws, S]`` whose env draws
    start at row ``first``: (cos and sin of the kick angle ``[T, S]``,
    kickoff noise x and y ``[T, n_bodies, S]``), the angle's normal by
    Box-Muller. The transcendentals run on ``device``."""
    n = p.n_bodies
    u1 = u[:, first].to(device).clamp_min(_r(1e-7, torch.float32))
    u2 = u[:, first + 1].to(device)
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        _r(2.0 * math.pi, torch.float32) * u2)
    theta = normal * _r(p.kick_noise, torch.float32)
    cos_t, sin_t = torch.cos(theta).to(u.device), torch.sin(theta).to(u.device)
    nx = u[:, first + 2:first + 2 + n] * 2.0 - 1.0
    ny = u[:, first + 2 + n:first + 2 + 2 * n] * 2.0 - 1.0
    return cos_t, sin_t, nx, ny


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

ACTIVE = {"pairs": 0.0, "walls": 0.0, "env_substeps": 0}


def reset_active() -> None:
    ACTIVE.update(pairs=0.0, walls=0.0, env_substeps=0)


def _dir_unit(d, dtype):
    zero = torch.zeros_like(d, dtype=dtype)
    ux = torch.where(d == 2, 1.0, torch.where(d == 4, -1.0, zero))
    uy = torch.where(d == 1, 1.0, torch.where(d == 3, -1.0, zero))
    return ux, uy


def _full(like, v):
    return torch.full_like(like, v)


def _forces(dirs, acts, p: Params, dtype):
    mf = _r(p.move_force, dtype)
    mfd = _r(p.move_force * p.dash_multiplier, dtype)
    zero = torch.zeros_like(dirs[0], dtype=dtype)
    fx, fy = [zero], [zero]
    for q in range(p.n_players):
        ux, uy = _dir_unit(dirs[q], dtype)
        mag = torch.where(acts[q] == ACT_DASH, mfd, _full(ux, mf))
        fx.append(ux * mag)
        fy.append(uy * mag)
    return fx, fy


def _possession(px, py, poss, acts, p: Params, dtype):
    bx, by = px[0], py[0]
    radius = _r(p.possession_radius, dtype)
    big = torch.finfo(dtype).max
    d, within, bids = [], [], []
    for q in range(p.n_players):
        dx = px[1 + q] - bx
        dy = py[1 + q] - by
        dq = _sqrt(dx * dx + dy * dy)
        w = dq <= radius
        d.append(dq)
        within.append(w)
        bids.append((acts[q] == ACT_PRESS) & w)
    best = torch.zeros_like(poss)
    best_d = torch.where(bids[0], d[0], big)
    any_bid = bids[0]
    for q in range(1, p.n_players):
        bd = torch.where(bids[q], d[q], big)
        take = bd < best_d
        best = torch.where(take, q, best)
        best_d = torch.where(take, bd, best_d)
        any_bid = any_bid | bids[q]
    owner = poss - 1
    owner_within = within[0].to(torch.int32)
    for q in range(1, p.n_players):
        owner_within = torch.where(owner == q, within[q].to(torch.int32), owner_within)
    keep = torch.where((poss > 0) & (owner_within > 0), poss, -1)
    return torch.where(any_bid, best + 1, keep)


def _kick(px, py, poss, acts, cos_t, sin_t, p: Params, dtype):
    ppt, n_players = p.players_per_team, p.n_players
    eps = _r(1e-9, dtype)
    bx, by = px[0], py[0]
    has_owner = poss > 0
    owner_p = torch.clamp(poss - 1, 0, n_players - 1)
    owner_act = acts[0]
    for q in range(1, n_players):
        owner_act = torch.where(owner_p == q, acts[q], owner_act)
    do_pass = has_owner & (owner_act == ACT_PASS)
    do_shoot = has_owner & (owner_act == ACT_SHOOT)
    ox, oy = px[0], py[0]
    for b in range(1, n_players + 1):
        ox = torch.where(poss == b, px[b], ox)
        oy = torch.where(poss == b, py[b], oy)
    owner_team = (owner_p >= ppt).to(torch.int32)
    goal_x = torch.where(owner_team == 0, _full(bx, _r(p.width, dtype)), 0.0)
    sdx = goal_x - bx
    sdy = _r(p.height / 2.0, dtype) - by
    snorm = _sqrt(sdx * sdx + sdy * sdy).clamp_min(eps)
    sdx, sdy = sdx / snorm, sdy / snorm
    big = torch.finfo(dtype).max
    mate_d = _full(bx, big)
    mx, my = px[1], py[1]
    has_mate = torch.zeros_like(has_owner)
    for q in range(n_players):
        team_q = 1 if q >= ppt else 0
        dx = px[1 + q] - ox
        dy = py[1 + q] - oy
        dq = _sqrt(dx * dx + dy * dy)
        is_mate = (owner_team == team_q) & (owner_p != q)
        dq = torch.where(is_mate, dq, big)
        take = dq < mate_d
        mx = torch.where(take, px[1 + q], mx)
        my = torch.where(take, py[1 + q], my)
        mate_d = torch.where(take, dq, mate_d)
        has_mate = has_mate | is_mate
    pdx = mx - bx
    pdy = my - by
    pnorm = _sqrt(pdx * pdx + pdy * pdy).clamp_min(eps)
    pdx, pdy = pdx / pnorm, pdy / pnorm
    pdx = torch.where(has_mate, pdx, sdx)
    pdy = torch.where(has_mate, pdy, sdy)
    c, s = cos_t, sin_t
    kdx = torch.where(do_shoot, c * sdx - s * sdy, c * pdx - s * pdy)
    kdy = torch.where(do_shoot, s * sdx + c * sdy, s * pdx + c * pdy)
    power = torch.where(do_shoot, _r(p.shoot_power, dtype),
                        _full(bx, _r(p.pass_power, dtype)))
    kicked = do_pass | do_shoot
    impulse = torch.where(kicked, power, 0.0)
    bm = _full(bx, _r(p.ball_mass, dtype))
    dvx = torch.where(kicked, kdx * impulse / bm, 0.0)
    dvy = torch.where(kicked, kdy * impulse / bm, 0.0)
    return dvx, dvy, torch.where(kicked, -1, poss)


_TABLES: dict = {}


def _tables(p: Params, dtype, device):
    """Per-pair and per-body constants as columns, for the set-up's
    batched form: (pair i, pair j, r_i + r_j, e_i e_j, -k_n, radii,
    inverse masses, wall restitutions)."""
    key = (p, dtype, str(device))
    if key not in _TABLES:
        c = constants(p, dtype)
        n = p.n_bodies
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]

        def col(values):
            return torch.tensor(values, dtype=dtype, device=device)[:, None]

        _TABLES[key] = SimpleNamespace(
            pairs=pairs,
            i=torch.tensor([i for i, _ in pairs], device=device),
            j=torch.tensor([j for _, j in pairs], device=device),
            rr=col([c.rr_bp if i == 0 else c.rr_pp for i, _ in pairs]),
            e=col([c.e_bp if i == 0 else c.e_pp for i, _ in pairs]),
            nkn=[c.nkn_bp if i == 0 else c.nkn_pp for i, _ in pairs],
            radii=col([c.r_ball] + [c.r_player] * (n - 1)),
            inv_m=[c.inv_m_ball] + [c.inv_m_player] * (n - 1),
            e_wall=col([c.ew_ball] + [c.ew_player] * (n - 1)))
    return _TABLES[key]


def _solve(px, py, vx, vy, p: Params, dtype):
    """One substep's contact set-up (every pair and wall at once, each
    element by the published operations) and sequential-impulse sweeps
    over the constraints active in some env, in the published order."""
    c = constants(p, dtype)
    tb = _tables(p, dtype, px[0].device)
    inv_m = tb.inv_m
    PX, PY, VX, VY = (torch.stack(x) for x in (px, py, vx, vy))
    vx, vy = list(vx), list(vy)
    zl = torch.zeros_like(vx[0])
    dpx = PX[tb.j] - PX[tb.i]
    dpy = PY[tb.j] - PY[tb.i]
    d2 = dpx * dpx + dpy * dpy
    inv_d = _sqrt(d2.clamp_min(_EPS2)).reciprocal()
    dist = d2 * inv_d
    pen = tb.rr - dist
    on = pen > 0
    pk = []
    for p_ in torch.nonzero(on.any(1)).flatten().tolist():
        i, j = tb.pairs[p_]
        nx = dpx[p_] * inv_d[p_]
        ny = dpy[p_] * inv_d[p_]
        vrn0 = (vx[j] - vx[i]) * nx + (vy[j] - vy[i]) * ny
        bounce = tb.e[p_] * vrn0.clamp_max(0.0)
        vbias = c.bias_coef * (pen[p_] - c.slop).clamp_min(0.0)
        pk.append(SimpleNamespace(
            i=i, j=j, nx=nx, ny=ny, nxi=nx * inv_m[i], nyi=ny * inv_m[i],
            nxj=nx * inv_m[j], nyj=ny * inv_m[j], nkn=tb.nkn[p_],
            bmv=torch.where(on[p_], bounce - vbias, _BIG), jn=zl, jt=zl))
    ACTIVE["pairs"] += on.sum().item()
    # walls [bottom, top, left, right] x bodies; the ball passes through
    # the goal mouth
    d = torch.stack([tb.radii - PY, tb.radii - (c.height - PY),
                     tb.radii - PX, tb.radii - (c.width - PX)])
    in_mouth = (py[0] >= c.goal_y_lo) & (py[0] <= c.goal_y_hi)
    d[2, 0] = torch.where(in_mouth, -1.0, d[2, 0])
    d[3, 0] = torch.where(in_mouth, -1.0, d[3, 0])
    won = d > 0
    wk = []
    vrn0_w = torch.stack([VY, -VY, VX, -VX])
    for wi, i in torch.nonzero(won.any(2)).tolist():
        wbounce = tb.e_wall[i] * vrn0_w[wi, i].clamp_max(0.0)
        wvbias = c.bias_coef * (d[wi, i] - c.slop).clamp_min(0.0)
        wk.append(SimpleNamespace(wi=wi, i=i, wn=torch.where(
            won[wi, i], wvbias - wbounce, -_BIG), jv=zl, jt=zl))
    ACTIVE["walls"] += won.sum().item()
    ACTIVE["env_substeps"] += px[0].numel()
    mu = c.mu
    for _ in range(p.solver_iterations):
        for k in pk:
            i, j = k.i, k.j
            vrn = (vx[j] - vx[i]) * k.nx + (vy[j] - vy[i]) * k.ny
            jn_new = (k.jn + k.nkn * (vrn + k.bmv)).clamp_min(0.0)
            dj = jn_new - k.jn
            vx[i] = vx[i] - dj * k.nxi
            vy[i] = vy[i] - dj * k.nyi
            vx[j] = vx[j] + dj * k.nxj
            vy[j] = vy[j] + dj * k.nyj
            vrt = (vy[j] - vy[i]) * k.nx - (vx[j] - vx[i]) * k.ny
            djt = k.nkn * vrt
            lim = mu * jn_new
            jt_new = torch.clamp(k.jt + djt, min=-lim, max=lim)
            djt = jt_new - k.jt
            vx[i] = vx[i] + djt * k.nyi
            vy[i] = vy[i] - djt * k.nxi
            vx[j] = vx[j] - djt * k.nyj
            vy[j] = vy[j] + djt * k.nxj
            k.jn, k.jt = jn_new, jt_new
        for k in wk:
            wi, i = k.wi, k.i
            if wi == 0:
                dv0 = k.wn - vy[i]
            elif wi == 1:
                dv0 = k.wn + vy[i]
            elif wi == 2:
                dv0 = k.wn - vx[i]
            else:
                dv0 = k.wn + vx[i]
            jv_new = (k.jv + dv0).clamp_min(0.0)
            dv = jv_new - k.jv
            if wi == 0:
                vy[i] = vy[i] + dv
                dvt0 = vx[i]
            elif wi == 1:
                vy[i] = vy[i] - dv
                dvt0 = -vx[i]
            elif wi == 2:
                vx[i] = vx[i] + dv
                dvt0 = -vy[i]
            else:
                vx[i] = vx[i] - dv
                dvt0 = vy[i]
            limv = mu * jv_new
            jt_new = torch.clamp(k.jt + dvt0, min=-limv, max=limv)
            dvt = jt_new - k.jt
            if wi == 0:
                vx[i] = vx[i] - dvt
            elif wi == 1:
                vx[i] = vx[i] + dvt
            elif wi == 2:
                vy[i] = vy[i] + dvt
            else:
                vy[i] = vy[i] - dvt
            k.jv, k.jt = jv_new, jt_new
    return vx, vy


def _physics(px, py, vx, vy, fx, fy, p: Params, dtype):
    c = constants(p, dtype)
    n = len(px)
    inv_m = [c.inv_m_ball] + [c.inv_m_player] * (n - 1)
    px, py, vx, vy = list(px), list(py), list(vx), list(vy)
    for _ in range(p.substeps):
        for i in range(n):
            nvx = vx[i] * c.damp + fx[i] * inv_m[i] * c.dt_sub
            nvy = vy[i] * c.damp + fy[i] * inv_m[i] * c.dt_sub
            s2 = nvx * nvx + nvy * nvy
            scale = (c.max_speed * _sqrt(s2.clamp_min(_EPS2)).reciprocal()
                     ).clamp_max(1.0)
            vx[i] = nvx * scale
            vy[i] = nvy * scale
        vx, vy = _solve(px, py, vx, vy, p, dtype)
        for i in range(n):
            px[i] = px[i] + vx[i] * c.dt_sub
            py[i] = py[i] + vy[i] * c.dt_sub
    return px, py, vx, vy


def _dribble(px, py, vx, vy, poss, dirs, p: Params, dtype):
    ppt, n_players = p.players_per_team, p.n_players
    has_owner = poss > 0
    owner_p = torch.clamp(poss - 1, 0, n_players - 1)
    direction = dirs[0]
    for q in range(1, n_players):
        direction = torch.where(owner_p == q, dirs[q], direction)
    ux, uy = _dir_unit(direction, dtype)
    owner_team = (owner_p >= ppt).to(torch.int32)
    fbx = torch.where(owner_team == 0, 1.0, _full(ux, -1.0))
    moving = (ux != 0) | (uy != 0)
    cdx = torch.where(moving, ux, fbx)
    cdy = torch.where(moving, uy, 0.0)
    ox, oy, ovx, ovy = px[0], py[0], vx[0], vy[0]
    for b in range(1, n_players + 1):
        is_b = poss == b
        ox = torch.where(is_b, px[b], ox)
        oy = torch.where(is_b, py[b], oy)
        ovx = torch.where(is_b, vx[b], ovx)
        ovy = torch.where(is_b, vy[b], ovy)
    off = _r(p.player_radius + p.ball_radius + p.dribble_offset, dtype)
    return (torch.where(has_owner, ox + cdx * off, px[0]),
            torch.where(has_owner, oy + cdy * off, py[0]),
            torch.where(has_owner, ovx, vx[0]),
            torch.where(has_owner, ovy, vy[0]))


def _clamp_oob(px, py, vx, vy, p: Params, dtype):
    w, h = _scalar(p.width, dtype), _scalar(p.height, dtype)
    px, py, vx, vy = list(px), list(py), list(vx), list(vy)
    in_mouth = (py[0] >= _r(p.goal_y_lo, dtype)) & (py[0] <= _r(p.goal_y_hi, dtype))
    clamped = None
    for i in range(len(px)):
        r = _scalar(p.ball_radius if i == 0 else p.player_radius, dtype)
        cx = torch.clamp(px[i], r.item(), (w - r).item())
        cy = torch.clamp(py[i], r.item(), (h - r).item())
        if i == 0:
            cx = torch.where(in_mouth, px[0], cx)
        moved_x = torch.abs(cx - px[i]) > 0
        moved_y = torch.abs(cy - py[i]) > 0
        vx[i] = torch.where(moved_x, 0.0, vx[i])
        vy[i] = torch.where(moved_y, 0.0, vy[i])
        px[i], py[i] = cx, cy
        if i == 0:
            clamped = moved_x | moved_y
    return px, py, vx, vy, clamped


def kickoff(nx, ny, p: Params, dtype):
    """Kickoff placement from per-body noise rows in [-1, 1): (px, py)."""
    w, h, ppt = p.width, p.height, p.players_per_team
    amp = _r(p.placement_noise * h, dtype)
    px = [_r(w / 2.0, dtype) + nx[0] * amp]
    py = [_r(h / 2.0, dtype) + ny[0] * amp]
    for team, base_x in ((0, w / 4.0), (1, 3.0 * w / 4.0)):
        for k in range(ppt):
            b = 1 + team * ppt + k
            px.append(_r(base_x, dtype) + nx[b] * amp)
            py.append(_r((k + 1.0) * (h / (ppt + 1.0)), dtype) + ny[b] * amp)
    return px, py


def _rewards(px0, py0, px1, py1, poss, goal0, goal1, clamped, p: Params, dtype):
    rc, ppt = p.rewards, p.players_per_team
    goals = (goal0, goal1)
    like = px1[0]

    def goal_dist(bx, by, team):
        dx = bx - _r(p.width if team == 0 else 0.0, dtype)
        dy = by - _r(p.height / 2.0, dtype)
        return _sqrt(dx * dx + dy * dy)

    def nearest(px, py, team):
        best = None
        for b in range(1 + team * ppt, 1 + (team + 1) * ppt):
            dx = px[b] - px[0]
            dy = py[b] - py[0]
            d = _sqrt(dx * dx + dy * dy)
            best = d if best is None else torch.minimum(best, d)
        return best

    out = []
    for team in (0, 1):
        r = _full(like, _r(rc.time_penalty, dtype))
        r = r + torch.where(goals[team], _full(like, _r(rc.goal, dtype)), 0.0)
        r = r + torch.where(goals[1 - team], _full(like, _r(rc.concede, dtype)), 0.0)
        r = r + _r(rc.ball_to_goal_delta, dtype) * (
            goal_dist(px0[0], py0[0], team) - goal_dist(px1[0], py1[0], team))
        r = r + _r(rc.player_to_ball_delta, dtype) * (
            nearest(px0, py0, team) - nearest(px1, py1, team))
        owner = poss - 1
        owns = (poss > 0) & ((owner >= team * ppt) & (owner < (team + 1) * ppt))
        r = r + torch.where(owns, _full(like, _r(rc.possession_bonus, dtype)), 0.0)
        r = r + torch.where(clamped, _full(like, _r(rc.oob_penalty, dtype)), 0.0)
        out.append(r)
    return out[0], out[1]


class State(NamedTuple):
    """Per-body lists of ``[S]`` rows, then possession, scores and clock."""

    px: list
    py: list
    vx: list
    vy: list
    poss: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    t: torch.Tensor


def state_from_packed(sf: torch.Tensor, si: torch.Tensor, n: int, dtype=torch.float32):
    """(statef ``[4n, S]``, statei ``[4, S]``) -> :class:`State`."""
    sf = sf.to(dtype)
    rows = [sf[k].clone() for k in range(4 * n)]
    return State(rows[:n], rows[n:2 * n], rows[2 * n:3 * n], rows[3 * n:],
                 *(si[k].to(torch.int32).clone() for k in range(4)))


def packed(s: State):
    return (torch.stack(s.px + s.py + s.vx + s.vy).float(),
            torch.stack([s.poss, s.s0, s.s1, s.t]).to(torch.int32))


def step(s: State, dirs, acts, cos_t, sin_t, nx, ny, p: Params):
    """One env step with auto-reset. Returns (state, r0, r1, done)."""
    dtype = s.px[0].dtype
    n = p.n_bodies
    px, py, vx, vy = list(s.px), list(s.py), list(s.vx), list(s.vy)
    px0, py0 = list(px), list(py)
    fx, fy = _forces(dirs, acts, p, dtype)
    poss = _possession(px, py, s.poss, acts, p, dtype)
    dvx, dvy, poss = _kick(px, py, poss, acts, cos_t.to(dtype), sin_t.to(dtype),
                           p, dtype)
    vx[0] = vx[0] + dvx
    vy[0] = vy[0] + dvy
    px, py, vx, vy = _physics(px, py, vx, vy, fx, fy, p, dtype)
    px[0], py[0], vx[0], vy[0] = _dribble(px, py, vx, vy, poss, dirs, p, dtype)
    in_mouth = (py[0] >= _r(p.goal_y_lo, dtype)) & (py[0] <= _r(p.goal_y_hi, dtype))
    goal0 = (px[0] > _r(p.width, dtype)) & in_mouth
    goal1 = (px[0] < 0.0) & in_mouth
    px, py, vx, vy, clamped = _clamp_oob(px, py, vx, vy, p, dtype)
    r0, r1 = _rewards(px0, py0, px, py, poss, goal0, goal1, clamped, p, dtype)
    kox, koy = kickoff([x.to(dtype) for x in nx], [y.to(dtype) for y in ny], p, dtype)
    any_goal = goal0 | goal1
    for i in range(n):
        px[i] = torch.where(any_goal, kox[i], px[i])
        py[i] = torch.where(any_goal, koy[i], py[i])
        vx[i] = torch.where(any_goal, 0.0, vx[i])
        vy[i] = torch.where(any_goal, 0.0, vy[i])
    poss = torch.where(any_goal, -1, poss)
    s0 = s.s0 + goal0.to(torch.int32)
    s1 = s.s1 + goal1.to(torch.int32)
    t = s.t + 1
    done = t >= p.max_steps
    out = State(
        [torch.where(done, k, x) for k, x in zip(kox, px)],
        [torch.where(done, k, y) for k, y in zip(koy, py)],
        [torch.where(done, 0.0, v) for v in vx],
        [torch.where(done, 0.0, v) for v in vy],
        torch.where(done, -1, poss), torch.where(done, 0, s0),
        torch.where(done, 0, s1), torch.where(done, 0, t))
    return out, r0, r1, done


def mirror_dir(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 2, 4, torch.where(d == 4, 2, d))


def observation(s: State, p: Params, mirror: bool) -> torch.Tensor:
    """One view's observation ``[F, S]`` in float32: positions times the
    f32 reciprocals of the field size, velocities times 1/max_speed, the
    two possession flags; team 1's view mirrored (x -> 1 - x, vx -> -vx,
    team blocks and flags swapped)."""
    ppt = p.players_per_team
    f32 = torch.float32
    inv_w, inv_h = _r(1.0 / p.width, f32), _r(1.0 / p.height, f32)
    inv_s = _r(1.0 / p.max_speed, f32)
    order = list(range(p.n_bodies))
    if mirror:
        order = [0, *range(1 + ppt, 1 + 2 * ppt), *range(1, 1 + ppt)]
    px, py, vx, vy = ([x.float() for x in rows] for rows in (s.px, s.py, s.vx, s.vy))
    rows = []
    for i in order:
        x = px[i] * inv_w
        rows += [1.0 - x if mirror else x, py[i] * inv_h]
    for i in order:
        v = vx[i] * inv_s
        rows += [-v if mirror else v, vy[i] * inv_s]
    owner = s.poss - 1
    owns0 = ((s.poss > 0) & (owner < ppt)).to(f32)
    owns1 = ((s.poss > 0) & (owner >= ppt)).to(f32)
    rows += [owns1, owns0] if mirror else [owns0, owns1]
    return torch.stack(rows)


def initial_state(generator: torch.Generator, p: Params, n_envs: int, device):
    """The benchmark's starting batch, made on ``device`` from
    ``generator`` in two calls: every env at a kickoff placement with
    its clock drawn uniformly from [0, max_steps), so that episodes end
    spread over the steps. Returns packed (statef ``[4n, B]``, statei
    ``[4, B]``)."""
    n = p.n_bodies
    noise = torch.rand((2 * n, n_envs), generator=generator, device=device) * 2.0 - 1.0
    t = torch.randint(0, p.max_steps, (n_envs,), generator=generator,
                      device=device, dtype=torch.int32)
    px, py = kickoff(list(noise[:n]), list(noise[n:]), p, torch.float32)
    zero = torch.zeros((2 * n, n_envs), device=device)
    sf = torch.cat([torch.stack(px), torch.stack(py), zero]).contiguous()
    minus = torch.full((n_envs,), -1, dtype=torch.int32, device=device)
    si = torch.stack([minus, torch.zeros_like(t), torch.zeros_like(t), t]).contiguous()
    return sf, si


def randint5(u: torch.Tensor) -> torch.Tensor:
    """A uniform int in [0, 5) from a uniform [0, 1) draw."""
    return torch.floor(u * 5.0).to(torch.int32)


def random_rollout(sf, si, seed: int, p: Params, n_steps: int,
                   envs: torch.Tensor, math_device="cpu", dtype=torch.float32):
    """The random-policy rollout of the envs ``envs`` (global indices)
    from packed state columns ``sf`` ``[4n, S]``, ``si`` ``[4, S]``, with
    the kernels' Philox stream keyed by ``seed``: per step, a direction
    and an act per player, the kick angle and the kickoff noise. Returns
    (statef, statei, team-0 rewards ``[T, S]``)."""
    n_pl = p.n_players
    u = philox_uniforms(seed, n_steps, n_draws_per_step(p), envs).to(sf.device)
    cos_t, sin_t, nx, ny = step_noise(u, p, 2 * n_pl, math_device)
    s = state_from_packed(sf, si, p.n_bodies, dtype)
    rewards = []
    for k in range(n_steps):
        dirs = [randint5(u[k, q]) for q in range(n_pl)]
        acts = [randint5(u[k, n_pl + q]) for q in range(n_pl)]
        s, r0, _, _ = step(s, dirs, acts, cos_t[k], sin_t[k], list(nx[k]),
                           list(ny[k]), p)
        rewards.append(r0.float())
    return (*packed(s), torch.stack(rewards))
