"""Game logic for FutbolEnv in PyTorch: actions, possession, kicks, goals,
rewards.

Counterpart of :mod:`gym_futbol_tpu.game`, whose module docstring holds
the normative ACTION and GOAL specs. Every function here is branch-free.
The ``*_scalars`` forms, which the env step runs, take per-body and
per-player quantities as ``[B]`` tensors in Python lists. Selections by
a dynamic index (the owner's position, action or direction) are chains
of ``torch.where`` over the static indices, never a gather, so an
out-of-range action int decodes as the JAX package decodes it
(direction (0, 0), a plain move).

The array forms (:func:`decode_forces`, :func:`update_possession`,
:func:`apply_kick`, :func:`apply_dribble`, :func:`detect_goal`,
:func:`clamp_oob`, :func:`kickoff_positions`, :func:`shaped_rewards`)
are the JAX package's per-env API under its names and argument orders,
each a wrapper over its scalar form: positions and velocities ``[...,
n_bodies, 2]``, actions ``[..., n_players, 2]``, possession ``[...]``.
One env (no leading dims) and any batch go through the same code, and
the results have JAX's shapes with the batch dims in front. Where JAX
draws from a key, these take the drawn noise.
"""

from __future__ import annotations

import torch

from .physics import dtype_scalar, split_xy, stack_xy, to_dtype
from .types import EnvParams

ACT_NOOP, ACT_DASH, ACT_PRESS, ACT_PASS, ACT_SHOOT = 0, 1, 2, 3, 4


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


# ---------------------------------------------------------------------------
# Action decoding -> forces
# ---------------------------------------------------------------------------


def _dir_unit(direction: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Direction index -> unit vector, branch-free (no table gather)."""
    zero = torch.zeros(direction.shape, dtype=dtype, device=direction.device)
    ux = torch.where(direction == 2, 1.0, torch.where(direction == 4, -1.0, zero))
    uy = torch.where(direction == 1, 1.0, torch.where(direction == 3, -1.0, zero))
    return ux, uy


def decode_forces_scalars(
    dirs: list, acts: list, params: EnvParams, dtype
) -> tuple[list, list]:
    """Per-body force lists (fx, fy), ball first (zero). ``dirs``/``acts``
    are per-player int ``[B]`` tensors."""
    mf = to_dtype(params.move_force, dtype)
    mfd = to_dtype(params.move_force * params.dash_multiplier, dtype)
    zero = torch.zeros(dirs[0].shape, dtype=dtype, device=dirs[0].device)
    fx, fy = [zero], [zero]
    for p in range(params.n_players):
        ux, uy = _dir_unit(dirs[p], dtype)
        mag = torch.where(acts[p] == ACT_DASH, mfd, _full(ux, mf))
        fx.append(ux * mag)
        fy.append(uy * mag)
    return fx, fy


def split_actions(actions: torch.Tensor, params: EnvParams) -> tuple[list, list]:
    """``[..., n_players, 2]`` action tensor -> (dirs, acts) per-player
    lists of ``[...]`` tensors."""
    n_players = params.n_players
    dirs = [actions[..., p, 0] for p in range(n_players)]
    acts = [actions[..., p, 1] for p in range(n_players)]
    return dirs, acts


def decode_forces(actions: torch.Tensor, params: EnvParams, dtype) -> torch.Tensor:
    """``[..., n_players, 2]`` int actions -> ``[..., n_bodies, 2]`` forces
    (the ball's row zero). Array form of :func:`decode_forces_scalars`."""
    return stack_xy(*decode_forces_scalars(*split_actions(actions, params),
                                           params, dtype))


# ---------------------------------------------------------------------------
# Possession
# ---------------------------------------------------------------------------


def update_possession_scalars(
    px: list, py: list, possession: torch.Tensor, acts: list,
    params: EnvParams, dtype,
) -> torch.Tensor:
    """Resolve possession bids: the nearest bidder within reach wins, ties
    to the lowest index (strict ``<``); an owner out of reach loses the
    ball. Returns the new owner body index (int32, -1 = loose)."""
    n_players = params.n_players
    bx, by = px[0], py[0]
    radius = to_dtype(params.possession_radius, dtype)
    big = torch.finfo(dtype).max

    d, within, bids = [], [], []
    for p in range(n_players):
        dx = px[1 + p] - bx
        dy = py[1 + p] - by
        dp = torch.sqrt(dx * dx + dy * dy)
        w = dp <= radius
        d.append(dp)
        within.append(w)
        bids.append((acts[p] == ACT_PRESS) & w)

    best = torch.zeros_like(possession)
    best_d = torch.where(bids[0], d[0], big)
    any_bid = bids[0]
    for p in range(1, n_players):
        bd = torch.where(bids[p], d[p], big)
        take = bd < best_d
        best = torch.where(take, p, best)
        best_d = torch.where(take, bd, best_d)
        any_bid = any_bid | bids[p]
    bid_winner = best + 1

    owner_player = possession - 1
    owner_within = within[0].to(torch.int32)
    for p in range(1, n_players):
        owner_within = torch.where(
            owner_player == p, within[p].to(torch.int32), owner_within
        )
    keep = torch.where((possession > 0) & (owner_within > 0), possession, -1)
    return torch.where(any_bid, bid_winner, keep)


def update_possession(state_pos: torch.Tensor, possession: torch.Tensor,
                      actions: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """The new owner ``[...]`` (int32, -1 loose) from positions ``[...,
    n_bodies, 2]``, the owner ``[...]`` and actions ``[..., n_players,
    2]``. Array form of :func:`update_possession_scalars`."""
    _, acts = split_actions(actions, params)
    return update_possession_scalars(*split_xy(state_pos), possession, acts,
                                     params, state_pos.dtype)


# ---------------------------------------------------------------------------
# Kicks (pass / shoot)
# ---------------------------------------------------------------------------


def apply_kick_scalars(
    px: list, py: list, vx: list, vy: list, possession: torch.Tensor,
    acts: list, theta: torch.Tensor, params: EnvParams, dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The owner's pass/shoot. ``theta`` is the drawn angular noise,
    already scaled by ``kick_noise``. Returns (ball dvx, ball dvy, new
    possession)."""
    ppt = params.players_per_team
    n_players = params.n_players
    eps = to_dtype(1e-9, dtype)
    bx, by = px[0], py[0]

    has_owner = possession > 0
    owner_p = torch.clamp(possession - 1, 0, n_players - 1)
    owner_act = acts[0]
    for p in range(1, n_players):
        owner_act = torch.where(owner_p == p, acts[p], owner_act)
    do_pass = has_owner & (owner_act == ACT_PASS)
    do_shoot = has_owner & (owner_act == ACT_SHOOT)

    # owner position; the ball's row when unowned
    ox, oy = px[0], py[0]
    for b in range(1, n_players + 1):
        ox = torch.where(possession == b, px[b], ox)
        oy = torch.where(possession == b, py[b], oy)
    owner_team = (owner_p >= ppt).to(torch.int32)

    # shoot target: the opponent goal mouth's center
    goal_x = torch.where(
        owner_team == 0, _full(bx, to_dtype(params.width, dtype)), 0.0
    )
    sdx = goal_x - bx
    sdy = to_dtype(params.height / 2.0, dtype) - by
    snorm = torch.sqrt(sdx * sdx + sdy * sdy).clamp_min(eps)
    sdx, sdy = sdx / snorm, sdy / snorm

    # pass target: the owner's nearest teammate (strict < keeps the
    # earlier index on ties)
    big = torch.finfo(dtype).max
    mate_d = _full(bx, big)
    mx, my = px[1], py[1]
    has_mate = torch.zeros_like(has_owner)
    for p in range(n_players):
        team_p = 1 if p >= ppt else 0
        dx = px[1 + p] - ox
        dy = py[1 + p] - oy
        dp = torch.sqrt(dx * dx + dy * dy)
        is_mate = (owner_team == team_p) & (owner_p != p)
        dp = torch.where(is_mate, dp, big)
        take = dp < mate_d
        mx = torch.where(take, px[1 + p], mx)
        my = torch.where(take, py[1 + p], my)
        mate_d = torch.where(take, dp, mate_d)
        has_mate = has_mate | is_mate
    pdx = mx - bx
    pdy = my - by
    pnorm = torch.sqrt(pdx * pdx + pdy * pdy).clamp_min(eps)
    pdx, pdy = pdx / pnorm, pdy / pnorm
    # 1v1 has no teammate: fall back to the shooting direction
    pdx = torch.where(has_mate, pdx, sdx)
    pdy = torch.where(has_mate, pdy, sdy)

    c, s = torch.cos(theta), torch.sin(theta)
    kdx = torch.where(do_shoot, c * sdx - s * sdy, c * pdx - s * pdy)
    kdy = torch.where(do_shoot, s * sdx + c * sdy, s * pdx + c * pdy)
    power = torch.where(
        do_shoot, to_dtype(params.shoot_power, dtype),
        _full(bx, to_dtype(params.pass_power, dtype)),
    )
    kicked = do_pass | do_shoot
    impulse = torch.where(kicked, power, 0.0)
    # the mass as a tensor on the batch's device: PyTorch's CUDA division by
    # a host scalar multiplies by its reciprocal, which is not the IEEE
    # quotient the kernels and the JAX package compute
    bm = _full(bx, to_dtype(params.ball_mass, dtype))
    dvx = torch.where(kicked, kdx * impulse / bm, 0.0)
    dvy = torch.where(kicked, kdy * impulse / bm, 0.0)
    possession = torch.where(kicked, -1, possession)
    return dvx, dvy, possession


def apply_kick(pos: torch.Tensor, vel: torch.Tensor, possession: torch.Tensor,
               actions: torch.Tensor, theta: torch.Tensor, params: EnvParams
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The owner's pass/shoot: returns (``vel`` with the kick's impulse
    added to the ball's row, the new possession). ``theta`` is the kick's
    drawn angular noise ``[...]`` (in place of JAX's key): a standard
    normal already scaled by ``params.kick_noise``. Array form of
    :func:`apply_kick_scalars`."""
    dtype = pos.dtype
    px, py = split_xy(pos)
    vx, vy = split_xy(vel)
    _, acts = split_actions(actions, params)
    dvx, dvy, possession = apply_kick_scalars(px, py, vx, vy, possession, acts,
                                              theta, params, dtype)
    vel = vel.clone()
    vel[..., 0, 0] = vx[0] + dvx
    vel[..., 0, 1] = vy[0] + dvy
    return vel, possession


# ---------------------------------------------------------------------------
# Dribble coupling
# ---------------------------------------------------------------------------


def apply_dribble_scalars(
    px: list, py: list, vx: list, vy: list, possession: torch.Tensor,
    dirs: list, params: EnvParams, dtype,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Carry the ball with its owner. Returns the ball's new
    (px, py, vx, vy)."""
    ppt = params.players_per_team
    n_players = params.n_players
    has_owner = possession > 0
    owner_p = torch.clamp(possession - 1, 0, n_players - 1)

    direction = dirs[0]
    for p in range(1, n_players):
        direction = torch.where(owner_p == p, dirs[p], direction)
    ux, uy = _dir_unit(direction, dtype)
    # facing fallback: team 0 faces +x, team 1 faces -x
    owner_team = (owner_p >= ppt).to(torch.int32)
    fbx = torch.where(owner_team == 0, 1.0, _full(ux, -1.0))
    moving = (ux != 0) | (uy != 0)
    cdx = torch.where(moving, ux, fbx)
    cdy = torch.where(moving, uy, 0.0)

    ox, oy, ovx, ovy = px[0], py[0], vx[0], vy[0]
    for b in range(1, n_players + 1):
        is_b = possession == b
        ox = torch.where(is_b, px[b], ox)
        oy = torch.where(is_b, py[b], oy)
        ovx = torch.where(is_b, vx[b], ovx)
        ovy = torch.where(is_b, vy[b], ovy)

    offset = to_dtype(
        params.player_radius + params.ball_radius + params.dribble_offset, dtype
    )
    ball_px = torch.where(has_owner, ox + cdx * offset, px[0])
    ball_py = torch.where(has_owner, oy + cdy * offset, py[0])
    ball_vx = torch.where(has_owner, ovx, vx[0])
    ball_vy = torch.where(has_owner, ovy, vy[0])
    return ball_px, ball_py, ball_vx, ball_vy


def apply_dribble(pos: torch.Tensor, vel: torch.Tensor, possession: torch.Tensor,
                  actions: torch.Tensor, params: EnvParams
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry the ball with its owner: (pos, vel) with the ball's rows
    replaced. Array form of :func:`apply_dribble_scalars`."""
    dirs, _ = split_actions(actions, params)
    bpx, bpy, bvx, bvy = apply_dribble_scalars(
        *split_xy(pos), *split_xy(vel), possession, dirs, params, pos.dtype)
    pos, vel = pos.clone(), vel.clone()
    pos[..., 0, 0], pos[..., 0, 1] = bpx, bpy
    vel[..., 0, 0], vel[..., 0, 1] = bvx, bvy
    return pos, vel


# ---------------------------------------------------------------------------
# Goals, out of bounds, kickoff
# ---------------------------------------------------------------------------


def detect_goal_scalars(
    ball_x: torch.Tensor, ball_y: torch.Tensor, params: EnvParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """(team0_scored, team1_scored): the ball's center past a goal line
    (strict) with its y inside the mouth."""
    dtype = ball_x.dtype
    in_mouth = (ball_y >= to_dtype(params.goal_y_lo, dtype)) & (
        ball_y <= to_dtype(params.goal_y_hi, dtype))
    g0 = (ball_x > to_dtype(params.width, dtype)) & in_mouth
    g1 = (ball_x < 0.0) & in_mouth
    return g0, g1


def detect_goal(pos: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """``[..., 2]`` bool: a goal by team 0 (the ball past the right line
    in the mouth), by team 1 (the left). Array form of
    :func:`detect_goal_scalars`."""
    return torch.stack(detect_goal_scalars(pos[..., 0, 0], pos[..., 0, 1],
                                           params), -1)


def clamp_oob_scalars(
    px: list, py: list, vx: list, vy: list, params: EnvParams, dtype,
) -> tuple[list, list, list, list, torch.Tensor]:
    """Clamp bodies into the field; the ball keeps its x inside the goal
    mouth. A clamped velocity component is zeroed. Returns the updated
    lists and ``ball_was_clamped``."""
    n = len(px)
    w = dtype_scalar(params.width, dtype)
    h = dtype_scalar(params.height, dtype)
    px, py, vx, vy = list(px), list(py), list(vx), list(vy)
    in_mouth = (py[0] >= to_dtype(params.goal_y_lo, dtype)) & (
        py[0] <= to_dtype(params.goal_y_hi, dtype))

    ball_was_clamped = None
    for i in range(n):
        r = dtype_scalar(
            params.ball_radius if i == 0 else params.player_radius, dtype)
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
            ball_was_clamped = moved_x | moved_y
    return px, py, vx, vy, ball_was_clamped


def clamp_oob(pos: torch.Tensor, vel: torch.Tensor, params: EnvParams
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamp bodies into the field (the ball free in x inside the goal
    mouth): returns (pos, vel, ball_was_clamped ``[...]``). Array form of
    :func:`clamp_oob_scalars`."""
    px, py, vx, vy, ball_was_clamped = clamp_oob_scalars(
        *split_xy(pos), *split_xy(vel), params, pos.dtype)
    return stack_xy(px, py), stack_xy(vx, vy), ball_was_clamped


def kickoff_scalars(
    noise_x: list, noise_y: list, params: EnvParams, dtype
) -> tuple[list, list]:
    """Kickoff placement: ball at the center, teams in columns at width/4
    and 3*width/4 spread in y, all jittered by ``placement_noise * height
    * noise`` with per-body ``noise`` in [-1, 1] (ball first). Returns
    (px, py); velocities are zero."""
    ppt = params.players_per_team
    w, h = params.width, params.height
    amp = to_dtype(params.placement_noise * h, dtype)

    px = [to_dtype(w / 2.0, dtype) + noise_x[0] * amp]
    py = [to_dtype(h / 2.0, dtype) + noise_y[0] * amp]
    for team, base_x in ((0, w / 4.0), (1, 3.0 * w / 4.0)):
        for k in range(ppt):
            b = 1 + team * ppt + k
            y0 = (k + 1.0) * (h / (ppt + 1.0))
            px.append(to_dtype(base_x, dtype) + noise_x[b] * amp)
            py.append(to_dtype(y0, dtype) + noise_y[b] * amp)
    return px, py


def kickoff_positions(noise: torch.Tensor, params: EnvParams,
                      dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Kickoff placement: (pos ``[..., n_bodies, 2]``, zero velocities).
    ``noise`` is the drawn per-body uniforms in [-1, 1] ``[..., n_bodies,
    2]``, x then y (in place of JAX's key). Array form of
    :func:`kickoff_scalars`."""
    pos = stack_xy(*kickoff_scalars(*split_xy(noise), params, dtype))
    return pos, torch.zeros_like(pos)


# ---------------------------------------------------------------------------
# Rewards
# ---------------------------------------------------------------------------


def _ball_goal_dist_scalar(bx, by, params: EnvParams, team: int, dtype):
    """Distance from the ball to the goal ``team`` attacks."""
    gx = to_dtype(params.width if team == 0 else 0.0, dtype)
    gy = to_dtype(params.height / 2.0, dtype)
    dx = bx - gx
    dy = by - gy
    return torch.sqrt(dx * dx + dy * dy)


def _nearest_player_ball_dist_scalar(px: list, py: list, params: EnvParams,
                                     team: int):
    ppt = params.players_per_team
    lo = 1 + team * ppt
    best = None
    for b in range(lo, lo + ppt):
        dx = px[b] - px[0]
        dy = py[b] - py[0]
        d = torch.sqrt(dx * dx + dy * dy)
        best = d if best is None else torch.minimum(best, d)
    return best


def shaped_rewards_scalars(
    px0: list, py0: list, px1: list, py1: list, possession: torch.Tensor,
    goal0: torch.Tensor, goal1: torch.Tensor, ball_clamped: torch.Tensor,
    params: EnvParams, dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-team shaped reward (team0, team1) from the positions before
    (``px0``) and after (``px1``) the step."""
    rc = params.rewards
    ppt = params.players_per_team
    goals = (goal0, goal1)
    like = px1[0]

    rews = []
    for team in (0, 1):
        r = _full(like, to_dtype(rc.time_penalty, dtype))
        r = r + torch.where(goals[team], _full(like, to_dtype(rc.goal, dtype)), 0.0)
        r = r + torch.where(
            goals[1 - team], _full(like, to_dtype(rc.concede, dtype)), 0.0)
        d0 = _ball_goal_dist_scalar(px0[0], py0[0], params, team, dtype)
        d1 = _ball_goal_dist_scalar(px1[0], py1[0], params, team, dtype)
        r = r + to_dtype(rc.ball_to_goal_delta, dtype) * (d0 - d1)
        p0 = _nearest_player_ball_dist_scalar(px0, py0, params, team)
        p1 = _nearest_player_ball_dist_scalar(px1, py1, params, team)
        r = r + to_dtype(rc.player_to_ball_delta, dtype) * (p0 - p1)
        owner_p = possession - 1
        owns = (possession > 0) & (
            (owner_p >= team * ppt) & (owner_p < (team + 1) * ppt)
        )
        r = r + torch.where(
            owns, _full(like, to_dtype(rc.possession_bonus, dtype)), 0.0)
        r = r + torch.where(
            ball_clamped, _full(like, to_dtype(rc.oob_penalty, dtype)), 0.0)
        rews.append(r)
    return rews[0], rews[1]


def shaped_rewards(pos_before: torch.Tensor, pos_after: torch.Tensor,
                   possession: torch.Tensor, goals: torch.Tensor,
                   ball_clamped: torch.Tensor, params: EnvParams) -> torch.Tensor:
    """``[..., 2]`` per-team shaped reward from the positions before and
    after the step ``[..., n_bodies, 2]``, the owner, ``goals`` ``[...,
    2]`` and ``ball_clamped`` ``[...]``. Array form of
    :func:`shaped_rewards_scalars`."""
    px0, py0 = split_xy(pos_before)
    px1, py1 = split_xy(pos_after)
    return torch.stack(shaped_rewards_scalars(
        px0, py0, px1, py1, possession, goals[..., 0], goals[..., 1],
        ball_clamped, params, pos_before.dtype), -1)
