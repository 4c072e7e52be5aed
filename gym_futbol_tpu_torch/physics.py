"""Batched, branch-free 2-D rigid-body physics for FutbolEnv in PyTorch.

Counterpart of :mod:`gym_futbol_tpu.physics`, whose module docstring is
the normative PHYSICS SPEC: substeps of (velocity integration with a
speed clamp, sequential-impulse contact solve over all circle pairs in
lexicographic order then the four walls, position integration). This
port keeps the spec's hot-form floating-point association operation
for operation: ``inv_d = 1/sqrt(max(d2, 1e-12))``, the ``1e20``
inactive-contact sentinel, inverse-mass-premultiplied normals, the
``jn_acc = jn'`` rename and walls solved in velocity units.

Scalar-SSA form: every per-body or per-pair quantity is its own ``[B]``
tensor held in a Python list, exactly as the JAX package writes it under
``vmap``. The same arithmetic is the CUDA kernel's in
``csrc/futbol_step.cuh``.

``1/sqrt`` is written as ``sqrt`` then ``reciprocal`` (both IEEE-rounded
on the CPU and on CUDA) in place of ``jax.lax.rsqrt``, which is not
bitwise ``1/sqrt`` on every input; the two differ in the last bit.

Everything is dtype-polymorphic: float32 for the rollout, float64 for
parity against the C++ oracle.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from .types import EnvParams


def circle_pairs(n_bodies: int) -> list[tuple[int, int]]:
    """Fixed lexicographic pair order, the normative sequential order."""
    return [(i, j) for i in range(n_bodies) for j in range(i + 1, n_bodies)]


def dtype_scalar(x: float, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d CPU tensor holding ``x`` rounded to ``dtype``."""
    return torch.tensor(x, dtype=torch.float64).to(dtype)


def to_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (the value ``jnp.asarray(x, dtype)``
    holds), as a Python float."""
    return dtype_scalar(x, dtype).item()


@functools.lru_cache(maxsize=64)
def physics_constants(params: EnvParams, dtype: torch.dtype) -> SimpleNamespace:
    """Every physics constant as a Python float rounded to ``dtype``.

    Each is formed as the JAX package forms it: a quotient or product
    written on Python floats there is taken in double and then rounded;
    one written on ``dtype`` arrays (``damping ** dt_sub``, the pair
    restitution ``e_i * e_j``, ``-1/(inv_m_i + inv_m_j)``) is taken in
    ``dtype``.
    """
    dt_sub = params.dt / params.substeps
    inv_ball = dtype_scalar(1.0 / params.ball_mass, dtype)
    inv_player = dtype_scalar(1.0 / params.player_mass, dtype)
    e_ball = dtype_scalar(params.ball_elasticity, dtype)
    e_player = dtype_scalar(params.player_elasticity, dtype)
    wall_e = dtype_scalar(params.wall_elasticity, dtype)
    one = dtype_scalar(1.0, dtype)
    return SimpleNamespace(
        dt_sub=to_dtype(dt_sub, dtype),
        damp=(dtype_scalar(params.damping, dtype)
              ** dtype_scalar(dt_sub, dtype)).item(),
        max_speed=to_dtype(params.max_speed, dtype),
        inv_m_ball=inv_ball.item(),
        inv_m_player=inv_player.item(),
        r_ball=to_dtype(params.ball_radius, dtype),
        r_player=to_dtype(params.player_radius, dtype),
        # contact distances r_i + r_j for ball-player / player-player pairs
        rr_bp=(dtype_scalar(params.ball_radius, dtype)
               + dtype_scalar(params.player_radius, dtype)).item(),
        rr_pp=(dtype_scalar(params.player_radius, dtype)
               + dtype_scalar(params.player_radius, dtype)).item(),
        # -k_n for ball-player and player-player pairs
        nkn_bp=(-(one / (inv_ball + inv_player))).item(),
        nkn_pp=(-(one / (inv_player + inv_player))).item(),
        # restitution products for ball-player / player-player pairs
        e_bp=(e_ball * e_player).item(),
        e_pp=(e_player * e_player).item(),
        # per-body wall restitution e_body * e_wall
        ew_ball=(e_ball * wall_e).item(),
        ew_player=(e_player * wall_e).item(),
        mu=to_dtype(params.friction, dtype),
        slop=to_dtype(params.collision_slop, dtype),
        bias_coef=to_dtype(params.baumgarte / dt_sub, dtype),
        width=to_dtype(params.width, dtype),
        height=to_dtype(params.height, dtype),
        goal_y_lo=to_dtype(params.goal_y_lo, dtype),
        goal_y_hi=to_dtype(params.goal_y_hi, dtype),
    )


_EPS2 = 1e-12      # degenerate-distance guard on squared lengths
_BIG = 1e20        # inactive-contact sentinel (spec item 3)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x).reciprocal()


def _pair_active(pen: torch.Tensor) -> torch.Tensor:
    """Spec item 3's activity test of a body pair: penetrating."""
    return pen > 0


def _wall_active(d: torch.Tensor) -> torch.Tensor:
    """The activity test of a (wall, body) constraint: overlapping."""
    return d > 0


def _contact_setup(px: list, py: list, vx: list, vy: list, params: EnvParams,
                   dtype, bodies=None) -> SimpleNamespace:
    """Spec items 2-3's per-substep set-up in scalar-SSA form: per pair
    (lexicographic order) its normal, the normals premultiplied by each
    body's inverse mass, -k_n and ``bmv`` (bounce - v_bias, or the 1e20
    inactive sentinel); per wall [bottom, top, left, right] and body its
    ``wn`` (v_bias - bounce, or -1e20); and the activity masks ``pair_on``
    and ``wall_on`` that chose between them.

    The per-body inverse masses, radii and elasticities are ``params``'
    (ball first, then players) unless ``bodies`` gives them as three
    per-body lists; the pair and wall constants are then formed from
    them in ``dtype`` as :func:`physics_constants` forms its own."""
    c = physics_constants(params, dtype)
    n = len(px)
    pairs = circle_pairs(n)
    if bodies is None:
        inv_m = [c.inv_m_ball] + [c.inv_m_player] * (n - 1)
        radii = [c.r_ball] + [c.r_player] * (n - 1)
        rr = [c.rr_bp if i == 0 else c.rr_pp for i, _ in pairs]
        e_pair = [c.e_bp if i == 0 else c.e_pp for i, _ in pairs]
        nkn = [c.nkn_bp if i == 0 else c.nkn_pp for i, _ in pairs]
        e_wall = [c.ew_ball] + [c.ew_player] * (n - 1)
    else:
        inv_m, radii, elas = bodies
        wall_e = to_dtype(params.wall_elasticity, dtype)
        rr = [radii[i] + radii[j] for i, j in pairs]
        e_pair = [elas[i] * elas[j] for i, j in pairs]
        nkn = [-(1.0 / (inv_m[i] + inv_m[j])) for i, j in pairs]
        e_wall = [e * wall_e for e in elas]

    # ---- circle-circle precompute (hot-form, spec item 3) ----------------
    k = SimpleNamespace(pairs=pairs, nx=[], ny=[], nxi=[], nyi=[], nxj=[], nyj=[],
                        nkn=[], bmv=[], pair_on=[], wn=[[None] * n for _ in range(4)],
                        wall_on=[[None] * n for _ in range(4)])
    for p, (i, j) in enumerate(pairs):
        dpx = px[j] - px[i]
        dpy = py[j] - py[i]
        d2 = dpx * dpx + dpy * dpy
        inv_d = _rsqrt(d2.clamp_min(_EPS2))
        dist = d2 * inv_d
        pen = rr[p] - dist
        nx = dpx * inv_d
        ny = dpy * inv_d
        vrn0 = (vx[j] - vx[i]) * nx + (vy[j] - vy[i]) * ny
        bounce = e_pair[p] * vrn0.clamp_max(0.0)
        vbias = c.bias_coef * (pen - c.slop).clamp_min(0.0)
        on = _pair_active(pen)
        k.nx.append(nx)
        k.ny.append(ny)
        k.nxi.append(nx * inv_m[i])
        k.nyi.append(ny * inv_m[i])
        k.nxj.append(nx * inv_m[j])
        k.nyj.append(ny * inv_m[j])
        k.nkn.append(nkn[p])
        k.bmv.append(torch.where(on, bounce - vbias, _BIG))
        k.pair_on.append(on)

    # ---- wall precompute: order [bottom, top, left, right], stored
    # negated (v_bias - bounce) with inactive sentinel -BIG ---------------
    for i in range(n):
        d = [
            radii[i] - py[i],
            radii[i] - (c.height - py[i]),
            radii[i] - px[i],
            radii[i] - (c.width - px[i]),
        ]
        if i == 0:  # the ball passes through the goal mouth
            in_mouth = (py[0] >= c.goal_y_lo) & (py[0] <= c.goal_y_hi)
            d[2] = torch.where(in_mouth, -1.0, d[2])
            d[3] = torch.where(in_mouth, -1.0, d[3])
        e_w = e_wall[i]
        vrn0_w = [vy[i], -vy[i], vx[i], -vx[i]]
        for wi in range(4):
            wbounce = e_w * vrn0_w[wi].clamp_max(0.0)
            wvbias = c.bias_coef * (d[wi] - c.slop).clamp_min(0.0)
            on = _wall_active(d[wi])
            k.wn[wi][i] = torch.where(on, wvbias - wbounce, -_BIG)
            k.wall_on[wi][i] = on
    return k


def _pair_update(k: SimpleNamespace, p: int, vx: list, vy: list, jn, jt, mu):
    """Pair p's normal then friction impulse (sequential impulses, spec
    item 3) on the velocity lists, in place; returns the accumulators
    (jn', jt'). With the inactive sentinel it changes nothing but the sign
    of a zero."""
    i, j = k.pairs[p]
    nx, ny = k.nx[p], k.ny[p]
    nxi, nyi, nxj, nyj = k.nxi[p], k.nyi[p], k.nxj[p], k.nyj[p]
    vrn = (vx[j] - vx[i]) * nx + (vy[j] - vy[i]) * ny
    jn_new = (jn + k.nkn[p] * (vrn + k.bmv[p])).clamp_min(0.0)
    dj = jn_new - jn
    vx[i] = vx[i] - dj * nxi
    vy[i] = vy[i] - dj * nyi
    vx[j] = vx[j] + dj * nxj
    vy[j] = vy[j] + dj * nyj
    # friction, tangent t = (-ny, nx)
    vrt = (vy[j] - vy[i]) * nx - (vx[j] - vx[i]) * ny
    djt = k.nkn[p] * vrt
    lim = mu * jn_new
    jt_new = torch.clamp(jt + djt, min=-lim, max=lim)
    djt = jt_new - jt
    vx[i] = vx[i] + djt * nyi
    vy[i] = vy[i] - djt * nxi
    vx[j] = vx[j] - djt * nyj
    vy[j] = vy[j] + djt * nxj
    return jn_new, jt_new


def _wall_update(k: SimpleNamespace, wi: int, i: int, vx: list, vy: list, jv, jtv,
                 mu):
    """Wall wi's normal then friction impulse on body i in velocity units
    (bottom/top act on vy, friction on vx; left/right the other way
    round), in place; returns (jv', jtv'). With the inactive sentinel it
    changes nothing but the sign of a zero."""
    wn = k.wn[wi][i]
    if wi == 0:
        dv0 = wn - vy[i]
    elif wi == 1:
        dv0 = wn + vy[i]
    elif wi == 2:
        dv0 = wn - vx[i]
    else:
        dv0 = wn + vx[i]
    jv_new = (jv + dv0).clamp_min(0.0)
    dv = jv_new - jv
    if wi == 0:
        vy[i] = vy[i] + dv
    elif wi == 1:
        vy[i] = vy[i] - dv
    elif wi == 2:
        vx[i] = vx[i] + dv
    else:
        vx[i] = vx[i] - dv
    if wi == 0:
        dvt0 = vx[i]
    elif wi == 1:
        dvt0 = -vx[i]
    elif wi == 2:
        dvt0 = -vy[i]
    else:
        dvt0 = vy[i]
    limv = mu * jv_new
    jt_new = torch.clamp(jtv + dvt0, min=-limv, max=limv)
    dvt = jt_new - jtv
    if wi == 0:
        vx[i] = vx[i] - dvt
    elif wi == 1:
        vx[i] = vx[i] + dvt
    elif wi == 2:
        vy[i] = vy[i] + dvt
    else:
        vy[i] = vy[i] - dvt
    return jv_new, jt_new


def _solve_contacts_scalar(
    px: list, py: list, vx: list, vy: list, params: EnvParams, dtype,
    bodies=None,
) -> tuple[list, list]:
    """Spec items 2-3 in scalar-SSA form: returns post-solve (vx, vy).
    ``bodies``: optional per-body (inverse masses, radii, elasticities),
    as :func:`_contact_setup` takes them."""
    mu = physics_constants(params, dtype).mu
    n = len(px)
    k = _contact_setup(px, py, vx, vy, params, dtype, bodies)
    vx, vy = list(vx), list(vy)
    zl = torch.zeros_like(vx[0])
    jn_cc = [zl] * len(k.pairs)
    jt_cc = [zl] * len(k.pairs)
    jv_w = [[zl] * n for _ in range(4)]
    jtv_w = [[zl] * n for _ in range(4)]
    for _ in range(params.solver_iterations):
        # -- circle-circle, sequential in fixed lexicographic order -------
        for p in range(len(k.pairs)):
            jn_cc[p], jt_cc[p] = _pair_update(k, p, vx, vy, jn_cc[p], jt_cc[p], mu)
        # -- walls in velocity units ---------------------------------------
        for wi in range(4):
            for i in range(n):
                jv_w[wi][i], jtv_w[wi][i] = _wall_update(
                    k, wi, i, vx, vy, jv_w[wi][i], jtv_w[wi][i], mu)
    return vx, vy


def integrate_velocity_scalars(vx: list, vy: list, fx: list, fy: list,
                               inv_m: list, damp, dt_sub, max_speed
                               ) -> tuple[list, list]:
    """Spec item 1 per body, in scalar-SSA form: ``v <- v * damp + f *
    inv_m * dt_sub``, then the speed clamp ``v * min(1, max_speed *
    1/sqrt(max(|v|^2, 1e-12)))``. Returns the new (vx, vy) lists."""
    vx, vy = list(vx), list(vy)
    for i in range(len(vx)):
        nvx = vx[i] * damp + fx[i] * inv_m[i] * dt_sub
        nvy = vy[i] * damp + fy[i] * inv_m[i] * dt_sub
        s2 = nvx * nvx + nvy * nvy
        scale = (max_speed * _rsqrt(s2.clamp_min(_EPS2))).clamp_max(1.0)
        vx[i] = nvx * scale
        vy[i] = nvy * scale
    return vx, vy


def physics_step_scalars(
    px: list, py: list, vx: list, vy: list, fx: list, fy: list,
    params: EnvParams, dtype,
) -> tuple[list, list, list, list]:
    """The full physics step (``params.substeps`` sub-steps) in
    scalar-SSA form. Forces are held constant across the sub-steps."""
    c = physics_constants(params, dtype)
    n = len(px)
    inv_m = [c.inv_m_ball] + [c.inv_m_player] * (n - 1)
    px, py, vx, vy = list(px), list(py), list(vx), list(vy)
    for _ in range(params.substeps):
        # spec item 1: velocity integration + speed clamp
        vx, vy = integrate_velocity_scalars(vx, vy, fx, fy, inv_m, c.damp,
                                            c.dt_sub, c.max_speed)
        # spec items 2-3: contacts
        vx, vy = _solve_contacts_scalar(px, py, vx, vy, params, dtype)
        # spec item 4: position integration
        for i in range(n):
            px[i] = px[i] + vx[i] * c.dt_sub
            py[i] = py[i] + vy[i] * c.dt_sub
    return px, py, vx, vy


def physics_step(
    pos: torch.Tensor, vel: torch.Tensor, forces: torch.Tensor,
    params: EnvParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance one env.step of simulated time (``params.dt``).

    pos/vel/forces: ``[B, n_bodies, 2]``. Returns the new (pos, vel).
    """
    n = pos.shape[1]
    px, py, vx, vy = physics_step_scalars(
        [pos[:, i, 0] for i in range(n)], [pos[:, i, 1] for i in range(n)],
        [vel[:, i, 0] for i in range(n)], [vel[:, i, 1] for i in range(n)],
        [forces[:, i, 0] for i in range(n)],
        [forces[:, i, 1] for i in range(n)],
        params, pos.dtype,
    )
    pos = torch.stack([torch.stack(px, 1), torch.stack(py, 1)], -1)
    vel = torch.stack([torch.stack(vx, 1), torch.stack(vy, 1)], -1)
    return pos, vel


# ---------------------------------------------------------------------------
# Array form: the JAX package's per-env API, on [..., n_bodies, 2] tensors
# ---------------------------------------------------------------------------


def split_xy(a: torch.Tensor) -> tuple[list, list]:
    """``[..., N, 2]`` -> per-body (x, y) lists of ``[...]`` tensors."""
    n = a.shape[-2]
    return [a[..., i, 0] for i in range(n)], [a[..., i, 1] for i in range(n)]


def stack_xy(x: list, y: list) -> torch.Tensor:
    """Per-body (x, y) lists of ``[...]`` tensors -> ``[..., N, 2]``."""
    return torch.stack([torch.stack(x, -1), torch.stack(y, -1)], -1)


def integrate_velocity(
    vel: torch.Tensor, forces: torch.Tensor, inv_mass: torch.Tensor,
    params: EnvParams, dt_sub: float,
) -> torch.Tensor:
    """Spec item 1 over one sub-step of ``dt_sub``: ``vel``/``forces``
    ``[..., N, 2]``, ``inv_mass`` ``[N]`` (or ``[..., N]``). Returns the
    new velocities ``[..., N, 2]``. Array wrapper over
    :func:`integrate_velocity_scalars`."""
    dtype = vel.dtype
    damp = (dtype_scalar(params.damping, dtype)
            ** dtype_scalar(dt_sub, dtype)).item()
    n = vel.shape[-2]
    vx, vy = integrate_velocity_scalars(
        *split_xy(vel), *split_xy(forces), [inv_mass[..., i] for i in range(n)],
        damp, to_dtype(dt_sub, dtype), to_dtype(params.max_speed, dtype))
    return stack_xy(vx, vy)


def solve_contacts(
    pos: torch.Tensor, vel: torch.Tensor, params: EnvParams,
    inv_mass: torch.Tensor, radii: torch.Tensor, elas: torch.Tensor,
) -> torch.Tensor:
    """Spec items 2-3: the post-solve velocities ``[..., N, 2]`` of bodies
    at ``pos`` with ``vel`` (``[..., N, 2]``), their inverse masses, radii
    and elasticities ``[N]`` (or ``[..., N]``; ``types.body_masses`` and
    friends give the env's). Array wrapper over the scalar-SSA solve."""
    n = pos.shape[-2]
    bodies = tuple([a[..., i] for i in range(n)] for a in (inv_mass, radii, elas))
    vx, vy = _solve_contacts_scalar(*split_xy(pos), *split_xy(vel), params,
                                    vel.dtype, bodies)
    return stack_xy(vx, vy)
