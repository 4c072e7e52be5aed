"""Fused T-step random-policy rollout: the CUDA kernel's wrappers and
its plain PyTorch version.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_rollout`. The whole
rollout (action sampling, kick and kickoff noise, the step pipeline of
:func:`gym_futbol_tpu_torch.env.step_scalars` with auto-reset) runs in
one launch of ``csrc/fused_rollout.cu``, one thread per env.

LAYOUT (the JAX package's, without its ``(B//128, 128)`` split):

    statef [4*n_bodies, B] f32   rows: px | py | vx | vy
    statei [4, B]          i32   rows: possession, score0, score1, t

:func:`fused_rollout` and :func:`fused_rollout_replay` run the plain
version :func:`fused_rollout_reference` for CPU tensors and launch the
kernel for CUDA tensors; ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import env as env_core
from ..physics import dtype_scalar, physics_constants, to_dtype
from ..types import EnvParams, EnvState

# Kernel launches by wrapper name, for every kernel of the package; each
# wrapper adds one where it launches its kernel.
LAUNCHES = {"fused_rollout": 0, "fused_rollout_replay": 0,
            "fused_collect": 0, "fused_selfplay_rollout": 0,
            "fused_minibatch_grad": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Packing: EnvState <-> (statef, statei)
# ---------------------------------------------------------------------------


def pack_state(state: EnvState, params: EnvParams):
    """Batched EnvState -> (statef ``[4n, B]`` f32, statei ``[4, B]`` i32)."""
    pos, vel = state.pos, state.vel
    statef = torch.cat([pos[:, :, 0].T, pos[:, :, 1].T,
                        vel[:, :, 0].T, vel[:, :, 1].T]).contiguous()
    statei = torch.stack([
        state.possession, state.score[:, 0], state.score[:, 1], state.t,
    ]).to(torch.int32).contiguous()
    return statef, statei


def unpack_state(statef: torch.Tensor, statei: torch.Tensor,
                 params: EnvParams) -> EnvState:
    """Inverse of :func:`pack_state`."""
    n = params.n_bodies
    pos = torch.stack([statef[:n].T, statef[n:2 * n].T], -1)
    vel = torch.stack([statef[2 * n:3 * n].T, statef[3 * n:].T], -1)
    return EnvState(
        pos=pos, vel=vel, possession=statei[0],
        score=torch.stack([statei[1], statei[2]], -1), t=statei[3],
    )


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


def n_draws_per_step(params: EnvParams) -> int:
    """Uniform draws one step consumes: a dir and an act per player, two
    for the Box-Muller kick-noise normal, and an (x, y) kickoff draw per
    body."""
    return 2 * params.n_players + 2 + 2 * params.n_bodies


_TWO_PI_F32 = to_dtype(2.0 * math.pi, torch.float32)
_U1_FLOOR_F32 = to_dtype(1e-7, torch.float32)


def _randint5_from(u: torch.Tensor) -> torch.Tensor:
    """Uniform int32 in [0, 5) from a uniform [0, 1) draw."""
    return torch.floor(u * 5.0).to(torch.int32)


def _normal_from(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normal via Box-Muller from two uniform draws."""
    u1 = u1.clamp_min(_U1_FLOOR_F32)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(_TWO_PI_F32 * u2)


def _pm1_from(u: torch.Tensor) -> torch.Tensor:
    """Uniform [-1, 1) from a uniform [0, 1) draw."""
    return u * 2.0 - 1.0


_MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``a * m`` for uint32 values held in
    int64 tensors, without overflowing int64."""
    p_lo = a * (m & 0xFFFF)          # < 2**48
    p_hi = a * (m >> 16)             # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on uint32 values held in int64 tensors; the same
    rounds as the kernel's ``philox4x32_10``."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, step: int, n_draws: int, n_envs: int,
                    device=None) -> torch.Tensor:
    """The kernel's random-mode draws for one step: f32 ``[n_draws, B]``.
    Counter (env, step, group, 0), key (seed, 0); draw d is word d % 4
    of group d // 4, as ``(bits >> 8) * 2**-24``."""
    groups = (n_draws + 3) // 4
    c0 = torch.arange(n_envs, dtype=torch.int64, device=device).expand(groups, -1)
    c2 = torch.arange(groups, dtype=torch.int64, device=device)[:, None].expand(
        -1, n_envs)
    c1 = torch.full_like(c0, step & _MASK32)
    c3 = torch.zeros_like(c0)
    words = philox4x32_10(c0, c1, c2, c3, seed & _MASK32, 0)
    bits = torch.stack(words, 1).reshape(4 * groups, n_envs)[:n_draws]
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def step_uniforms(uniforms, seed, k: int, n_draws: int, b: int, device):
    """Step ``k``'s draws ``[n_draws, B]``: the table's, or Philox's."""
    if uniforms is not None:
        return uniforms[k]
    return philox_uniforms(seed, k, n_draws, b, device)


def split_state(statef: torch.Tensor, statei: torch.Tensor, n: int):
    """(px, py, vx, vy per-body row lists, possession, score0, score1, t)."""
    return ([statef[i] for i in range(n)], [statef[n + i] for i in range(n)],
            [statef[2 * n + i] for i in range(n)],
            [statef[3 * n + i] for i in range(n)], *statei)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fused_rollout_reference(
    statef: torch.Tensor, statei: torch.Tensor, params: EnvParams,
    n_steps: int | None = None, *, uniforms: torch.Tensor | None = None,
    actions: torch.Tensor | None = None, seed: int | None = None,
):
    """The kernel's computation as T calls of the scalar step.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]``,
    ``actions`` i32 ``[T, 2*n_players, B]`` (replay with zero noise), or
    ``seed`` (the kernel's Philox stream). Draw order per step: dirs per
    player, acts per player, two uniforms for theta, noise_x per body,
    noise_y per body. Returns (statef', statei', rewards ``[T, B]``).
    """
    if sum(x is not None for x in (uniforms, actions, seed)) != 1:
        raise ValueError("give exactly one of uniforms, actions, seed")
    n = params.n_bodies
    n_players = params.n_players
    n_draws = n_draws_per_step(params)
    b = statef.shape[1]
    if actions is not None:
        n_steps = actions.shape[0]
    elif uniforms is not None:
        n_steps = uniforms.shape[0]
    kick_noise = to_dtype(params.kick_noise, statef.dtype)

    px, py, vx, vy, poss, s0, s1, t = split_state(statef, statei, n)
    rewards = []
    for k in range(n_steps):
        if actions is not None:
            dirs = [actions[k, 2 * p] for p in range(n_players)]
            acts = [actions[k, 2 * p + 1] for p in range(n_players)]
            theta = torch.zeros_like(px[0])
            noise_x = noise_y = [theta] * n
        else:
            rows = iter(step_uniforms(uniforms, seed, k, n_draws, b,
                                      statef.device))
            dirs = [_randint5_from(next(rows)) for _ in range(n_players)]
            acts = [_randint5_from(next(rows)) for _ in range(n_players)]
            theta = _normal_from(next(rows), next(rows)) * kick_noise
            noise_x = [_pm1_from(next(rows)) for _ in range(n)]
            noise_y = [_pm1_from(next(rows)) for _ in range(n)]
        s = env_core.auto_reset_scalars(env_core.step_scalars(
            px, py, vx, vy, poss, s0, s1, t, dirs, acts, theta,
            noise_x, noise_y, params,
        ))
        px, py, vx, vy = s.px, s.py, s.vx, s.vy
        poss, s0, s1, t = s.possession, s.score0, s.score1, s.t
        rewards.append(s.r0)
    statef_out = torch.stack(px + py + vx + vy)
    statei_out = torch.stack([poss, s0, s1, t]).to(torch.int32)
    if rewards:
        reward = torch.stack(rewards)
    else:
        reward = statef.new_empty((0, b))
    return statef_out, statei_out, reward


# ---------------------------------------------------------------------------
# The kernel's constants
# ---------------------------------------------------------------------------

# Field order of ``struct Consts`` in csrc/futbol_step.cuh.
KERNEL_CONSTANT_NAMES = (
    "dt_sub", "damp", "max_speed", "inv_m_ball", "inv_m_player", "r_ball",
    "r_player", "rr_bp", "rr_pp", "nkn_bp", "nkn_pp", "e_bp", "e_pp",
    "ew_ball", "ew_player", "mu", "slop", "bias_coef", "width", "height",
    "goal_y_lo", "goal_y_hi",
    "move_force", "move_force_dash", "possession_radius", "half_height",
    "shoot_power", "pass_power", "ball_mass", "dribble_offset",
    "clamp_x_ball", "clamp_y_ball", "clamp_x_player", "clamp_y_player",
    "kick_amp", "center_x", "base_x0", "base_x1",
    "y0_0", "y0_1", "y0_2", "y0_3", "y0_4", "kick_noise",
    "r_time", "r_goal", "r_concede", "r_btg", "r_ptb", "r_poss", "r_oob",
)
_MAX_PPT = 5


def kernel_constants(params: EnvParams) -> dict[str, float]:
    """Every float constant the kernel takes, rounded to f32 and formed
    as the JAX package forms it (see ``physics_constants``)."""
    f32 = torch.float32
    f = lambda x: dtype_scalar(x, f32)  # noqa: E731
    phys = physics_constants(params, f32)
    rc = params.rewards
    w, h = params.width, params.height
    ppt = params.players_per_team
    out = {name: getattr(phys, name) for name in KERNEL_CONSTANT_NAMES[:22]}
    out.update(
        move_force=to_dtype(params.move_force, f32),
        move_force_dash=to_dtype(params.move_force * params.dash_multiplier, f32),
        possession_radius=to_dtype(params.possession_radius, f32),
        half_height=to_dtype(h / 2.0, f32),
        shoot_power=to_dtype(params.shoot_power, f32),
        pass_power=to_dtype(params.pass_power, f32),
        ball_mass=to_dtype(params.ball_mass, f32),
        dribble_offset=to_dtype(
            params.player_radius + params.ball_radius + params.dribble_offset,
            f32),
        # clamp_oob's upper bounds, width - r and height - r, taken in f32
        clamp_x_ball=(f(w) - f(params.ball_radius)).item(),
        clamp_y_ball=(f(h) - f(params.ball_radius)).item(),
        clamp_x_player=(f(w) - f(params.player_radius)).item(),
        clamp_y_player=(f(h) - f(params.player_radius)).item(),
        kick_amp=to_dtype(params.placement_noise * h, f32),
        center_x=to_dtype(w / 2.0, f32),
        base_x0=to_dtype(w / 4.0, f32),
        base_x1=to_dtype(3.0 * w / 4.0, f32),
        kick_noise=to_dtype(params.kick_noise, f32),
        r_time=to_dtype(rc.time_penalty, f32),
        r_goal=to_dtype(rc.goal, f32),
        r_concede=to_dtype(rc.concede, f32),
        r_btg=to_dtype(rc.ball_to_goal_delta, f32),
        r_ptb=to_dtype(rc.player_to_ball_delta, f32),
        r_poss=to_dtype(rc.possession_bonus, f32),
        r_oob=to_dtype(rc.oob_penalty, f32),
    )
    for k in range(_MAX_PPT):
        y0 = (k + 1.0) * (h / (ppt + 1.0)) if k < ppt else 0.0
        out[f"y0_{k}"] = to_dtype(y0, f32)
    return {name: out[name] for name in KERNEL_CONSTANT_NAMES}


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_state(statef: torch.Tensor, statei: torch.Tensor,
                 params: EnvParams) -> int:
    n = params.n_bodies
    if statef.dtype != torch.float32 or statei.dtype != torch.int32:
        raise TypeError("statef must be float32 and statei int32")
    if statef.dim() != 2 or statef.shape[0] != 4 * n:
        raise ValueError(f"statef must be [4*n_bodies={4 * n}, B], "
                         f"got {tuple(statef.shape)}")
    b = statef.shape[1]
    if tuple(statei.shape) != (4, b):
        raise ValueError(f"statei must be [4, {b}], got {tuple(statei.shape)}")
    if statei.device != statef.device:
        raise ValueError("statef and statei must be on one device")
    return b


def check_uniforms(uniforms, n_steps: int, params: EnvParams, statef) -> None:
    """A uniforms table must be f32 ``[n_steps, n_draws, B]`` on the
    state's device (and contiguous for the kernel)."""
    if uniforms is None:
        return
    shape = (n_steps, n_draws_per_step(params), statef.shape[1])
    if tuple(uniforms.shape) != shape or uniforms.dtype != torch.float32:
        raise ValueError(f"uniforms must be float32 {shape}")
    if uniforms.device != statef.device:
        raise ValueError("uniforms must be on the state's device")
    if statef.device.type == "cuda" and not uniforms.is_contiguous():
        raise ValueError("uniforms must be contiguous")


def _kernel_args(statef, statei, params: EnvParams):
    """Common checks and arguments for a kernel launch on CUDA tensors:
    (B, the constants as a ctypes array, the current stream)."""
    if statef.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {statef.device}")
    if params.players_per_team > _MAX_PPT:
        raise ValueError(f"players_per_team must be <= {_MAX_PPT}")
    if not (statef.is_contiguous() and statei.is_contiguous()):
        raise ValueError("statef and statei must be contiguous")
    if statef.shape[1] == 0:
        raise ValueError("the batch must hold at least one env")
    consts = kernel_constants(params)
    c_consts = (ctypes.c_float * len(consts))(*consts.values())
    stream = torch.cuda.current_stream(statef.device).cuda_stream
    return statef.shape[1], c_consts, stream


def _state_and_reward_out(statef, statei, n_steps: int):
    """Empty outputs (statef', statei', rewards ``[n_steps, B]``)."""
    return (torch.empty_like(statef), torch.empty_like(statei),
            torch.empty((n_steps, statef.shape[1]), dtype=torch.float32,
                        device=statef.device))


def _raise_on_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")


def fused_rollout(
    statef: torch.Tensor, statei: torch.Tensor, seed: int,
    params: EnvParams, n_steps: int, uniforms: torch.Tensor | None = None,
):
    """Run ``n_steps`` of random-policy auto-reset rollout.

    Draws come from Philox keyed by ``seed`` (an int; use a new seed for
    each call), or from ``uniforms`` f32 ``[n_steps, n_draws, B]`` when
    given. Returns (statef', statei', rewards ``[n_steps, B]``): the
    team-0 shaped reward of each step.
    """
    _check_state(statef, statei, params)
    check_uniforms(uniforms, n_steps, params, statef)
    if statef.device.type == "cpu":
        if uniforms is not None:
            return fused_rollout_reference(statef, statei, params,
                                           uniforms=uniforms)
        return fused_rollout_reference(statef, statei, params, n_steps,
                                       seed=seed)
    b, c_consts, stream = _kernel_args(statef, statei, params)
    sf, si, rew = _state_and_reward_out(statef, statei, n_steps)
    from . import _build

    lib = _build.load()
    err = lib.futbol_fused_rollout_random(
        statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
        rew.data_ptr(), None if uniforms is None else uniforms.data_ptr(),
        seed & 0xFFFFFFFF, params.n_bodies, b, n_steps, params.substeps,
        params.solver_iterations, params.max_steps, c_consts, len(c_consts),
        stream,
    )
    _raise_on_error(err, "fused_rollout")
    LAUNCHES["fused_rollout"] += 1
    return sf, si, rew


def fused_rollout_replay(
    statef: torch.Tensor, statei: torch.Tensor, actions: torch.Tensor,
    params: EnvParams,
):
    """Deterministic rollout replaying ``actions`` i32
    ``[T, 2*n_players, B]`` (per step, (dir, act) interleaved per player)
    with zero kick and kickoff noise. Returns (statef', statei', rewards
    ``[T, B]``)."""
    b = _check_state(statef, statei, params)
    n_steps = actions.shape[0]
    shape = (n_steps, 2 * params.n_players, b)
    if tuple(actions.shape) != shape or actions.dtype != torch.int32:
        raise ValueError(f"actions must be int32 {shape}")
    if actions.device != statef.device:
        raise ValueError("actions must be on the state's device")
    if statef.device.type == "cpu":
        return fused_rollout_reference(statef, statei, params, actions=actions)
    if not actions.is_contiguous():
        raise ValueError("actions must be contiguous")
    b, c_consts, stream = _kernel_args(statef, statei, params)
    sf, si, rew = _state_and_reward_out(statef, statei, n_steps)
    from . import _build

    lib = _build.load()
    err = lib.futbol_fused_rollout_replay(
        statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
        rew.data_ptr(), actions.data_ptr(), params.n_bodies, b, n_steps,
        params.substeps, params.solver_iterations, params.max_steps,
        c_consts, len(c_consts), stream,
    )
    _raise_on_error(err, "fused_rollout_replay")
    LAUNCHES["fused_rollout_replay"] += 1
    return sf, si, rew
