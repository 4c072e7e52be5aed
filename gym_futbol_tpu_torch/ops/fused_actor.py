"""Policy-vs-policy self-play rollout: the CUDA kernel's wrapper, its
plain PyTorch version, and the per-team MLP policy they run.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_actor`. Each step, both
teams' observations are built from the state (team 1's mirrored, as
:func:`gym_futbol_tpu_torch.env.mirror_obs` mirrors it), each goes
through its team's MLP (tanh between layers, none after the last), the
actions are sampled by the inverse CDF (row form), team 1's directions
are un-mirrored, and the env steps with auto-reset. On a CUDA tensor
:func:`fused_selfplay_rollout` runs all T steps in one launch of
``csrc/fused_policy.cu`` (``selfplay_kernel``); on a CPU tensor it runs
the plain version :func:`fused_selfplay_rollout_reference`.

MLP weights are a flat tuple ``(W1, b1, ..., Wl, bl)``, ``W`` ``[in,
out]`` and ``b`` ``[out, 1]`` f32, as the JAX package's ``init_mlp``
gives them. The plain helpers work on ``[feature, B]`` row matrices,
each dense output an ordered sum over its inputs with the bias added
last: the kernel's arithmetic, operation for operation.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import env as env_core
from ..models.policy import (
    N_CHOICES,
    pack_actions,
    sample_actions,
    sample_group,
)
from ..physics import to_dtype
from ..types import EnvParams
from .fused_rollout import (
    LAUNCHES,
    _check_state,
    _kernel_args,
    _normal_from,
    _pm1_from,
    _raise_on_error,
    check_uniforms,
    n_draws_per_step,
    split_state,
    step_uniforms,
)

# The kernels' limits (csrc/fused_policy.cu): dense layers per MLP, and
# the widest layer, whose two activation columns per env must fit the
# block's shared memory (2 * 512 rows * 32 envs * 4 bytes = 128 KB).
MAX_LAYERS = 8
MAX_WIDTH = 512
_CHUNK = 16   # the kernel's register tile: layer widths pad to a multiple


def mlp_weight_shapes(params: EnvParams, hidden=(128, 128)):
    """[(W shape, b shape), ...] for the per-team policy MLP."""
    f = env_core.obs_size(params)
    dims = [f, *hidden, params.players_per_team * 2 * N_CHOICES]
    return [((dims[i], dims[i + 1]), (dims[i + 1], 1))
            for i in range(len(dims) - 1)]


def init_mlp(generator: torch.Generator, params: EnvParams, hidden=(128, 128),
             device: torch.device | str = "cuda") -> tuple:
    """He-initialised per-team policy weights: flat tuple (W1, b1, W2, ...)."""
    out = []
    for ws, bs in mlp_weight_shapes(params, hidden):
        out.append(torch.randn(ws, generator=generator, device=device)
                   / math.sqrt(ws[0]))
        out.append(torch.zeros(bs, device=device))
    return tuple(out)


def mlp_team_policy(weights: tuple, params: EnvParams):
    """The per-team MLP as an :mod:`evaluate` team policy ``(generator,
    obs [B, F]) -> actions [B, ppt, 2]``, sampling as
    :func:`gym_futbol_tpu_torch.models.policy.sample_actions` does."""
    n_layers = len(weights) // 2

    @torch.no_grad()
    def policy(generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for li in range(n_layers):
            x = x @ weights[2 * li] + weights[2 * li + 1][:, 0]
            if li < n_layers - 1:
                x = torch.tanh(x)
        return sample_actions(x, generator=generator)[0]

    return policy


# ---------------------------------------------------------------------------
# Plain versions of the kernel's pieces (row matrices [rows, B])
# ---------------------------------------------------------------------------


def obs_scales(params: EnvParams) -> tuple[float, float, float]:
    """(1/width, 1/height, 1/max_speed), each rounded to f32 as
    ``jnp.float32(1.0 / x)`` rounds it."""
    f32 = torch.float32
    return (to_dtype(1.0 / params.width, f32), to_dtype(1.0 / params.height, f32),
            to_dtype(1.0 / params.max_speed, f32))


def obs_matrix(px, py, vx, vy, possession, params: EnvParams,
               mirror: bool) -> torch.Tensor:
    """The observation as an ``[F, B]`` matrix from per-body ``[B]``
    rows: positions times the f32 reciprocals of the field size (not
    divided, as ``env.observe`` does), velocities times 1/max_speed,
    then the possession flags. ``mirror`` gives team 1's view:
    x -> 1 - x, vx -> -vx, team blocks and flags swapped."""
    ppt = params.players_per_team
    inv_w, inv_h, inv_s = obs_scales(params)
    order = list(range(params.n_bodies))
    if mirror:
        order = [0, *range(1 + ppt, 1 + 2 * ppt), *range(1, 1 + ppt)]
    rows = []
    for i in order:
        x = px[i] * inv_w
        rows += [1.0 - x if mirror else x, py[i] * inv_h]
    for i in order:
        v = vx[i] * inv_s
        rows += [-v if mirror else v, vy[i] * inv_s]
    owner_p = possession - 1
    owns0 = ((possession > 0) & (owner_p < ppt)).to(px[0].dtype)
    owns1 = ((possession > 0) & (owner_p >= ppt)).to(px[0].dtype)
    rows += [owns1, owns0] if mirror else [owns0, owns1]
    return torch.stack(rows)


def dense_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x`` ``[in, B]`` through ``w`` ``[in, out]``, ``b`` ``[out, 1]``:
    each output summed over the inputs in ascending order, then the bias
    added, each product and sum rounded to f32 (no FMA), as the kernel
    computes it."""
    acc = w[0][:, None] * x[0]
    for k in range(1, w.shape[0]):
        acc = acc + w[k][:, None] * x[k]
    return acc + b


def mlp_logit_rows(x: torch.Tensor, weights: tuple) -> torch.Tensor:
    """``x`` ``[F, B]`` through the flat MLP, tanh between layers and none
    after the last; returns ``[out, B]``."""
    n_layers = len(weights) // 2
    for li in range(n_layers):
        x = dense_rows(x, weights[2 * li], weights[2 * li + 1])
        if li < n_layers - 1:
            x = torch.tanh(x)
    return x


def sample_with_logp(logit_rows: torch.Tensor, n_groups: int,
                     uniforms: torch.Tensor):
    """Row-form inverse-CDF sampling of each 5-way group of
    ``logit_rows`` ``[G*5, B]`` with ``uniforms[g]`` ``[B]``: (index rows
    ``[B]`` int32 per group, joint log-prob of the sampled indices)."""
    idxs, logp_total = [], None
    for g in range(n_groups):
        idx, taken = sample_group(
            [logit_rows[g * N_CHOICES + i] for i in range(N_CHOICES)],
            uniforms[g])
        idxs.append(idx)
        logp_total = taken if logp_total is None else logp_total + taken
    return idxs, logp_total


def sample_rows(logit_rows: torch.Tensor, n_groups: int,
                uniforms: torch.Tensor) -> list[torch.Tensor]:
    """Per-group sampled indices (``_sample_rows``), the joint log-prob
    not taken."""
    return sample_with_logp(logit_rows, n_groups, uniforms)[0]


# Swap left/right (2 <-> 4) for the mirrored team's direction.
unmirror_dir = env_core.mirror_dir


def joint_action(ia: list, ib: list, ppt: int):
    """World-frame (dirs, acts) per player from both views' group
    indices: team 0 as sampled, team 1's directions un-mirrored."""
    dirs = [ia[2 * p] for p in range(ppt)] + [
        unmirror_dir(ib[2 * p]) for p in range(ppt)]
    acts = [ia[2 * p + 1] for p in range(ppt)] + [
        ib[2 * p + 1] for p in range(ppt)]
    return dirs, acts


def pack_rows(idx: list, ppt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One view's group index rows packed at 3 bits per player: (dirs,
    acts)."""
    return pack_actions(torch.stack(idx, -1).reshape(-1, ppt, 2))


def step_draws(u: torch.Tensor, params: EnvParams):
    """The env's draws of one step from its uniforms ``[n_draws, B]``
    (after both views' group draws): (theta, kickoff noise x, y)."""
    n, g = params.n_bodies, 2 * params.players_per_team
    theta = _normal_from(u[2 * g], u[2 * g + 1]) * to_dtype(
        params.kick_noise, u.dtype)
    noise_x = [_pm1_from(u[2 * g + 2 + i]) for i in range(n)]
    noise_y = [_pm1_from(u[2 * g + 2 + n + i]) for i in range(n)]
    return theta, noise_x, noise_y


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fused_selfplay_rollout_reference(
    statef: torch.Tensor, statei: torch.Tensor, weights_a: tuple,
    weights_b: tuple, params: EnvParams, n_steps: int | None = None, *,
    uniforms: torch.Tensor | None = None, seed: int | None = None,
    return_actions: bool = False,
):
    """The kernel's computation as T steps of row-matrix code.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]`` or
    ``seed`` (the kernel's Philox stream). Per step: view 0's G =
    2*players_per_team group draws, view 1's G, two for the kick angle,
    kickoff x per body, kickoff y per body. Returns (statef', statei',
    team-0 rewards ``[T, B]``, goals ``[2, B]`` int32 summed over the
    whole rollout), and with ``return_actions`` each view's packed
    (dirs, acts) ``[T, 2, B]`` in its own frame.
    """
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms, seed")
    n, ppt = params.n_bodies, params.players_per_team
    g = 2 * ppt
    n_draws = n_draws_per_step(params)
    b = statef.shape[1]
    if uniforms is not None:
        n_steps = uniforms.shape[0]
    px, py, vx, vy, poss, s0, s1, t = split_state(statef, statei, n)
    goals = torch.zeros((2, b), dtype=torch.int32, device=statef.device)
    rewards, dirs_out, acts_out = [], [], []
    for k in range(n_steps):
        u = step_uniforms(uniforms, seed, k, n_draws, b, statef.device)
        ia = sample_rows(mlp_logit_rows(
            obs_matrix(px, py, vx, vy, poss, params, False), weights_a), g, u[:g])
        ib = sample_rows(mlp_logit_rows(
            obs_matrix(px, py, vx, vy, poss, params, True), weights_b), g,
            u[g:2 * g])
        if return_actions:
            (da, aa), (db, ab) = pack_rows(ia, ppt), pack_rows(ib, ppt)
            dirs_out.append(torch.stack([da, db]))
            acts_out.append(torch.stack([aa, ab]))
        dirs, acts = joint_action(ia, ib, ppt)
        theta, noise_x, noise_y = step_draws(u, params)
        s = env_core.step_scalars(px, py, vx, vy, poss, s0, s1, t, dirs, acts,
                                  theta, noise_x, noise_y, params)
        goals = goals + torch.stack([s.goal0, s.goal1]).to(torch.int32)
        rewards.append(s.r0)
        s = env_core.auto_reset_scalars(s)
        px, py, vx, vy = s.px, s.py, s.vx, s.vy
        poss, s0, s1, t = s.possession, s.score0, s.score1, s.t
    out = (torch.stack(px + py + vx + vy),
           torch.stack([poss, s0, s1, t]).to(torch.int32),
           torch.stack(rewards), goals)
    if return_actions:
        out += (torch.stack(dirs_out), torch.stack(acts_out))
    return out


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def check_mlp(weights: tuple, n_in: int, name: str) -> list[tuple[int, int]]:
    """Validate a flat (W, b, ...) tuple; returns its (in, out) per layer."""
    if len(weights) < 2 or len(weights) % 2:
        raise ValueError(f"{name}: a flat (W1, b1, ..., Wl, bl) tuple")
    dims, prev = [], n_in
    for li in range(len(weights) // 2):
        w, b = weights[2 * li], weights[2 * li + 1]
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"{name}: weights must be float32")
        if w.dim() != 2 or w.shape[0] != prev or tuple(b.shape) != (w.shape[1], 1):
            raise ValueError(f"{name}: layer {li} must be W [{prev}, out], "
                             f"b [out, 1]; got {tuple(w.shape)}, {tuple(b.shape)}")
        dims.append((w.shape[0], w.shape[1]))
        prev = w.shape[1]
    return dims


def pack_mlp(layers: list[tuple[torch.Tensor, torch.Tensor]]):
    """Dense layers ``(W [in, out], b)`` -> (flat f32 buffer, ctypes int
    table ``[n_layers, 4]`` of (in, out_pad, w_off, b_off)) in the
    kernel's layout: each W padded with zero columns to ``out_pad``, a
    multiple of 16, then its bias padded the same."""
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} dense layers")
    chunks, table, off = [], [], 0
    for w, b in layers:
        n_in, n_out = w.shape
        if max(n_in, n_out) > MAX_WIDTH:
            raise ValueError(f"layer widths must be <= {MAX_WIDTH}, got "
                             f"{tuple(w.shape)}")
        out_pad = -(-n_out // _CHUNK) * _CHUNK
        wp = w.new_zeros((n_in, out_pad))
        wp[:, :n_out] = w
        bp = w.new_zeros(out_pad)
        bp[:n_out] = b.reshape(-1)
        table += [n_in, out_pad, off, off + n_in * out_pad]
        off += n_in * out_pad + out_pad
        chunks += [wp.reshape(-1), bp]
    flat = torch.cat(chunks)
    if flat.data_ptr() % 16:
        raise ValueError("the flat weight buffer must be 16-byte aligned")
    return flat, (ctypes.c_int * len(table))(*table)


def fused_selfplay_rollout(
    statef: torch.Tensor, statei: torch.Tensor, weights_a: tuple,
    weights_b: tuple, seed: int, params: EnvParams, n_steps: int,
    uniforms: torch.Tensor | None = None, return_actions: bool = False,
):
    """Policy-vs-policy rollout of ``n_steps``: team 0 plays MLP
    ``weights_a``, team 1 ``weights_b`` on its mirrored view (pass one
    tuple twice for self-play; both need the same number of layers).

    Draws come from Philox keyed by ``seed`` (an int; a new seed for
    each call), or from ``uniforms`` f32 ``[n_steps, n_draws, B]``.
    Returns (statef', statei', team-0 rewards ``[n_steps, B]``, goals
    ``[2, B]`` int32 totals over the rollout), and with
    ``return_actions`` each view's packed (dirs, acts) ``[n_steps, 2,
    B]`` in its own frame.
    """
    b = _check_state(statef, statei, params)
    f = env_core.obs_size(params)
    dims_a = check_mlp(weights_a, f, "weights_a")
    dims_b = check_mlp(weights_b, f, "weights_b")
    n_logits = params.players_per_team * 2 * N_CHOICES
    if len(dims_a) != len(dims_b):
        raise ValueError("weights_a and weights_b need the same layer count")
    if dims_a[-1][1] != n_logits or dims_b[-1][1] != n_logits:
        raise ValueError(f"the last layer must give {n_logits} logits")
    if any(w.device != statef.device for w in (*weights_a, *weights_b)):
        raise ValueError("weights must be on the state's device")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    check_uniforms(uniforms, n_steps, params, statef)
    if statef.device.type == "cpu":
        return fused_selfplay_rollout_reference(
            statef, statei, weights_a, weights_b, params, n_steps,
            uniforms=uniforms, seed=None if uniforms is not None else seed,
            return_actions=return_actions)
    b, c_consts, stream = _kernel_args(statef, statei, params)
    flat_a, table_a = pack_mlp(list(zip(weights_a[::2], weights_a[1::2])))
    flat_b, table_b = pack_mlp(list(zip(weights_b[::2], weights_b[1::2])))
    dev = statef.device
    sf, si = torch.empty_like(statef), torch.empty_like(statei)
    rew = torch.empty((n_steps, b), dtype=torch.float32, device=dev)
    goals = torch.empty((2, b), dtype=torch.int32, device=dev)
    acts_out = dirs_out = None
    if return_actions:
        dirs_out = torch.empty((n_steps, 2, b), dtype=torch.int32, device=dev)
        acts_out = torch.empty_like(dirs_out)
    scales = (ctypes.c_float * 3)(*obs_scales(params))
    from . import _build

    lib = _build.load()
    err = lib.futbol_fused_selfplay(
        statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
        flat_a.data_ptr(), table_a, flat_b.data_ptr(), table_b, len(dims_a),
        rew.data_ptr(), goals.data_ptr(),
        None if dirs_out is None else dirs_out.data_ptr(),
        None if acts_out is None else acts_out.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(),
        seed & 0xFFFFFFFF, params.n_bodies, b, n_steps, params.substeps,
        params.solver_iterations, params.max_steps, c_consts, len(c_consts),
        scales, stream,
    )
    _raise_on_error(err, "fused_selfplay_rollout")
    LAUNCHES["fused_selfplay_rollout"] += 1
    out = (sf, si, rew, goals)
    if return_actions:
        out += (dirs_out, acts_out)
    return out
