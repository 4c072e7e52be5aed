"""Policy-vs-policy self-play rollout: the CUDA kernel's wrapper, its
plain PyTorch version, and the per-team MLP policy they run.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_actor`. Each step, both
teams' observations are built from the state (team 1's mirrored, as
:func:`gym_futbol_tpu_torch.env.mirror_obs` mirrors it), each goes
through its team's MLP (tanh between layers, none after the last), the
actions are sampled by the inverse CDF (row form), team 1's directions
are un-mirrored, and the env steps with auto-reset. On a CUDA tensor
:func:`fused_selfplay_rollout` runs all T steps in one launch: with
``compute_dtype`` bfloat16 (the default, the JAX kernel's rounding on its
chip) of ``csrc/fused_policy_tc.cu`` (``selfplay_tc_kernel``, the layer
products on the tensor cores, laid out by :func:`._policy.tc_plan`), with float32
of ``csrc/fused_policy.cu`` (``selfplay_kernel``, exact f32); on a CPU
tensor it runs the plain version :func:`fused_selfplay_rollout_reference`
in the same mode.

MLP weights are a flat tuple ``(W1, b1, ..., Wl, bl)``, ``W`` ``[in,
out]`` and ``b`` ``[out, 1]`` f32, as the JAX package's ``init_mlp``
gives them. The row-matrix helpers, the packing and the layout are the
policy kernels' shared ones (:mod:`._policy`).
"""

from __future__ import annotations

import math

import torch

from .. import env as env_core
from ..models.policy import N_CHOICES, sample_actions
from ..types import EnvParams
from ..utils.profiling import spanned
from . import _build
from ._policy import (
    check_compute_dtype,
    check_limits,
    check_mlp,
    dense_rows,
    joint_action,
    obs_matrix,
    pack_mlp,
    pack_rows,
    policy_args,
    sample_with_logp,
    step_draws,
    tc_pack,
    tc_plan,
    tc_plan_ints,
)
from .fused_rollout import (
    check_state,
    check_uniforms,
    kernel_args,
    n_draws_per_step,
    split_state,
    state_args,
    step_uniforms,
)

_build.counters("fused_selfplay_rollout", "fused_selfplay_rollout_f32")


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


def mlp_logit_rows(x: torch.Tensor, weights: tuple,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """``x`` ``[F, B]`` through the flat MLP, tanh between layers and none
    after the last; returns ``[out, B]``."""
    n_layers = len(weights) // 2
    for li in range(n_layers):
        x = dense_rows(x, weights[2 * li], weights[2 * li + 1], compute_dtype)
        if li < n_layers - 1:
            x = torch.tanh(x)
    return x


def sample_rows(logit_rows: torch.Tensor, n_groups: int,
                uniforms: torch.Tensor) -> list[torch.Tensor]:
    """Per-group sampled indices (``_sample_rows``), the joint log-prob
    not taken."""
    return sample_with_logp(logit_rows, n_groups, uniforms)[0]


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def fused_selfplay_rollout_reference(
    statef: torch.Tensor, statei: torch.Tensor, weights_a: tuple,
    weights_b: tuple, params: EnvParams, n_steps: int | None = None, *,
    uniforms: torch.Tensor | None = None, seed: int | None = None,
    return_actions: bool = False, compute_dtype=torch.bfloat16,
):
    """The kernel's computation as T steps of row-matrix code.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]`` or
    ``seed`` (the kernel's Philox stream). Per step: view 0's G =
    2*players_per_team group draws, view 1's G, two for the kick angle,
    kickoff x per body, kickoff y per body. ``compute_dtype`` as
    :func:`fused_selfplay_rollout`'s (:func:`dense_rows`). Returns
    (statef', statei', team-0 rewards ``[T, B]``, goals ``[2, B]`` int32
    summed over the whole rollout), and with ``return_actions`` each
    view's packed (dirs, acts) ``[T, 2, B]`` in its own frame.
    """
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms, seed")
    check_compute_dtype(compute_dtype)
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
            obs_matrix(px, py, vx, vy, poss, params, False), weights_a,
            compute_dtype), g, u[:g])
        ib = sample_rows(mlp_logit_rows(
            obs_matrix(px, py, vx, vy, poss, params, True), weights_b,
            compute_dtype), g, u[g:2 * g])
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


@spanned("ops.fused_selfplay_rollout")
def fused_selfplay_rollout(
    statef: torch.Tensor, statei: torch.Tensor, weights_a: tuple,
    weights_b: tuple, seed: int, params: EnvParams, n_steps: int,
    uniforms: torch.Tensor | None = None, return_actions: bool = False,
    compute_dtype=torch.bfloat16,
):
    """Policy-vs-policy rollout of ``n_steps``: team 0 plays MLP
    ``weights_a``, team 1 ``weights_b`` on its mirrored view (pass one
    tuple twice for self-play; both need the same number of layers).

    Draws come from Philox keyed by ``seed`` (an int; a new seed for
    each call), or from ``uniforms`` f32 ``[n_steps, n_draws, B]``.
    ``compute_dtype`` bfloat16 (the main path) rounds the operands of
    every layer product to bf16 and sums in f32, as the JAX kernel's
    products run on its chip, on the tensor-core kernel; float32 is the
    exact parity mode on the CUDA cores (:func:`tc_plan`). Returns
    (statef', statei', team-0 rewards ``[n_steps, B]``, goals ``[2, B]``
    int32 totals over the rollout), and with ``return_actions`` each
    view's packed (dirs, acts) ``[n_steps, 2, B]`` in its own frame.
    """
    check_compute_dtype(compute_dtype)
    b = check_state(statef, statei, params)
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
    check_limits(dims_a)
    check_limits(dims_b)
    if statef.device.type == "cpu":
        return fused_selfplay_rollout_reference(
            statef, statei, weights_a, weights_b, params, n_steps,
            uniforms=uniforms, seed=None if uniforms is not None else seed,
            return_actions=return_actions, compute_dtype=compute_dtype)
    b, c_consts, stream = kernel_args(statef, statei, params)
    layers_a = list(zip(weights_a[::2], weights_a[1::2]))
    layers_b = list(zip(weights_b[::2], weights_b[1::2]))
    dev = statef.device
    sf, si, state = state_args(statef, statei)
    rew = torch.empty((n_steps, b), dtype=torch.float32, device=dev)
    goals = torch.empty((2, b), dtype=torch.int32, device=dev)
    acts_out = dirs_out = None
    if return_actions:
        dirs_out = torch.empty((n_steps, 2, b), dtype=torch.int32, device=dev)
        acts_out = torch.empty_like(dirs_out)
    outs = (rew.data_ptr(), goals.data_ptr(),
            None if dirs_out is None else dirs_out.data_ptr(),
            None if acts_out is None else acts_out.data_ptr(),
            *policy_args(params, uniforms, seed, b, n_steps, c_consts, stream))
    if compute_dtype == torch.float32:
        flat_a, table_a = pack_mlp(layers_a)
        flat_b, table_b = pack_mlp(layers_b)
        _build.launch("futbol_fused_selfplay", "fused_selfplay_rollout_f32", *state,
                      flat_a.data_ptr(), table_a, flat_b.data_ptr(), table_b,
                      len(dims_a), *outs)
    else:
        plan = tc_plan(params, [[d[1] for d in dims[:-1]] for dims in (dims_a, dims_b)],
                       b)
        frags, fv, (table_a, table_b), _ = tc_pack(
            [(layers_a, None), (layers_b, None)], params)
        _build.launch("futbol_fused_selfplay_tc", "fused_selfplay_rollout", *state,
                      frags.data_ptr(), frags.numel() // 8, fv.data_ptr(), table_a,
                      table_b, len(dims_a), tc_plan_ints(plan), *outs)
    out = (sf, si, rew, goals)
    if return_actions:
        out += (dirs_out, acts_out)
    return out
