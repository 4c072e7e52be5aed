"""Self-play PPO experience collection in one launch: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of :mod:`gym_futbol_tpu.ops.fused_collect`. Each step, both
views (view 0 is team 0, view 1 team 1 in its mirrored frame) go
through one per-team actor-critic (tanh torso, logits head, value head);
each view's actions are sampled with their joint log-prob, team 1's
directions are un-mirrored, and the env steps with auto-reset. After the
loop come the bootstrap values of the carried state. On a CUDA tensor
:func:`fused_collect` runs it all in one launch: with ``compute_dtype``
bfloat16 (the default) of ``csrc/fused_policy_tc.cu``
(``collect_tc_kernel``: the torso's and the logits head's products on
the tensor cores, operands rounded to bf16 and summed in f32, as the JAX
kernel's products run on its chip; the value head, biases and tanh in
f32), with float32 of ``csrc/fused_policy.cu`` (``collect_kernel``,
exact f32: the parity mode); on a CPU tensor it runs the plain version
:func:`fused_collect_reference` in the same mode. The obs buffer holds
the unrounded f32 obs in both modes.

OUTPUTS (the JAX package's, without its ``(B//128, 128)`` split):

    obs        [2, F_pad, T, B] f32  feature-major, F_pad = F rounded up
                                     to a multiple of 8, pad rows zero
    dirs, acts [T, 2, B] i32         packed 3 bits per player, each view
                                     in its own frame
    logp       [T, 2, B] f32         joint log-prob of the sampled actions
    value      [T, 2, B] f32
    reward     [T, 2, B] f32         view k carries team k's reward
    done       [T, 2, B] i32
    last_value [2, B] f32            bootstrap values, both views

The actor-critic must have a torso of at least one layer: the JAX
kernel, given an empty torso, applies a tanh to the raw observation that
the flax model does not apply, so the two would disagree; here an empty
torso raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import env as env_core
from ..models.policy import N_CHOICES, ActorCritic
from ..types import EnvParams
from ..utils.profiling import spanned
from .fused_actor import (
    check_compute_dtype,
    check_limits,
    check_mlp,
    dense_rows,
    joint_action,
    obs_matrix,
    obs_scales,
    pack_mlp,
    pack_rows,
    sample_with_logp,
    step_draws,
    tc_pack,
    tc_plan,
    tc_plan_ints,
)
from .fused_rollout import (
    LAUNCHES,
    _check_state,
    _kernel_args,
    _raise_on_error,
    check_uniforms,
    n_draws_per_step,
    split_state,
    step_uniforms,
)


def feature_rows(params: EnvParams) -> int:
    """F_pad: the observation's F rows rounded up to a multiple of 8."""
    return -(-env_core.obs_size(params) // 8) * 8


def collect_culls(params: EnvParams) -> bool:
    """Whether the bfloat16 kernel runs the env step culled at this team
    size (``csrc/fused_policy_tc.cu``'s ``collect_culls``), as compiled:
    builds the kernels at first use, so it needs the CUDA toolkit."""
    from . import _build

    return bool(_build.load().futbol_collect_tc_culls(params.n_bodies))


def flatten_actor_critic(model: ActorCritic) -> tuple:
    """An :class:`ActorCritic`'s weights as the flat kernel-order tuple:
    torso layers, logits head, value head, each ``W`` ``[in, out]`` and
    ``b`` ``[out, 1]`` f32."""
    out = []
    for layer in model.dense_layers():
        out.append(layer.weight.detach().t().contiguous())
        out.append(layer.bias.detach().reshape(-1, 1).contiguous())
    return tuple(out)


def actor_critic_policy_weights(model: ActorCritic) -> tuple:
    """A trained :class:`ActorCritic` as the policy-only flat (W1, b1,
    ..., Wl, bl) tuple that ``fused_selfplay_rollout`` and
    ``evaluate.evaluate_fused`` take: :func:`flatten_actor_critic`
    without the value head (the MLP there applies tanh between layers
    and none after the last, as the torso and logits head do)."""
    return flatten_actor_critic(model)[:-2]


def _check_weights(weights: tuple, params: EnvParams) -> list[tuple[int, int]]:
    if len(weights) < 6:
        raise ValueError(
            "the actor-critic needs a torso of at least one layer (the JAX "
            "kernel's empty-torso forward applies a tanh the model does not)")
    # torso and logits head chain; the value head reads the torso too
    dims = check_mlp(weights[:-2], env_core.obs_size(params), "weights")
    h_in = dims[-1][0]
    dims += check_mlp(weights[-2:], h_in, "value head")
    n_logits = params.players_per_team * 2 * N_CHOICES
    if dims[-2][1] != n_logits or dims[-1][1] != 1:
        raise ValueError(f"the heads must be logits [{h_in}, {n_logits}] and "
                         f"value [{h_in}, 1]")
    return dims


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _forward(x: torch.Tensor, weights: tuple, compute_dtype=torch.float32):
    """Actor-critic forward on ``x`` ``[F, B]``: (logits ``[G*5, B]``,
    value ``[B]``). ``compute_dtype`` rounds the torso's and the logits
    head's operands (:func:`dense_rows`); the value head stays f32 on the
    unrounded torso output, as on the TPU (a degenerate dot)."""
    h = x
    for li in range(len(weights) // 2 - 2):
        h = torch.tanh(dense_rows(h, weights[2 * li], weights[2 * li + 1],
                                  compute_dtype))
    logits = dense_rows(h, weights[-4], weights[-3], compute_dtype)
    return logits, dense_rows(h, weights[-2], weights[-1])[0]


def fused_collect_reference(
    statef: torch.Tensor, statei: torch.Tensor, weights: tuple,
    params: EnvParams, n_steps: int | None = None, *,
    uniforms: torch.Tensor | None = None, seed: int | None = None,
    compute_dtype=torch.bfloat16,
):
    """The kernel's computation as T steps of row-matrix code.

    Exactly one draw source: ``uniforms`` f32 ``[T, n_draws, B]`` or
    ``seed`` (the kernel's Philox stream); the per-step draw order is
    :func:`gym_futbol_tpu_torch.ops.fused_actor.fused_selfplay_rollout_reference`'s.
    ``compute_dtype`` as :func:`fused_collect`'s (:func:`_forward`).
    Returns (statef', statei', obs, dirs, acts, logp, value, reward,
    done, last_value) as listed in the module docstring.
    """
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms, seed")
    check_compute_dtype(compute_dtype)
    _check_weights(weights, params)
    n, ppt = params.n_bodies, params.players_per_team
    g = 2 * ppt
    f, f_pad = env_core.obs_size(params), feature_rows(params)
    n_draws = n_draws_per_step(params)
    b = statef.shape[1]
    if uniforms is not None:
        n_steps = uniforms.shape[0]
    px, py, vx, vy, poss, s0, s1, t = split_state(statef, statei, n)
    obs = statef.new_zeros((2, f_pad, n_steps, b))
    rows = {k: [] for k in ("dirs", "acts", "logp", "value", "reward", "done")}
    for k in range(n_steps):
        u = step_uniforms(uniforms, seed, k, n_draws, b, statef.device)
        idx = []
        for v in range(2):
            x = obs_matrix(px, py, vx, vy, poss, params, v == 1)
            obs[v, :f, k] = x
            logits, value = _forward(x, weights, compute_dtype)
            iv, logp = sample_with_logp(logits, g, u[v * g:(v + 1) * g])
            idx.append(iv)
            rows["logp"].append(logp)
            rows["value"].append(value)
            dpack, apack = pack_rows(iv, ppt)
            rows["dirs"].append(dpack)
            rows["acts"].append(apack)
        dirs, acts = joint_action(idx[0], idx[1], ppt)
        theta, noise_x, noise_y = step_draws(u, params)
        s = env_core.step_scalars(px, py, vx, vy, poss, s0, s1, t, dirs, acts,
                                  theta, noise_x, noise_y, params)
        done = s.done.to(torch.int32)
        rows["reward"] += [s.r0, s.r1]
        rows["done"] += [done, done]
        s = env_core.auto_reset_scalars(s)
        px, py, vx, vy = s.px, s.py, s.vx, s.vy
        poss, s0, s1, t = s.possession, s.score0, s.score1, s.t
    last_value = torch.stack([
        _forward(obs_matrix(px, py, vx, vy, poss, params, v == 1), weights,
                 compute_dtype)[1]
        for v in range(2)])
    per_step = {k: torch.stack(r).reshape(n_steps, 2, b) for k, r in rows.items()}
    return (torch.stack(px + py + vx + vy),
            torch.stack([poss, s0, s1, t]).to(torch.int32), obs,
            per_step["dirs"], per_step["acts"], per_step["logp"],
            per_step["value"], per_step["reward"], per_step["done"], last_value)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


@spanned("ops.fused_collect")
def fused_collect(
    statef: torch.Tensor, statei: torch.Tensor, weights: tuple, seed: int,
    params: EnvParams, n_steps: int, uniforms: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
):
    """Collect ``n_steps`` of self-play PPO experience (module docstring).

    ``weights``: the flat actor-critic tuple of
    :func:`flatten_actor_critic`. Draws come from Philox keyed by
    ``seed`` (an int; a new seed for each call), or from ``uniforms``
    f32 ``[n_steps, n_draws, B]``. ``compute_dtype``: bfloat16 (the main
    path, the tensor-core kernel) or float32 (exact, the CUDA-core
    kernel); the layout of each is
    :func:`gym_futbol_tpu_torch.ops.fused_actor.tc_plan`'s. Returns
    (statef', statei', obs, dirs, acts, logp, value, reward, done,
    last_value).
    """
    check_compute_dtype(compute_dtype)
    b = _check_state(statef, statei, params)
    dims = _check_weights(weights, params)
    if any(w.device != statef.device for w in weights):
        raise ValueError("weights must be on the state's device")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    check_uniforms(uniforms, n_steps, params, statef)
    check_limits(dims[:-1])
    if statef.device.type == "cpu":
        return fused_collect_reference(
            statef, statei, weights, params, n_steps, uniforms=uniforms,
            seed=None if uniforms is not None else seed,
            compute_dtype=compute_dtype)
    b, c_consts, stream = _kernel_args(statef, statei, params)
    torso = list(zip(weights[:-4:2], weights[1:-4:2]))
    f_pad = feature_rows(params)
    dev = statef.device

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    sf, si = torch.empty_like(statef), torch.empty_like(statei)
    obs = out(2, f_pad, n_steps, b)
    dirs, acts, done = (out(n_steps, 2, b, dtype=torch.int32) for _ in range(3))
    logp, value, reward = (out(n_steps, 2, b) for _ in range(3))
    last_value = out(2, b)
    scales = (ctypes.c_float * 3)(*obs_scales(params))
    from . import _build

    outs = (obs.data_ptr(), dirs.data_ptr(), acts.data_ptr(), logp.data_ptr(),
            value.data_ptr(), reward.data_ptr(), done.data_ptr(),
            last_value.data_ptr(), None if uniforms is None else uniforms.data_ptr(),
            seed & 0xFFFFFFFF, params.n_bodies, b, n_steps, f_pad,
            params.substeps, params.solver_iterations, params.max_steps,
            c_consts, len(c_consts), scales, stream)
    lib = _build.load()
    if compute_dtype == torch.float32:
        # torso layers, then the logits and value heads as one layer
        layers = torso + [(torch.cat([weights[-4], weights[-2]], 1),
                           torch.cat([weights[-3], weights[-1]], 0))]
        flat, table = pack_mlp(layers)
        err = lib.futbol_fused_collect(
            statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
            flat.data_ptr(), table, len(layers), *outs)
        name = "fused_collect_f32"
    else:
        plan = tc_plan(params, [[d[1] for d in dims[:-2]]], b)
        frags, fv, (table,), (wv_off,) = tc_pack(
            [(torso + [(weights[-4], weights[-3])], (weights[-2], weights[-1]))],
            params)
        err = lib.futbol_fused_collect_tc(
            statef.data_ptr(), statei.data_ptr(), sf.data_ptr(), si.data_ptr(),
            frags.data_ptr(), frags.numel() // 8, fv.data_ptr(), table,
            len(torso) + 1, wv_off, tc_plan_ints(plan), *outs)
        name = "fused_collect"
    _raise_on_error(err, "fused_collect")
    LAUNCHES[name] += 1
    return sf, si, obs, dirs, acts, logp, value, reward, done, last_value
