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

import torch

from .. import env as env_core
from ..models.policy import N_CHOICES, ActorCritic
from ..types import EnvParams
from ..utils.profiling import spanned
from . import _build
from ._policy import (
    check_compute_dtype,
    check_limits,
    check_mlp,
    collect_outputs,
    collect_reference,
    dense_rows,
    pack_mlp,
    tc_pack,
    tc_plan,
    tc_plan_ints,
)
from .fused_rollout import check_state, check_uniforms, kernel_args, state_args

_build.counters("fused_collect", "fused_collect_f32")


def collect_culls(params: EnvParams) -> bool:
    """Whether the bfloat16 kernel runs the env step culled at this team
    size (``csrc/fused_policy_tc.cu``'s ``collect_culls``), as compiled:
    builds the kernels at first use, so it needs the CUDA toolkit."""
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
    check_compute_dtype(compute_dtype)
    _check_weights(weights, params)
    return collect_reference(statef, statei, params, n_steps, uniforms, seed,
                             lambda v, x, last=False: _forward(x, weights, compute_dtype))


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
    :func:`gym_futbol_tpu_torch.ops._policy.tc_plan`'s. Returns
    (statef', statei', obs, dirs, acts, logp, value, reward, done,
    last_value).
    """
    check_compute_dtype(compute_dtype)
    b = check_state(statef, statei, params)
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
    b, c_consts, stream = kernel_args(statef, statei, params)
    torso = list(zip(weights[:-4:2], weights[1:-4:2]))
    sf, si, state = state_args(statef, statei)
    outs, tail = collect_outputs(params, statef, n_steps, uniforms, seed, c_consts,
                                 stream)
    if compute_dtype == torch.float32:
        # torso layers, then the logits and value heads as one layer
        layers = torso + [(torch.cat([weights[-4], weights[-2]], 1),
                           torch.cat([weights[-3], weights[-1]], 0))]
        flat, table = pack_mlp(layers)
        _build.launch("futbol_fused_collect", "fused_collect_f32", *state,
                      flat.data_ptr(), table, len(layers), *tail)
    else:
        plan = tc_plan(params, [[d[1] for d in dims[:-2]]], b)
        frags, fv, (table,), (wv_off,) = tc_pack(
            [(torso + [(weights[-4], weights[-3])], (weights[-2], weights[-1]))],
            params)
        _build.launch("futbol_fused_collect_tc", "fused_collect", *state,
                      frags.data_ptr(), frags.numel() // 8, fv.data_ptr(), table,
                      len(torso) + 1, wv_off, tc_plan_ints(plan), *tail)
    return (sf, si, *outs)
