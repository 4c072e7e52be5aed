"""Recurrent (LSTM) PPO in PyTorch.

Counterpart of :mod:`gym_futbol_tpu.recurrent_ppo`, the clipped-surrogate
companion of recurrent A2C (:mod:`gym_futbol_tpu_torch.a2c`), with the
same collect and runner:

- collect: :func:`a2c.collect_recurrent_rollout`, or
  :func:`a2c.collect_recurrent_rollout_fused` on the
  ``fused_recurrent_collect`` kernel: obs ``[T, 2B, F]``, each view's
  carry zeroed at episode ends;
- update: ``cfg.epochs`` x ``cfg.minibatches`` clipped-surrogate steps
  whose minibatches split the SEQUENCE axis (the 2B self-play views),
  never the time axis: each re-runs the LSTM over the whole window from
  the carry its sequences started it with, so gradients flow through
  time. An epoch permutes contiguous blocks of ``cfg.shuffle_block``
  sequences (degrading to the largest divisor, as ``ppo``'s blocks), and
  a block count the minibatches do not divide is refused, where the JAX
  package drops the leftover blocks. By default (``compute_dtype``
  bfloat16) the LSTM recurrence runs forward and backward in K6
  (:mod:`gym_futbol_tpu_torch.ops.fused_bptt`), its products on the
  tensor cores from bf16 operand pairs held to float32's result;
  float32 runs the cell step by step under autograd.

With ``group`` (a ``torch.distributed`` process group over which the
envs are sharded) each minibatch's gradients and metrics are averaged
over the ranks before the optimiser step.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ppo
from .a2c import (
    RecurrentRunnerState,
    _flat_carry,
    collect_recurrent_rollout,
    init_recurrent_runner,
)
from .models.policy import action_log_prob_and_entropy_grouped
from .models.recurrent import RecurrentActorCritic
from .ops._policy import check_compute_dtype
from .ppo import (
    TRAJ_FIELDS,
    PPOConfig,
    Transition,
    _epoch_perms,
    _mean_metrics,
    _shuffle_block_for,
    average_grads,
    clipped_surrogate,
    compute_gae,
    mean_reward,
)
from .types import EnvParams
from .utils.profiling import span

__all__ = [
    "RecurrentPPOConfig",
    "init_recurrent_ppo_runner",
    "make_optimizer",
    "recurrent_ppo_loss",
    "train_iteration_recurrent_ppo",
    "update_epochs_recurrent",
]


@dataclasses.dataclass(frozen=True)
class RecurrentPPOConfig(PPOConfig):
    """:class:`ppo.PPOConfig` with the recurrent defaults: a short window
    (the carry holds the context across iterations) and
    ``shuffle_block`` counted in SEQUENCES."""

    rollout_steps: int = 16
    shuffle_block: int = 512


def make_optimizer(model: RecurrentActorCritic, cfg: PPOConfig,
                   total_iters: int | None = None) -> ppo.Optimizer:
    """:func:`ppo.make_optimizer`: Adam, the clip, the optional anneal."""
    return ppo.make_optimizer(model, cfg, total_iters)


def init_recurrent_ppo_runner(
    generator: torch.Generator, model: RecurrentActorCritic,
    env_params: EnvParams, cfg: PPOConfig, n_envs: int,
    total_iters: int | None = None,
) -> RecurrentRunnerState:
    """Recurrent A2C's runner (:func:`a2c.init_recurrent_runner`) with
    :func:`make_optimizer`'s optimiser."""
    return init_recurrent_runner(generator, model, env_params, cfg, n_envs,
                                 optimizer=make_optimizer(model, cfg, total_iters))


def recurrent_ppo_loss(
    model: RecurrentActorCritic, traj: Transition, init_carry,
    adv: torch.Tensor, returns: torch.Tensor, cfg: PPOConfig,
    compute_dtype=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The clipped-surrogate loss over a ``[T, S]`` window of S
    sequences: the model re-run from ``init_carry`` (``[S, H]`` each, the
    carry the behaviour policy started the window with), resetting at the
    window's episode ends as the collect did, so that with unchanged
    weights the ratio is 1. The advantage is normalised over all T*S
    elements; the log-probs and entropies of all action groups at once
    (:func:`models.policy.action_log_prob_and_entropy_grouped`).
    ``compute_dtype``: the unroll's (:meth:`RecurrentActorCritic.unroll`;
    None, float32 or bfloat16). Returns (total loss, metrics)."""
    _, (logits, value) = model.unroll(init_carry, traj.obs, traj.done,
                                      compute_dtype=compute_dtype)
    logp, entropy = action_log_prob_and_entropy_grouped(logits, traj.dirs, traj.acts)
    return clipped_surrogate(logp, entropy, value, traj.logp, traj.value, adv,
                             returns, cfg)


def update_epochs_recurrent(
    model: RecurrentActorCritic, optimizer: ppo.Optimizer, traj: Transition,
    init_carry, adv: torch.Tensor, returns: torch.Tensor,
    generator: torch.Generator, cfg: PPOConfig,
    perms: torch.Tensor | None = None, group=None,
    compute_dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """``cfg.epochs`` x ``cfg.minibatches`` optimiser steps of
    :func:`recurrent_ppo_loss`, minibatched over the sequence axis in
    blocks of :func:`ppo._shuffle_block_for` sequences (one block
    permutation per epoch, drawn from ``generator`` or given as ``perms``
    ``[epochs, n_blocks]``). ``traj`` fields are ``[T, S(, F)]``,
    ``init_carry`` ``[S, H]`` each. Raises if the minibatches do not
    divide the block count. With ``group`` each step's gradients and
    metrics are averaged over the ranks first (:func:`ppo.average_grads`).
    ``compute_dtype``: bfloat16 (the default, as the fused collect's:
    the recurrence forward and backward in K6,
    :func:`ops.fused_bptt.fused_lstm_bptt`, its products from bf16
    operand pairs held to float32's result) or float32 (the cell step by
    step under autograd). Updates ``model`` in place; returns each
    metric's mean over the steps."""
    check_compute_dtype(compute_dtype)
    t, s = traj.reward.shape
    block = _shuffle_block_for(s, cfg)
    n_blocks = s // block
    if n_blocks % cfg.minibatches:
        raise ValueError(
            f"{s} sequences make {n_blocks} blocks of {block}, which "
            f"{cfg.minibatches} minibatches do not divide (no block is "
            f"dropped): choose shuffle_block or the env count to fit")
    mb_blocks = n_blocks // cfg.minibatches
    mb = mb_blocks * block

    def blocks(x):                  # [T, S, ...] -> [T, n_blocks, block, ...]
        return x.reshape(t, n_blocks, block, *x.shape[2:])

    fields = {name: blocks(getattr(traj, name)) for name in TRAJ_FIELDS}
    adv_blk, ret_blk = blocks(adv), blocks(returns)
    carry_blk = tuple(c.reshape(n_blocks, block, -1) for c in init_carry)
    history = []
    for perm in _epoch_perms(n_blocks, cfg, generator, perms):
        for idx in perm.reshape(cfg.minibatches, mb_blocks):
            def take(x):
                return x[:, idx].reshape(t, mb, *x.shape[3:])

            optimizer.zero_grad()
            loss, metrics = recurrent_ppo_loss(
                model, Transition(**{k: take(v) for k, v in fields.items()}),
                tuple(c[idx].reshape(mb, -1) for c in carry_blk),
                take(adv_blk), take(ret_blk), cfg, compute_dtype=compute_dtype)
            loss.backward()
            metrics = average_grads(optimizer.params, {
                k: v.detach() for k, v in metrics.items()}, group)
            optimizer.step()
            history.append(metrics)
    return _mean_metrics(history)


def train_iteration_recurrent_ppo(
    runner: RecurrentRunnerState, env_params: EnvParams, cfg: PPOConfig,
    collect_fn=None, update_fn=None, group=None,
) -> tuple[RecurrentRunnerState, dict[str, torch.Tensor]]:
    """One recurrent PPO iteration: collect (``collect_fn``, default
    :func:`a2c.collect_recurrent_rollout`;
    :func:`a2c.collect_recurrent_rollout_fused` for the kernel) -> GAE ->
    the epochs of ``update_fn`` (default :func:`update_epochs_recurrent`)
    from the carry the window started with. Returns (runner, metrics:
    the update's mean ``loss``, ``pg_loss``, ``v_loss``, ``entropy``,
    ``approx_kl`` and the team-0 rows' ``mean_reward``), both averaged
    over ``group``'s ranks. The three stages are the spans
    ``rppo.collect``, ``rppo.gae`` and ``rppo.update`` while a profiler
    runs."""
    collect_fn = collect_fn or collect_recurrent_rollout
    update_fn = update_fn or update_epochs_recurrent
    init_carry = _flat_carry(runner.carry, runner.obs.shape[0])
    with span("rppo.collect"):
        runner, traj, last_value = collect_fn(runner, env_params, cfg)
    with span("rppo.gae"):
        adv, returns = compute_gae(traj, last_value, cfg)
    with span("rppo.update"):
        metrics = update_fn(runner.model, runner.optimizer, traj, init_carry, adv,
                            returns, runner.generator, cfg, group=group)
    metrics["mean_reward"] = mean_reward(traj, group)
    return runner, metrics
