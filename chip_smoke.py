#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from gym_futbol_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, and drives the
port's main paths:
- phases 3-6, the random-policy rollout (fused_rollout,
  fused_rollout_replay): 4096 2v2 envs for 512 steps (bench config 3),
  a replay of given actions (held bitwise to its plain version at 2v2,
  custom params, 3v3 and 5v5), the random rollout held bitwise to its
  plain version on every route of rollout_plan (table mode at 2v2,
  custom params and 5v5, Philox at config 3), and one 5v5 rollout of
  65536 envs; the
  replay timed at 2v2 with 4096 envs (T=16 and 128), 3v3 with 16384 and
  5v5 with 65536 by its plan and with every other lane count, beside
  its bound;
- phases 7-10, the self-play policy path (fused_collect,
  fused_selfplay_rollout) in both routes, bfloat16 on the tensor cores
  (the main path's) and float32 on the CUDA cores (exact): table- and
  Philox-mode parity at both main paths' shapes and on other ones (bf16:
  within a tolerance, every differing action a counted near tie), a
  teacher-forced check of the collect against the actor-critic module,
  Philox sampling statistics, then PPO collection + GAE at bench config
  4 (3v3, 16384 envs, T=128, hidden (256, 256)) and fused evaluation at
  bench config 6 (2v2, 4096 envs, T=512, two (128, 128) MLPs), both
  routes' times, the layout plan and a cuBLAS yardstick;
- phases 11-13, PPO training (fused_minibatch_grad): the update kernels
  (bf16 on the tensor cores, float32 on the CUDA-core chain) against
  their plain version and against autograd on real minibatches (a
  collected buffer, after one iteration's updates have moved the
  weights, so that both clips decide some samples' gradients; 3v3, 2v2,
  custom params, a 5v5 G = 10 head, and 5v5 and 4v4 at (256, 256), whose
  W2 is streamed), then train_iteration at bench config 4 (fused collect,
  GAE, 4 epochs x 4 minibatches of 2^20 samples on the kernels) and once
  through the training CLI, then the kernels' times beside the CUDA-core
  chain's and cuBLAS's on the same products, and W2 streamed at config 4
  (bitwise the resident layout) timed beside resident;
- phases 14-16, the recurrent learners (fused_recurrent_collect) in
  both routes, bfloat16 on the tensor cores (the main path's) and
  float32 on the CUDA cores (exact): the kernel against its plain
  version in table and Philox modes from non-zero carries (3v3, 16384
  envs, hidden (128,), H=128, and other shapes; bf16 within a
  tolerance, every differing action a counted near tie), teacher-forced
  checks against the RecurrentActorCritic module (bf16: with rounded
  operands) and sampling statistics, then recurrent PPO through
  train_iteration_recurrent_ppo at that shape (T=16), one recurrent A2C
  iteration and the training CLI with --recurrent, then K5's times in
  both routes, its layout plan against the other layouts and a cuBLAS
  yardstick;
- phase 17, normalised PPO through K2 and K3: the normalised fused
  collect (statistics folded into K2's first layer, the buffer's moments,
  the post-hoc reward scaling) against its plain version (float32
  bitwise; bf16 by phase 7's rules on the folded weights), the fold's
  bf16-vs-f32 log-prob error beside the unnormalised one, K3 on folded
  weights against its plain version and, unfolded, against autograd on
  the z-scored buffer (3v3, a ragged 1000 envs, T=16, hidden (256, 256),
  statistics from 2 plain normalised iterations); the normalised
  train_iteration at config 4 split into K2, obs moments, post-hoc reward
  norm, GAE and K3, beside phase 12's; a bitwise resume through
  utils.checkpoint (2 iterations, save, restore into a fresh runner, 1
  more, against 3); the CLI checkpointed and logged for 4 iterations,
  then resumed to 6;
- phase 18, the distribution layer (gym_futbol_tpu_torch.parallel): two
  spawned ranks sharing the card over gloo run, each on its half of the
  envs, K1a through shard_fused_rollout at config 3 (each rank bitwise
  one unsharded launch of its envs with its folded seed; the ranks'
  streams differ), K1b on its share, two sharded fused PPO iterations at
  config 4 width (K2, K3 in bf16; the replicated leaves bitwise equal
  across the ranks) and one sharded recurrent PPO iteration (K5), every
  one of those kernels launched on each rank; the iteration's time and
  the all-reduce's per minibatch; one rank over NCCL runs the sharded
  fused iteration bitwise equal to the undistributed one; the training
  CLI under torchrun on two ranks (--distributed --fused-collect);
- phase 19, FutbolEnv on the card through make("futbol-v0");
- phase 20, the PPO iteration at bench config 5 (5v5, 65536 envs, T=64,
  hidden (256, 256), 4 x 4 minibatches of 2^21 samples): train_iteration
  on the fused collect and K3 in bf16, K3 on the tensor cores with W2
  streamed through shared memory (its forward block does not fit with W2
  resident), then with K3 forced to the CUDA-core chain, each split into
  collect, update and the rest, with their launch counts; K3 alone on a
  config-5 minibatch against its plain version, timed beside the chain,
  the plain version, its bound and cuBLAS, and a profile of one update;
  K2's bound per step at config 5 and cuBLAS on its per-step products;
- phase 21, the learning gates (gym_futbol_tpu_torch.check_learning and
  check_recurrent_learning) in this process at a smoke budget: the MLP
  gate split over two calls (--max-new-seeds 1 exits 2, the second call
  trains only the rest and plays the league), then recurrent PPO and
  recurrent A2C on fused_recurrent_collect (A2C on the route the package
  picks for it), every kernel's launches counted exactly;
- phase 22, the JAX package's array-form game, physics and types API on
  a CUDA batch (bench config 4's 16384 3v3 envs, states from one K1a
  rollout), each function bitwise equal to its scalar form;
- phase 24, K6 (ops.fused_bptt: the recurrent PPO update's LSTM
  recurrence, forward and backward) at the recurrent PPO cell's
  minibatch (8192 sequences, T = 128, torso 64, H = 256): both kernels
  against their plain versions, their times beside the plain versions',
  the float32 autograd unroll they replace, cuBLAS on the same per-step
  products and their bound;
- phase 25, K5's and K6's LayerNorm instantiations (stable-baselines'
  layer-normalised cell) at the LayerNorm cell's shapes (K5: 16384 3v3
  envs, torso (64, 64), H = 256; K6: phase 24's minibatch), each held to
  its plain version step by step (the recurrence is chaotic), their
  times beside the plain instantiations' and the plain versions', the
  bounds of futbench/counts_lnlstm.py, cuBLAS on the same per-step
  products, t Wi's one stacked product against three, LayerNorm's
  backward tail kernel against its plain version on one minibatch's
  saved state and timed beside it and its bound, and recurrent PPO
  iterations at the cell's configuration with the LayerNorm route's
  launches under their own counters;
- phase 23, the port's bench as a user runs it: python -m
  gym_futbol_tpu_torch.bench --config N --verbose for configs 2-6 at
  their presets, then --scaling with one rank, each in a subprocess:
  exit 0, one JSON last line with the JAX bench's keys, the launches of
  each config's kernels over its calls (every other count 0), and its
  env-steps/s beside the rate this process's time for the same shape
  implies (phases 6, 10 and 20).
Phase 6 also measures the contact solver's active share (the pairs and
walls the culled env step updates) at config 3, the 5v5 scale and config
4, with the replay's solver slots per warp beside the warp union, and
the env step's operation count, and so every bound that counts it, uses
that share.
One line per phase; any failed phase exits nonzero with no result line.
The last two lines are the kernels' record and ``{"ok": true, "device":
{...}}``. Each kernel's ``bound_ms`` is the least time the card could
take for its work on this run's inputs: the larger of its bytes (each
input read once, each output written once) over the memory rate and its
operations over the peak rate of their type (H100 SXM data sheet, 700
W); operations are counted by hand from the shapes (env_step_ops,
mlp_ops, K3's layer products).

Run from the repository root:  python3 chip_smoke.py
It needs a CUDA device and nvcc, and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

B3, T3 = 4096, 512          # bench config 3: 2v2
B5, T5 = 65536, 64          # bench config 5 scale: 5v5
T5_PARITY = 4               # phase 7: K2 at config 5 against its plain version
H5 = (256, 256)             # phase 20: config 5's PPO iteration, the default torso
N5_ITERS = 3                # phase 20: timed iterations on each route
B4, T4, H4 = 16384, 128, (256, 256)   # bench config 4: 3v3 PPO collect
B6, T6, H6 = 4096, 512, (128, 128)    # bench config 6: 2v2 evaluation
T_PARITY = 16
T_STATS = 64
T_FORCED = 32
SOURCE = "gym_futbol_tpu_torch/csrc/fused_rollout.cu"
POLICY_SOURCE = "gym_futbol_tpu_torch/csrc/fused_policy_tc.cu"
UPDATE_SOURCE = "gym_futbol_tpu_torch/csrc/fused_update.cu"
RECURRENT_SOURCE = "gym_futbol_tpu_torch/csrc/fused_recurrent_tc.cu"
BPTT_SOURCE = "gym_futbol_tpu_torch/csrc/fused_bptt_tc.cu"
REPLACES = {
    "fused_rollout": "gym_futbol_tpu/ops/fused_rollout.py:342",
    "fused_rollout_replay": "gym_futbol_tpu/ops/fused_rollout.py:487",
    "fused_collect": "gym_futbol_tpu/ops/fused_collect.py:304",
    "fused_selfplay_rollout": "gym_futbol_tpu/ops/fused_actor.py:237",
    "fused_minibatch_grad": "gym_futbol_tpu/ops/fused_update.py:255",
    "fused_recurrent_collect": "gym_futbol_tpu/ops/fused_recurrent.py:328",
}
# H100 SXM peaks (NVIDIA data sheet, 700 W): memory, float32 on the CUDA
# cores, dense bfloat16 on the tensor cores.
HBM_BYTES_PER_S, F32_PER_S, BF16_PER_S = 3.35e12, 67e12, 989e12
TC_SMEM = 232448      # shared memory a block may use (H100)
# Kernel against plain version on the same inputs: pos/vel rtol 1e-4 /
# atol 1e-3, rewards 1e-4 absolute, integer state exact.
RTOL, ATOL, REW_ATOL = 1e-4, 1e-3, 1e-4
# Policy kernels against plain versions: every float output within 1e-4
# (the same operations in the same order: bitwise in practice), integers
# and sampled actions exact. Teacher-forced logp and value against the
# actor-critic module (cuBLAS f32 with TF32 off, another summation
# order): 1e-4; the kernel's mirrored view against mirror_obs: 1e-6.
POLICY_ATOL, FORCED_ATOL, MIRROR_ATOL = 1e-4, 1e-4, 1e-6
# The bfloat16 route (tensor cores) against the plain bfloat16 version
# on the same uniforms: the same rounding points, the f32 sums in another
# order. Where that order puts an activation's f32 value on the other
# side of a bf16 rounding boundary, the rounded activation moves by one
# bf16 ulp (2^-8 relative), and the logits and values after it by up to
# a few 1e-3 (<= 2.3e-3 measured over T = 3-8 on the card): logp, value
# and last_value within 1e-2 on the envs whose actions all agreed; the
# env's own outputs (obs, rewards, states) within POLICY_ATOL there, and
# integers exact. A sampled action may differ only where the uniform
# lies within TIE_FACTOR x the measured log-prob error of a boundary of
# the plain version's CDF (a near tie); such envs leave the comparison
# from that step on and are counted. The teacher-forced bf16 check
# against the module's forward with bf16-rounded operands (cuBLAS f32
# sums, another order again): the same 1e-2.
POLICY_BF16_ATOL, FORCED_BF16_ATOL, TIE_FACTOR = 1e-2, 1e-2, 2.0
# The update kernels (fused_minibatch_grad) against their plain version
# on the same inputs, per gradient leaf rel-L2: float32 sums in another
# order only; bfloat16 the same rounding points, so only the summation
# order and the rare one-ulp bfloat16 flips of an operand that it causes.
# Against autograd of ppo_loss through the module (float32, TF32 off):
# another formulation of the same sums. Metric sums: error relative to
# the plain version's sum of |per-sample term| (compare_update).
K3_F32_REL, K3_BF16_REL, K3_AUTOGRAD_REL, K3_METRIC_REL = 1e-4, 1e-3, 1e-4, 1e-4
# approx_kl's terms, (ratio - 1) - log ratio, vanish on an on-policy
# minibatch (the weights that collected it: the main path's first of each
# iteration), where each is float32 noise, the rounding of a ratio near 1.
# There its sum may also differ by K3_KL_ULPS float32 ulps of 1 a sample.
K3_KL_ULPS = 4
K3_BLOCK = 1024             # PPOConfig.shuffle_block
# Shared memory below config 4's resident forward block (229,504 bytes)
# and above its streamed one (163,968): W2 streamed where it fits resident
K3_STREAM_SMEM = 200000
# The recurrent main path: the JAX recurrent gate at config-4 scale
# (3v3, 16384 envs, T=16, hidden (128,), LSTM size 128).
BR, TR, HR, LSTM_R = 16384, 16, (128,), 128
# K5 replayed through the RecurrentActorCritic module (cuBLAS float32,
# TF32 off, another summation order, the carry fed back over 16 steps):
# logp, value and the final carries within 5e-5.
K5_FORCED_ATOL = 5e-5
# Normalised PPO (phase 17): the parity shape (3v3, a ragged 1000 envs,
# T=16, hidden (256, 256), K3 in blocks of 128 samples: 32000 is no
# multiple of 1024) and the resume shape (2048 envs). The fused collect's
# statistics against the plain version's: relative 1e-5 (the same
# reductions on equal buffers: bitwise in practice).
BN, TN, BN_RESUME, BLOCK_N = 1000, 16, 2048, 128
NORM_STAT_REL = 1e-5
# K6 (phase 24) at the recurrent PPO cell's minibatch: 8192 sequences of
# T = 128, torso 64, H = 256. Kernels against their plain versions (the
# backward's fed the forward kernel's saved state), the largest
# difference over the plain output's largest value: forward 5e-3,
# dgates 2e-2 (a float32 sum in another order can land a rounded h one
# bf16 ulp apart, and the recurrence carries it on; 9.1e-4 and 4.3e-3
# measured).
BT_S, BT_T, BT_NT, BT_H = 8192, 128, 64, 256
K6_FWD_REL, K6_BWD_REL = 1e-4, 1e-3
# K5's and K6's LayerNorm instantiations (phase 25) at the LayerNorm
# cell's shapes: K5 at 16384 3v3 envs, torso (64, 64), H = 256 (from game
# states after 32 random-policy steps, non-zero and zero carries), K6 at
# phase 24's minibatch. The layer-normalised recurrence is chaotic (a
# difference in h grows ~1.12x a step), so each is held to its plain
# version step by step: K5 fed its own state and carries one step a call
# (T = 1) for LN_TF_STEPS steps, by phase 14's bf16 rules; K6's forward
# within K6_FWD_REL of its plain version run each step from the kernel's
# carry, its backward within K6_BWD_REL over the window's first
# LN_BWD_STEPS steps (its dh recurrence grows the same way). The main
# path: recurrent PPO iterations at the cell's configuration, the
# LayerNorm route's launches under their own counters, the plain ones 0.
LN_B, LN_HIDDEN, LN_H, LN_T = 16384, (64, 64), 256, 128
LN_TF_STEPS, LN_BWD_STEPS = 16, 4
# LayerNorm's backward tail (phase 25) against its plain version on one
# minibatch's saved state: dx (hi + lo) and the five parameter gradients
# within 1e-5 relative (L2), each: the same float32 work, its row and
# column sums in another order (4.2e-7 and 9.6e-7 measured at most).
LN_TAIL_REL = 1e-5
LN_PPO = dict(gamma=0.99, gae_lambda=0.95, clip_eps=0.2, lr=0.00025, epochs=4,
              minibatches=4, vf_coef=0.5, ent_coef=0.01, max_grad_norm=0.5,
              shuffle_block=512)


class SmokeFailure(RuntimeError):
    pass


PHASE_SECONDS: dict[str, float] = {}
_LAST_LINE = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    """Prints one line of phase ``name``; the seconds since the last line
    go to its phase number (``name``'s, else the message's first word)."""
    print(f"[{name}] {msg}", flush=True)
    key = (name if name[0].isdigit() else msg).split()[0]
    now = time.perf_counter()
    PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare(kernel_out, plain_out, label: str, exact: bool = False) -> float:
    """Kernel vs plain outputs (statef, statei, rewards); returns the
    largest absolute float difference. ``exact``: bitwise equality is
    required (signed zeros compare equal)."""
    import torch

    ksf, ksi, krew = kernel_out
    psf, psi, prew = plain_out
    check(ksf.shape == psf.shape and krew.shape == prew.shape,
          f"{label}: shapes differ")
    check(bool(torch.isfinite(krew).all()) and bool(torch.isfinite(ksf).all()),
          f"{label}: non-finite kernel output")
    err_sf = (ksf - psf).abs()
    err_rew = (krew - prew).abs()
    ok_sf = bool((err_sf <= ATOL + RTOL * psf.abs()).all())
    ok_rew = bool((err_rew <= REW_ATOL).all())
    ok_int = bool(torch.equal(ksi, psi))
    bitwise = bool(torch.equal(ksf, psf) and torch.equal(krew, prew))
    err = max(err_sf.max().item(), err_rew.max().item())
    phase("parity", f"{label}: max |state err| {err_sf.max().item():.3g}, "
          f"max |reward err| {err_rew.max().item():.3g}, integers equal "
          f"{ok_int}, bitwise {bitwise}")
    check(ok_sf and ok_rew and ok_int, f"{label}: kernel disagrees with plain")
    check(bitwise or not exact, f"{label}: kernel not bitwise equal to plain")
    return err


def compare_policy(kernel_out, plain_out, label: str, actions=()) -> float:
    """Policy kernel vs plain outputs (tuples of tensors): floats within
    POLICY_ATOL, integers exact. Reports bitwise agreement and the share
    of packed actions (outputs at positions ``actions``) that agree.
    Returns the largest absolute float difference."""
    import torch

    check(len(kernel_out) == len(plain_out), f"{label}: output count")
    err, ints_equal, bitwise = 0.0, True, True
    for k, p in zip(kernel_out, plain_out):
        check(k.shape == p.shape and k.dtype == p.dtype, f"{label}: shapes differ")
        if k.dtype.is_floating_point:
            check(bool(torch.isfinite(k).all()), f"{label}: non-finite output")
            err = max(err, (k - p).abs().max().item())
        else:
            ints_equal &= bool(torch.equal(k, p))
        bitwise &= bool(torch.equal(k, p))
    n_agree = sum(int((kernel_out[i] == plain_out[i]).sum()) for i in actions)
    n_all = sum(kernel_out[i].numel() for i in actions)
    agree = f", packed actions agreeing {n_agree / n_all:.6f}" if actions else ""
    phase("parity", f"{label}: max |float err| {err:.3g}, integers equal "
          f"{ints_equal}{agree}, bitwise {bitwise}")
    check(err <= POLICY_ATOL and ints_equal, f"{label}: kernel disagrees with plain")
    return err


def group_indices(dirs, acts, n_groups):
    """Packed [T, 2, B] dirs / acts -> sampled indices [T, 2, G, B]."""
    import torch

    return torch.stack([((dirs, acts)[g % 2] >> (3 * (g // 2))) & 7
                        for g in range(n_groups)], 2)


@contextlib.contextmanager
def recorded(module, name: str, out: list):
    """``module.name`` (a function) wrapped inside the block to append
    each call's result to ``out``."""
    orig = getattr(module, name)

    def wrapped(*a, **k):
        out.append(orig(*a, **k))
        return out[-1]

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def recording(module, name: str, calls: list):
    """``module.name`` (a sampler the plain versions call once per view
    and step with (logit rows [G*5, B], n_groups, uniforms [G, B]))
    wrapped to append each call's logits and uniforms to ``calls``;
    returns the original."""
    orig = getattr(module, name)

    def wrapped(logit_rows, n_groups, uniforms):
        calls.append((logit_rows.clone(), uniforms[:n_groups].clone()))
        return orig(logit_rows, n_groups, uniforms)

    setattr(module, name, wrapped)
    return orig


def compare_policy_bf16(kernel_out, plain_out, calls, label: str, actions,
                        floats, env_outs, tie_eps=None):
    """The bf16 route against the plain bf16 version on the same draws.
    ``calls``: the plain version's (logits, uniforms) per step and view
    (``recording``); ``actions``: positions of the packed dirs and acts
    [T, 2, B]; ``floats``: positions of the model's float outputs (logp,
    value, last_value; last axis B), within POLICY_BF16_ATOL; ``env_outs``:
    positions of the env's outputs (states, obs, rewards, goals, dones),
    within POLICY_ATOL, integers exact. Both on the envs whose actions
    all agreed. Each env's first differing action must be a near tie: its
    uniform within TIE_FACTOR x ``tie_eps`` (default: the logp error
    measured here) of a boundary of the plain version's CDF. Returns (the
    largest float error, the logp error measured, the counts)."""
    import torch

    kd, ka = (kernel_out[i] for i in actions)
    t, _, b = kd.shape
    n_groups = calls[0][0].shape[0] // 5
    idx_k = group_indices(kd, ka, n_groups)
    idx_p = group_indices(plain_out[actions[0]], plain_out[actions[1]], n_groups)
    differ = idx_k != idx_p                                  # [T, 2, G, B]
    bad_step = differ.flatten(1, 2).any(1)                   # [T, B]
    bad_env = bad_step.any(0)
    first = torch.where(bad_env, bad_step.int().argmax(0), t)  # T: none
    steps = torch.arange(t, device=kd.device)[:, None]
    logits = torch.stack([c[0] for c in calls]).reshape(t, 2, n_groups, 5, b)
    u = torch.stack([c[1] for c in calls]).reshape(t, 2, n_groups, b)
    cdf = torch.softmax(logits.double(), 3).cumsum(3)[:, :, :, :4]
    margin = (u.double()[:, :, :, None] - cdf).abs().amin(3)   # [T, 2, G, B]
    good = ~bad_env
    err, logp_err = 0.0, 0.0
    for i in floats:
        k, p = kernel_out[i][..., good], plain_out[i][..., good]
        check(bool(torch.isfinite(kernel_out[i]).all()), f"{label}: non-finite output")
        e = (k - p).abs().max().item() if k.numel() else 0.0
        err = max(err, e)
        if i == floats[0]:
            logp_err = e
    env_err, ints_equal = 0.0, True
    for i in env_outs:
        k, p = kernel_out[i][..., good], plain_out[i][..., good]
        if k.dtype.is_floating_point:
            env_err = max(env_err, (k - p).abs().max().item() if k.numel() else 0.0)
        else:
            ints_equal &= bool(torch.equal(k, p))
    delta = TIE_FACTOR * (logp_err if tie_eps is None else tie_eps)
    at_first = differ & (steps == first)[:, None, None, :]
    n_mismatch = int(at_first.sum())
    untied = int((at_first & (margin > delta)).sum())
    in_window = (steps <= first)[:, None, None, :].expand_as(margin)
    n_ties = int((in_window & (margin <= delta)).sum())
    counts = dict(envs_diverged=int(bad_env.sum()), mismatched_samples=n_mismatch,
                  not_near_ties=untied, near_tie_samples=n_ties,
                  samples=int(in_window.sum()))
    phase("parity", f"{label}: on the {int(good.sum())} envs whose actions all "
          f"agreed, max |model float err| {err:.3g} (<= {POLICY_BF16_ATOL}), "
          f"|env float err| {env_err:.3g}, integers equal {ints_equal}; "
          f"near-tie margin {delta:.3g}: {counts}")
    check(err <= POLICY_BF16_ATOL and env_err <= POLICY_ATOL and ints_equal,
          f"{label}: bf16 kernel disagrees with its plain version")
    check(untied == 0, f"{label}: {untied} differing actions are not near ties")
    return max(err, env_err), logp_err, counts


def rounded_forward(model, x):
    """The ActorCritic module's forward with the operands of the torso's
    and the logits head's products rounded to bf16 (f32 sums by cuBLAS),
    the value head in f32: what the bf16 route computes. (logits, value)."""
    import torch

    def rnd(a):
        return a.to(torch.bfloat16).float()

    layers = model.dense_layers()
    h = x
    for layer in layers[:-2]:
        h = torch.tanh(rnd(h) @ rnd(layer.weight).T + layer.bias)
    logits = rnd(h) @ rnd(layers[-2].weight).T + layers[-2].bias
    return logits, (h @ layers[-1].weight.T + layers[-1].bias)[:, 0]


def policy_phases(dev, custom, shares) -> list[dict]:
    """Phases 7-10: the self-play policy kernels (fused_collect,
    fused_selfplay_rollout) against their plain versions, the
    teacher-forced check, sampling statistics and the main path. Returns
    the two kernels' entries of the kernels line."""
    import torch

    from gym_futbol_tpu_torch import EnvParams, evaluate, obs_size, ops, ppo, vector
    from gym_futbol_tpu_torch.env import mirror_obs
    from gym_futbol_tpu_torch.models.policy import (
        ActorCritic,
        action_log_prob_and_entropy_packed,
    )
    from gym_futbol_tpu_torch.ops.fused_rollout import n_draws_per_step, split_state

    fa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
    pol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p4, p6 = EnvParams(players_per_team=3), EnvParams(players_per_team=2)
    errs = {}
    k2_actions, k4_actions = (3, 4), (4, 5)   # packed dirs, acts

    def setup(params, hidden, n_envs, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state, _ = vector.reset_batch(gen, params, n_envs, device=dev)
        model = ActorCritic(params.players_per_team, obs_size(params), hidden,
                            generator=gen, device=dev)
        return (*ops.pack_state(state, params), model, gen)

    # 7: kernel vs plain version, same uniforms, and in Philox mode at
    # the main paths' shapes and on the ragged batch; float32 (exact, the
    # CUDA-core route) and bfloat16 (the tensor-core route, the main
    # path's). The kernels line takes each kernel's bf16 error at its own
    # main path's shape (K2: config 4, K4: config 6; K2 also at config 5,
    # phase 20's collect: the same layout, which phase 20 checks, the
    # selfplay kernel not on that path, float32 bitwise); the other cases
    # must pass all the same.
    f32, bf16 = torch.float32, torch.bfloat16
    ties = {"fused_collect": [], "fused_selfplay_rollout": []}
    config5 = {}
    for label, params, hidden, n_envs, n_steps, philox, main in (
            (f"config 4 3v3 {H4}", p4, H4, B4, T_PARITY, True, "fused_collect"),
            (f"config 6 2v2 {H6}", p6, H6, B6, T_PARITY, True,
             "fused_selfplay_rollout"),
            (f"config 5 5v5 {H5}", EnvParams(players_per_team=5), H5, B5, T5_PARITY,
             False, "config5"),
            ("custom (32, 16)", custom, (32, 16), B3, T_PARITY, False, None),
            ("ragged 2v2 (64, 64)", p6.replace(max_steps=7), (64, 64), 1000,
             T_PARITY, True, None)):
        sf, si, model, gen = setup(params, hidden, n_envs, 4)
        w = fc.flatten_actor_critic(model)
        wa = fa.init_mlp(gen, params, hidden, device=dev)
        wb = fa.init_mlp(gen, params, hidden, device=dev)
        u = torch.rand((n_steps, n_draws_per_step(params), n_envs),
                       generator=gen, device=dev)
        tag = f"7 {label} B={n_envs} T={n_steps}"
        draws = [("table", 0, dict(uniforms=u), dict(uniforms=u))]
        if philox:
            draws.append(("Philox", 5, {}, dict(n_steps=n_steps, seed=5)))
        selfplay = main != "config5"
        for mode in (f32, bf16):
            k2, k4 = [], []
            for name, seed, kw, ref_kw in draws:
                ktag = f"{tag} {str(mode)[6:]}"
                plans = []
                with recorded(fc, "tc_plan", plans):
                    k2_out = ops.fused_collect(sf, si, w, seed, params, n_steps,
                                               compute_dtype=mode, **kw)
                if selfplay:
                    k4_out = ops.fused_selfplay_rollout(
                        sf, si, wa, wb, seed + 1, params, n_steps,
                        return_actions=True, compute_dtype=mode, **kw)
                ref_kw4 = dict(ref_kw, seed=seed + 1) if "seed" in ref_kw else ref_kw
                if mode is f32:
                    k2.append(compare_policy(k2_out, fc.fused_collect_reference(
                        sf, si, w, params, compute_dtype=mode, **ref_kw),
                        f"{ktag} collect, {name}", k2_actions))
                    if selfplay:
                        k4.append(compare_policy(
                            k4_out, fa.fused_selfplay_rollout_reference(
                                sf, si, wa, wb, params, return_actions=True,
                                compute_dtype=mode, **ref_kw4),
                            f"{ktag} selfplay, {name}", k4_actions))
                    else:
                        check(k2[-1] == 0.0, f"{ktag}: float32 not bitwise")
                    continue
                calls = []
                orig = recording(pol, "sample_with_logp", calls)
                try:
                    plain = fc.fused_collect_reference(sf, si, w, params,
                                                       compute_dtype=mode, **ref_kw)
                finally:
                    pol.sample_with_logp = orig
                err, logp_err, n2 = compare_policy_bf16(
                    k2_out, plain, calls, f"{ktag} collect, {name}", k2_actions,
                    (5, 6, 9), (0, 1, 2, 7, 8))
                k2.append(err)
                ties["fused_collect"].append(n2)
                if not selfplay:
                    config5 = dict(err=err, plan=plans[0] if plans else None,
                                   near_ties=n2)
                    phase("7 plan", f"{ktag} collect: {config5['plan']}")
                    continue
                calls = []
                orig = recording(fa, "sample_rows", calls)
                try:
                    plain = fa.fused_selfplay_rollout_reference(
                        sf, si, wa, wb, params, return_actions=True,
                        compute_dtype=mode, **ref_kw4)
                finally:
                    fa.sample_rows = orig
                err4, _, n4 = compare_policy_bf16(
                    k4_out, plain, calls, f"{ktag} selfplay, {name} (near ties "
                    "against the collect's logp error)", k4_actions, (),
                    (0, 1, 2, 3), tie_eps=logp_err)
                k4.append(err4)
                ties["fused_selfplay_rollout"].append(n4)
            if main and mode is bf16:
                errs[main] = max(k4 if main == "fused_selfplay_rollout" else k2)
    for name, counts in ties.items():
        total = {k: sum(c[k] for c in counts) for k in counts[0]}
        phase("7 near ties", f"{name} bf16, every case: {total}")

    # 8: teacher-forced collect at config 4: the kernel's own obs and
    # actions through the actor-critic module, float32, then bfloat16
    # against the module's forward with bf16-rounded operands
    sf, si, model, gen = setup(p4, H4, B4, 5)
    w = fc.flatten_actor_critic(model)
    (_, _, obs, dirs, acts, logp, value, reward, done,
     _) = ops.fused_collect(sf, si, w, 77, p4, T_FORCED, compute_dtype=f32)
    f = obs_size(p4)
    x = obs[:, :f].permute(0, 2, 3, 1).reshape(-1, f)   # (view, step, env)

    def flat(a):                                        # [T, 2, B] -> same order
        return a.transpose(0, 1).reshape(-1)

    with torch.no_grad():
        logits, v = model(x)
        lp, _ = action_log_prob_and_entropy_packed(logits, flat(dirs), flat(acts))
    v_err = (v - flat(value)).abs().max().item()
    lp_err = (lp - flat(logp)).abs().max().item()
    half = x.shape[0] // 2
    mir_err = (mirror_obs(x[:half], p4) - x[half:]).abs().max().item()
    pad_zero = bool((obs[:, f:] == 0).all())
    rew_gap = (reward[:, 0] - reward[:, 1]).abs().max().item()
    dones_agree = bool(torch.equal(done[:, 0], done[:, 1]))
    in_range = all(bool((((a >> (3 * q)) & 7) < 5).all())
                   for a in (dirs, acts) for q in range(p4.players_per_team))
    phase("8 forced", f"config 4 B={B4} T={T_FORCED}, Philox: value err "
          f"{v_err:.3g}, logp err {lp_err:.3g} (<= {FORCED_ATOL}), mirror err "
          f"{mir_err:.3g} (<= {MIRROR_ATOL}), pad rows zero {pad_zero}, "
          f"max |r0 - r1| {rew_gap:.3g}, dones agree {dones_agree}, "
          f"actions in range {in_range}, {int(done.sum()) // 2} episode ends")
    check(v_err <= FORCED_ATOL and lp_err <= FORCED_ATOL, "8: logp/value")
    check(mir_err <= MIRROR_ATOL and pad_zero, "8: mirror or pad rows")
    check(rew_gap > 1e-4 and dones_agree and in_range, "8: rewards/dones/actions")

    (_, _, obs, dirs, acts, logp, value, _, done,
     _) = ops.fused_collect(sf, si, w, 78, p4, T_FORCED)
    x = obs[:, :f].permute(0, 2, 3, 1).reshape(-1, f)
    with torch.no_grad():
        logits, v = rounded_forward(model, x)
        lp, _ = action_log_prob_and_entropy_packed(logits, flat(dirs), flat(acts))
    v_err = (v - flat(value)).abs().max().item()
    lp_err = (lp - flat(logp)).abs().max().item()
    phase("8 forced", f"config 4 B={B4} T={T_FORCED}, Philox, bfloat16: value err "
          f"{v_err:.3g}, logp err {lp_err:.3g} (<= {FORCED_BF16_ATOL}) against the "
          f"module's forward with bf16-rounded operands; "
          f"{int(done.sum()) // 2} episode ends")
    check(v_err <= FORCED_BF16_ATOL and lp_err <= FORCED_BF16_ATOL,
          "8: bf16 logp/value")

    # 9: Philox sampling statistics of the bf16 route (the main path's).
    # Per group and choice, the kernel's frequency against the mean
    # softmax probability of its own obs through the bf16-rounded forward.
    def max_z(counts, p_sum, var_sum, n):
        se = var_sum.sqrt() / n
        return ((counts / n - p_sum / n).abs() / se).max().item()

    n_groups = 2 * p4.players_per_team
    probs = torch.softmax(logits.double().reshape(-1, n_groups, 5), -1)
    packed = (flat(dirs), flat(acts))
    z2 = 0.0
    for g in range(n_groups):
        a = (packed[g % 2] >> (3 * (g // 2))) & 7
        onehot = torch.nn.functional.one_hot(a.long(), 5).double()
        pg = probs[:, g]
        z2 = max(z2, max_z(onehot.sum(0), pg.sum(0), (pg * (1 - pg)).sum(0),
                           pg.shape[0]))
    phase("9 stats", f"collect, bfloat16: {x.shape[0]} samples x {n_groups} groups, "
          f"max |freq - p| / SE {z2:.3f} (<= 5)")
    check(z2 <= 5.0, "9: collect sampling statistics")

    sf, si, _, gen = setup(p6, (16,), B4, 6)
    wa = fa.init_mlp(gen, p6, H6, device=dev)
    wb = fa.init_mlp(gen, p6, H6, device=dev)
    n_groups = 2 * p6.players_per_team
    acc = [torch.zeros(2, n_groups, 5, dtype=torch.float64, device=dev)
           for _ in range(3)]
    n_calls = 8
    for i in range(n_calls):
        rows = split_state(sf, si, p6.n_bodies)
        view_probs = []
        for view, wts in ((0, wa), (1, wb)):
            logits6 = fa.mlp_logit_rows(pol.obs_matrix(*rows[:5], p6, view == 1),
                                        wts, bf16)
            view_probs.append(torch.softmax(
                logits6.T.double().reshape(-1, n_groups, 5), -1))
        sf, si, _, _, dirs4, acts4 = ops.fused_selfplay_rollout(
            sf, si, wa, wb, 100 + i, p6, 1, return_actions=True)
        for view in range(2):
            for g in range(n_groups):
                a = ((dirs4, acts4)[g % 2][0, view] >> (3 * (g // 2))) & 7
                pg = view_probs[view][:, g]
                acc[0][view, g] += torch.nn.functional.one_hot(a.long(), 5).sum(0)
                acc[1][view, g] += pg.sum(0)
                acc[2][view, g] += (pg * (1 - pg)).sum(0)
    z4 = max_z(*acc, n_calls * B4)
    phase("9 stats", f"selfplay, bfloat16: {n_calls} x {B4} envs x 2 views x {n_groups} "
          f"groups, max |freq - p| / SE {z4:.3f} (<= 5)")
    check(z4 <= 5.0, "9: selfplay sampling statistics")

    # 10: the main path: PPO collection + GAE at config 4, fused
    # evaluation at config 6
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ActorCritic(p4.players_per_team, obs_size(p4), H4, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=T4)
    box = {"runner": ppo.init_runner(gen, model, p4, cfg, B4)}

    def collect(i):
        runner, traj, last_v = ppo.collect_rollout_fused(box["runner"], p4, cfg)
        box.update(runner=runner, traj=traj,
                   gae=ppo.compute_gae(traj, last_v, cfg))

    for i in range(2):
        collect(i)
    iters4 = 20 if time_cuda(collect, 1) < 50 else 5
    ms4 = time_cuda(collect, iters4)
    BENCH_REFERENCE_MS[4] = ("phase 10", ms4)
    traj, (adv, ret) = box["traj"], box["gae"]
    check(tuple(traj.obs.shape) == (pol.feature_rows(p4), 2 * T4 * B4)
          and tuple(adv.shape) == (T4, 2 * B4), "10: collect shapes")
    check(bool(torch.isfinite(adv).all() and torch.isfinite(ret).all()
               and torch.isfinite(traj.obs).all()), "10: non-finite collect")
    t_clock = box["runner"].env_state.t
    check(bool(((t_clock >= 0) & (t_clock < p4.max_steps)).all()), "10: clock")

    wa6 = fa.init_mlp(gen, p6, H6, device=dev)
    wb6 = fa.init_mlp(gen, p6, H6, device=dev)
    evals = []

    def run_eval(i):
        evals.append(evaluate.evaluate_fused(p6, wa6, wb6, n_envs=B6,
                                             n_steps=T6, seed=i))

    for i in range(2):
        run_eval(i)
    iters6 = 20 if time_cuda(run_eval, 1) < 50 else 5
    ms6 = time_cuda(run_eval, iters6)
    BENCH_REFERENCE_MS[6] = ("phase 10", ms6)
    m = evals[-1]
    check(abs(m["win_rate_a"] + m["win_rate_b"] + m["draw_rate"] - 1.0) < 1e-9
          and (m["goals"] >= 0).all() and math.isfinite(m["mean_team0_reward"]),
          f"10: evaluation metrics {m}")
    launches = {k: ops.LAUNCHES[k] for k in (
        "fused_collect", "fused_selfplay_rollout", "fused_collect_f32",
        "fused_selfplay_rollout_f32")}
    check(launches["fused_collect"] > 0 and launches["fused_selfplay_rollout"] > 0,
          f"10: the main path skipped a kernel: {launches}")
    check(launches["fused_collect_f32"] == launches["fused_selfplay_rollout_f32"] == 0,
          f"10: the main path left the tensor-core route: {launches}")
    phase("10 main path", f"collect_rollout_fused + compute_gae, 3v3 B={B4} "
          f"T={T4} hidden {H4}: {ms4:.3f} ms/iteration, "
          f"{B4 * T4 / ms4 * 1e3:.6g} env-steps/s ({iters4} iterations)")
    phase("10 main path", f"evaluate_fused, 2v2 B={B6} T={T6} MLPs {H6}: "
          f"{ms6:.3f} ms/evaluation, {B6 * T6 / ms6 * 1e3:.6g} env-steps/s "
          f"({iters6} evaluations); last: goals {m['goals'].tolist()}, "
          f"win rates {m['win_rate_a']:.4f} / {m['win_rate_b']:.4f}")
    phase("10 main path", f"kernel launches in the main path (bfloat16 tensor-core "
          f"route under each kernel's name, float32 under _f32): {launches}")
    plan4 = pol.tc_plan(p4, [H4], B4)
    plan6 = pol.tc_plan(p6, [H6, H6], B6)
    phase("10 plan", f"fused_collect config 4: {plan4}")
    phase("10 plan", f"fused_selfplay_rollout config 6: {plan6}")

    # the kernels alone in both routes, in turns; the env step alone
    # (fused_rollout, random actions) at the same batches; the plain
    # versions at the same batch
    sf4, si4 = ops.pack_state(box["runner"].env_state, p4)
    w4 = fc.flatten_actor_critic(model)
    state6, _ = vector.reset_batch(gen, p6, B6, device=dev)
    sf6, si6 = ops.pack_state(state6, p6)

    def k2(mode):
        return lambda i: ops.fused_collect(sf4, si4, w4, 500 + i, p4, T4,
                                           compute_dtype=mode)

    def k4(mode):
        return lambda i: ops.fused_selfplay_rollout(sf6, si6, wa6, wb6, 600 + i, p6,
                                                    T6, compute_dtype=mode)

    ms_k2, ms_k2_f32, ms_k2_again = (time_cuda(k2(mode), 3) / T4
                                     for mode in (bf16, f32, bf16))
    ms_k4, ms_k4_f32, ms_k4_again = (time_cuda(k4(mode), 5) / T6
                                     for mode in (bf16, f32, bf16))
    # the plan's choice against the other layouts it weighs (the plan
    # function replaced, where each wrapper looks it up, for the run, as
    # with update_plan in phase 13)
    plan_fn, layouts = pol.tc_plan, {}
    for label, fn, n_steps, alternatives in (
            ("fused_collect config 4", k2, T4, ((128, False), (64, True), (32, True))),
            ("fused_selfplay_rollout config 6", k4, T6,
             ((32, False), (64, True), (128, True)))):
        for envs, resident in alternatives:
            def forced(*a, envs=envs, resident=resident, **kw):
                p = plan_fn(*a, **kw)
                return dict(p, envs=envs, weights="resident" if resident else "streamed",
                            smem=(p["frag_bytes"] if resident else 0)
                            + envs // 32 * sum(p["t_bytes"]))
            fa.tc_plan = fc.tc_plan = forced
            try:
                layouts[f"{label}, {envs} envs, {'resident' if resident else 'streamed'}"] = (
                    time_cuda(fn(bf16), 3) / n_steps)
            finally:
                fa.tc_plan = fc.tc_plan = plan_fn
    phase("10 plan", "other layouts, ms/step (the plan's: the bfloat16 times "
          "below): " + "; ".join(f"{k} {v:.5f}" for k, v in layouts.items()))
    ms_env4 = time_cuda(lambda i: ops.fused_rollout(sf4, si4, 700 + i, p4, T4), 3) / T4
    ms_env6 = time_cuda(lambda i: ops.fused_rollout(sf6, si6, 800 + i, p6, T6), 5) / T6
    t_plain = 2
    fc.fused_collect_reference(sf4, si4, w4, p4, 1, seed=0)
    plain_k2 = time_cuda(lambda i: fc.fused_collect_reference(
        sf4, si4, w4, p4, t_plain, seed=1 + i), 1) / t_plain
    plain_k4 = time_cuda(lambda i: fa.fused_selfplay_rollout_reference(
        sf6, si6, wa6, wb6, p6, t_plain, seed=1 + i), 1) / t_plain
    cfg2 = ppo.PPOConfig(rollout_steps=t_plain)

    def plain_collect(i):
        _, traj2, last2 = ppo.collect_rollout(box["runner"], p4, cfg2)
        ppo.compute_gae(traj2, last2, cfg2)

    plain_collect(0)
    ms_plain4 = time_cuda(plain_collect, 1)
    pa, pb = fa.mlp_team_policy(wa6, p6), fa.mlp_team_policy(wb6, p6)
    ms_plain6 = time_cuda(lambda i: evaluate.evaluate(
        p6, pa, pb, n_envs=B6, n_steps=t_plain, seed=i, device=dev), 1)
    phase("10 kernels", f"fused_collect config 4 T={T4}, ms/step: bfloat16 on "
          f"the tensor cores {ms_k2:.5f} (again after float32: {ms_k2_again:.5f}), "
          f"float32 on the CUDA cores {ms_k2_f32:.5f}; the env step alone "
          f"(fused_rollout) {ms_env4:.5f}; plain version {plain_k2:.1f}")
    phase("10 kernels", f"fused_selfplay_rollout config 6 T={T6}, ms/step: "
          f"bfloat16 on the tensor cores {ms_k4:.5f} (again: {ms_k4_again:.5f}), "
          f"float32 on the CUDA cores {ms_k4_f32:.5f}; the env step alone "
          f"(fused_rollout) {ms_env6:.5f}; plain version {plain_k4:.1f}")
    phase("10 plain", f"collect_rollout + compute_gae, config 4 T={t_plain}: "
          f"{ms_plain4:.1f} ms, {B4 * t_plain / ms_plain4 * 1e3:.6g} env-steps/s")
    phase("10 plain", f"evaluate, config 6 T={t_plain}: {ms_plain6:.1f} ms, "
          f"{B6 * t_plain / ms_plain6 * 1e3:.6g} env-steps/s")
    # bounds per step: state and weights read, state written once per
    # call; K2's obs, per-step rows and bootstrap values, K4's rewards
    # and goals written once. Operations per env-step: the env step, and
    # the MLP of both views (K2: one actor-critic; K4: each team's
    # policy). In bfloat16 the products of the torso and the logits head
    # run on the tensor cores; the biases and the value head stay f32.
    def bf16_ops(weights):       # two per multiply-add of the bf16 products
        return sum(2 * w.numel() for w in weights[::2])

    bound_k2, bound_k2_f32, ops_k2, ops_k2_bf16 = k2_bound(
        p4, w4, sf4, si4, B4, T4, shares["3v3"])
    ops_k4 = env_step_ops(p6, shares["2v2"]) + mlp_ops(wa6) + mlp_ops(wb6)
    ops_k4_bf16 = bf16_ops(wa6) + bf16_ops(wb6)
    bytes_k4 = (2 * nbytes(sf6, si6) + nbytes(*wa6, *wb6)
                + 4 * B6 * (T6 + 2))
    bound_k4_f32 = bound(bytes_k4 / T6, B6 * ops_k4)
    bound_k4 = bound(bytes_k4 / T6, B6 * (ops_k4 - ops_k4_bf16), B6 * ops_k4_bf16)
    phase("10 bound", f"the env step at the active shares: {env_step_ops(p4, shares['3v3'])}"
          f" operations at 3v3 (every constraint {env_step_ops(p4)}), "
          f"{env_step_ops(p6, shares['2v2'])} at 2v2 (every constraint "
          f"{env_step_ops(p6)})")
    phase("10 bound", f"fused_collect: {ops_k2} operations per env-step, of them "
          f"{ops_k2_bf16} bf16 products -> bfloat16 {bound_k2[0]:.6g} ms/step "
          f"({bound_k2[1]}), float32 {bound_k2_f32[0]:.6g} ({bound_k2_f32[1]}); "
          f"fused_selfplay_rollout: {ops_k4}, of them {ops_k4_bf16} bf16 -> "
          f"bfloat16 {bound_k4[0]:.6g} ({bound_k4[1]}), float32 "
          f"{bound_k4_f32[0]:.6g} ({bound_k4_f32[1]})")
    # yardstick, never called by the port: cuBLAS (torch.matmul, bf16) on
    # the same per-step layer products of both views
    ms_cublas4 = k2_cublas_ms(dev, p4, w4, B4, H4)
    x6 = [torch.randn(B6, d, device=dev, dtype=bf16) for d in (obs_size(p6), *H6)]
    m6 = [w.to(bf16) for w in (*wa6[::2], *wb6[::2])]

    def products6(i):
        for v in range(2):
            for x, w in zip(x6, m6[3 * v:3 * v + 3]):
                torch.matmul(x, w)

    products6(0)
    ms_cublas6 = time_cuda(products6, 20)
    phase("10 kernels", f"yardstick: cuBLAS (torch.matmul, bf16) on the same "
          f"per-step layer products of both views: config 4 {ms_cublas4:.5f} "
          f"ms/step ({B4 * ops_k2_bf16 / ms_cublas4 / 1e9:.4g} TFLOP/s), config 6 "
          f"{ms_cublas6:.5f} ({B6 * ops_k4_bf16 / ms_cublas6 / 1e9:.4g} TFLOP/s), "
          f"20 iterations each")
    del x6
    for line in ptxas_summary(_build_log()):
        if line.startswith(("collect_", "selfplay_")):
            phase("10 kernels", line)
    return [
        {"name": "fused_collect", "route": "cuda", "source": POLICY_SOURCE,
         "env_step": "culled" if fc.collect_culls(p4) else "unculled",
         "replaces": REPLACES["fused_collect"],
         "launches": launches["fused_collect"],
         "max_abs_err": errs["fused_collect"], "ms": ms_k2,
         "plain_ms": plain_k2, "bound_ms": bound_k2[0],
         "bound_by": bound_k2[1], "library_ms": None,
         "f32_route_ms": ms_k2_f32, "f32_bound_ms": bound_k2_f32[0],
         "unit": f"ms per step of the {B4}-env 3v3 batch, hidden {H4}, bfloat16",
         "config5_max_abs_err": config5["err"], "config5_plan": config5["plan"],
         "config5_near_ties": config5["near_ties"],
         "config5_unit": f"bfloat16 against the plain bfloat16 version on the "
                         f"same uniforms, 5v5 B={B5} T={T5_PARITY} hidden {H5}, "
                         f"in phase 20's layout"},
        {"name": "fused_selfplay_rollout", "route": "cuda",
         "source": POLICY_SOURCE, "replaces": REPLACES["fused_selfplay_rollout"],
         "launches": launches["fused_selfplay_rollout"],
         "max_abs_err": errs["fused_selfplay_rollout"], "ms": ms_k4,
         "plain_ms": plain_k4, "bound_ms": bound_k4[0],
         "bound_by": bound_k4[1], "library_ms": None,
         "f32_route_ms": ms_k4_f32, "f32_bound_ms": bound_k4_f32[0],
         "unit": f"ms per step of the {B6}-env 2v2 batch, two MLPs {H6}, "
                 f"bfloat16"},
    ]


def compare_update(kernel_out, other_out, terms, label: str,
                   grad_rel: float, metric_rel: float, on_policy: bool = False) -> float:
    """Gradients and metric sums of fused_minibatch_grad against another
    computation of them: per leaf the max abs error and the rel-L2
    (within ``grad_rel``); each metric sum's error relative to the sum
    of |per-sample term| in ``terms`` (the plain version's, within
    ``metric_rel``: the surrogate's terms cancel in the sum); on an
    ``on_policy`` minibatch approx_kl's may instead be within K3_KL_ULPS
    float32 ulps of 1 per sample. Returns the largest absolute gradient
    error."""
    import torch

    (kg, km), (pg, pm) = kernel_out, other_out
    check(len(kg) == len(pg), f"{label}: leaf count")
    leaves, worst_abs, worst_rel = [], 0.0, 0.0
    for k, p in zip(kg, pg):
        check(k.shape == p.shape, f"{label}: shapes differ")
        check(bool(torch.isfinite(k).all()), f"{label}: non-finite gradient")
        err = (k - p).abs().max().item()
        rel = ((k - p).norm() / p.norm().clamp_min(1e-30)).item()
        leaves.append(f"{err:.3g}/{rel:.3g}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    abs_err = {k: abs(km[k].item() - pm[k].item()) for k in km}
    m_err = {k: e / max(terms[k].abs().sum().item(), 1e-30)
             for k, e in abs_err.items()}
    kl_floor = K3_KL_ULPS * 2.0 ** -23 * terms["approx_kl"].numel() if on_policy else 0.0
    m_ok = {k: e <= metric_rel or (k == "approx_kl" and abs_err[k] <= kl_floor)
            for k, e in m_err.items()}
    floor = (f" (on-policy: approx_kl's absolute {abs_err['approx_kl']:.3g}, "
             f"floor {kl_floor:.3g})") if on_policy else ""
    phase("parity", f"{label}: per leaf max|err|/rel-L2 {' '.join(leaves)}; "
          f"metric sums err " + ", ".join(f"{k} {e:.3g}" for k, e in m_err.items())
          + floor)
    check(worst_rel <= grad_rel and all(m_ok.values()),
          f"{label}: disagrees (rel-L2 {worst_rel:.3g} > {grad_rel} or metrics "
          f"{m_err} > {metric_rel})")
    return worst_abs


def update_minibatch(dev, params, hidden, n_envs, n_steps, block, mb_blocks,
                     seed):
    """A real minibatch for fused_minibatch_grad: a fused collect of
    ``n_envs`` x ``n_steps`` by a fresh ActorCritic and its GAE, cut into
    blocks as update_epochs_fused cuts it; ``mb_blocks`` blocks in
    permuted order. The weights are those after one iteration's updates
    on that buffer (update_epochs_fused), not those that collected it, so
    that the ratio and the value move past their clips as in the main
    path's later minibatches. Returns (model, cfg, args, kw)."""
    import torch

    from gym_futbol_tpu_torch import obs_size, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = ActorCritic(params.players_per_team, obs_size(params), hidden,
                        device=dev)
    cfg = ppo.PPOConfig(rollout_steps=n_steps, shuffle_block=block)
    runner = ppo.init_runner(gen, model, params, cfg, n_envs)
    runner, traj, last_v = ppo.collect_rollout_fused(runner, params, cfg)
    adv, ret = ppo.compute_gae(traj, last_v, cfg)
    ppo.update_epochs_fused(model, runner.optimizer, traj, adv, ret, gen, cfg)
    return (model, cfg, *minibatch_args(model, traj, adv, ret, cfg, mb_blocks,
                                        gen))


def minibatch_args(model, traj, adv, ret, cfg, mb_blocks, gen):
    """fused_minibatch_grad's (args, kw) for ``mb_blocks`` blocks of a
    fused collect's buffer in permuted order, cut as update_epochs_fused
    cuts it, on ``model``'s weights."""
    import torch

    from gym_futbol_tpu_torch import ppo

    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
    block = cfg.shuffle_block
    n_blocks = traj.obs.shape[1] // block
    dirs, acts, logp, value, adv, ret = (
        ppo._flatten_tm(x).reshape(n_blocks, block).contiguous()
        for x in (traj.dirs, traj.acts, traj.logp, traj.value, adv, ret))
    order = torch.randperm(n_blocks, generator=gen, device=traj.obs.device)
    idx = order[:mb_blocks].to(torch.int32).contiguous()
    adv_mb = adv[idx]
    adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
    args = (fc.flatten_actor_critic(model), traj.obs.contiguous(), dirs, acts,
            logp, value, ret, adv_n, idx)
    kw = dict(n_torso=len(model.hidden), clip_eps=cfg.clip_eps,
              vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, block=block)
    return args, kw


@contextlib.contextmanager
def forced_update_plan(compute_dtype=None, smem_bytes=None):
    """fused_minibatch_grad's route forced inside the block:
    ``compute_dtype=torch.float32`` sends it to the CUDA-core chain (which
    still computes in the caller's dtype); ``smem_bytes`` lowers the
    shared memory update_plan allows a block (K3_STREAM_SMEM: W2 streamed
    where it would stay resident). The main path never runs inside it."""
    from gym_futbol_tpu_torch.ops import _build

    fu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
    plan, limit = fu.update_plan, _build.SMEM_BYTES
    if compute_dtype is not None:
        fu.update_plan = lambda f_dim, widths, g5, m, mode: plan(
            f_dim, widths, g5, m, compute_dtype)
    if smem_bytes is not None:
        _build.SMEM_BYTES = smem_bytes
    try:
        yield
    finally:
        fu.update_plan, _build.SMEM_BYTES = plan, limit


def timed_iterations(runner, params, cfg, n_iters: int):
    """One warm-up and ``n_iters`` timed train_iteration calls on
    collect_rollout_fused and update_epochs_fused (bfloat16), every
    launch count set to 0 just before. Returns (runner, the step
    function, {ms, collect, update: ms per timed iteration by CUDA events;
    history: their metrics; launches: every count after them; iters: the
    iterations run, warm-up included})."""
    import torch

    from gym_futbol_tpu_torch import ops, ppo

    spans = {"collect": [], "update": []}

    def timed(fn, name):
        def run(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    step = functools.partial(
        ppo.train_iteration, collect_fn=timed(ppo.collect_rollout_fused, "collect"),
        update_fn=timed(ppo.update_epochs_fused, "update"))
    ops.reset_launch_counts()
    runner, _ = step(runner, params, cfg)                        # warm-up
    totals, history = [], []
    for _ in range(n_iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        runner, metrics = step(runner, params, cfg)
        end.record()
        totals.append((start, end))
        history.append(metrics)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)

    def per_iter(pairs):
        return sum(s.elapsed_time(e) for s, e in pairs) / n_iters

    return runner, step, dict(
        ms=per_iter(totals), collect=per_iter(spans["collect"][1:]),
        update=per_iter(spans["update"][1:]), history=history,
        launches=launches, iters=n_iters + 1)


def k2_bound(params, weights, sf, si, n_envs: int, n_steps: int, share):
    """K2's least time per step of a collect: the state read and written
    and the weights read once per collect, the [F_pad, 2BT] obs buffer,
    its per-step rows and the bootstrap values written once; operations
    per env-step the env step at the active ``share`` and both views' MLP,
    of them the torso's and logits head's products on the tensor cores
    (bf16), the biases and the value head in float32. Returns (bf16 bound,
    f32 bound, operations per env-step, of them bf16)."""
    pol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")
    ops_all = env_step_ops(params, share) + 2 * mlp_ops(weights)
    ops_bf16 = 2 * sum(2 * w.numel() for w in weights[:-2:2])
    n_bytes = (2 * nbytes(sf, si) + nbytes(*weights) + 4 * 2 * n_envs
               * (pol.feature_rows(params) * n_steps + 6 * n_steps + 1))
    return (bound(n_bytes / n_steps, n_envs * (ops_all - ops_bf16),
                  n_envs * ops_bf16),
            bound(n_bytes / n_steps, n_envs * ops_all), ops_all, ops_bf16)


def k2_cublas_ms(dev, params, weights, n_envs: int, hidden) -> float:
    """The yardstick, never called by the port: cuBLAS (torch.matmul,
    bf16) on K2's per-step layer products of both views (the torso and the
    logits head), ms per step over 20."""
    import torch

    from gym_futbol_tpu_torch import obs_size

    bf16 = torch.bfloat16
    xs = [torch.randn(2 * n_envs, d, device=dev, dtype=bf16)
          for d in (obs_size(params), *hidden)]
    ws = [w.to(bf16) for w in weights[:-2:2]]

    def products(i):
        for x, w in zip(xs, ws):
            torch.matmul(x, w)

    products(0)
    return time_cuda(products, 20)


def k3_bound(weights, f_pad: int, m: int, mb_blocks: int):
    """K3's least time on one minibatch of ``m`` samples (``mb_blocks``
    blocks): the minibatch's obs columns, per-sample rows and idx read
    once, weights read and gradients written once; the layer products'
    multiply-adds on the tensor cores (bf16) or all in float32, the value
    head's in float32. Returns (bf16 bound, f32 bound, bf16 multiply-adds
    per sample, f32 ones)."""
    n_torso = len(weights) // 2 - 2
    dims = [weights[0].shape[0], *(weights[2 * i].shape[1] for i in range(n_torso))]
    g5 = weights[-4].shape[1]
    layer_macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    head_macs = dims[-1] * g5
    # forward: layers + logits; backward: dh and dW of the logits head and
    # of every layer but the first, whose dW alone is needed
    bf16_macs = (layer_macs + head_macs) + 2 * head_macs + 2 * layer_macs - dims[0] * dims[1]
    f32_macs = 3 * dims[-1]                       # value head: v, dh, dW
    n_bytes = f_pad * m * 4 + 6 * m * 4 + mb_blocks * 4 + 2 * nbytes(*weights) + 16
    return (bound(n_bytes, 2 * f32_macs * m, 2 * bf16_macs * m),
            bound(n_bytes, 2 * (bf16_macs + f32_macs) * m), bf16_macs, f32_macs)


def k3_cublas_ms(dev, f_pad: int, hidden, g5: int, m: int) -> float:
    """The yardstick, never called by the port: cuBLAS (torch.matmul, bf16)
    on K3's eight layer products of a two-layer torso at this minibatch
    (forward: layer 1, layer 2, logits; backward: dh and dW of the logits
    head and of layer 2, dW of layer 1), ms per set over 20."""
    import torch

    bf16 = torch.bfloat16
    x, h1, h2 = (torch.randn(d, m, device=dev, dtype=bf16) for d in (f_pad, *hidden))
    dl = torch.randn(g5, m, device=dev, dtype=bf16)
    w1, w2, wl = (torch.randn(a, b, device=dev, dtype=bf16) for a, b in
                  ((f_pad, hidden[0]), (hidden[0], hidden[1]), (hidden[1], g5)))

    def products(i):
        torch.matmul(w1.T, x)
        torch.matmul(w2.T, h1)
        torch.matmul(wl.T, h2)
        torch.matmul(wl, dl)
        torch.matmul(h2, dl.T)
        torch.matmul(h1, h2.T)
        torch.matmul(w2, h2)
        torch.matmul(x, h1.T)

    products(0)
    return time_cuda(products, 20)


def update_phases(dev, custom) -> dict:
    """Phases 11-13: fused_minibatch_grad against its plain version and
    autograd, PPO training at config 4 through train_iteration and the
    CLI, and the kernels' times. Returns K3's entry of the kernels line."""
    import torch

    from gym_futbol_tpu_torch import EnvParams, obs_size, ops, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    fu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    p4, p6 = EnvParams(players_per_team=3), EnvParams(players_per_team=2)
    mb4 = 2 * B4 * T4 // K3_BLOCK // 4      # config 4's minibatch, in blocks

    # 11: kernel vs plain version on real minibatches, both modes; the
    # float32 kernel also against autograd at config 4 and at 5v5 (256, 256)
    p5 = EnvParams(players_per_team=5)
    cases = (
        (f"config 4 3v3 {H4} block {K3_BLOCK}", p4, H4, B4, T4, K3_BLOCK, mb4, True),
        ("custom (32, 16)", custom, (32, 16), B3, 8, K3_BLOCK, 16, False),
        ("2v2 (128, 128) block 128", p6, (128, 128), 1024, 16, 128, 64, False),
        ("5v5 (128, 128), G = 10", p5, (128, 128), 1024, 16, K3_BLOCK, 8, False),
        ("5v5 (256, 256), G = 10", p5, H5, 1024, 16, K3_BLOCK, 8, True),
        ("4v4 (256, 256), G = 8", EnvParams(players_per_team=4), H5, 1024, 16,
         K3_BLOCK, 8, False),
    )
    for n, (label, params, hidden, n_envs, n_steps, block, mb_blocks,
            autograd) in enumerate(cases):
        model, cfg, args, kw = update_minibatch(
            dev, params, hidden, n_envs, n_steps, block, mb_blocks, 10 + n)
        plans = [fu.update_plan(args[1].shape[0], hidden, args[0][-4].shape[1],
                                mb_blocks * block, mode) for mode in (bf16, f32)]
        routes = "/".join(pl["route"] for pl in plans)
        tag = (f"11 {label}, {mb_blocks} blocks ({mb_blocks * block} samples, "
               f"bf16/f32 on {routes}, W2 {plans[0].get('w2_layout')})")
        got, terms = {}, {}
        for mode, tol in ((bf16, K3_BF16_REL), (f32, K3_F32_REL)):
            got[mode] = ops.fused_minibatch_grad(*args, **kw, compute_dtype=mode)
            plain_grads, terms[mode] = fu.fused_minibatch_grad_reference(
                *args, **kw, compute_dtype=mode, per_sample=True)
            err = compare_update(
                got[mode], (plain_grads, {k: terms[mode][k].sum() for k in fu.METRICS}),
                terms[mode], f"{tag}, {str(mode)[6:]}", tol, K3_METRIC_REL)
            again = ops.fused_minibatch_grad(*args, **kw, compute_dtype=mode)
            same = all(torch.equal(a, b) for a, b in zip(got[mode][0], again[0]))
            same &= all(torch.equal(got[mode][1][m], again[1][m]) for m in fu.METRICS)
            check(same, f"{tag}: two calls differ")
            if n == 0 and mode is bf16:
                k3_err = err
        gap = max(((a - b).norm() / b.norm()).item()
                  for a, b in zip(got[bf16][0], got[f32][0]))
        clip = {k: terms[bf16][k].mean().item() for k in ("pg_clip", "v_clip")}
        phase("11 parity", f"{tag}: identical across two calls in both modes; "
              f"bfloat16-to-float32 gap of the kernel, largest leaf rel-L2 "
              f"{gap:.3g}; share of samples whose gradient the clip zeroes: "
              f"surrogate {clip['pg_clip']:.4g}, value {clip['v_clip']:.4g}")
        # at the main path's shape both clips must decide some gradients
        # (the small cases' returns stay inside the value clip)
        check(n > 0 or min(clip.values()) > 0, f"{tag}: a clip decides no sample")
        if autograd:
            # f32 kernel vs autograd of ppo_loss through the module
            obs_fm, dirs, acts, logp, value, ret, adv_n, idx = args[1:]
            m = idx.shape[0] * K3_BLOCK
            sel = idx.long()
            obs = obs_fm.reshape(obs_fm.shape[0], -1, K3_BLOCK)[:, sel].reshape(-1, m)
            model.zero_grad()
            loss, lm = ppo.ppo_loss(model, obs, *(x[sel].reshape(m) for x in (
                dirs, acts, logp, value)), adv_n.reshape(m), ret[sel].reshape(m),
                cfg)
            loss.backward()
            auto = (tuple(g for layer in model.dense_layers() for g in (
                layer.weight.grad.t(), layer.bias.grad[:, None])),
                {k: lm[k].detach() * m for k in fu.METRICS})
            compare_update(got[f32], auto, terms[f32], f"{tag}, float32 vs "
                           f"autograd of ppo_loss", K3_AUTOGRAD_REL, K3_METRIC_REL)
        if n == 0:
            k3_args, k3_kw = args, kw

    # 12: the main path: train_iteration at config 4 on both kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ActorCritic(p4.players_per_team, obs_size(p4), H4, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=T4)
    runner = ppo.init_runner(gen, model, p4, cfg, B4)
    first = [p.detach().clone() for p in model.parameters()]
    n_iters, per_iter = 3, cfg.epochs * cfg.minibatches
    runner, step, it = timed_iterations(runner, p4, cfg, n_iters)
    launches = {k: it["launches"][k] for k in (
        "fused_collect", "fused_minibatch_grad", "fused_minibatch_grad_chain")}
    check(launches == {"fused_collect": n_iters + 1,
                       "fused_minibatch_grad": per_iter * (n_iters + 1),
                       "fused_minibatch_grad_chain": 0},
          f"12: the main path's launches: {launches}")
    ms, ms_collect, ms_update, history = (it[k] for k in (
        "ms", "collect", "update", "history"))
    values = {k: [float(m[k]) for m in history] for k in history[0]}
    check(all(math.isfinite(v) for vs in values.values() for v in vs),
          f"12: non-finite metrics {values}")
    moved = [not torch.equal(a, b) for a, b in zip(first, model.parameters())]
    check(all(moved), "12: a parameter did not change")
    phase("12 main path", f"train_iteration (collect_rollout_fused, compute_gae, "
          f"update_epochs_fused bfloat16), 3v3 B={B4} T={T4} hidden {H4}, "
          f"{cfg.epochs} x {cfg.minibatches} minibatches of "
          f"{2 * B4 * T4 // cfg.minibatches} samples: {ms:.3f} ms/iteration, "
          f"{B4 * T4 / ms * 1e3:.6g} env-steps/s ({n_iters} iterations after "
          f"1 warm-up); collect {ms_collect:.3f} ms, update {ms_update:.3f} ms, "
          f"GAE and the rest {ms - ms_collect - ms_update:.3f} ms")
    phase("12 main path", "metrics per iteration: " + "; ".join(
        f"{k} " + " ".join(f"{v:.5g}" for v in vs) for k, vs in values.items()))
    phase("12 main path", f"kernel launches in the main path: {launches}")
    main12 = dict(ms=ms, collect=ms_collect, update=ms_update, launches=launches,
                  iters=n_iters + 1)

    argv = ["--ppt", "3", "--envs", str(B4), "--iters", "2", "--fused-collect"]
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "gym_futbol_tpu_torch.train",
                          *argv], capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    records = [json.loads(x) for x in cli.stdout.splitlines() if x.startswith("{")]
    phase("12 CLI", f"python -m gym_futbol_tpu_torch.train {' '.join(argv)}: "
          f"exit {cli.returncode} in {time.perf_counter() - t0:.1f} s; "
          + " | ".join(json.dumps(r) for r in records))
    check(cli.returncode == 0, f"12: the CLI failed: {cli.stderr[-2000:]}")
    check(len(records) == 3 and [r.get("step") for r in records[:2]] == [0, 1]
          and records[2].get("done") is True, "12: the CLI's records")

    # 13: the kernels alone at config 4's minibatch: bf16 on the tensor
    # cores, the CUDA-core chain in float32 and, for the record, in bf16
    # (the route before the tensor-core kernels); the plain version
    def k3(mode):
        return lambda i: ops.fused_minibatch_grad(*k3_args, **k3_kw,
                                                  compute_dtype=mode)

    ms_bf16 = time_cuda(k3(bf16), 10)
    ms_f32 = time_cuda(k3(f32), 3)
    with forced_update_plan(compute_dtype=f32):
        ms_chain_bf16 = time_cuda(k3(bf16), 3)
    # W2 streamed as at 4v4/5v5 (256, 256), here where resident fits: the
    # same bits, timed between the resident runs
    resident = k3(bf16)(0)
    with forced_update_plan(smem_bytes=K3_STREAM_SMEM):
        layout = fu.update_plan(k3_args[1].shape[0], H4, k3_args[0][-4].shape[1],
                                mb4 * K3_BLOCK)["w2_layout"]
        check(layout == "streamed", f"13: W2 {layout} under the lowered limit")
        streamed = k3(bf16)(0)
        ms_streamed = time_cuda(k3(bf16), 10)
    check(all(torch.equal(a, b) for a, b in zip(resident[0], streamed[0]))
          and all(torch.equal(resident[1][k], streamed[1][k]) for k in fu.METRICS),
          "13: W2 streamed differs from resident at config 4")
    ms_bf16_again = time_cuda(k3(bf16), 10)
    plain_bf16 = time_cuda(lambda i: fu.fused_minibatch_grad_reference(
        *k3_args, **k3_kw, compute_dtype=bf16), 2)
    plain_f32 = time_cuda(lambda i: fu.fused_minibatch_grad_reference(
        *k3_args, **k3_kw, compute_dtype=f32), 2)
    w, obs_fm = k3_args[0], k3_args[1]
    m, g5 = mb4 * K3_BLOCK, w[-4].shape[1]
    bound_bf16, bound_f32, bf16_macs, f32_macs = k3_bound(w, obs_fm.shape[0], m, mb4)
    phase("13 kernels", f"fused_minibatch_grad, config 4 minibatch of {m} "
          f"samples: bfloat16 on the tensor cores, W2 resident {ms_bf16:.3f} ms "
          f"(again after the chain and the streamed layout: {ms_bf16_again:.3f} "
          f"ms; bound {bound_bf16[0]:.4g} ms, {bound_bf16[1]}; "
          f"{2 * bf16_macs * m / ms_bf16 / 1e9:.4g} TFLOP/s of bf16 products), W2 "
          f"streamed {ms_streamed:.3f} ms (bitwise the resident one's output), "
          f"the CUDA-core chain in bfloat16 {ms_chain_bf16:.3f} "
          f"ms, float32 {ms_f32:.3f} ms (bound {bound_f32[0]:.4g} ms); plain "
          f"version bfloat16 {plain_bf16:.3f} ms, float32 {plain_f32:.3f} ms; "
          f"{(bf16_macs + f32_macs)} multiply-adds per sample")
    ms_cublas = k3_cublas_ms(dev, obs_fm.shape[0], H4, g5, m)
    phase("13 kernels", f"yardstick: cuBLAS (torch.matmul, bf16) on the same "
          f"eight layer products at this minibatch: {ms_cublas:.3f} ms "
          f"({2 * bf16_macs * m / ms_cublas / 1e9:.4g} TFLOP/s), 20 iterations")
    for line in ptxas_summary(_build_log()):
        if line.startswith(("tc_forward", "tc_backward", "round_obs", "rows_gemm",
                            "outer_gemm", "rowdot", "reduce_", "head_loss")):
            phase("13 kernels", line)
    # where the time goes: one launch, then one main-path iteration
    box = {"runner": runner}

    def iteration():
        box["runner"], _ = step(box["runner"], p4, cfg)

    for label, fn in (
            ("fused_minibatch_grad bfloat16, one config-4 launch",
             lambda: ops.fused_minibatch_grad(*k3_args, **k3_kw, compute_dtype=bf16)),
            ("train_iteration, one config-4 iteration", iteration)):
        busy, wall_ms, rows = device_profile(fn)
        phase("13 profile", f"{label}: {wall_ms:.3f} ms wall, device busy share "
              f"{busy:.4f}; device ms by kernel: " + "; ".join(
                  f"{name} {n}x {ms:.3f}" for name, n, ms in rows[:12]))
    return {"name": "fused_minibatch_grad", "route": "cuda",
            "source": UPDATE_SOURCE, "replaces": REPLACES["fused_minibatch_grad"],
            "launches": launches["fused_minibatch_grad"], "max_abs_err": k3_err,
            "ms": ms_bf16, "plain_ms": plain_bf16, "bound_ms": bound_bf16[0],
            "bound_by": bound_bf16[1], "library_ms": None,
            "unit": f"ms per launch, bfloat16, one config-4 minibatch of {m} "
                    f"samples (3v3, hidden {H4})"}, main12


def rounded_unroll(model, carry, x, done):
    """RecurrentActorCritic.unroll with the operands of the torso's, the
    cell's and the logits head's products rounded to bf16 (f32 sums by
    cuBLAS, the cell's input and recurrent products apart), the gates, the
    carries and the value head f32: what the bf16 route computes.
    (carry after the window, (logits, value))."""
    import torch

    from gym_futbol_tpu_torch.models.recurrent import lstm_cell

    def rnd(a):
        return a.to(torch.bfloat16).float()

    t = x
    for layer in model.torso:
        t = torch.tanh(rnd(t) @ rnd(layer.weight).T + layer.bias)
    x_in = rnd(t) @ rnd(model.cell_i.weight).T
    wh, bh = rnd(model.cell_h.weight), model.cell_h.bias
    keep = (1.0 - done.float())[..., None]
    c, h = carry
    hs = []
    for x_t, keep_t in zip(x_in.unbind(0), keep):
        c, h = lstm_cell(rnd(h) @ wh.T + bh + x_t, c)
        hs.append(h)
        c, h = c * keep_t, h * keep_t
    hs = torch.stack(hs)
    logits = rnd(hs) @ rnd(model.logits.weight).T + model.logits.bias
    value = (hs @ model.value.weight.T + model.value.bias)[..., 0]
    return (c, h), (logits, value)


def recurrent_phases(dev, custom, shares) -> dict:
    """Phases 14-16: fused_recurrent_collect in both routes against its
    plain version, the teacher-forced checks and sampling statistics, the
    recurrent learners' main path (recurrent PPO and A2C, the CLI, on the
    bf16 route) and K5's times, layouts and bounds. Returns K5's entry of
    the kernels line."""
    import torch

    from gym_futbol_tpu_torch import EnvParams, a2c, obs_size, ops, vector
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.policy import action_log_prob_and_entropy_packed
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic
    from gym_futbol_tpu_torch.ops.fused_rollout import n_draws_per_step

    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")
    pol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p3, p2 = EnvParams(players_per_team=3), EnvParams(players_per_team=2)
    f32, bf16 = torch.float32, torch.bfloat16
    k5_actions, k5_floats, k5_env = (3, 4), (5, 6, 9, 10, 11), (0, 1, 2, 7, 8)

    def setup(params, hidden, lstm, n_envs, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state, _ = vector.reset_batch(gen, params, n_envs, device=dev)
        model = RecurrentActorCritic(params.players_per_team, obs_size(params),
                                     hidden, lstm, generator=gen, device=dev)
        carries = [torch.randn(2, lstm, n_envs, generator=gen, device=dev) * 0.5
                   for _ in range(2)]
        return (*ops.pack_state(state, params), model, carries, gen)

    def plain_bf16(*args, **kw):
        """The plain bf16 version, its sampler's (logits, uniforms)
        recorded for the near-tie test."""
        calls = []
        orig = recording(pol, "sample_with_logp", calls)
        try:
            return fr.fused_recurrent_collect_reference(*args, **kw), calls
        finally:
            pol.sample_with_logp = orig

    # 14: kernel vs plain version from non-zero carries, same uniforms and
    # Philox, in both routes: float32 bitwise, bfloat16 within the bf16
    # tolerances with every differing action a counted near tie. The
    # plain version runs T=4 at the main shape; the kernels line takes
    # the bf16 error there
    k5_err, k5_f32_err, ties = 0.0, 0.0, []
    for label, params, hidden, lstm, n_envs, n_steps, philox, main in (
            (f"3v3 {HR} H={LSTM_R}", p3, HR, LSTM_R, BR, 4, True, True),
            ("2v2 (128,) H=128", p2, (128,), 128, B6, T_PARITY, True, False),
            ("custom (32, 16) H=32", custom, (32, 16), 32, B3, T_PARITY, False, False),
            ("ragged 2v2 max_steps 7 (64,) H=64", p2.replace(max_steps=7), (64,), 64,
             1000, T_PARITY, True, False)):
        sf, si, model, (cc, hh), gen = setup(params, hidden, lstm, n_envs, 7)
        w = fr.flatten_recurrent_actor_critic(model)
        c0, h0 = cc.clone(), hh.clone()
        u = torch.rand((n_steps, n_draws_per_step(params), n_envs), generator=gen,
                       device=dev)
        tag = f"14 {label} B={n_envs} T={n_steps}"
        got = ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, params, n_steps,
                                          uniforms=u, compute_dtype=f32)
        errs = [compare_policy(got, fr.fused_recurrent_collect_reference(
            sf, si, w, cc, hh, params, uniforms=u, compute_dtype=f32),
            f"{tag}, table, float32", k5_actions)]
        if philox:
            errs.append(compare_policy(
                ops.fused_recurrent_collect(sf, si, w, cc, hh, 5, params, n_steps,
                                            compute_dtype=f32),
                fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                     n_steps, seed=5, compute_dtype=f32),
                f"{tag}, Philox, float32", k5_actions))
        k5_f32_err = max(k5_f32_err, *errs)
        modes = [("table", dict(uniforms=u), 0, dict(uniforms=u))]
        if philox:
            modes.append(("Philox", {}, 5, dict(seed=5)))
        for mode, kw, seed, plain_kw in modes:
            got_bf = ops.fused_recurrent_collect(sf, si, w, cc, hh, seed, params,
                                                 n_steps, **kw)
            want, calls = plain_bf16(sf, si, w, cc, hh, params, n_steps, **plain_kw)
            err, _, counts = compare_policy_bf16(
                got_bf, want, calls, f"{tag}, {mode}, bfloat16", k5_actions,
                k5_floats, k5_env)
            ties.append(counts)
            if main:
                k5_err = max(k5_err, err)
        check(torch.equal(cc, c0) and torch.equal(hh, h0),
              f"{tag}: the input carries changed")
        if params.max_steps <= n_steps:
            check(bool(got[8].any()), f"{tag}: no episode ended in the window")
    total = {k: sum(c[k] for c in ties) for k in ties[0]}
    phase("14 near ties", f"fused_recurrent_collect bf16, every case: {total}")

    # 14: teacher-forced at the main shape (episodes ending in the window):
    # the module replayed over the kernel's own obs from its initial carry;
    # float32 against the module (5e-5), bfloat16 against the module's
    # unroll with rounded operands (1e-2)
    pf = p3.replace(max_steps=12)
    sf, si, model, (cc, hh), gen = setup(pf, HR, LSTM_R, BR, 8)
    w = fr.flatten_recurrent_actor_critic(model)
    f = obs_size(pf)

    def flat(a):                                        # [T, 2, B] -> [T, 2B]
        return a.reshape(TR, 2 * BR)

    carry0 = tuple(c.transpose(1, 2).reshape(2 * BR, LSTM_R) for c in (cc, hh))
    for mode, unroll, tol in (("float32", model.unroll, K5_FORCED_ATOL),
                              ("bfloat16", functools.partial(rounded_unroll, model),
                               FORCED_BF16_ATOL)):
        (_, _, obs, dirs, acts, logp, value, _, done, _, cc2,
         hh2) = ops.fused_recurrent_collect(sf, si, w, cc, hh, 78, pf, TR,
                                            compute_dtype=f32 if mode == "float32"
                                            else bf16)
        x = obs[:, :f].permute(2, 0, 3, 1).reshape(TR, 2 * BR, f)    # [T, 2B, F]
        with torch.no_grad():
            (c_end, h_end), (logits, v) = unroll(carry0, x, flat(done).bool())
            lp, _ = action_log_prob_and_entropy_packed(logits, flat(dirs), flat(acts))
        errs = {"logp": (lp - flat(logp)).abs().max().item(),
                "value": (v - flat(value)).abs().max().item(),
                "carry": max((a - b.transpose(1, 2).reshape(2 * BR, LSTM_R)).abs()
                             .max().item() for a, b in ((c_end, cc2), (h_end, hh2)))}
        n_ends = int(done.sum()) // 2
        phase("14 forced", f"3v3 max_steps 12 B={BR} T={TR} H={LSTM_R}, Philox, "
              f"{mode}, module replay (TF32 off{', rounded operands' if mode == 'bfloat16' else ''}): "
              + ", ".join(f"{k} err {e:.3g}" for k, e in errs.items())
              + f" (<= {tol}); {n_ends} episode ends")
        check(max(errs.values()) <= tol and n_ends > 0, f"14: module replay, {mode}")

    # 14: sampling statistics of the bf16 collect (the main path's) against
    # its own softmax (the logits of the last replay)
    n_groups = 2 * pf.players_per_team
    probs = torch.softmax(logits.double().reshape(-1, n_groups, 5), -1)
    packed = (flat(dirs).reshape(-1), flat(acts).reshape(-1))
    z = 0.0
    for g in range(n_groups):
        a = (packed[g % 2] >> (3 * (g // 2))) & 7
        onehot = torch.nn.functional.one_hot(a.long(), 5).double()
        pg = probs[:, g]
        se = (pg * (1 - pg)).sum(0).sqrt() / pg.shape[0]
        z = max(z, ((onehot.mean(0) - pg.mean(0)).abs() / se).max().item())
    phase("14 stats", f"recurrent collect, bfloat16: {probs.shape[0]} samples x "
          f"{n_groups} groups, max |freq - p| / SE {z:.3f} (<= 5)")
    check(z <= 5.0, "14: sampling statistics")

    # 15: the main path: recurrent PPO at the main shape on the kernel (the
    # collect's default route, bfloat16; the update on K6, its default),
    # then one recurrent A2C iteration
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = RecurrentActorCritic(3, obs_size(p3), HR, LSTM_R, device=dev)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=TR)
    runner = rppo.init_recurrent_ppo_runner(gen, model, p3, cfg, BR)
    spans = {"collect": [], "update": []}

    def timed(fn, name):
        def run(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    step = functools.partial(
        rppo.train_iteration_recurrent_ppo,
        collect_fn=timed(a2c.collect_recurrent_rollout_fused, "collect"),
        update_fn=timed(rppo.update_epochs_recurrent, "update"))
    first = [p.detach().clone() for p in model.parameters()]
    runner, _ = step(runner, p3, cfg)                            # warm-up
    n_iters, totals, history = 3, [], []
    for i in range(n_iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        runner, metrics = step(runner, p3, cfg)
        end.record()
        totals.append((start, end))
        history.append(metrics)
        check(ops.LAUNCHES["fused_recurrent_collect"] == i + 2,
              "15: one K5 launch per iteration")
    torch.cuda.synchronize()
    ms = sum(s.elapsed_time(e) for s, e in totals) / n_iters
    ms_collect = sum(s.elapsed_time(e) for s, e in spans["collect"][1:]) / n_iters
    ms_update = sum(s.elapsed_time(e) for s, e in spans["update"][1:]) / n_iters
    values = {k: [float(m[k]) for m in history] for k in history[0]}
    check(all(math.isfinite(v) for vs in values.values() for v in vs),
          f"15: non-finite metrics {values}")
    check(all(not torch.equal(a, b) for a, b in zip(first, model.parameters())),
          "15: a parameter did not change")
    k6_launches = ops.LAUNCHES["fused_lstm_bptt"]
    check(sum(ops.LAUNCHES.values()) == ops.LAUNCHES["fused_recurrent_collect"] + k6_launches,
          "15: another kernel (or K5's float32 route) ran in the recurrent path")
    check(k6_launches == 2 * cfg.epochs * cfg.minibatches * (n_iters + 1),
          f"15: {k6_launches} K6 launches, 2 a minibatch expected")
    phase("15 main path", f"train_iteration_recurrent_ppo (collect_recurrent_rollout_"
          f"fused, bfloat16, compute_gae, update_epochs_recurrent), 3v3 B={BR} "
          f"T={TR} hidden {HR} H={LSTM_R}, {cfg.epochs} x {cfg.minibatches} "
          f"minibatches of {2 * BR // cfg.minibatches} sequences: {ms:.3f} "
          f"ms/iteration, {BR * TR / ms * 1e3:.6g} env-steps/s ({n_iters} "
          f"iterations after 1 warm-up); collect {ms_collect:.3f} ms, update "
          f"{ms_update:.3f} ms, GAE and the rest {ms - ms_collect - ms_update:.3f} ms")
    phase("15 main path", "metrics per iteration: " + "; ".join(
        f"{k} " + " ".join(f"{v:.5g}" for v in vs) for k, vs in values.items()))
    a2c_model = RecurrentActorCritic(3, obs_size(p3), HR, LSTM_R, device=dev)
    a2c_cfg = a2c.A2CConfig(rollout_steps=TR)
    a2c_runner = a2c.init_recurrent_runner(gen, a2c_model, p3, a2c_cfg, BR)
    t0 = time.perf_counter()
    a2c_runner, m = a2c.train_iteration_recurrent(
        a2c_runner, p3, a2c_cfg, collect_fn=a2c.collect_recurrent_rollout_fused)
    m = {k: float(v) for k, v in m.items()}                     # synchronises
    phase("15 main path", f"train_iteration_recurrent (A2C, one full-batch BPTT "
          f"step), 3v3 B={BR} T={TR}: first iteration {1e3 * (time.perf_counter() - t0):.1f}"
          f" ms wall; " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    check(all(math.isfinite(v) for v in m.values()), "15: A2C metrics")
    launches = {k: ops.LAUNCHES[k] for k in ("fused_recurrent_collect",
                                             "fused_recurrent_collect_f32")}
    check(launches["fused_recurrent_collect"] == n_iters + 2
          and launches["fused_recurrent_collect_f32"] == 0,
          f"15: {launches} K5 launches in the main path")
    phase("15 main path", f"kernel launches in the main path (bfloat16 "
          f"recurrent_tc_kernel under the kernel's name, float32 under _f32): "
          f"{launches}; K6 (the update's recurrence) {k6_launches}")

    argv = ["--recurrent", "--fused-collect", "--ppt", "3", "--envs", str(BR),
            "--hidden", *map(str, HR), "--lstm-size", str(LSTM_R), "--iters", "2"]
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "gym_futbol_tpu_torch.train",
                          *argv], capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    records = [json.loads(x) for x in cli.stdout.splitlines() if x.startswith("{")]
    phase("15 CLI", f"python -m gym_futbol_tpu_torch.train {' '.join(argv)}: "
          f"exit {cli.returncode} in {time.perf_counter() - t0:.1f} s; "
          + " | ".join(json.dumps(r) for r in records))
    check(cli.returncode == 0, f"15: the CLI failed: {cli.stderr[-2000:]}")
    check(len(records) == 3 and records[2].get("total_env_steps") == 2 * BR * TR,
          "15: the CLI's records (T must resolve to 16)")

    # 16: K5 alone at the main shape in both routes, in turns; the plan and
    # the other layouts it weighs; the env step alone; the plain version;
    # the bounds; a cuBLAS yardstick
    sf, si = ops.pack_state(runner.env_state, p3)
    cc, hh = (c.transpose(1, 2).contiguous() for c in runner.carry)
    w = fr.flatten_recurrent_actor_critic(model)

    def k5(mode):
        return lambda i: ops.fused_recurrent_collect(sf, si, w, cc, hh, 700 + i, p3,
                                                     TR, compute_dtype=mode)

    k5(bf16)(0)
    ms_k5, ms_k5_f32, ms_k5_f32_again, ms_k5_again = (
        time_cuda(k5(mode), 5) / TR for mode in (bf16, f32, f32, bf16))
    plan = fr.recurrent_tc_plan(p3, HR, LSTM_R, BR)
    phase("16 plan", f"fused_recurrent_collect 3v3 B={BR} hidden {HR} H={LSTM_R}: {plan}")
    plan_fn, layouts = fr.recurrent_tc_plan, {}
    units, tiles = plan["frag_bytes"] // 16, sum(plan["t_bytes"])
    torso_head = (plan["frag_bytes"] - 2 * (HR[-1] + LSTM_R) * 4 * LSTM_R) // 16
    for envs, per_sm, n_res in ((128, 1, torso_head), (128, 1, 0), (64, 1, None),
                                (64, 2, None), (32, 2, None)):
        if n_res is None:
            n_res = min(units, (TC_SMEM // per_sm - envs // 32 * tiles) // 16)
        forced = dict(plan, envs=envs, n_res=n_res, blocks=-(-BR // envs),
                      smem=16 * n_res + envs // 32 * tiles)
        fr.recurrent_tc_plan = lambda *a, forced=forced, **kw: forced
        try:
            layouts[f"{envs} envs, {16 * n_res} bytes resident"] = (
                time_cuda(k5(bf16), 3) / TR)
        finally:
            fr.recurrent_tc_plan = plan_fn
    phase("16 plan", "other layouts, ms/step (the plan's: the bfloat16 times "
          "below): " + "; ".join(f"{k} {v:.5f}" for k, v in layouts.items()))
    ms_env = time_cuda(lambda i: ops.fused_rollout(sf, si, 800 + i, p3, TR), 5) / TR
    t_plain = 2
    fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, p3, 1, seed=0)
    plain_k5 = time_cuda(lambda i: fr.fused_recurrent_collect_reference(
        sf, si, w, cc, hh, p3, t_plain, seed=1 + i), 1) / t_plain
    # bound per step: state, weights and input carries read, state and
    # output carries written once per call; obs, the six [T, 2, B] rows
    # and the bootstrap values written once. Operations: the env step at
    # config 4's active share and both views' torso, cell ([t; h] x [n_t +
    # H, 4H]) and heads; in bfloat16 the torso's, the cell's and the logits
    # head's products on the tensor cores, the biases and value head f32
    n_torso = len(HR)
    wi, wh, bh, wl, bl, wv, bv = w[2 * n_torso:]
    layers = (*w[:2 * n_torso], torch.cat([wi, wh]), bh, wl, bl, wv, bv)
    ops_k5 = env_step_ops(p3, shares["3v3"]) + 2 * mlp_ops(layers)
    ops_k5_bf16 = 2 * sum(2 * x.numel() for x in (*w[:2 * n_torso:2], wi, wh, wl))
    f_pad = -(-obs_size(p3) // 8) * 8
    bytes_k5 = (2 * nbytes(sf, si) + nbytes(*w) + 4 * nbytes(cc)
                + 4 * 2 * BR * (f_pad * TR + 6 * TR + 1))
    bound_k5 = bound(bytes_k5 / TR, BR * (ops_k5 - ops_k5_bf16), BR * ops_k5_bf16)
    bound_k5_f32 = bound(bytes_k5 / TR, BR * ops_k5)
    bound_k5_all = bound(bytes_k5 / TR, BR * (ops_k5 - ops_k5_bf16
                                              - env_step_ops(p3, shares["3v3"])
                                              + env_step_ops(p3)),
                         BR * ops_k5_bf16)
    phase("16 kernels", f"fused_recurrent_collect 3v3 B={BR} T={TR}, ms/step: "
          f"bfloat16 on the tensor cores (recurrent_tc_kernel) {ms_k5:.5f} (again "
          f"after float32: {ms_k5_again:.5f}), float32 on the CUDA cores "
          f"(recurrent_kernel) {ms_k5_f32:.5f} (again {ms_k5_f32_again:.5f}); the "
          f"env step alone (fused_rollout) {ms_env:.5f}; plain version (bf16) "
          f"{plain_k5:.1f}")
    phase("16 bound", f"fused_recurrent_collect: {ops_k5} operations per env-step "
          f"at config 4's active share, of them {ops_k5_bf16} bf16 products -> "
          f"bfloat16 {bound_k5[0]:.6g} ms/step ({bound_k5[1]}), float32 "
          f"{bound_k5_f32[0]:.6g} ({bound_k5_f32[1]}); with every constraint: "
          f"bfloat16 {bound_k5_all[0]:.6g}")
    # yardstick, never called by the port: cuBLAS (torch.matmul, bf16) on
    # the same per-step products of both views (torso, cell, logits head)
    xs = [torch.randn(2 * BR, d, device=dev, dtype=bf16)
          for d in (obs_size(p3), HR[-1] + LSTM_R, LSTM_R)]
    ms_ = [w[0].to(bf16), torch.cat([wi, wh]).to(bf16), wl.to(bf16)]

    def products(i):
        for x, m in zip(xs, ms_):
            torch.matmul(x, m)

    products(0)
    ms_cublas = time_cuda(products, 20)
    phase("16 kernels", f"yardstick: cuBLAS (torch.matmul, bf16) on the same "
          f"per-step products of both views: {ms_cublas:.5f} ms/step "
          f"({BR * ops_k5_bf16 / ms_cublas / 1e9:.4g} TFLOP/s), 20 iterations")
    del xs
    for line in ptxas_summary(_build_log()):
        if line.startswith(("recurrent_kernel", "recurrent_tc_kernel")):
            phase("16 kernels", line)
    box = {"runner": runner}

    def iteration():
        box["runner"], _ = step(box["runner"], p3, cfg)

    busy, wall_ms, rows = device_profile(iteration)
    phase("16 profile", f"train_iteration_recurrent_ppo, one main-path iteration: "
          f"{wall_ms:.3f} ms wall, device busy share {busy:.4f}; device ms by "
          f"kernel: " + "; ".join(f"{name} {n}x {ms:.3f}" for name, n, ms in rows[:12]))
    return {"name": "fused_recurrent_collect", "route": "cuda",
            "kernel": "recurrent_tc_kernel (bfloat16 operands, tensor cores)",
            "source": RECURRENT_SOURCE,
            "replaces": REPLACES["fused_recurrent_collect"],
            "launches": launches["fused_recurrent_collect"],
            "max_abs_err": k5_err, "ms": ms_k5, "plain_ms": plain_k5,
            "bound_ms": bound_k5[0], "bound_by": bound_k5[1], "library_ms": None,
            "yardstick_ms": ms_cublas,
            "f32_route_ms": ms_k5_f32, "f32_bound_ms": bound_k5_f32[0],
            "f32_max_abs_err": k5_f32_err,
            "unit": f"ms per step of the {BR}-env 3v3 batch, hidden {HR}, "
                    f"H {LSTM_R}, bfloat16",
            "k6_launches": k6_launches}


def runner_leaves(x, name="runner"):
    """Every tensor and number a training runner holds, with its path:
    the model's and the optimiser's state (Adam's moments, step counts and
    count), the env state, obs, the normalisers' statistics and the
    generator's state."""
    import dataclasses

    import torch

    if isinstance(x, torch.Generator):
        yield name, x.get_state()
    elif isinstance(x, (torch.Tensor, int, float)) or x is None:
        yield name, x
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from runner_leaves(v, f"{name}[{i}]")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from runner_leaves(v, f"{name}.{k}")
    elif hasattr(x, "state_dict"):
        yield from runner_leaves(x.state_dict(), name)
    else:
        for f in dataclasses.fields(x):
            yield from runner_leaves(getattr(x, f.name), f"{name}.{f.name}")


def stat_rel(a, b) -> float:
    """Largest relative difference of two normalisers' statistics."""
    import torch

    return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(vars(a).values(), vars(b).values())
               if isinstance(x, torch.Tensor))


def normalized_phases(dev, main12) -> None:
    """Phase 17: normalised PPO through K2 and K3. Parity of the
    normalised fused collect (statistics folded into K2's first layer,
    the buffer's moments, the post-hoc reward scaling) and of K3 with the
    fold and the unfold against their plain versions and autograd; the
    normalised train_iteration at config 4 with its split beside phase
    12's; a bitwise resume through utils.checkpoint on the card; the CLI's
    checkpoint resume and metrics log."""
    import shutil

    import torch

    from gym_futbol_tpu_torch import EnvParams, obs_size, ops, ppo
    from gym_futbol_tpu_torch.models.policy import (
        ActorCritic,
        action_log_prob_and_entropy_packed,
    )
    from gym_futbol_tpu_torch.utils.checkpoint import Checkpointer

    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
    fu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
    pol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    p4 = EnvParams(players_per_team=3)
    f = obs_size(p4)
    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke_17")
    shutil.rmtree(scratch, ignore_errors=True)

    # 17 parity: statistics from 2 iterations of plain normalised training
    gen = torch.Generator(device=dev).manual_seed(17)
    model = ActorCritic(3, f, H4, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=TN, shuffle_block=BLOCK_N)
    runner = ppo.init_runner(gen, model, p4, cfg, BN, normalize_obs=True,
                             normalize_reward=True)
    for _ in range(2):
        runner, _ = ppo.train_iteration(runner, p4, cfg,
                                        collect_fn=ppo.make_normalized_collect())
    mean, inv_std = ppo._obs_norm_scales(runner.obs_norm)
    w_plain = fc.flatten_actor_critic(model)
    w_fold = ppo.fold_obs_norm(w_plain, mean, inv_std)
    phase("17 parity", f"statistics after 2 plain normalised iterations, 3v3 "
          f"B={BN} T={TN} hidden {H4}: inv_std {inv_std.min().item():.4g} .. "
          f"{inv_std.max().item():.6g}, obs count {runner.obs_norm.count.item():.6g}, "
          f"return variance {runner.rew_norm.var.item():.6g}; largest |b1| "
          f"{w_plain[1].abs().max().item():.4g}, folded |b1'| "
          f"{w_fold[1].abs().max().item():.6g}, |W1'| {w_fold[0].abs().max().item():.6g}")
    check(bool((inv_std - 1).abs().max() > 0.1), "17: the statistics are the identity")

    # the whole normalised fused collect, f32 route, against the same
    # collect over K2's plain version: one seed from the same generator
    def plain_collect(sf, si, w, seed, params, n_steps, uniforms=None,
                      compute_dtype=bf16):
        return fc.fused_collect_reference(sf, si, w, params, n_steps, seed=seed,
                                          compute_dtype=compute_dtype)

    g_state = runner.generator.get_state()
    kern = ppo.collect_rollout_fused(runner, p4, cfg, compute_dtype=f32,
                                     normalize_obs=True, normalize_reward=True)
    runner.generator.set_state(g_state)
    orig = fc.fused_collect
    fc.fused_collect = plain_collect
    try:
        plain = ppo.collect_rollout_fused(runner, p4, cfg, compute_dtype=f32,
                                          normalize_obs=True, normalize_reward=True)
    finally:
        fc.fused_collect = orig
    (k_run, k_traj, k_last), (p_run, p_traj, p_last) = kern, plain
    same = {name: torch.equal(getattr(k_traj, name), getattr(p_traj, name))
            for name in ppo.TRAJ_FIELDS}
    same["last_value"] = torch.equal(k_last, p_last)
    rels = {"obs_norm": stat_rel(k_run.obs_norm, p_run.obs_norm),
            "rew_norm": stat_rel(k_run.rew_norm, p_run.rew_norm)}
    phase("17 parity", f"collect_rollout_fused(normalize_obs, normalize_reward), "
          f"float32, against its plain version: bitwise {same}; statistics "
          f"max relative error {rels} (<= {NORM_STAT_REL}); traj.norm is the "
          f"lagged statistics {k_traj.norm is runner.obs_norm}")
    check(all(same.values()) and max(rels.values()) <= NORM_STAT_REL
          and k_traj.norm is runner.obs_norm, "17: the normalised f32 collect")
    check(bool(torch.isfinite(k_traj.reward).all())
          and not torch.equal(k_run.obs_norm.mean, runner.obs_norm.mean),
          "17: scaled rewards or merged statistics")

    # bf16 route, K2 on the folded weights against its plain version, as
    # phase 7 holds it (table and Philox modes)
    sf, si = ops.pack_state(runner.env_state, p4)
    u = torch.rand((TN, ops.n_draws_per_step(p4), BN), generator=gen, device=dev)
    bf16_err = 0.0
    for name, seed, kw, ref_kw in (("table", 0, dict(uniforms=u), dict(uniforms=u)),
                                   ("Philox", 9, {}, dict(n_steps=TN, seed=9))):
        k_out = ops.fused_collect(sf, si, w_fold, seed, p4, TN, compute_dtype=bf16,
                                  **kw)
        calls = []
        orig = recording(pol, "sample_with_logp", calls)
        try:
            p_out = fc.fused_collect_reference(sf, si, w_fold, p4, compute_dtype=bf16,
                                               **ref_kw)
        finally:
            pol.sample_with_logp = orig
        err, _, _ = compare_policy_bf16(
            k_out, p_out, calls, f"17 folded weights B={BN} T={TN} bf16, {name}",
            (3, 4), (5, 6, 9), (0, 1, 2, 7, 8))
        bf16_err = max(bf16_err, err)
    # what the fold costs in bf16: logp of the buffer's actions through
    # the bf16 forward against the f32 one, folded weights on raw obs and
    # (as in phase 7) the unfolded weights on the same obs
    x = k_traj.obs[:f]
    dirs, acts = ppo._flatten_tm(k_traj.dirs), ppo._flatten_tm(k_traj.acts)

    def logp(w, mode):
        rows, _ = fc._forward(x, w, mode)
        return action_log_prob_and_entropy_packed(rows.T, dirs, acts)[0]

    gap = {k: (logp(w, bf16) - logp(w, f32)).abs().max().item()
           for k, w in (("normalised", w_fold), ("unnormalised", w_plain))}
    phase("17 parity", f"bf16-vs-f32 logp of the buffer's {x.shape[1]} samples, "
          f"max |err|: normalised (folded) {gap['normalised']:.4g}, unnormalised "
          f"{gap['unnormalised']:.4g}; largest bf16 kernel-vs-plain error "
          f"{bf16_err:.3g}")

    # K3 on the normalised buffer: the folded weights in, the gradients
    # unfolded, against the plain version and against autograd of
    # ppo_loss on the buffer z-scored with the same statistics. The
    # weights are those after one update_epochs_fused over the buffer
    # (through traj.norm), so that the ratio and the value leave 1 and
    # their old values, as in the main path's later minibatches.
    adv, ret = ppo.compute_gae(k_traj, k_last, cfg)
    ppo.update_epochs_fused(model, runner.optimizer, k_traj, adv, ret, gen, cfg)
    scales = ppo._obs_norm_scales(k_traj.norm)
    w_fold = ppo.fold_obs_norm(fc.flatten_actor_critic(model), *scales)
    n_blocks = k_traj.obs.shape[1] // BLOCK_N
    rows = [ppo._flatten_tm(a).reshape(n_blocks, BLOCK_N).contiguous() for a in (
        k_traj.dirs, k_traj.acts, k_traj.logp, k_traj.value, adv, ret)]
    idx = torch.randperm(n_blocks, generator=gen, device=dev)[:n_blocks // 4]
    idx = idx.to(torch.int32).contiguous()
    adv_mb = rows[4][idx]
    adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
    args = (w_fold, k_traj.obs.contiguous(), *rows[:4], rows[5], adv_n, idx)
    kw = dict(n_torso=len(H4), clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
              ent_coef=cfg.ent_coef, block=BLOCK_N)
    got, terms = {}, {}
    for mode, tol in ((bf16, K3_BF16_REL), (f32, K3_F32_REL)):
        route = fu.update_plan(k_traj.obs.shape[0], H4, w_fold[-4].shape[1],
                               idx.shape[0] * BLOCK_N, mode)["route"]
        kg, ks = ops.fused_minibatch_grad(*args, **kw, compute_dtype=mode)
        pg, terms[mode] = fu.fused_minibatch_grad_reference(
            *args, **kw, compute_dtype=mode, per_sample=True)
        sums = {k: terms[mode][k].sum() for k in fu.METRICS}
        compare_update((kg, ks), (pg, sums), terms[mode],
                       f"17 K3 on folded weights, {str(mode)[6:]} ({route})", tol,
                       K3_METRIC_REL)
        got[mode] = (ppo.unfold_obs_norm_grads(kg, *scales), ks)
        compare_update(got[mode], (ppo.unfold_obs_norm_grads(pg, *scales), sums),
                       terms[mode], f"17 K3 unfolded, {str(mode)[6:]}", tol,
                       K3_METRIC_REL)
    m = idx.shape[0] * BLOCK_N
    sel = idx.long()
    obs = k_traj.obs.reshape(k_traj.obs.shape[0], -1, BLOCK_N)[:, sel].reshape(-1, m)
    z = (obs[:f] - scales[0][:, None]) * scales[1][:, None]
    model.zero_grad()
    loss, lm = ppo.ppo_loss(model, z, *(a[sel].reshape(m) for a in rows[:4]),
                            adv_n.reshape(m), rows[5][sel].reshape(m), cfg)
    loss.backward()
    auto = (tuple(g for layer in model.dense_layers() for g in (
        layer.weight.grad.t(), layer.bias.grad[:, None])),
        {k: lm[k].detach() * m for k in fu.METRICS})
    compare_update(got[f32], auto, terms[f32], "17 K3 unfolded, float32, against "
                   "autograd of ppo_loss on the z-scored buffer", K3_AUTOGRAD_REL,
                   K3_METRIC_REL)
    model.zero_grad()
    phase("17 parity", f"K3 minibatch of {m} samples after one normalised "
          f"update_epochs_fused: share of samples whose gradient the clip zeroes, "
          f"surrogate {terms[bf16]['pg_clip'].mean().item():.4g}, value "
          f"{terms[bf16]['v_clip'].mean().item():.4g}")

    # 17 main path: the normalised train_iteration at config 4, both
    # kernels in bf16, split by wrapping what it calls
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ActorCritic(3, f, H4, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=T4)
    runner = ppo.init_runner(gen, model, p4, cfg, B4, normalize_obs=True,
                             normalize_reward=True)
    spans = {k: [] for k in ("collect", "K2", "moments", "posthoc", "GAE", "update")}

    def timed(fn, name):
        def run(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    wrapped = {(fc, "fused_collect"): "K2", (ppo, "merge_buffer_moments"): "moments",
               (ppo, "posthoc_reward_norm"): "posthoc", (ppo, "compute_gae"): "GAE"}
    saved = {key: getattr(*key) for key in wrapped}
    step = functools.partial(
        ppo.train_iteration,
        collect_fn=timed(ppo.make_fused_normalized_collect(), "collect"),
        update_fn=timed(ppo.update_epochs_fused, "update"))
    n_iters = 3
    ops.reset_launch_counts()
    for (mod, name), label in wrapped.items():
        setattr(mod, name, timed(saved[(mod, name)], label))
    try:
        runner, _ = step(runner, p4, cfg)                        # warm-up
        totals, history = [], []
        for _ in range(n_iters):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            runner, metrics = step(runner, p4, cfg)
            end.record()
            totals.append((start, end))
            history.append(metrics)
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    launches = {k: ops.LAUNCHES[k] for k in (
        "fused_collect", "fused_minibatch_grad", "fused_collect_f32",
        "fused_minibatch_grad_chain")}
    check(launches["fused_collect"] == n_iters + 1
          and launches["fused_minibatch_grad"] == 16 * (n_iters + 1)
          and launches["fused_collect_f32"] == 0
          and launches["fused_minibatch_grad_chain"] == 0,
          f"17: the normalised main path's launches: {launches}")
    values = {k: [float(x[k]) for x in history] for k in history[0]}
    check(all(math.isfinite(v) for vs in values.values() for v in vs),
          f"17: non-finite metrics {values}")
    ms = sum(s.elapsed_time(e) for s, e in totals) / n_iters
    split = {k: sum(s.elapsed_time(e) for s, e in v[1:]) / n_iters
             for k, v in spans.items()}
    rest = split["collect"] - split["K2"] - split["moments"] - split["posthoc"]
    phase("17 main path", f"train_iteration, normalised (make_fused_normalized_"
          f"collect, update_epochs_fused bfloat16), 3v3 B={B4} T={T4} hidden {H4}: "
          f"{ms:.3f} ms/iteration, {B4 * T4 / ms * 1e3:.6g} env-steps/s ({n_iters} "
          f"iterations after 1 warm-up); collect {split['collect']:.3f} ms (K2 "
          f"{split['K2']:.3f}, obs moments {split['moments']:.3f}, posthoc reward "
          f"norm {split['posthoc']:.3f}, the rest {rest:.3f}), GAE "
          f"{split['GAE']:.3f}, update {split['update']:.3f}, the rest "
          f"{ms - split['collect'] - split['GAE'] - split['update']:.3f}; "
          f"launches {launches}")
    phase("17 main path", f"beside phase 12's unnormalised iteration in this run: "
          f"{main12['ms']:.3f} ms/iteration (collect {main12['collect']:.3f}, "
          f"update {main12['update']:.3f}), launches {main12['launches']} over "
          f"{main12['iters']} iterations")
    phase("17 main path", "metrics per iteration: " + "; ".join(
        f"{k} " + " ".join(f"{v:.5g}" for v in vs) for k, vs in values.items()))

    # 17 resume: 3 iterations against 2 + save + restore into a freshly
    # built runner + 1, bitwise
    cfg = ppo.PPOConfig(rollout_steps=TN)
    step = functools.partial(ppo.train_iteration,
                             collect_fn=ppo.make_fused_normalized_collect(),
                             update_fn=ppo.update_epochs_fused)

    def build(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return ppo.init_runner(g, ActorCritic(3, f, H4, device=dev), p4, cfg,
                               BN_RESUME, normalize_obs=True, normalize_reward=True)

    ref = build(0)
    for _ in range(3):
        ref, _ = step(ref, p4, cfg)
    run = build(0)
    for _ in range(2):
        run, _ = step(run, p4, cfg)
    ck = Checkpointer(os.path.join(scratch, "resume"))
    ck.save(run, 2)
    resumed, it = ck.restore_latest(build(1))
    resumed, _ = step(resumed, p4, cfg)
    a, b = dict(runner_leaves(resumed)), dict(runner_leaves(ref))
    differ = [k for k in b if not (torch.equal(a[k], b[k]) if isinstance(
        b[k], torch.Tensor) else a[k] == b[k])]
    phase("17 resume", f"3v3 B={BN_RESUME} T={TN} hidden {H4}, normalised, fused, "
          f"bf16: 3 iterations against 2 + save + restore_latest (step {it}) into a "
          f"fresh runner + 1: {len(b)} leaves (params, Adam moments and count, env "
          f"state, obs, generator state, obs_norm, rew_norm), differing {differ}; "
          f"{len(ck.steps())} checkpoint of "
          f"{os.path.getsize(os.path.join(scratch, 'resume', 'checkpoint_2.pt'))} bytes")
    check(it == 2 and a.keys() == b.keys() and not differ, "17: resume not bitwise")

    # 17 CLI: a checkpointed, logged run, then the same resumed to 6
    d = os.path.join(scratch, "cli")
    base = ["--ppt", "2", "--envs", "4096", "--hidden", "128", "128",
            "--fused-collect", "--normalize-obs", "--normalize-reward",
            "--checkpoint-dir", d, "--checkpoint-every", "2", "--log-dir", d,
            "--eval-episodes", "512"]
    outs = []
    for iters in ("4", "6"):
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-m", "gym_futbol_tpu_torch.train",
                              *base, "--iters", iters], capture_output=True,
                             text=True, timeout=600, cwd=root)
        lines = cli.stdout.splitlines()
        phase("17 CLI", f"--iters {iters}: exit {cli.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines))
        check(cli.returncode == 0, f"17: the CLI failed: {cli.stderr[-2000:]}")
        outs.append(lines)
    records = [json.loads(x) for x in outs[1] if x.startswith("{")]
    with open(os.path.join(d, "metrics.jsonl")) as fh:
        logged = [json.loads(x)["step"] for x in fh]
    steps = Checkpointer(d).steps()
    evals = [r for lines in outs for r in map(json.loads, filter(
        lambda x: x.startswith("{"), lines)) if "eval_vs_random" in r]
    notes = [[x for x in lines if x.startswith("#")] for lines in outs]
    phase("17 CLI", f"the runs' notes {notes}; the second run's first record "
          f"step {records[0].get('step')}; metrics.jsonl steps {logged}; "
          f"checkpoints {steps}; eval records {len(evals)}")
    check(notes == [[], ["# resumed from iteration 4"]]
          and records[0].get("step") == 4 and logged == list(range(6))
          and steps == [2, 4, 6] and len(evals) == 2,
          "17: the CLI's resume, log or checkpoints")
    shutil.rmtree(scratch, ignore_errors=True)


B_DIST, T_DIST = 16384, 128           # phase 18: config 4 over 2 ranks
B_DIST_K1, T_DIST_K1 = 4096, 512      # phase 18: config 3 over 2 ranks
B_DIST_R, T_DIST_R = 4096, 16         # phase 18: recurrent, 2v2 over 2 ranks
DIST_SEED = 2_000_000_000             # rank 1's folded seed wraps past 2**31
FUTBOL_ENV_STEPS = 200
FUTBOL_ENV_TIMED = 50


def _dist_rank(rank: int, world: int, init_file: str, out_file: str) -> None:
    """One rank of phase 18 (a spawned process; both ranks share the
    card over gloo): the sharded K1a rollout and K1b replay at config 3,
    two sharded fused PPO iterations at config 4 width (K2, K3), one
    sharded recurrent PPO iteration with the fused collect (K5), their
    launch counts, times and the checks; the result as JSON."""
    import dataclasses
    import functools

    import torch
    import torch.distributed as dist

    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from gym_futbol_tpu_torch import EnvParams, a2c, obs_size, ops, ppo, vector
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic
    from gym_futbol_tpu_torch.parallel import (
        check_replicated,
        env_group,
        init_distributed,
        rank_device,
        shard_env_state,
        shard_fused_rollout,
        shard_runner,
        shard_train_iteration,
    )
    from gym_futbol_tpu_torch.parallel.mesh import all_mean, fold_seed

    init_distributed(init_method=f"file://{init_file}", rank=rank,
                     world_size=world, device="cuda")
    _, _, group = env_group()
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    out = {"backend": dist.get_backend(group), "device": str(dev)}
    p3, p4 = EnvParams(players_per_team=2), EnvParams(players_per_team=3)

    def sync_time(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the main path: sharded K1a and K1b, the sharded fused PPO iteration
    # (K2, K3), the sharded recurrent iteration (K5)
    gen = torch.Generator(device=dev).manual_seed(0)
    st3, _ = vector.reset_batch(gen, p3, B_DIST_K1, device=dev)
    acts = torch.randint(0, 5, (16, 2 * p3.n_players, B_DIST_K1), generator=gen,
                         device=dev, dtype=torch.int32)
    sf, si = ops.pack_state(shard_env_state(st3, group), p3)
    gen4 = torch.Generator(device=dev).manual_seed(4)
    cfg = ppo.PPOConfig(rollout_steps=T_DIST)
    runner = shard_runner(ppo.init_runner(
        gen4, ActorCritic(3, obs_size(p4), H4, device=dev), p4, cfg, B_DIST), group)
    step = shard_train_iteration(functools.partial(
        ppo.train_iteration, collect_fn=ppo.collect_rollout_fused,
        update_fn=ppo.update_epochs_fused), group)
    rcfg = rppo.RecurrentPPOConfig(rollout_steps=T_DIST_R)
    rrunner = shard_runner(rppo.init_recurrent_ppo_runner(
        torch.Generator(device=dev).manual_seed(5),
        RecurrentActorCritic(2, obs_size(p3), (128,), 128, device=dev), p3, rcfg,
        B_DIST_R), group)
    rstep = shard_train_iteration(functools.partial(
        rppo.train_iteration_recurrent_ppo,
        collect_fn=a2c.collect_recurrent_rollout_fused), group)
    torch.cuda.synchronize()
    dist.barrier()
    ops.reset_launch_counts()
    k1 = shard_fused_rollout(group, p3, T_DIST_K1)(sf, si, DIST_SEED)
    k1b = ops.fused_rollout_replay(sf, si, shard_env_state(acts, group, dim=2), p3)
    ms_iter, metrics = [], []
    for i in range(3):                       # one warm-up, two timed
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, m = step(runner, p4, cfg)
        torch.cuda.synchronize()
        if i:
            ms_iter.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
    rrunner, rm = rstep(rrunner, p3, rcfg)
    torch.cuda.synchronize()
    out["launches"] = dict(ops.LAUNCHES)
    out["ms_iter"], out["metrics"] = ms_iter, metrics
    out["recurrent"] = {k: float(v) for k, v in rm.items()}

    # the checks (launches from here on are comparisons, not the main path)
    check_replicated(runner, group)
    check_replicated(rrunner, group)
    out["replicated"] = True
    ref = ops.fused_rollout(sf, si, fold_seed(DIST_SEED, rank), p3, T_DIST_K1)
    out["k1_bitwise"] = all(torch.equal(a, b) for a, b in zip(k1, ref))
    sf0, si0 = ops.pack_state(dataclasses.replace(st3, **{
        f.name: getattr(st3, f.name)[: B_DIST_K1 // world]
        for f in dataclasses.fields(st3)}), p3)
    rew = shard_fused_rollout(group, p3, 64)(sf0, si0, DIST_SEED)[2].cpu()
    rank0 = rew.clone()
    dist.broadcast(rank0, 0, group=group)
    out["streams_differ"] = rank == 0 or not torch.equal(rew, rank0)
    out["folded_seed"] = fold_seed(DIST_SEED, rank)
    out["k1b_finite"] = bool(torch.isfinite(k1b[2]).all())
    # the all-reduce of one minibatch: the flat gradients and five metrics
    n = sum(p.numel() for p in runner.model.parameters()) + 5
    buf = torch.randn(n, device=dev)
    for _ in range(3):
        all_mean([buf], group)
    times = sorted(sync_time(lambda: all_mean([buf], group)) for _ in range(20))
    out["allreduce_ms"], out["allreduce_numel"] = times[len(times) // 2], n
    with open(out_file, "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


def distributed_phases(dev) -> None:
    """Phase 18: the distribution layer. (a, c) two spawned ranks share the
    card over gloo: K1a through shard_fused_rollout at config 3 (each
    rank bitwise one unsharded launch of its envs with its folded seed,
    the ranks' streams different), K1b on each rank's share, two sharded
    fused PPO iterations at config 4 width (K2, K3; replicated leaves
    bitwise equal across the ranks), one sharded recurrent PPO iteration
    (K5), every kernel of the path launched on each rank; the iteration's
    time and the all-reduce's per minibatch. Phase 19's first steps, timed
    alone. (d) the CLI under torchrun on two ranks, in the background of
    (b), one rank over NCCL (the sharded fused iteration bitwise the
    undistributed one from the same runner), and of phase 19's other
    steps, neither of which measures a time."""
    import multiprocessing as mp
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke_18")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)

    # (a, c): two ranks on the card, gloo
    world = 2
    ctx = mp.get_context("spawn")
    outs = [os.path.join(scratch, f"rank{r}.json") for r in range(world)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dist_rank, args=(
        r, world, os.path.join(scratch, "rendezvous"), outs[r]))
        for r in range(world)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(timeout=300)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(all(pr.exitcode == 0 for pr in procs),
          f"18: a rank failed: exit codes {[pr.exitcode for pr in procs]}")
    res = []
    for path in outs:
        with open(path) as fh:
            res.append(json.load(fh))
    path_kernels = ("fused_rollout", "fused_rollout_replay", "fused_collect",
                    "fused_minibatch_grad", "fused_recurrent_collect",
                    "fused_lstm_bptt")
    for r, o in enumerate(res):
        launches = {k: o["launches"].get(k, 0) for k in path_kernels}
        others = {k: v for k, v in o["launches"].items()
                  if k.endswith(("_f32", "_chain"))}
        phase("18 ranks", f"rank {r} of {world} on {o['device']} over "
              f"{o['backend']}: kernel launches in the main path {launches}; "
              f"f32 routes and K3's CUDA-core chain {others}")
        check(o["backend"] == "gloo", "18: two ranks on one card must take gloo")
        check(all(n > 0 for n in launches.values()),
              f"18: rank {r}'s main path skipped a kernel: {launches}")
        check(all(v == 0 for v in others.values()),
              "18: an f32 route or K3's chain ran on the main path")
        check(o["replicated"] and o["k1_bitwise"] and o["streams_differ"]
              and o["k1b_finite"], f"18: rank {r}'s checks: {o}")
    check(res[0]["metrics"] == res[1]["metrics"], "18: the ranks' metrics differ")
    phase("18 K1", f"shard_fused_rollout config 3 2v2 {B_DIST_K1} envs over "
          f"{world} ranks T={T_DIST_K1}, seed {DIST_SEED} folded to "
          f"{[o['folded_seed'] for o in res]}: each rank bitwise one unsharded "
          f"launch of its envs with its folded seed; the ranks' streams differ "
          f"on the same envs; the sharded replay finite")
    phase("18 main path", f"sharded train_iteration (fused collect + K3), 3v3 "
          f"{B_DIST} envs over {world} ranks sharing the card ({B_DIST // world} "
          f"each), T={T_DIST}, hidden {H4}, bf16: ms per iteration "
          f"{[[round(x, 3) for x in o['ms_iter']] for o in res]} (rank 0, rank "
          f"1); all-reduce of one minibatch's {res[0]['allreduce_numel']} "
          f"gradient and metric floats (gloo, through host memory), median of "
          f"20: {[round(o['allreduce_ms'], 4) for o in res]} ms; replicated "
          f"leaves bitwise equal across the ranks after 3 iterations and after "
          f"the recurrent one; metrics {res[0]['metrics'][-1]}")
    phase("18 recurrent", f"sharded train_iteration_recurrent_ppo (K5 collect), "
          f"2v2 {B_DIST_R} envs over {world} ranks, T={T_DIST_R}, (128,) H=128: "
          f"{res[0]['recurrent']}")
    phase("18 ranks", f"spawn to exit: {time.perf_counter() - t0:.1f} s")

    # phase 19's timed steps, alone on the card
    env_run = FutbolEnvRun()
    ms_env = env_run.steps(FUTBOL_ENV_TIMED)

    # (d): the CLI under torchrun, two ranks on the card, in the background
    # of (b) and of phase 19's untimed steps, which measure no time
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "gym_futbol_tpu_torch.train",
            "--distributed", "--fused-collect", "--ppt", "2", "--envs", "8192",
            "--hidden", "128", "128", "--iters", "3"]
    t0 = time.perf_counter()
    logs = [os.path.join(scratch, f"cli.{x}") for x in ("out", "err")]
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        cli = subprocess.Popen(argv, stdout=out, stderr=err, cwd=root,
                               env={**os.environ, "OMP_NUM_THREADS": "1"})
        try:
            one_rank_phase(dev, scratch)
            env_run.steps(FUTBOL_ENV_STEPS - FUTBOL_ENV_TIMED)
            cli.wait(timeout=300)
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
    env_run.report(ms_env)
    stdout, stderr = (open(x).read() for x in logs)
    lines = [x for x in stdout.splitlines() if x.startswith("{")]
    phase("18 CLI", f"{' '.join(argv[1:])}: exit {cli.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines))
    check(cli.returncode == 0, f"18: the torchrun CLI failed: {stderr[-3000:]}")
    recs = [json.loads(x) for x in lines]
    check([r.get("step") for r in recs[:-1]] == [0, 1, 2] and recs[-1].get("done")
          and recs[-1]["total_env_steps"] == 3 * 8192 * 128,
          "18: the CLI's records (rank 0 alone prints)")
    shutil.rmtree(scratch, ignore_errors=True)


def one_rank_phase(dev, scratch: str) -> None:
    """Phase 18 (b): one rank over NCCL runs the sharded fused iteration
    at config 4 width, bitwise the undistributed one from the same
    runner."""
    import functools

    import torch
    import torch.distributed as dist

    from gym_futbol_tpu_torch import EnvParams, obs_size, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic
    from gym_futbol_tpu_torch.parallel import (
        env_group,
        init_distributed,
        shard_runner,
        shard_train_iteration,
    )

    p4 = EnvParams(players_per_team=3)
    cfg = ppo.PPOConfig(rollout_steps=T_DIST)

    def make():
        gen = torch.Generator(device=dev).manual_seed(9)
        return ppo.init_runner(gen, ActorCritic(3, obs_size(p4), H4, device=dev),
                               p4, cfg, B_DIST // 2)

    it = functools.partial(ppo.train_iteration, collect_fn=ppo.collect_rollout_fused,
                           update_fn=ppo.update_epochs_fused)
    alone, m_alone = it(make(), p4, cfg)
    check(init_distributed(init_method=f"file://{os.path.join(scratch, 'nccl')}",
                           rank=0, world_size=1, device="cuda"),
          "18: the one-rank group did not start")
    try:
        _, _, group = env_group()
        backend = dist.get_backend(group)
        shared, m_shared = shard_train_iteration(it, group)(
            shard_runner(make(), group), p4, cfg)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    flat_a, flat_b = dict(runner_leaves(alone)), dict(runner_leaves(shared))
    differ = [k for k in flat_a if not (torch.equal(flat_a[k], flat_b[k])
                                        if isinstance(flat_a[k], torch.Tensor)
                                        else flat_a[k] == flat_b[k])]
    same_metrics = all(torch.equal(m_alone[k], m_shared[k]) for k in m_alone)
    phase("18 one rank", f"{backend}, 3v3 {B_DIST // 2} envs T={T_DIST} {H4}: the "
          f"sharded iteration against the undistributed one from the same "
          f"runner: {len(flat_a)} leaves, differing {differ}, metrics equal "
          f"{same_metrics}")
    check(backend == "nccl" and not differ and same_metrics,
          "18: the one-rank NCCL iteration is not bitwise the undistributed one")


class FutbolEnvRun:
    """Phase 19: FutbolEnv on the card through make("futbol-v0") (max
    steps 150): random steps drawn from its action space and generator,
    a reset where an episode ends; then the entity views and the ASCII
    render."""

    def __init__(self):
        import torch

        from gym_futbol_tpu_torch import make

        self.env = make("futbol-v0", seed=0, max_steps=150)
        self.obs = self.env.reset()
        self.episodes, self.rewards, self.n = 0, [], 0
        torch.cuda.synchronize()

    def steps(self, n: int) -> float:
        """``n`` steps; their ms per step (synchronised)."""
        import torch

        env = self.env
        t0 = time.perf_counter()
        for _ in range(n):
            self.obs, reward, done, _ = env.step(env.action_space.sample(env.generator))
            self.rewards.append(reward)
            if done:
                self.episodes += 1
                self.obs = env.reset()
        torch.cuda.synchronize()
        self.n += n
        return (time.perf_counter() - t0) * 1e3 / n

    def report(self, ms: float) -> None:
        import torch

        from gym_futbol_tpu_torch import Ball, Team

        env, obs = self.env, self.obs
        rewards = torch.stack(self.rewards)
        frame = env.render(mode="ansi")
        check(obs.device.type == "cuda" and obs.shape == (4 * env.params.n_bodies + 2,)
              and bool(torch.isfinite(obs).all())
              and bool(torch.isfinite(rewards).all()), "19: FutbolEnv's outputs")
        check(self.episodes == self.n // 150 and all(c in frame for c in "ABo"),
              "19: FutbolEnv's episodes or render")
        phase("19 FutbolEnv", f"make('futbol-v0', max_steps=150) on {obs.device}: "
              f"{self.n} steps, {self.episodes} episode ends; {ms:.2f} ms per "
              f"step over the first {FUTBOL_ENV_TIMED}, alone on the card (the "
              f"plain step of one env, host-bound); reward sum "
              f"{float(rewards.sum()):.5g}; ball at "
              f"{Ball(env.state).position.tolist()}, team 0 "
              f"{Team(env.state, 0, env.params).positions.tolist()}; frame:\n{frame}")



def config5_phase(dev, k2_plan: dict, shares: dict) -> tuple[dict, dict]:
    """Phase 20: the bench config-5 PPO iteration (5v5, 65536 envs, T=64,
    hidden (256, 256), 4 x 4 minibatches of 2^21 samples) through
    train_iteration on the fused collect and K3 in bfloat16, first on the
    tensor cores (W2 streamed through shared memory), then with K3's route
    forced to the CUDA-core chain (the route this shape took before), each
    split into collect, update and the rest; then K3 alone on one config-5
    minibatch of a fresh buffer against its plain version (on-policy, and
    after one update on the buffer), timed beside the chain, the plain
    version, its bound and cuBLAS on the same products. ``k2_plan``: the
    collect's layout phase 7 held against its plain version, which this
    phase's collect must take. Also K2's bound per step at config 5, by
    phase 10's rules on phase 6's 5v5 active ``shares``, beside the
    collect's time and a cuBLAS yardstick of its per-step products.
    Returns K3's and K2's config-5 fields of the kernels line."""
    import torch

    from gym_futbol_tpu_torch import EnvParams, obs_size, ops, ppo
    from gym_futbol_tpu_torch.models.policy import ActorCritic

    fu = importlib.import_module("gym_futbol_tpu_torch.ops.fused_update")
    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
    f32 = torch.float32
    p5 = EnvParams(players_per_team=5)
    gen = torch.Generator(device=dev).manual_seed(20)
    model = ActorCritic(p5.players_per_team, obs_size(p5), H5, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=T5)
    runner = ppo.init_runner(gen, model, p5, cfg, B5)
    m5 = 2 * B5 * T5 // cfg.minibatches
    mb_blocks = m5 // cfg.shuffle_block
    f_pad, g5 = -(-obs_size(p5) // 8) * 8, 10 * p5.players_per_team
    plan = fu.update_plan(f_pad, H5, g5, m5)
    check(plan["route"] == "tensor_cores" and plan["w2_layout"] == "streamed",
          f"20: config 5's K3 plan {plan['route']} W2 {plan.get('w2_layout')}")
    phase("20 plan", f"update_plan at config 5 (F_pad {f_pad}, G*5 {g5}, {m5} "
          f"samples): {plan['route']}, W2 {plan['w2_layout']} (ring "
          f"{plan['w2_ring_bytes']} bytes), forward block {plan['smem_fwd']} "
          f"bytes, backward {plan['smem_bwd']}, {plan['fwd_blocks']} / "
          f"{plan['bwd_blocks']} blocks")
    per_iter = cfg.epochs * cfg.minibatches
    runs = {}
    t0 = time.perf_counter()
    runner, _, runs["tensor cores"] = timed_iterations(runner, p5, cfg, N5_ITERS)
    with forced_update_plan(compute_dtype=f32):
        runner, _, runs["CUDA-core chain"] = timed_iterations(runner, p5, cfg,
                                                               N5_ITERS)
    for name, it in runs.items():
        n, tc = it["iters"], name == "tensor cores"
        launches = {k: it["launches"][k] for k in (
            "fused_collect", "fused_collect_f32", "fused_minibatch_grad",
            "fused_minibatch_grad_chain")}
        check(launches == {"fused_collect": n, "fused_collect_f32": 0,
                           "fused_minibatch_grad": per_iter * n if tc else 0,
                           "fused_minibatch_grad_chain": 0 if tc else per_iter * n},
              f"20: the {name} iterations' launches: {launches}")
        values = {k: [float(x[k]) for x in it["history"]] for k in it["history"][0]}
        check(all(math.isfinite(v) for vs in values.values() for v in vs),
              f"20: non-finite metrics {values}")
        phase("20 main path", f"train_iteration, K3 on the {name} (bfloat16), "
              f"5v5 B={B5} T={T5} hidden {H5}, {cfg.epochs} x {cfg.minibatches} "
              f"minibatches of {m5} samples: {it['ms']:.3f} ms/iteration, "
              f"{B5 * T5 / it['ms'] * 1e3:.6g} env-steps/s ({N5_ITERS} iterations "
              f"after 1 warm-up); collect {it['collect']:.3f} ms, update "
              f"{it['update']:.3f} ms, GAE and the rest "
              f"{it['ms'] - it['collect'] - it['update']:.3f} ms; launches "
              f"{launches}; loss " + " ".join(f"{v:.5g}" for v in values["loss"]))
    k3_launches = runs["tensor cores"]["launches"]["fused_minibatch_grad"]
    BENCH_REFERENCE_MS[5] = ("phase 20", runs["tensor cores"]["ms"])

    # K2's bound per step at config 5, at phase 6's 5v5 active share, and
    # its cuBLAS yardstick
    w5 = fc.flatten_actor_critic(model)
    sf5, si5 = ops.pack_state(runner.env_state, p5)
    bound_k2, _, ops_k2, ops_k2_bf16 = k2_bound(p5, w5, sf5, si5, B5, T5,
                                                shares["5v5"])
    del sf5, si5
    ms_cublas_k2 = k2_cublas_ms(dev, p5, w5, B5, H5)
    k2_step = runs["tensor cores"]["collect"] / T5
    # the route K2 compiled for 5v5, and the share of the sweep a culled
    # warp runs on phase 6's 5v5 states (its warp union)
    route5 = "culled" if fc.collect_culls(p5) else "unculled"
    sh5 = shares["5v5"]
    union5 = {k: sh5[f"{k}_warp"] / sh5[f"n_{k}"] for k in ("pairs", "walls")}
    phase("20 bound", f"fused_collect at config 5 (5v5 B={B5} hidden {H5}): "
          f"env step {route5} (collect_culls), a warp's union "
          f"{union5['pairs']:.4g} of the pairs and {union5['walls']:.4g} of the "
          f"walls a substep (phase 6's 5v5 share); "
          f"{ops_k2} operations per env-step (the env step "
          f"{env_step_ops(p5, shares['5v5'])} at phase 6's 5v5 share), of them "
          f"{ops_k2_bf16} bf16 products -> bound {bound_k2[0]:.6g} ms/step "
          f"({bound_k2[1]}); the collect above {k2_step:.5f} ms/step, "
          f"{bound_k2[0] / k2_step:.4g} of it the bound; cuBLAS (torch.matmul, "
          f"bf16) on the same per-step products of both views "
          f"{ms_cublas_k2:.5f} ms/step "
          f"({B5 * ops_k2_bf16 / ms_cublas_k2 / 1e9:.4g} TFLOP/s), 20 iterations")

    # K3 alone on one minibatch of a fresh buffer: on-policy, as the main
    # path's first minibatch of each iteration, then on the weights after
    # one update on it (as update_minibatch: so that the ratio and the
    # value move past their clips, and the approx_kl terms past float32
    # noise)
    plans = []
    with recorded(fc, "tc_plan", plans):
        runner, traj, last_v = ppo.collect_rollout_fused(runner, p5, cfg)
    check(plans == [k2_plan], f"20: the collect's layout {plans} is not the one "
          f"phase 7 held against its plain version, {k2_plan}")
    adv, ret = ppo.compute_gae(traj, last_v, cfg)
    args, kw = minibatch_args(model, traj, adv, ret, cfg, mb_blocks, gen)
    got = ops.fused_minibatch_grad(*args, **kw)
    plain_grads, terms = fu.fused_minibatch_grad_reference(*args, **kw,
                                                           per_sample=True)
    err_on = compare_update(got, (plain_grads, {k: terms[k].sum() for k in fu.METRICS}),
                            terms, f"20 K3 config 5, {m5} samples on-policy, bf16 "
                            f"on the tensor cores (W2 streamed) vs plain",
                            K3_BF16_REL, K3_METRIC_REL, on_policy=True)
    del got, plain_grads, terms, args
    opt = runner.optimizer
    ppo.update_epochs_fused(model, opt, traj, adv, ret, gen, cfg)
    args, kw = minibatch_args(model, traj, adv, ret, cfg, mb_blocks, gen)
    traj_box = (traj, adv, ret)              # for the update's profile
    del runner, traj, last_v, adv, ret

    def k3(i):
        return ops.fused_minibatch_grad(*args, **kw)

    got = k3(0)
    plain_grads, terms = fu.fused_minibatch_grad_reference(*args, **kw,
                                                           per_sample=True)
    err = compare_update(got, (plain_grads, {k: terms[k].sum() for k in fu.METRICS}),
                         terms, f"20 K3 config 5, {m5} samples, bf16 on the tensor "
                         f"cores (W2 streamed) vs plain", K3_BF16_REL, K3_METRIC_REL)
    clip = {k: terms[k].mean().item() for k in ("pg_clip", "v_clip")}
    del plain_grads, terms
    again = k3(0)
    check(all(torch.equal(a, b) for a, b in zip(got[0], again[0])),
          "20: two calls differ")
    ms_tc = time_cuda(k3, 10)
    with forced_update_plan(compute_dtype=f32):
        ms_chain = time_cuda(k3, 3)
    ms_tc_again = time_cuda(k3, 10)
    plain_ms = time_cuda(lambda i: fu.fused_minibatch_grad_reference(*args, **kw), 2)
    bound_bf16, _, bf16_macs, _ = k3_bound(args[0], f_pad, m5, mb_blocks)
    ms_cublas = k3_cublas_ms(dev, f_pad, H5, g5, m5)
    phase("20 kernels", f"fused_minibatch_grad, config 5 minibatch of {m5} "
          f"samples (share whose gradient the clip zeroes: surrogate "
          f"{clip['pg_clip']:.4g}, value {clip['v_clip']:.4g}): bfloat16 on the "
          f"tensor cores, W2 streamed {ms_tc:.3f} ms (again after the chain: "
          f"{ms_tc_again:.3f}; {2 * bf16_macs * m5 / ms_tc / 1e9:.4g} TFLOP/s of "
          f"bf16 products), the CUDA-core chain in bfloat16 {ms_chain:.3f} ms, "
          f"plain version bfloat16 {plain_ms:.3f} ms; bound {bound_bf16[0]:.4g} "
          f"ms ({bound_bf16[1]}, {bf16_macs} bf16 multiply-adds per sample); "
          f"cuBLAS (torch.matmul, bf16) on the same eight layer products "
          f"{ms_cublas:.3f} ms")
    # the first profile taken after phase 18 recorded no device events
    # once (of one launch, then printed); the profile after it did
    device_profile(lambda: k3(0))
    busy, wall_ms, rows = device_profile(lambda: ppo.update_epochs_fused(
        model, opt, *traj_box, gen, cfg))
    phase("20 profile", f"update_epochs_fused, one config-5 update (16 launches): "
          f"{wall_ms:.3f} ms wall, device busy share {busy:.4f}; device ms by "
          f"kernel: " + "; ".join(f"{name} {n}x {ms:.3f}" for name, n, ms in rows[:8]))
    phase("20 time", f"phase 20 in {time.perf_counter() - t0:.1f} s")
    k2_fields = {"config5_env_step": route5, "config5_union_share": union5,
                 "config5_ms": k2_step, "config5_bound_ms": bound_k2[0],
                 "config5_bound_by": bound_k2[1],
                 "config5_library_ms": ms_cublas_k2,
                 "config5_time_unit": f"ms per step of phase 20's collect, 5v5 "
                                      f"B={B5} T={T5} hidden {H5}, bfloat16; "
                                      f"library_ms: cuBLAS on its per-step "
                                      f"bf16 layer products"}
    return {"config5_launches": k3_launches, "config5_max_abs_err": max(err, err_on),
            "config5_ms": ms_tc, "config5_chain_ms": ms_chain,
            "config5_plain_ms": plain_ms, "config5_bound_ms": bound_bf16[0],
            "config5_bound_by": bound_bf16[1], "config5_cublas_ms": ms_cublas,
            "config5_iteration_ms": runs["tensor cores"]["ms"],
            "config5_chain_iteration_ms": runs["CUDA-core chain"]["ms"],
            "config5_unit": f"ms per launch, bfloat16, one config-5 minibatch of "
                            f"{m5} samples (5v5, hidden {H5}, W2 streamed); "
                            f"launches: the {N5_ITERS + 1} tensor-core "
                            f"iterations of phase 20"}, k2_fields


# Phase 21: both learning gates at a smoke budget (episodes of
# GATE_MAX_STEPS steps, so the plain evaluations stay short)
GATE_MAX_STEPS = 20
GATE_KEYS = {"metric", "ppt", "value", "unit", "threshold", "ok", "per_seed",
             "monotonic_all", "league_points", "train_env_steps_per_seed",
             "train_seconds_total", "hyperparams"}


def run_gate(module, argv: list[str]) -> tuple[int, list[str]]:
    """``module.main(argv)`` in this process (so ops.LAUNCHES counts its
    launches): (exit code, its stdout lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue().splitlines()


def gate_verdict(rc: int, lines: list[str], label: str) -> dict:
    """The gate's last line, checked: JAX's keys, and exit 0 exactly when
    it passed, else 1. At a smoke budget the policies have barely moved,
    so the verdict itself may go either way: the strict final-beats-1/3
    test has few goals to count."""
    out = json.loads(lines[-1])
    check(set(out) == GATE_KEYS, f"21: {label}: the last line's keys {sorted(out)}")
    check(rc == (0 if out["ok"] else 1), f"21: {label}: exit {rc}, ok {out['ok']}")
    check(not out["ok"] or (out["value"] >= out["threshold"]
                            and out["monotonic_all"]),
          f"21: {label}: the verdict {out}")
    return out


def learning_gate_phase() -> None:
    """Phase 21: the learning gates on the card at a smoke budget
    (gym_futbol_tpu_torch.check_learning and check_recurrent_learning,
    called in this process). The MLP gate (2v2, 512 envs, 4 iterations, 2
    seeds, 256 evaluation envs) first with --max-new-seeds 1, which must
    leave seed 1 untrained and exit 2, then again, which must load seed 0,
    train only seed 1, play the league and print the verdict; K2, K3 and
    K4 launched on their bf16 routes as many times as the gate's
    iterations and matches need. Then recurrent PPO on K5
    (--fused-collect, 1 seed, 2 iterations, no league), and recurrent A2C
    the same way on the route ``a2c.FUSED_COLLECT_DTYPE`` picks for it,
    its launches counted under that route's name."""
    import shutil

    from gym_futbol_tpu_torch import a2c, check_learning, check_recurrent_learning, ops

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke_21")
    shutil.rmtree(scratch, ignore_errors=True)
    iters, seeds = 4, 2
    argv = ["--ppt", "2", "--envs", "512", "--iters", str(iters), "--seeds",
            str(seeds), "--eval-envs", "256", "--win-threshold", "0",
            "--max-steps", str(GATE_MAX_STEPS), "--out-dir", scratch]
    ops.reset_launch_counts()
    rc, first = run_gate(check_learning, argv + ["--max-new-seeds", "1"])
    partial = json.loads(first[-1])
    check(rc == 2 and partial.get("complete") is False
          and partial["seeds_done"] == 1 and partial["trained_now"] == 1,
          f"21: the first call (--max-new-seeds 1): exit {rc}, {partial}")
    rc, second = run_gate(check_learning, argv)
    launches = {k: ops.LAUNCHES[k] for k in (
        "fused_collect", "fused_minibatch_grad", "fused_selfplay_rollout",
        "fused_collect_f32", "fused_minibatch_grad_chain",
        "fused_selfplay_rollout_f32")}
    out = gate_verdict(rc, second, "check_learning")
    trained = [sorted({x.split()[2] for x in lines if " iter " in x})
               for lines in (first, second)]
    check(trained == [["0"], ["1000"]]
          and "# seed 0: loaded from " + scratch in second,
          f"21: the seeds each call trained: {trained}")
    # K4: each seed's match against random play and against its 1/3
    # snapshot, then the league's seeds x (seeds - 1) matches
    want = {"fused_collect": seeds * iters,
            "fused_minibatch_grad": seeds * iters * 16,
            "fused_selfplay_rollout": 2 * seeds + seeds * (seeds - 1),
            "fused_collect_f32": 0, "fused_minibatch_grad_chain": 0,
            "fused_selfplay_rollout_f32": 0}
    check(launches == want, f"21: the MLP gate's launches {launches}, "
          f"expected {want}")
    phase("21 gate", f"check_learning 2v2 512 envs x {iters} iterations x "
          f"{seeds} seeds, max_steps {GATE_MAX_STEPS}: first call exit 2 "
          f"({partial}), second exit {rc}: {second[-1]}; launches {launches}")
    rargv = ["--algo", "ppo", "--fused-collect", "--seeds", "1", "--iters", "2",
             "--envs", "512", "--eval-envs", "256", "--max-steps",
             str(GATE_MAX_STEPS), "--no-league", "--win-threshold", "0",
             "--out-dir", scratch]
    ops.reset_launch_counts()
    rc, lines = run_gate(check_recurrent_learning, rargv)
    gate_verdict(rc, lines, "check_recurrent_learning")
    k6_launches = ops.LAUNCHES["fused_lstm_bptt"]
    check(k6_launches > 0, "21: the recurrent PPO gate's update skipped K6")
    launches = {k: ops.LAUNCHES[k] for k in ("fused_recurrent_collect",
                                             "fused_recurrent_collect_f32")}
    check(launches == {"fused_recurrent_collect": 2, "fused_recurrent_collect_f32": 0},
          f"21: the recurrent gate's launches {launches}")
    phase("21 gate", f"check_recurrent_learning --algo ppo --fused-collect 2v2 "
          f"512 envs x 2 iterations, 1 seed: exit {rc}: {lines[-1]}; launches "
          f"{launches}, K6 {k6_launches}")
    # recurrent A2C on the route the package picks for it: its launches
    # land under that route's name only
    route = a2c.FUSED_COLLECT_DTYPE["a2c"]
    ops.reset_launch_counts()
    rc, lines = run_gate(check_recurrent_learning,
                         ["--algo", "a2c", *rargv[2:]])
    out = gate_verdict(rc, lines, "check_recurrent_learning --algo a2c")
    launches = {k: ops.LAUNCHES[k] for k in ("fused_recurrent_collect",
                                             "fused_recurrent_collect_f32")}
    f32 = route == "float32"
    check(out["hyperparams"]["collect_dtype"] == route
          and launches == {"fused_recurrent_collect": 0 if f32 else 2,
                           "fused_recurrent_collect_f32": 2 if f32 else 0},
          f"21: the recurrent A2C gate's route {out['hyperparams']} and "
          f"launches {launches}, expected {route}")
    phase("21 gate", f"check_recurrent_learning --algo a2c --fused-collect 2v2 "
          f"512 envs x 2 iterations, 1 seed, route {route}: exit {rc}: "
          f"{lines[-1]}; launches {launches}")
    shutil.rmtree(scratch, ignore_errors=True)
    phase("21 time", f"phase 21 in {time.perf_counter() - t0:.1f} s")


def array_api_phase(dev, params, sf, si) -> None:
    """Phase 22: the JAX package's per-env API in its array form
    (game.decode_forces, update_possession, apply_kick, apply_dribble,
    detect_goal, clamp_oob, kickoff_positions, shaped_rewards;
    physics.integrate_velocity, solve_contacts; types.body_masses,
    body_radii, body_elasticities, team_of_body) on a CUDA batch: bench
    config 4's 16384 3v3 envs in the states one K1a rollout left, random
    actions (out-of-range ints among them), kick angles and kickoff noise;
    each function's outputs bitwise equal to its scalar form's on the same
    tensors. No kernel runs here."""
    import torch

    from gym_futbol_tpu_torch import game, physics
    from gym_futbol_tpu_torch import types as ttypes
    from gym_futbol_tpu_torch.ops import unpack_state

    t0 = time.perf_counter()
    f32 = torch.float32
    state = unpack_state(sf, si, params)
    pos, vel, poss = state.pos, state.vel, state.possession
    b, n = pos.shape[0], params.n_bodies
    gen = torch.Generator(device=dev).manual_seed(22)
    acts = torch.randint(-1, 6, (b, params.n_players, 2), generator=gen,
                         device=dev, dtype=torch.int32)
    theta = torch.randn(b, generator=gen, device=dev) * params.kick_noise
    noise = torch.rand((b, n, 2), generator=gen, device=dev) * 2.0 - 1.0
    pos1 = pos + torch.randn(pos.shape, generator=gen, device=dev)
    goals = torch.rand((b, 2), generator=gen, device=dev) < 0.1
    clamped = torch.rand(b, generator=gen, device=dev) < 0.1
    table_fns = (ttypes.body_masses, ttypes.body_radii,
                 ttypes.body_elasticities, ttypes.team_of_body)
    tables = [fn(params, device=dev) for fn in table_fns]
    check(all(t.device.type == dev.type and torch.equal(t.cpu(), fn(params))
              for t, fn in zip(tables, table_fns)), "22: the body tables")
    c = physics.physics_constants(params, f32)
    px, py = physics.split_xy(pos)
    vx, vy = physics.split_xy(vel)
    dirs, acts_l = game.split_actions(acts, params)
    xy = physics.stack_xy
    fx, fy = game.decode_forces_scalars(dirs, acts_l, params, f32)
    dvx, dvy, kick_owner = game.apply_kick_scalars(px, py, vx, vy, poss, acts_l,
                                                   theta, params, f32)
    kick_vel = vel.clone()
    kick_vel[:, 0, 0], kick_vel[:, 0, 1] = vx[0] + dvx, vy[0] + dvy
    bpx, bpy, bvx, bvy = game.apply_dribble_scalars(px, py, vx, vy, poss, dirs,
                                                    params, f32)
    cpx, cpy, cvx, cvy, cball = game.clamp_oob_scalars(px, py, vx, vy, params, f32)
    kx, ky = game.kickoff_scalars(*physics.split_xy(noise), params, f32)
    dt_sub = params.dt / params.substeps
    ivx, ivy = physics.integrate_velocity_scalars(
        vx, vy, fx, fy, [c.inv_m_ball] + [c.inv_m_player] * (n - 1), c.damp,
        c.dt_sub, c.max_speed)
    svx, svy = physics._solve_contacts_scalar(px, py, vx, vy, params, f32)
    inv_mass = 1.0 / tables[0]
    pairs = {
        "decode_forces": ((game.decode_forces(acts, params, f32),), (xy(fx, fy),)),
        "update_possession": (
            (game.update_possession(pos, poss, acts, params),),
            (game.update_possession_scalars(px, py, poss, acts_l, params, f32),)),
        "apply_kick": (game.apply_kick(pos, vel, poss, acts, theta, params),
                       (kick_vel, kick_owner)),
        "apply_dribble": (
            game.apply_dribble(pos, vel, poss, acts, params),
            (torch.cat([torch.stack([bpx, bpy], -1)[:, None], pos[:, 1:]], 1),
             torch.cat([torch.stack([bvx, bvy], -1)[:, None], vel[:, 1:]], 1))),
        "detect_goal": ((game.detect_goal(pos, params),),
                        (torch.stack(game.detect_goal_scalars(px[0], py[0],
                                                              params), -1),)),
        "clamp_oob": (game.clamp_oob(pos, vel, params),
                      (xy(cpx, cpy), xy(cvx, cvy), cball)),
        "kickoff_positions": (game.kickoff_positions(noise, params),
                              (xy(kx, ky), torch.zeros_like(pos))),
        "shaped_rewards": (
            (game.shaped_rewards(pos, pos1, poss, goals, clamped, params),),
            (torch.stack(game.shaped_rewards_scalars(
                px, py, *physics.split_xy(pos1), poss, goals[:, 0], goals[:, 1],
                clamped, params, f32), -1),)),
        "integrate_velocity": (
            (physics.integrate_velocity(vel, xy(fx, fy), inv_mass, params,
                                        dt_sub),), (xy(ivx, ivy),)),
        "solve_contacts": ((physics.solve_contacts(pos, vel, params, inv_mass,
                                                   *tables[1:3]),),
                           (xy(svx, svy),)),
    }
    for name, (arr, ref) in pairs.items():
        check(len(arr) == len(ref) and all(
            a.shape == r.shape and torch.equal(a, r) for a, r in zip(arr, ref)),
              f"22: {name}: the array form differs from the scalar form")
    torch.cuda.synchronize()
    owners = int((pairs["update_possession"][0][0] > 0).sum())
    kicks = int((pairs["apply_kick"][0][0] != vel).any(-1).any(-1).sum())
    phase("22 array API", f"3v3 B={b} (the states of one K1a rollout of 128 "
          f"steps): {len(pairs)} array forms and the 4 body tables bitwise "
          f"equal to the scalar forms on the card ({owners} owners, {kicks} "
          f"kicks) in {time.perf_counter() - t0:.1f} s")


# Phase 23: the port's bench as a user runs it, each config at its preset
# and default --iters. Per call of the bench's loop, the launches of the
# kernel of each config's path (every other count must stay 0: no plain
# version, no float32 route, no CUDA-core chain); the bench's --verbose
# line counts from the first of its two warm-ups, so over iters + 2 calls.
BENCH_LAUNCHES = {2: {"fused_rollout": 1}, 3: {"fused_rollout": 1},
                  4: {"fused_collect": 1},
                  5: {"fused_collect": 1, "fused_minibatch_grad": 16},
                  6: {"fused_selfplay_rollout": 1}}
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_SCALING_KEYS = BENCH_KEYS + ["steps_per_sec"]
# ms per call of the same shape's path in this process, for each config
# (phase 6: K1a's rollout; phase 10: collect + GAE, evaluate_fused; phase
# 20: the PPO iteration), written by those phases
BENCH_REFERENCE_MS: dict[int, tuple[str, float]] = {}


def run_bench(argv: list[str], keys: list[str]) -> tuple[dict, list[str], float]:
    """``python -m gym_futbol_tpu_torch.bench *argv`` in a subprocess:
    exit 0 and exactly one JSON line, the last, with ``keys`` in order and
    a value > 0. Returns (record, stdout lines, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gym_futbol_tpu_torch.bench", *argv],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    what = f"23: bench {' '.join(argv)}"
    check(proc.returncode == 0, f"{what} exit {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    records = [x for x in lines if x.startswith("{")]
    check(len(records) == 1 and lines[-1] == records[0],
          f"{what}: {len(records)} JSON lines, last line {lines[-1:]}")
    rec = json.loads(records[0])
    check(list(rec) == keys and rec["value"] > 0, f"{what}: record {rec}")
    return rec, lines, secs


def verbose_field(lines: list[str], prefix: str) -> str:
    """The rest of the bench's ``# <prefix>...`` line after its first
    ': '."""
    line = next((x for x in lines if x.startswith(f"# {prefix}")), None)
    check(line is not None, f"23: no '# {prefix}' line in {lines}")
    return line.split(": ", 1)[-1]


def bench_phase() -> None:
    """Phase 23: ``python -m gym_futbol_tpu_torch.bench --config N
    --verbose`` for configs 2-6 at their presets, then ``--scaling`` with
    one rank: each exits 0 with one contract line; its launches over the
    warm-ups and the timed calls prove its kernels ran (BENCH_LAUNCHES,
    every other count 0). Each rate is printed beside the one implied by
    this process's time for the same shape (BENCH_REFERENCE_MS)."""
    import torch

    from gym_futbol_tpu_torch.bench import CONFIGS

    torch.cuda.empty_cache()     # the subprocesses share the card
    t0 = time.perf_counter()
    for config in sorted(CONFIGS):
        rec, lines, secs = run_bench(["--config", str(config), "--verbose"],
                                     BENCH_KEYS)
        p = CONFIGS[config]
        calls = (40 if config == 2 else 10) + 2
        launches = json.loads(verbose_field(lines, "kernel launches"))
        want = {k: 0 for k in launches}
        want.update({k: n * calls for k, n in BENCH_LAUNCHES[config].items()})
        check(launches == want, f"23: config {config}'s launches {launches}, "
              f"want {want}")
        ran = {k: n for k, n in launches.items() if n}
        if config in BENCH_REFERENCE_MS:
            where, ms = BENCH_REFERENCE_MS[config]
            rate = p["envs"] * p["steps"] / ms * 1e3
            beside = (f"{where}'s {ms:.3f} ms a call implies {rate:.6g} "
                      f"env-steps/s, the bench's ratio to it "
                      f"{rec['value'] / rate:.4f}")
        else:
            beside = "no phase times this shape"
        phase("23 bench", f"config {config} ({p['ppt']}v{p['ppt']} B={p['envs']} "
              f"T={p['steps']}): {rec['value']} env-steps/s (vs_baseline "
              f"{rec['vs_baseline']}); {beside}; launches {ran} over {calls} "
              f"calls; first run {verbose_field(lines, 'first run')}; "
              f"{secs:.1f} s in all; {verbose_field(lines, 'device')}")
    rec, lines, secs = run_bench(["--scaling", "--verbose"], BENCH_SCALING_KEYS)
    check(rec["value"] == 1.0 and list(rec["steps_per_sec"]) == ["1"],
          f"23: --scaling on one rank: {rec}")
    launches = json.loads(verbose_field(lines, "kernel launches"))
    check(launches["fused_collect"] == 12
          and launches["fused_minibatch_grad"] == 16 * 12,
          f"23: --scaling's launches {launches}")
    phase("23 bench", f"--scaling, one rank: {json.dumps(rec)}; {secs:.1f} s")
    phase("23 time", f"phase 23 in {time.perf_counter() - t0:.1f} s")


def replay_phase(dev, shares: dict) -> list[dict]:
    """Phase 6's replay rows: K1b (fused_rollout_replay) at each shape of
    replay_timing.SHAPES on its game states, by its plan and with the plan
    forced to each other lane count G (the plan's threads a block, lowered
    to fit; G = 0, one thread per env, PR 12's design, at its 32), ms per
    step in turns (plan, others, plan), beside the bound
    per step at phase 6's active share of the same team size (the state
    read and written once per call, the actions and rewards once; the env
    step's operations, env_step_ops); each shape's launches counted."""
    from gym_futbol_tpu_torch import EnvParams, ops, replay_timing

    # the module (ops/__init__ shadows its name with the function)
    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")
    rows = []
    own = fr.replay_plan
    for ppt, n_envs, n_steps in replay_timing.SHAPES:
        params = EnvParams(players_per_team=ppt)
        sf, si, acts = replay_timing.replay_inputs(params, n_envs, n_steps, 5, dev)
        plan = own(params, n_envs)
        before = ops.LAUNCHES["fused_rollout_replay"]

        def replay():
            ops.fused_rollout_replay(sf, si, acts, params)

        first = replay_timing.time_call(replay, 10)
        others = {}
        for g in (0, 2, 4, 8):
            if g == plan["lanes"]:
                continue
            # G = 0: one thread per env, PR 12's design and block
            fr.replay_plan = replay_timing.forced_plan(
                fr, g, 32 if g == 0 else plan["threads"])
            try:
                threads = fr.replay_plan(params, n_envs)["threads"]
                others[f"G={g},{threads}"] = replay_timing.time_call(
                    replay, 10) / n_steps
            finally:
                fr.replay_plan = own
        last = replay_timing.time_call(replay, 10)
        launches = ops.LAUNCHES["fused_rollout_replay"] - before
        check(launches == 11 * (2 + len(others)), f"6: replay launches at {ppt}v{ppt}")
        sh = shares[f"{ppt}v{ppt}"]
        b = bound((2 * nbytes(sf, si) + nbytes(acts)) / n_steps + n_envs * 4,
                  n_envs * env_step_ops(params, sh))
        ms = min(first, last) / n_steps
        rows.append({"shape": f"{ppt}v{ppt}", "n_envs": n_envs, "T": n_steps,
                     "lanes": plan["lanes"], "threads": plan["threads"],
                     "ms": ms, "ms_turns": [first / n_steps, last / n_steps],
                     "pr12_design_ms": others.get("G=0,32"),
                     "bound_ms": b[0], "bound_by": b[1], "others_ms": others,
                     "launches": launches})
        phase("6 replay", f"fused_rollout_replay {ppt}v{ppt} B={n_envs} T={n_steps}, "
              f"plan G={plan['lanes']} x {plan['threads']} threads: {ms:.6g} ms/step "
              f"(turns {first / n_steps:.6g}, {last / n_steps:.6g}), bound {b[0]:.6g} "
              f"({b[1]}), {b[0] / ms:.3%} of it; other G, ms/step: "
              + ", ".join(f"{k} {v:.6g}" for k, v in others.items())
              + f"; {launches} launches")
    return rows


def bptt_phase(dev, main_launches: int) -> dict:
    """Phase 24: K6 against its plain versions at the recurrent PPO cell's
    minibatch, its times (the kernels alone, the whole autograd node with
    the weight gradients' products) beside the plain versions', the
    float32 autograd unroll of the cell it replaces (forward and
    backward), cuBLAS (one bf16 product, where K6 takes three) on the
    same per-step products, and its bound. Returns K6's entry of the
    kernels line, with ``main_launches``, phase 15's count of K6's
    launches on the main path."""
    import torch

    from gym_futbol_tpu_torch import ops
    from gym_futbol_tpu_torch.models.recurrent import lstm_cell

    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    torch.backends.cuda.matmul.allow_tf32 = False
    s, t_len, n_t, hs = BT_S, BT_T, BT_NT, BT_H
    gen = torch.Generator(device=dev).manual_seed(24)
    t = torch.tanh(torch.randn(t_len, s, n_t, generator=gen, device=dev))
    std = 1.0 / math.sqrt(n_t + hs)
    w_i = torch.randn(4 * hs, n_t, generator=gen, device=dev) * std
    w_h = torch.randn(4 * hs, hs, generator=gen, device=dev) * std
    b_h = torch.randn(4 * hs, generator=gen, device=dev) * 0.1
    c0 = torch.randn(s, hs, generator=gen, device=dev) * 0.5
    h0 = torch.tanh(torch.randn(s, hs, generator=gen, device=dev))
    done = torch.rand(t_len, s, generator=gen, device=dev) < 0.01
    dh = torch.randn(t_len, s, hs, generator=gen, device=dev) * 1e-2
    plan = fb.bptt_plan(n_t, hs, s)
    d8 = done.to(torch.uint8)
    t2 = fb._split(t)                                # t's two bf16 terms
    before = ops.LAUNCHES["fused_lstm_bptt"]
    (kg, kc, kh, _, kcl, khl), bwd = fb._forward_kernel(t2, w_i, w_h, b_h, c0, h0, d8)
    kd = fb._backward_kernel(kg, kc, c0, d8, dh, bwd)
    kd = kd[0].float() + kd[1].float()               # dgates' two bf16 terms
    pg, pc, ph, _, pcl, phl = fb.bptt_forward_reference(t, w_i, w_h, b_h, c0, h0, d8)
    pd = fb.bptt_backward_reference(fb.fragment_rows(kg, s, hs).contiguous(),
                                    fb.fragment_rows(kc, s, hs).contiguous(), c0, d8,
                                    dh, w_h)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["fused_lstm_bptt"] == before + 2, "24: K6 launches")

    def rel_max(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max()).item()

    errs = {"gates": rel_max(fb.fragment_rows(kg, s, hs), pg),
            "c": rel_max(fb.fragment_rows(kc, s, hs), pc), "h": rel_max(kh, ph),
            "c_last": rel_max(kcl, pcl), "h_last": rel_max(khl, phl)}
    err_bwd = rel_max(kd, pd)
    check(max(errs.values()) <= K6_FWD_REL and err_bwd <= K6_BWD_REL,
          f"24: K6 against its plain versions: forward {errs}, dgates {err_bwd}")
    max_abs = max((kh - ph).abs().max().item(), (kd - pd).abs().max().item())
    del kg, kc, kh, kcl, khl, kd, pg, pc, ph, pcl, phl, pd
    torch.cuda.empty_cache()
    phase("24 parity", f"fused_lstm_bptt S={s} T={t_len} torso {n_t} H={hs}, resets "
          f"{int(done.sum())}: forward kernel against its plain version (largest "
          f"difference over the largest value) " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()) + f"; backward dgates "
          f"{err_bwd:.3g}")
    state = {}

    def kernels(_):
        state["f"] = fb._forward_kernel(t2, w_i, w_h, b_h, c0, h0, d8)
        (g_, c_, *_), b_ = state["f"]
        fb._backward_kernel(g_, c_, c0, d8, dh, b_)

    def forward_only(_):
        state["f"] = fb._forward_kernel(t2, w_i, w_h, b_h, c0, h0, d8)

    leaves = [x.clone().requires_grad_(True) for x in (t, w_i, w_h, b_h)]

    def node(_):
        h_all, _ = fb.fused_lstm_bptt(*leaves, (c0, h0), done)
        h_all.backward(dh)

    def plain(_):
        out = fb.bptt_forward_reference(t, w_i, w_h, b_h, c0, h0, d8)
        fb.bptt_backward_reference(out[0], out[1], c0, d8, dh, w_h)

    cell_i = torch.nn.Linear(n_t, 4 * hs, bias=False, device=dev)
    cell_h = torch.nn.Linear(hs, 4 * hs, device=dev)
    with torch.no_grad():
        cell_i.weight.copy_(w_i)
        cell_h.weight.copy_(w_h)
        cell_h.bias.copy_(b_h)
    t_req = t.clone().requires_grad_(True)

    def autograd_f32(_):          # models.recurrent's float32 unroll of the cell
        x_in = cell_i(t_req)
        keep = (1.0 - done.float())[..., None]
        c, h, hs_all = c0, h0, []
        for x_t, keep_t in zip(x_in.unbind(0), keep):
            c, h = lstm_cell(cell_h(h) + x_t, c)
            hs_all.append(h)
            c, h = c * keep_t, h * keep_t
        torch.stack(hs_all).backward(dh)

    a_f = torch.randn(s, plan["kt"] + plan["hp"], generator=gen, device=dev).bfloat16()
    b_f = torch.randn(plan["kt"] + plan["hp"], 4 * hs, generator=gen,
                      device=dev).bfloat16()
    a_b = torch.randn(s, 4 * hs, generator=gen, device=dev).bfloat16()
    b_b = torch.randn(4 * hs, hs, generator=gen, device=dev).bfloat16()

    def products(_):              # cuBLAS on the window's per-step products
        for _k in range(t_len):
            torch.mm(a_f, b_f, out_dtype=torch.float32)
            torch.mm(a_b, b_b, out_dtype=torch.float32)

    kernels(0)
    ms_fwd = time_cuda(forward_only, 5)
    ms_k6 = time_cuda(kernels, 5)
    state.clear()
    node(0)
    ms_node = time_cuda(node, 5)
    products(0)
    ms_lib = time_cuda(products, 3)
    plain(0)
    ms_plain = time_cuda(plain, 1)
    autograd_f32(0)
    ms_f32 = time_cuda(autograd_f32, 2)
    rows = s * t_len
    # the function's own work: the step's products forward (K = kt + H)
    # and backward (dh = dgates Wh^T), three bf16 products each for
    # float32's result; its own bytes: t read, h written, the heads' dh
    # read, dgates written (f32)
    flops = 3 * 2 * rows * 4 * hs * ((plan["kt"] + plan["hp"]) + hs)
    n_bytes = rows * 4 * (n_t + hs + hs + 4 * hs)
    # the design's saved state besides: the gates and c written and read,
    # c read again as c_{t-1}, h_{t-1} written for dWh
    saved_bytes = rows * 4 * hs * (2 * 4 + 3 + 1)
    bound_k6 = bound(n_bytes, 0.0, flops)
    phase("24 kernels", f"fused_lstm_bptt, one minibatch (S={s} T={t_len} torso {n_t} "
          f"H={hs}), ms: forward {ms_fwd:.3f} + backward {ms_k6 - ms_fwd:.3f} = "
          f"kernels {ms_k6:.3f}; the autograd node (the weight gradients' split "
          f"bf16 products on cuBLAS included) {ms_node:.3f}; plain versions "
          f"{ms_plain:.1f}; the float32 autograd unroll it replaces {ms_f32:.1f} "
          f"({ms_f32 / ms_node:.3g}x the node); cuBLAS, one bf16 product a step, "
          f"{ms_lib:.3f}; bound {bound_k6[0]:.3f} ({bound_k6[1]}: {n_bytes / 1e9:.4g} GB "
          f"of its own, {flops / 1e12:.4g} TFLOP bf16), kernels at "
          f"{bound_k6[0] / ms_k6:.3%} of it; the design's saved state "
          f"{saved_bytes / 1e9:.4g} GB more")
    return {"name": "fused_lstm_bptt", "route": "cuda",
            "kernel": "bptt_forward_kernel + bptt_backward_kernel (bf16 operand "
                      "pairs, tensor cores)",
            "source": BPTT_SOURCE, "replaces": None,
            "launches": main_launches, "max_abs_err": max_abs,
            "ms": ms_k6, "forward_ms": ms_fwd, "node_ms": ms_node, "plain_ms": ms_plain,
            "f32_autograd_ms": ms_f32, "bound_ms": bound_k6[0], "bound_by": bound_k6[1],
            "saved_state_gb": saved_bytes / 1e9,
            "library_ms": None, "yardstick_ms": ms_lib,
            "unit": f"ms per minibatch of {s} sequences, T {t_len}, torso {n_t}, H {hs}"}


def ln_phase(dev, shares: dict) -> list[dict]:
    """Phase 25: K5's and K6's LayerNorm instantiations against their plain
    versions at the LayerNorm cell's shapes, step by step (the constants'
    note), their times beside the plain instantiations' on the same
    inputs, in turns, and the plain versions', the bounds of
    ``futbench.counts_lnlstm`` (K5's at ``shares``, phase 6's 3v3 active
    shares), cuBLAS (one bf16 product each) on the same per-step
    products, ``t Wi`` as the node takes it (:func:`_mm3_k`, one stacked
    product) against three (:func:`_mm3`), and recurrent PPO iterations
    at the cell's configuration on the main path. Returns the two
    kernels' entries of the kernels line."""
    import torch

    from futbench import counts_lnlstm, counts_recurrent
    from gym_futbol_tpu_torch import EnvParams, a2c, obs_size, ops, vector
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.recurrent import LN_EPS, RecurrentActorCritic
    from gym_futbol_tpu_torch.ops._policy import unit_major
    from gym_futbol_tpu_torch.ops.fused_rollout import n_draws_per_step

    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")
    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    pol = importlib.import_module("gym_futbol_tpu_torch.ops._policy")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    p3 = EnvParams(players_per_team=3)
    n_obs, n_logits = obs_size(p3), 2 * p3.players_per_team * 5
    bf16 = torch.bfloat16

    def changed(before):
        return {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}

    def ln_model(gen):
        model = RecurrentActorCritic(3, n_obs, LN_HIDDEN, LN_H, generator=gen, device=dev,
                                     layer_norm=True)
        with torch.no_grad():       # gains and biases off 1 and 0, the cell's bias off 0
            for ln in model.layer_norms():
                ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=gen, device=dev))
                ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=gen, device=dev))
            model.cell_h.bias.normal_(0.0, 0.1, generator=gen)
        return model

    # K5: T = 1 calls, each from the kernel's own state and carries
    gen = torch.Generator(device=dev).manual_seed(25)
    state, _ = vector.reset_batch(gen, p3, LN_B, device=dev)
    sf, si, _ = ops.fused_rollout(*ops.pack_state(state, p3), 2500, p3, 32)
    model = ln_model(gen)
    w, ln = fr.flatten_recurrent_actor_critic(model), fr.layer_norm_leaves(model)
    cc, hh = (torch.randn(2, LN_H, LN_B, generator=gen, device=dev) * 0.5 for _ in range(2))
    cc[:, :, :5] = 0.0
    hh[:, :, :5] = 0.0                                   # zero carries
    u = torch.rand((LN_TF_STEPS, n_draws_per_step(p3), LN_B), generator=gen, device=dev)
    k5_err, k5_logp, ties = 0.0, [], []
    before = dict(ops.LAUNCHES)
    for k in range(LN_TF_STEPS):
        got = ops.fused_recurrent_collect(sf, si, w, cc, hh, 0, p3, 1, uniforms=u[k:k + 1],
                                          ln=ln)
        calls = []
        orig = recording(pol, "sample_with_logp", calls)
        try:
            want = fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, p3,
                                                        uniforms=u[k:k + 1], ln=ln)
        finally:
            pol.sample_with_logp = orig
        err, logp_err, counts = compare_policy_bf16(
            got, want, calls, f"25 K5-LN step {k} (T=1 from the kernel's carry)", (3, 4),
            (5, 6, 9, 10, 11), (0, 1, 2, 7, 8))
        k5_err = max(k5_err, err)
        k5_logp.append(logp_err)
        ties.append(counts)
        sf, si, cc, hh = got[0], got[1], got[10], got[11]
    torch.cuda.synchronize()
    check(changed(before) == {"fused_recurrent_collect_ln": LN_TF_STEPS},
          f"25: K5-LN launches {changed(before)}")
    total = {k: sum(c[k] for c in ties) for k in ties[0]}
    phase("25 K5-LN", f"fused_recurrent_collect(ln=) 3v3 B={LN_B} torso {LN_HIDDEN} "
          f"H={LN_H}, {LN_TF_STEPS} steps teacher-forced: largest float error {k5_err:.3g} "
          f"(<= {POLICY_BF16_ATOL}), logp error by step "
          f"{[float(f'{e:.3g}') for e in k5_logp]}; near ties {total}")

    def k5(with_ln):
        return lambda i: ops.fused_recurrent_collect(sf, si, w, cc, hh, 900 + i, p3, TR,
                                                     ln=ln if with_ln else None)

    k5(True)(0)
    k5(False)(0)
    ms_k5ln, ms_k5, ms_k5ln_again, ms_k5_again = (
        time_cuda(k5(x), 5) / TR for x in (True, False, True, False))
    fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, p3, 1, seed=0, ln=ln)
    plain_k5ln = time_cuda(lambda i: fr.fused_recurrent_collect_reference(
        sf, si, w, cc, hh, p3, 2, seed=1 + i, ln=ln), 1) / 2
    dims = counts_recurrent.lstm_dims(n_obs, LN_HIDDEN, LN_H, n_logits)
    f_pad = -(-n_obs // 8) * 8
    bound_k5ln = counts_lnlstm.k5ln_bound(3, dims, LN_H, f_pad, LN_B, TR, shares,
                                          p3.substeps, p3.solver_iterations)
    ms_bound_k5ln = bound_k5ln[0] / TR
    wi, wh, wl = w[2 * len(LN_HIDDEN)], w[2 * len(LN_HIDDEN) + 1], w[2 * len(LN_HIDDEN) + 3]
    xs = [torch.randn(2 * LN_B, d, device=dev, dtype=bf16)
          for d in (n_obs, LN_HIDDEN[0], LN_HIDDEN[1], LN_H, LN_H)]
    ms_ = [w[0].to(bf16), w[2].to(bf16), wi.to(bf16), wh.to(bf16), wl.to(bf16)]

    def k5_products(_):           # cuBLAS on both views' per-step products
        for x, m in zip(xs, ms_):
            torch.matmul(x, m)

    k5_products(0)
    ms_lib5 = time_cuda(k5_products, 20)
    phase("25 K5-LN", f"3v3 B={LN_B} T={TR}, ms/step: recurrent_ln_tc_kernel {ms_k5ln:.5f} "
          f"(again {ms_k5ln_again:.5f}), the plain recurrent_tc_kernel on the same weights "
          f"without the norms {ms_k5:.5f} (again {ms_k5_again:.5f}); plain version "
          f"{plain_k5ln:.1f}; bound {ms_bound_k5ln:.6g} ({bound_k5ln[1]}; "
          f"counts_lnlstm.k5ln_bound), kernel at {ms_bound_k5ln / ms_k5ln:.3%} of it; "
          f"cuBLAS, one bf16 product each of the step's products, {ms_lib5:.5f}")
    k5_record = {
        "name": "fused_recurrent_collect_ln", "route": "cuda",
        "kernel": "recurrent_ln_tc_kernel (bf16, tensor cores, LayerNorm)",
        "source": RECURRENT_SOURCE, "replaces": None, "max_abs_err": k5_err,
        "ms": ms_k5ln, "plain_kernel_ms": ms_k5, "plain_ms": plain_k5ln,
        "bound_ms": ms_bound_k5ln, "bound_by": bound_k5ln[1], "library_ms": None,
        "yardstick_ms": ms_lib5,
        "unit": f"ms per step of {LN_B} 3v3 envs, torso {list(LN_HIDDEN)}, H {LN_H}"}
    del xs, ms_, got, want, calls, model, w, ln, cc, hh, sf, si, state, u

    # K6: the node's own gates' input side (t Wi, its LayerNorm)
    s, t_len, n_t, hs = BT_S, BT_T, BT_NT, BT_H
    gen = torch.Generator(device=dev).manual_seed(26)
    t = torch.tanh(torch.randn(t_len, s, n_t, generator=gen, device=dev))
    std = 1.0 / math.sqrt(n_t + hs)
    w_i = torch.randn(4 * hs, n_t, generator=gen, device=dev) * std
    w_h = torch.randn(4 * hs, hs, generator=gen, device=dev) * std
    b = torch.randn(4 * hs, generator=gen, device=dev) * 0.1
    c0 = torch.randn(s, hs, generator=gen, device=dev) * 0.5
    h0 = torch.tanh(torch.randn(s, hs, generator=gen, device=dev))
    c0[:7] = 0.0
    h0[:7] = 0.0                                         # zero carries: h Wh a zero row
    done = torch.rand(t_len, s, generator=gen, device=dev) < 0.01
    d8 = done.to(torch.uint8)
    dh = torch.randn(t_len, s, hs, generator=gen, device=dev) * 1e-2
    lnl = [(1.0 if k % 2 == 0 else 0.0) + 0.1 * torch.randn(n, generator=gen, device=dev)
           for k, n in enumerate((4 * hs,) * 4 + (hs,) * 2)]
    gx, bx, gh, bh, gc, bc = lnl
    t2 = fb._split(t)
    rows2 = tuple(z.reshape(t_len * s, n_t) for z in t2)
    wi2 = fb._split(unit_major(w_i).t())
    x = fb._mm3_k(rows2, wi2)
    x3 = fb._mm3(rows2, wi2)
    mm_gap = ((x - x3).abs().max() / x3.abs().max()).item()
    del x3
    ms_mm3_k, ms_mm3, ms_mm3_k_again = (time_cuda(lambda i, f=f: f(rows2, wi2), 5)
                                        for f in (fb._mm3_k, fb._mm3, fb._mm3_k))
    a = torch.native_layer_norm(x, [4 * hs], unit_major(gx), unit_major(bx + b),
                                LN_EPS)[0].reshape(t_len, s, hs, 4)
    del x
    torch.cuda.empty_cache()
    phase("25 K6-LN", f"t Wi over the window ([{t_len * s}, {n_t}] x [{n_t}, {4 * hs}], "
          f"split): one stacked product (_mm3_k) {ms_mm3_k:.3f} ms (again "
          f"{ms_mm3_k_again:.3f}), three products (_mm3) {ms_mm3:.3f} ms; largest "
          f"difference over the largest value {mm_gap:.3g}")
    ghu, bhu = unit_major(gh).reshape(hs, 4), unit_major(bh).reshape(hs, 4)
    before = dict(ops.LAUNCHES)
    kout, bwd = fb._ln_forward_kernel(a, w_h, (gh, bh, gc, bc), c0, h0, d8)
    kg, kc, kh, khp, ky, ksh, ksc, kcl, khl = kout
    check(all(bool(torch.isfinite(z).all()) for z in (kg, kc, kh, ky, ksh, ksc)),
          "25: K6-LN forward not finite")
    check(bool((ky[0, :7] == 0).all()) and bool((ksh[0, :7, 0] == 0).all()),
          "25: a zero carry's h Wh is not a zero row")
    g_rows, c_rows = (fb.fragment_rows(z, s, hs).contiguous() for z in (kg, kc))
    keep = (1.0 - done.float())[..., None]
    num, den = {}, {}
    c, h = c0, h0
    for k in range(t_len):          # each step from the kernel's carry
        p = fb.bptt_ln_forward_reference(a[k:k + 1], w_h, ghu, bhu, gc, bc, c, h,
                                         d8[k:k + 1])
        pairs = {"gates": (g_rows[k:k + 1], p[0]), "c": (c_rows[k:k + 1], p[1]),
                 "h": (kh[k:k + 1], p[2]),
                 "h_prev": (khp[0][k:k + 1].float() + khp[1][k:k + 1].float(), p[3]),
                 "y": (ky[k:k + 1], p[4]), "stats_y": (ksh[k:k + 1], p[5]),
                 "stats_c": (ksc[k:k + 1], p[6])}
        if k == t_len - 1:
            pairs.update(c_last=(kcl, p[7]), h_last=(khl, p[8]))
        for name, (g_, w_) in pairs.items():
            num[name] = max(num.get(name, 0.0), (g_ - w_).abs().max().item())
            den[name] = max(den.get(name, 0.0), w_.abs().max().item())
        c, h = c_rows[k] * keep[k], kh[k] * keep[k]
    errs = {k: num[k] / den[k] for k in num}
    n_b = LN_BWD_STEPS
    kd = fb._ln_backward_kernel(kg[:n_b], kc[:n_b], ky[:n_b], ksh[:n_b], ksc[:n_b], c0,
                                d8[:n_b], dh[:n_b], bwd, ghu.contiguous(), gc, bc)
    pd = fb.bptt_ln_backward_reference(g_rows[:n_b], c_rows[:n_b], ky[:n_b], ksh[:n_b],
                                       ksc[:n_b], c0, d8[:n_b], dh[:n_b], w_h, ghu, gc, bc)
    torch.cuda.synchronize()
    check(changed(before) == {"fused_lnlstm_bptt": 2}, f"25: K6-LN launches {changed(before)}")
    kd = (kd[0], kd[1][0].float() + kd[1][1].float(), kd[2])
    errs_bwd = {name: ((g_ - w_).abs().max() / w_.abs().max()).item()
                for name, g_, w_ in zip(("dpre", "dy", "dn"), kd, pd)}
    check(all(bool(torch.isfinite(z).all()) for z in kd), "25: K6-LN backward not finite")
    check(max(errs.values()) <= K6_FWD_REL and max(errs_bwd.values()) <= K6_BWD_REL,
          f"25: K6-LN against its plain versions: forward {errs}, backward {errs_bwd}")
    k6_err = max(num["h"], (kd[0] - pd[0]).abs().max().item())
    phase("25 K6-LN", f"fused_lnlstm_bptt S={s} T={t_len} torso {n_t} H={hs}, resets "
          f"{int(done.sum())}, 7 zero carries: forward kernel against its plain version "
          f"run each step from the kernel's carry (largest difference over the largest "
          f"value) " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; backward over the first {n_b} steps " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs_bwd.items()))
    del kout, kg, kc, kh, khp, ky, ksh, ksc, kcl, khl, g_rows, c_rows, kd, pd, p, pairs
    del c, h
    torch.cuda.empty_cache()

    def ln_kernels(_):
        (g_, c_, _h, _hp, y_, sh_, sc_, *_), b_ = fb._ln_forward_kernel(
            a, w_h, (gh, bh, gc, bc), c0, h0, d8)
        fb._ln_backward_kernel(g_, c_, y_, sh_, sc_, c0, d8, dh, b_, ghu.contiguous(), gc, bc)

    def ln_forward(_):
        fb._ln_forward_kernel(a, w_h, (gh, bh, gc, bc), c0, h0, d8)

    def plain_kernels(_):
        (g_, c_, *_), b_ = fb._forward_kernel(t2, w_i, w_h, b, c0, h0, d8)
        fb._backward_kernel(g_, c_, c0, d8, dh, b_)

    ln_kernels(0)
    plain_kernels(0)
    ms_fwd, ms_k6ln, ms_k6, ms_k6ln_again, ms_k6_again = (
        time_cuda(f, 5) for f in (ln_forward, ln_kernels, plain_kernels, ln_kernels,
                                  plain_kernels))
    leaves = [z.clone().requires_grad_(True) for z in (t, w_i, w_h, b)]
    ln_leaves = [z.clone().requires_grad_(True) for z in lnl]

    def node(_):
        h_all, _ = fb.fused_lnlstm_bptt(*leaves, ln_leaves, (c0, h0), done)
        h_all.backward(dh)

    node(0)
    ms_node = time_cuda(node, 3)

    def plain(_):
        out = fb.bptt_ln_forward_reference(a, w_h, ghu, bhu, gc, bc, c0, h0, d8)
        fb.bptt_ln_backward_reference(out[0], out[1], out[4], out[5], out[6], c0, d8, dh,
                                      w_h, ghu, gc, bc)

    plain(0)
    ms_plain = time_cuda(plain, 1)
    a_f = torch.randn(s, hs, generator=gen, device=dev).bfloat16()
    b_f = torch.randn(hs, 4 * hs, generator=gen, device=dev).bfloat16()
    a_b = torch.randn(s, 4 * hs, generator=gen, device=dev).bfloat16()
    b_b = torch.randn(4 * hs, hs, generator=gen, device=dev).bfloat16()

    def products(_):              # cuBLAS on the recurrence's per-step products
        for _k in range(t_len):
            torch.mm(a_f, b_f, out_dtype=torch.float32)
            torch.mm(a_b, b_b, out_dtype=torch.float32)

    products(0)
    ms_lib6 = time_cuda(products, 3)
    bound_k6ln = counts_lnlstm.k6ln_bound(hs, s, t_len, 1)
    phase("25 K6-LN", f"fused_lnlstm_bptt, one minibatch (S={s} T={t_len} torso {n_t} "
          f"H={hs}), ms: bptt_ln_forward_kernel {ms_fwd:.3f} + bptt_ln_backward_kernel "
          f"{ms_k6ln - ms_fwd:.3f} = kernels {ms_k6ln:.3f} (again {ms_k6ln_again:.3f}); "
          f"the plain K6 kernels on the same t and weights {ms_k6:.3f} (again "
          f"{ms_k6_again:.3f}); the autograd node (t Wi, its LayerNorm and LayerNorm's "
          f"backward, the split weight products) {ms_node:.3f}; plain versions "
          f"{ms_plain:.1f}; cuBLAS, one bf16 product a step, {ms_lib6:.3f}; bound "
          f"{bound_k6ln[0]:.3f} ({bound_k6ln[1]}; counts_lnlstm.k6ln_bound), kernels at "
          f"{bound_k6ln[0] / ms_k6ln:.3%} of it")
    k6_record = {
        "name": "fused_lnlstm_bptt", "route": "cuda",
        "kernel": "bptt_ln_forward_kernel + bptt_ln_backward_kernel (bf16 operand "
                  "pairs, tensor cores, LayerNorm)",
        "source": BPTT_SOURCE, "replaces": None, "max_abs_err": k6_err,
        "ms": ms_k6ln, "forward_ms": ms_fwd, "node_ms": ms_node, "plain_kernel_ms": ms_k6,
        "plain_ms": ms_plain, "bound_ms": bound_k6ln[0], "bound_by": bound_k6ln[1],
        "library_ms": None, "yardstick_ms": ms_lib6, "t_wi_stacked_ms": ms_mm3_k,
        "t_wi_three_ms": ms_mm3,
        "unit": f"ms per minibatch of {s} sequences, T {t_len}, torso {n_t}, H {hs}"}
    del leaves, ln_leaves, a_f, b_f, a_b, b_b
    torch.cuda.empty_cache()
    tail_record = tail_phase(dev, s, t_len, hs, a, (rows2, wi2), w_h, lnl, b, (c0, h0), d8,
                             dh)
    del t, t2, rows2, a, dh
    torch.cuda.empty_cache()

    # the main path: recurrent PPO iterations at the cell's configuration
    gen = torch.Generator(device=dev).manual_seed(27)
    cfg = rppo.RecurrentPPOConfig(rollout_steps=LN_T, **LN_PPO)
    runner = rppo.init_recurrent_ppo_runner(gen, ln_model(gen), p3, cfg, LN_B)
    step = functools.partial(rppo.train_iteration_recurrent_ppo,
                             collect_fn=a2c.collect_recurrent_rollout_fused)
    runner, _ = step(runner, p3, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    n_iters = 2
    t0 = time.perf_counter()
    for _ in range(n_iters):
        runner, metrics = step(runner, p3, cfg)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) * 1e3 / n_iters
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    n_mb = cfg.epochs * cfg.minibatches
    check(launches == {"fused_recurrent_collect_ln": n_iters,
                       "fused_lnlstm_bptt": 2 * n_mb * n_iters,
                       "lnlstm_tail": n_mb * n_iters},
          f"25: the LayerNorm main path's launches {launches}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), "25: metrics not finite")
    phase("25 main path", f"train_iteration_recurrent_ppo, the layer-normalised LSTM, 3v3 "
          f"B={LN_B} T={LN_T} torso {LN_HIDDEN} H={LN_H}, {cfg.epochs} x "
          f"{cfg.minibatches} minibatches: {ms_iter:.1f} ms an iteration "
          f"({LN_B * LN_T / ms_iter * 1e3:.6g} env-steps/s), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches over "
          f"{n_iters} iterations (counters reset just before) {launches}")
    k5_record["launches"] = launches["fused_recurrent_collect_ln"]
    k6_record["launches"] = launches["fused_lnlstm_bptt"]
    tail_record["launches"] = launches["lnlstm_tail"]
    del runner
    torch.cuda.empty_cache()
    phase("25 time", f"phase 25 in {time.perf_counter() - t_start:.1f} s")
    return [k5_record, k6_record, tail_record]


def tail_phase(dev, s, t_len, hs, a, t_wi, w_h, lnl, b, carry, d8, dh) -> dict:
    """Phase 25's LayerNorm backward tail: on one minibatch's saved state
    (K6-LN's forward and backward over the whole window from the gates'
    input side ``a``; ``x = t Wi`` from its split operands ``t_wi``
    and its statistics), the tail kernel against its plain version
    (``ln_tail_reference``, fed c' copied out of the fragment order as
    the node did before the kernel) within LN_TAIL_REL, one launch
    counted; both timed in turns (CUDA events) beside the bound of their
    bytes. Returns the tail's entry of the kernels line."""
    import torch

    from gym_futbol_tpu_torch import ops
    from gym_futbol_tpu_torch.models.recurrent import LN_EPS
    from gym_futbol_tpu_torch.ops._policy import unit_major

    fb = importlib.import_module("gym_futbol_tpu_torch.ops.fused_bptt")
    gx, bx, gh, bh, gc, bc = lnl
    c0, h0 = carry
    gxu, bxu = unit_major(gx), unit_major(bx + b)
    ghu = unit_major(gh).reshape(hs, 4).contiguous()
    n = t_len * s
    x = fb._mm3_k(*t_wi)
    _, mux, rx = torch.native_layer_norm(x, [4 * hs], gxu, bxu, LN_EPS)
    (_g, c_, _h, _hp, y_, sh_, sc_, *_), b_ = fb._ln_forward_kernel(
        a, w_h, (gh, bh, gc, bc), c0, h0, d8)
    dpre, _dy, dn = fb._ln_backward_kernel(_g, c_, y_, sh_, sc_, c0, d8, dh, b_, ghu, gc, bc)
    del _g, _h, _hp, _dy
    torch.cuda.empty_cache()

    def kernel(_):
        return fb._ln_tail_kernel(dpre, x, mux, rx, gxu, y_, sh_, dn, c_, sc_)

    def plain(_):
        return fb.ln_tail_reference(
            dpre.reshape(n, 4 * hs), x, mux, rx, gxu, bxu, y_.reshape(n, 4 * hs),
            sh_.reshape(n, 2), ghu.reshape(-1), dn.reshape(n, hs),
            fb.fragment_rows(c_, s, hs).reshape(n, hs).contiguous(), sc_.reshape(n, 2), gc,
            bc)

    before = dict(ops.LAUNCHES)
    got = kernel(0)
    torch.cuda.synchronize()
    changed = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    check(changed == {"lnlstm_tail": 1}, f"25: the tail's launches {changed}")
    want = plain(0)
    names = ("dx", "dgx", "db", "dgh", "dgc", "dbc")
    flat = [[o[0][0].double() + o[0][1].double(), *(z.double() for z in o[1:])]
            for o in (got, want)]
    errs = {k: ((g_ - w_).norm() / w_.norm()).item() for k, g_, w_ in zip(names, *flat)}
    check(all(bool(torch.isfinite(z).all()) for z in flat[0]), "25: the tail not finite")
    check(max(errs.values()) <= LN_TAIL_REL, f"25: the tail against its plain version {errs}")
    del got, want, flat
    torch.cuda.empty_cache()
    kernel(0)
    plain(0)                        # the allocator holds both routes' buffers
    ms_kernel, ms_plain, ms_kernel_again, ms_plain_again = (
        time_cuda(f, 5) for f in (kernel, plain, kernel, plain))
    n_bytes = 4 * n * (3 * 4 * hs + 2 * hs + 6) + 2 * 2 * n * 4 * hs
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    phase("25 tail", f"LayerNorm's backward tail, one minibatch (S={s} T={t_len} H={hs}): "
          f"lnlstm_tail_kernel + lnlstm_tail_sum_kernel {ms_kernel:.3f} ms (again "
          f"{ms_kernel_again:.3f}), its plain version (three native_layer_norm_backward, "
          f"c' copied out of the fragment order, dx split) {ms_plain:.3f} (again "
          f"{ms_plain_again:.3f}); bound {bound:.3f} ({n_bytes / 1e9:.3f} GB at 3.35 TB/s), "
          f"kernel at {bound / ms_kernel:.3%} of it; against the plain version (relative "
          f"L2) " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return {
        "name": "lnlstm_tail", "route": "cuda",
        "kernel": "lnlstm_tail_kernel + lnlstm_tail_sum_kernel (f32, one pass, partial "
                  "sums per block)",
        "source": "none: LayerNorm's backward tail of the layer-normalised LSTM's BPTT "
                  "node (PyTorch's native_layer_norm_backward before)",
        "replaces": None, "max_abs_err": max(errs.values()), "ms": ms_kernel,
        "plain_ms": ms_plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
        "unit": f"ms per minibatch of {s} sequences, T {t_len}, H {hs}"}


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (the share of its wall
    time the device was busy, the wall ms, [(kernel, launches, device
    ms)] largest first). One stream, so the kernels do not overlap. The
    program's spans, which the profiler also draws on the device's
    timeline (user annotations), are no device work and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        name = re.sub(r"\([^()]*\)$", "", e.name).replace(
            "(anonymous namespace)::", "").replace("void ", "")[:70]
        n, us = per.get(name, (0, 0.0))
        per[name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in per.values())
    rows = sorted(((k, n, us / 1e3) for k, (n, us) in per.items()),
                  key=lambda r: -r[2])
    return busy / wall_us, wall_us / 1e3, rows


def _build_log() -> str:
    from gym_futbol_tpu_torch.ops import _build

    return _build.library_path() + ".log"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their type's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_PER_S + bf16_ops / BF16_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def env_step_ops(params, shares=None) -> int:
    """Floating-point operations of one env step, counted by hand from
    csrc/futbol_step.cuh: per solver iteration 40 per body pair update
    (normal and friction impulses) and 11 per (wall, body) update; per
    substep 20 per pair (contact set-up) and 40 per body (wall set-up,
    integration). Without ``shares`` every pair and wall is updated; with
    them (active_shares) only the mean number active per env and substep
    on this run's data, the work these inputs need (an inactive update is
    a no-op the kernels skip). The rules, rewards and draws are left out,
    so the bound stays below the true one."""
    nb = 2 * params.players_per_team + 1
    pairs = nb * (nb - 1) // 2
    upd_pairs, upd_walls = ((pairs, 4 * nb) if shares is None
                            else (shares["pairs_env"], shares["walls_env"]))
    return round(params.substeps * (params.solver_iterations
                                    * (40 * upd_pairs + 11 * upd_walls)
                                    + 20 * pairs + 40 * nb))


def active_shares(params, sf, si, n_steps: int, seed: int, lanes: int = 1) -> dict:
    """The contact solver's active share on a state, measured with the
    plain version on the card (fused_rollout_reference, ``n_steps``
    random-policy steps, Philox ``seed``) by wrapping its activity tests
    (physics._pair_active, _wall_active): per substep, the mean number of
    active pairs and (wall, body) constraints per env; per group of 32
    consecutive envs (a warp of the one-thread-per-env kernels) the mean
    number active in any env of the group, which the warp-union sweep
    runs; and per group of 32 / ``lanes`` envs (a warp of the replay
    kernel at ``lanes`` per env) the mean of the longest env's count,
    the slots its per-env lists walk."""
    import torch

    from gym_futbol_tpu_torch import physics
    from gym_futbol_tpu_torch.ops.fused_rollout import fused_rollout_reference

    masks = {"pairs": [], "walls": []}
    orig = (physics._pair_active, physics._wall_active)

    def wrap(fn, key):
        def active(x):
            on = fn(x)
            masks[key].append(on)
            return on
        return active

    physics._pair_active = wrap(orig[0], "pairs")
    physics._wall_active = wrap(orig[1], "walls")
    try:
        fused_rollout_reference(sf, si, params, n_steps, seed=seed)
    finally:
        physics._pair_active, physics._wall_active = orig
    nb = params.n_bodies
    per = {"pairs": nb * (nb - 1) // 2, "walls": 4 * nb}
    out = {"n_pairs": per["pairs"], "n_walls": per["walls"]}
    for key, n in per.items():
        m = torch.stack(masks[key])                       # [substeps * n, B]
        substeps = m.shape[0] // n
        b = m.shape[1]
        warp = torch.nn.functional.pad(m, (0, (-b) % 32)).reshape(
            m.shape[0], -1, 32).any(2)
        out[f"{key}_env"] = m.double().sum().item() / (substeps * b)
        out[f"{key}_warp"] = warp.double().sum().item() / (substeps * warp.shape[1])
        per_env = m.reshape(substeps, n, b).sum(1)         # [substeps, B]
        per_warp = 32 // lanes if lanes else 32   # lanes 0: the union runs
        slots = torch.nn.functional.pad(per_env, (0, (-b) % per_warp)).reshape(
            substeps, -1, per_warp).max(2).values
        out[f"{key}_slots"] = slots.double().mean().item()
    out["lanes"] = lanes
    return out


def shares_text(sh: dict) -> str:
    return (f"per env and substep {sh['pairs_env']:.4g} of {sh['n_pairs']} pairs, "
            f"{sh['walls_env']:.4g} of {sh['n_walls']} walls active; union over each "
            f"warp's 32 envs {sh['pairs_warp']:.4g} pairs, {sh['walls_warp']:.4g} walls; "
            f"per-env list slots per warp of the replay at G={sh['lanes']} "
            f"({32 // max(sh['lanes'], 1)} envs a warp) {sh['pairs_slots']:.4g} pairs, "
            f"{sh['walls_slots']:.4g} walls")


def mlp_ops(weights) -> int:
    """Operations of one MLP forward per sample on flat (W [in, out], b,
    ...) weights: two per multiply-add of each layer product, one per
    bias (activations and sampling left out)."""
    return sum(2 * w.numel() + b.numel() for w, b in zip(weights[::2], weights[1::2]))


def time_cuda(fn, iters: int) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` calls (CUDA events,
    synchronized)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(log_path: str) -> list[str]:
    """One line per kernel from nvcc's -Xptxas -v report: registers,
    stack frame and spills, each kernel named from its mangled symbol
    as ``<name>_kernel<n_bodies>``."""
    out, name, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                m = re.search(r"([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
                args = re.findall(r"L[ib](\d+)E", m[2] or "") if m else []
                name = (f"{m[1]}<{','.join(args)}>" if args else m[1]) if m else mangled
            elif name and "spill stores" in line:
                spill = line.strip()
            elif name and "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                out.append(f"{name}: {regs} registers, {spill}")
                name, spill = None, ""
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gym_futbol_tpu_torch import EnvParams, RewardConfig, ops, replay_timing, vector
    from gym_futbol_tpu_torch.ops import _build
    from gym_futbol_tpu_torch.ops.fused_rollout import (
        fused_rollout_reference,
        n_draws_per_step,
        replay_plan,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # 1: device
    phase("1 device", f"{kind}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    # 2: build
    t0 = time.perf_counter()
    _build.load()
    phase("2 build", f"nvcc sm_90a build {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(_build.library_path())}")
    for line in ptxas_summary(_build.library_path() + ".log"):
        phase("2 build", line)

    def start(params, n_envs, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state, _ = vector.reset_batch(gen, params, n_envs, device=dev)
        return (*ops.pack_state(state, params), gen)

    def replay_actions(params, gen, n_steps, n_envs):
        return torch.randint(0, 5, (n_steps, 2 * params.n_players, n_envs),
                             generator=gen, device=dev, dtype=torch.int32)

    custom = EnvParams(
        players_per_team=2, kick_noise=0.12, placement_noise=0.06,
        substeps=3, solver_iterations=5, max_steps=7,
        width=900.0, height=300.0, goal_size=60.0,
        player_radius=12.0, ball_radius=14.0, player_mass=35.0, ball_mass=2.5,
        player_elasticity=0.5, ball_elasticity=0.3, wall_elasticity=0.95,
        friction=0.7, dt=0.08, damping=0.9, collision_slop=0.05,
        baumgarte=0.3, max_speed=350.0, move_force=3500.0,
        dash_multiplier=1.5, possession_radius=55.0, dribble_offset=5.0,
        pass_power=450.0, shoot_power=900.0,
        rewards=RewardConfig(
            goal=25.0, concede=-5.0, ball_to_goal_delta=0.37,
            player_to_ball_delta=0.045, possession_bonus=0.013,
            oob_penalty=-0.55, time_penalty=-0.002),
    )
    p_test = EnvParams(players_per_team=2, kick_noise=0.0, placement_noise=0.0,
                       substeps=2, solver_iterations=4, max_steps=6)
    p3 = EnvParams(players_per_team=2)
    p5 = EnvParams(players_per_team=5)
    errs = {"fused_rollout": 0.0, "fused_rollout_replay": 0.0}

    # 3: replay parity, bitwise: zero-noise params from the kickoff; 3v3
    # and 5v5 at their main batches from game states (replay_timing's
    # inputs: 32 random-policy steps after a reset)
    p4 = EnvParams(players_per_team=3)
    for label, params, n_envs, n_steps in (
            ("P", p_test, B3, T_PARITY),
            ("custom", custom.replace(kick_noise=0.0, placement_noise=0.0), B3,
             T_PARITY),
            ("3v3", p4, B4, 4), ("5v5", p5, B5, 4)):
        if params.players_per_team == 2:
            sf, si, gen = start(params, n_envs, 1)
            acts = replay_actions(params, gen, n_steps, n_envs)
        else:
            sf, si, acts = replay_timing.replay_inputs(params, n_envs, n_steps, 1, dev)
        got = ops.fused_rollout_replay(sf, si, acts, params)
        want = fused_rollout_reference(sf, si, params, actions=acts)
        errs["fused_rollout_replay"] = max(
            errs["fused_rollout_replay"],
            compare(got, want, f"3 replay {label} B={n_envs} T={n_steps}, "
                    f"plan {replay_plan(params, n_envs)}", exact=True))

    # 4-5: K1a bitwise against the plain version on the plan's route and
    # on each other route of rollout_plan, forced as replay_phase forces
    # the replay's (G = 0: one thread per env, 32 a block; other G at the
    # plan's block), each launch counted under its route's counter
    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")
    own_plan = fr.rollout_plan

    def on_routes(params, n_envs, run, want, label):
        plan = own_plan(params, n_envs)
        for g in (None, 0, 2, 4, 8):
            if g == plan["lanes"]:
                continue
            if g is not None:
                fr.rollout_plan = replay_timing.forced_plan(
                    fr, g, 32 if g == 0 else plan["threads"])
            try:
                route = fr.rollout_plan(params, n_envs)
                counter = "fused_rollout" if route["lanes"] else "fused_rollout_union"
                before = ops.LAUNCHES[counter]
                got = run()
                check(ops.LAUNCHES[counter] == before + 1,
                      f"{label}: launch not counted under {counter}")
                errs["fused_rollout"] = max(errs["fused_rollout"], compare(
                    got, want, f"{label}, G={route['lanes']} x {route['threads']}"
                    + (" (plan)" if g is None else ""), exact=True))
            finally:
                fr.rollout_plan = own_plan

    # 4: table-mode parity, same uniforms to both
    for label, params, n_envs, n_steps in (
            ("default 2v2", p3, B3, T_PARITY), ("custom", custom, B3, T_PARITY),
            ("default 5v5", p5, B5, 4)):
        sf, si, gen = start(params, n_envs, 2)
        u = torch.rand((n_steps, n_draws_per_step(params), n_envs),
                       generator=gen, device=dev)
        on_routes(params, n_envs,
                  lambda: ops.fused_rollout(sf, si, 0, params, n_steps, uniforms=u),
                  fused_rollout_reference(sf, si, params, uniforms=u),
                  f"4 table {label} B={n_envs} T={n_steps}")

    # 5: Philox mode at config 3
    sf0, si0, gen = start(p3, B3, 3)
    on_routes(p3, B3, lambda: ops.fused_rollout(sf0, si0, 11, p3, T_PARITY),
              fused_rollout_reference(sf0, si0, p3, T_PARITY, seed=11),
              f"5 philox vs plain philox B={B3} T={T_PARITY}")
    sf, si, rew = ops.fused_rollout(sf0, si0, 12, p3, T3)
    again = ops.fused_rollout(sf0, si0, 12, p3, T3)
    other = ops.fused_rollout(sf0, si0, 13, p3, T3)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rew).all()), "5: non-finite rewards")
    t_final = si[3].long()
    t_implied = (si0[3].long() + T3) % p3.max_steps
    dones = int(((si0[3].long() + T3) // p3.max_steps).sum())
    check(bool(((t_final >= 0) & (t_final < p3.max_steps)).all()),
          "5: clock out of range")
    check(torch.equal(t_final, t_implied), "5: clock differs from T steps")
    check(all(torch.equal(a, b) for a, b in zip((sf, si, rew), again)),
          "5: same seed, different output")
    check(not torch.equal(rew, other[2]), "5: new seed, same output")
    phase("5 philox", f"B={B3} T={T3}: rewards finite, clocks exact, "
          f"{dones} episode ends (the clock's count), seed-deterministic")

    # Philox kernel vs plain fed torch.Generator uniforms: same
    # distribution of mean reward, goals and possession per env.
    def env_stats(out):
        sf_, si_, rew_ = out
        goals = ((si_[1] + si_[2]) - (si0[1] + si0[2])).double()
        return (rew_.double().mean(0), goals / T_STATS, (si_[0] > 0).double())

    k_stats = env_stats(ops.fused_rollout(sf0, si0, 14, p3, T_STATS))
    u = torch.rand((T_STATS, n_draws_per_step(p3), B3), generator=gen, device=dev)
    p_stats = env_stats(fused_rollout_reference(sf0, si0, p3, uniforms=u))
    for name, a, b in zip(("mean reward", "goal rate", "possession rate"),
                          k_stats, p_stats):
        se = ((a.var() + b.var()) / B3).sqrt().item()
        diff = abs(a.mean().item() - b.mean().item())
        phase("5 philox", f"{name}: kernel {a.mean().item():.6g}, plain "
              f"{b.mean().item():.6g}, |diff| {diff:.3g} <= 5 SE {5 * se:.3g}")
        check(diff <= 5 * se, f"5: {name} differs by more than 5 SE")

    # 6: main path
    gen = torch.Generator(device=dev).manual_seed(0)
    state, obs = vector.reset_batch(gen, p3, B3, device=dev)
    sf, si = ops.pack_state(state, p3)
    ops.reset_launch_counts()
    for w in range(2):
        sf, si, rew = ops.fused_rollout(sf, si, 100 + w, p3, T3)
    t_before = si[3].clone()
    iters = 20
    box = [sf, si]

    def run3(i):
        box[0], box[1], _ = ops.fused_rollout(box[0], box[1], 200 + i, p3, T3)

    ms3 = time_cuda(run3, iters)
    BENCH_REFERENCE_MS[3] = ("phase 6", ms3)
    sf, si = box
    check(bool(torch.isfinite(sf).all()), "6: non-finite state")
    check(torch.equal(si[3].long(),
                      (t_before.long() + iters * T3) % p3.max_steps),
          "6: clock differs from the steps taken")
    acts = replay_actions(p3, gen, T_PARITY, B3)
    ms_replay = time_cuda(
        lambda i: ops.fused_rollout_replay(sf, si, acts, p3), iters)
    st5, _ = vector.reset_batch(gen, p5, B5, device=dev)
    sf5, si5 = ops.pack_state(st5, p5)
    sf5, si5, rew5 = ops.fused_rollout(sf5, si5, 300, p5, T5)
    ms5 = time_cuda(lambda i: ops.fused_rollout(sf5, si5, 301 + i, p5, T5), 3)
    check(bool(torch.isfinite(rew5).all()) and rew5.shape == (T5, B5),
          "6: 5v5 rewards")
    launches = {k: ops.LAUNCHES[k] for k in ("fused_rollout", "fused_rollout_union",
                                             "fused_rollout_replay")}
    check(launches["fused_rollout"] > 0 and launches["fused_rollout_replay"] > 0,
          f"6: the main path skipped a kernel: {launches}")
    phase("6 main path", f"2v2 B={B3} T={T3}: {ms3:.3f} ms/rollout, "
          f"{B3 * T3 / ms3 * 1e3:.6g} env-steps/s ({iters} rollouts)")
    phase("6 main path", f"replay 2v2 B={B3} T={T_PARITY}: {ms_replay:.3f} "
          f"ms/call, {B3 * T_PARITY / ms_replay * 1e3:.6g} env-steps/s")
    phase("6 main path", f"5v5 B={B5} T={T5}: {ms5:.3f} ms/rollout, "
          f"{B5 * T5 / ms5 * 1e3:.6g} env-steps/s")
    phase("6 main path", f"kernel launches in the main path: {launches}")

    # the plain version at the same batch, T=4 (thousands of small
    # launches per step)
    t_plain = 4
    fused_rollout_reference(sf, si, p3, t_plain, seed=1)
    plain_ms = time_cuda(
        lambda i: fused_rollout_reference(sf, si, p3, t_plain, seed=2 + i), 2)
    acts4 = acts[:t_plain].contiguous()
    plain_replay_ms = time_cuda(
        lambda i: fused_rollout_reference(sf, si, p3, actions=acts4), 2)
    phase("6 plain", f"2v2 B={B3} T={t_plain}: {plain_ms:.1f} ms/rollout, "
          f"{B3 * t_plain / plain_ms * 1e3:.6g} env-steps/s")
    # the contact solver's active share on game states of each main path's
    # scale (the work the culled kernels' inputs need): config 3's and the
    # 5v5 rollout's states from above, config 4's after 128 random steps
    st4, _ = vector.reset_batch(gen, p4, 16384, device=dev)
    sf4, si4 = ops.pack_state(st4, p4)
    sf4, si4, _ = ops.fused_rollout(sf4, si4, 400, p4, 128)
    shares = {}
    for key, label, params, a, b in (
            ("2v2", f"config 3 2v2 B={B3}", p3, sf, si),
            ("5v5", f"5v5 B={B5}", p5, sf5, si5),
            ("3v3", "config 4 3v3 B=16384 (random play)", p4, sf4, si4)):
        shares[key] = active_shares(params, a, b, 2, 900,
                                    replay_plan(params, a.shape[1])["lanes"])
        phase("6 active", f"{label}, plain version over 2 steps: "
              f"{shares_text(shares[key])}")
    # bounds per step: the state read and written once per call, rewards
    # (and the replayed actions) once; the env step's operations on this
    # run's active share (every constraint's count beside it)
    ops_k1 = env_step_ops(p3, shares["2v2"])
    bound_k1 = bound((2 * nbytes(sf, si)) / T3 + B3 * 4, B3 * ops_k1)
    bound_k1b = bound((2 * nbytes(sf, si) + nbytes(acts)) / T_PARITY + B3 * 4,
                      B3 * ops_k1)
    bound_k1_all = bound((2 * nbytes(sf, si)) / T3 + B3 * 4, B3 * env_step_ops(p3))
    ops_k1_5 = env_step_ops(p5, shares["5v5"])
    bound_k1_5 = bound((2 * nbytes(sf5, si5)) / T5 + B5 * 4, B5 * ops_k1_5)
    phase("6 bound", f"fused_rollout and replay: {ops_k1} operations per "
          f"env-step at config 3's active share -> {bound_k1[0]:.6g} / "
          f"{bound_k1b[0]:.6g} ms/step ({bound_k1[1]} / {bound_k1b[1]}); every "
          f"constraint: {env_step_ops(p3)} -> {bound_k1_all[0]:.6g}; 5v5: "
          f"{ops_k1_5} (every constraint {env_step_ops(p5)}) -> "
          f"{bound_k1_5[0]:.6g} ms/step")

    replay_shapes = replay_phase(dev, shares)

    policy_record = policy_phases(dev, custom, shares)
    update_record, main12 = update_phases(dev, custom)
    recurrent_record = recurrent_phases(dev, custom, shares)
    k6_main_launches = recurrent_record.pop("k6_launches")
    normalized_phases(dev, main12)
    distributed_phases(dev)
    k3_config5, k2_config5 = config5_phase(
        dev, policy_record[0]["config5_plan"], shares)
    update_record.update(k3_config5)
    policy_record[0].update(k2_config5)
    learning_gate_phase()
    array_api_phase(dev, p4, sf4, si4)
    bench_phase()
    bptt_record = bptt_phase(dev, k6_main_launches)
    ln_records = ln_phase(dev, shares["3v3"])
    phase("time", "seconds per phase (each interval between two lines charged "
          "to the phase of the later): " + json.dumps(
              {k: round(v, 1) for k, v in PHASE_SECONDS.items()}))

    per_step = f"ms per step of the {B3}-env 2v2 batch"
    record = {"kernels": [
        {"name": "fused_rollout", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_rollout"],
         "launches": launches["fused_rollout"],
         "launches_union": launches["fused_rollout_union"],
         "max_abs_err": errs["fused_rollout"],
         "ms": ms3 / T3, "plain_ms": plain_ms / t_plain,
         "bound_ms": bound_k1[0], "bound_by": bound_k1[1], "library_ms": None,
         "unit": per_step},
        {"name": "fused_rollout_replay", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_rollout_replay"],
         "launches": launches["fused_rollout_replay"],
         "max_abs_err": errs["fused_rollout_replay"],
         "ms": ms_replay / T_PARITY, "plain_ms": plain_replay_ms / t_plain,
         "bound_ms": bound_k1b[0], "bound_by": bound_k1b[1], "library_ms": None,
         "unit": per_step, "shapes": replay_shapes},
        *policy_record,
        update_record,
        recurrent_record,
        bptt_record,
        *ln_records,
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
