#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from gym_futbol_tpu_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, and drives the
port's main paths:
- phases 3-6, the random-policy rollout (fused_rollout,
  fused_rollout_replay): 4096 2v2 envs for 512 steps (bench config 3),
  a replay of given actions, and one 5v5 rollout of 65536 envs;
- phases 7-10, the self-play policy path (fused_collect,
  fused_selfplay_rollout): table- and Philox-mode parity at both main
  paths' shapes and on other ones, a teacher-forced check of
  the collect against the actor-critic module, Philox sampling
  statistics, then PPO collection + GAE at bench config 4 (3v3, 16384
  envs, T=128, hidden (256, 256)) and fused evaluation at bench config 6
  (2v2, 4096 envs, T=512, two (128, 128) MLPs);
- phases 11-13, PPO training (fused_minibatch_grad): the update kernels
  (bf16 on the tensor cores, float32 on the CUDA-core chain) against
  their plain version and against autograd on real minibatches (a
  collected buffer, after one iteration's updates have moved the
  weights, so that both clips decide some samples' gradients; 3v3, 2v2,
  custom params and a 5v5 G = 10 head), then train_iteration at bench
  config 4 (fused collect, GAE, 4 epochs x 4 minibatches of 2^20 samples
  on the kernels) and once through the training CLI, then the kernels'
  times beside the CUDA-core chain's and cuBLAS's on the same products;
- phases 14-16, the recurrent learners (fused_recurrent_collect): the
  kernel against its plain version in table and Philox modes from
  non-zero carries (3v3, 16384 envs, hidden (128,), H=128, and other
  shapes), a teacher-forced check against the RecurrentActorCritic
  module and sampling statistics, then recurrent PPO through
  train_iteration_recurrent_ppo at that shape (T=16), one recurrent A2C
  iteration and the training CLI with --recurrent, then K5's times.
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
B4, T4, H4 = 16384, 128, (256, 256)   # bench config 4: 3v3 PPO collect
B6, T6, H6 = 4096, 512, (128, 128)    # bench config 6: 2v2 evaluation
T_PARITY = 16
T_STATS = 64
T_FORCED = 32
SOURCE = "gym_futbol_tpu_torch/csrc/fused_rollout.cu"
POLICY_SOURCE = "gym_futbol_tpu_torch/csrc/fused_policy.cu"
UPDATE_SOURCE = "gym_futbol_tpu_torch/csrc/fused_update.cu"
RECURRENT_SOURCE = "gym_futbol_tpu_torch/csrc/fused_recurrent.cu"
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
# Kernel against plain version on the same inputs: pos/vel rtol 1e-4 /
# atol 1e-3, rewards 1e-4 absolute, integer state exact.
RTOL, ATOL, REW_ATOL = 1e-4, 1e-3, 1e-4
# Policy kernels against plain versions: every float output within 1e-4
# (the same operations in the same order: bitwise in practice), integers
# and sampled actions exact. Teacher-forced logp and value against the
# actor-critic module (cuBLAS f32 with TF32 off, another summation
# order): 1e-4; the kernel's mirrored view against mirror_obs: 1e-6.
POLICY_ATOL, FORCED_ATOL, MIRROR_ATOL = 1e-4, 1e-4, 1e-6
# The update kernels (fused_minibatch_grad) against their plain version
# on the same inputs, per gradient leaf rel-L2: float32 sums in another
# order only; bfloat16 the same rounding points, so only the summation
# order and the rare one-ulp bfloat16 flips of an operand that it causes.
# Against autograd of ppo_loss through the module (float32, TF32 off):
# another formulation of the same sums. Metric sums: error relative to
# the plain version's sum of |per-sample term| (compare_update).
K3_F32_REL, K3_BF16_REL, K3_AUTOGRAD_REL, K3_METRIC_REL = 1e-4, 1e-3, 1e-4, 1e-4
K3_BLOCK = 1024             # PPOConfig.shuffle_block
# The recurrent main path: the JAX recurrent gate at config-4 scale
# (3v3, 16384 envs, T=16, hidden (128,), LSTM size 128).
BR, TR, HR, LSTM_R = 16384, 16, (128,), 128
# K5 replayed through the RecurrentActorCritic module (cuBLAS float32,
# TF32 off, another summation order, the carry fed back over 16 steps):
# logp, value and the final carries within 5e-5.
K5_FORCED_ATOL = 5e-5


class SmokeFailure(RuntimeError):
    pass


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare(kernel_out, plain_out, label: str) -> float:
    """Kernel vs plain outputs (statef, statei, rewards); returns the
    largest absolute float difference."""
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


def policy_phases(dev, custom) -> list[dict]:
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
    from gym_futbol_tpu_torch.ops.fused_rollout import n_draws_per_step

    fa = importlib.import_module("gym_futbol_tpu_torch.ops.fused_actor")
    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
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
    # the main paths' shapes and on the ragged batch. The kernels line
    # takes each kernel's error at its own main path's shape (K2: config
    # 4, K4: config 6); the other cases must pass all the same.
    for label, params, hidden, n_envs, philox, main in (
            (f"config 4 3v3 {H4}", p4, H4, B4, True, "fused_collect"),
            (f"config 6 2v2 {H6}", p6, H6, B6, True, "fused_selfplay_rollout"),
            ("custom (32, 16)", custom, (32, 16), B3, False, None),
            ("ragged 2v2 (64, 64)", p6.replace(max_steps=7), (64, 64), 1000,
             True, None)):
        sf, si, model, gen = setup(params, hidden, n_envs, 4)
        w = fc.flatten_actor_critic(model)
        wa = fa.init_mlp(gen, params, hidden, device=dev)
        wb = fa.init_mlp(gen, params, hidden, device=dev)
        u = torch.rand((T_PARITY, n_draws_per_step(params), n_envs),
                       generator=gen, device=dev)
        tag = f"7 {label} B={n_envs} T={T_PARITY}"
        k2 = [compare_policy(
            ops.fused_collect(sf, si, w, 0, params, T_PARITY, uniforms=u),
            fc.fused_collect_reference(sf, si, w, params, uniforms=u),
            f"{tag} collect, table", k2_actions)]
        k4 = [compare_policy(
            ops.fused_selfplay_rollout(sf, si, wa, wb, 0, params, T_PARITY,
                                       uniforms=u, return_actions=True),
            fa.fused_selfplay_rollout_reference(
                sf, si, wa, wb, params, uniforms=u, return_actions=True),
            f"{tag} selfplay, table", k4_actions)]
        if philox:
            k2.append(compare_policy(
                ops.fused_collect(sf, si, w, 5, params, T_PARITY),
                fc.fused_collect_reference(sf, si, w, params, T_PARITY, seed=5),
                f"{tag} collect, Philox", k2_actions))
            k4.append(compare_policy(
                ops.fused_selfplay_rollout(sf, si, wa, wb, 6, params, T_PARITY,
                                           return_actions=True),
                fa.fused_selfplay_rollout_reference(
                    sf, si, wa, wb, params, T_PARITY, seed=6,
                    return_actions=True),
                f"{tag} selfplay, Philox", k4_actions))
        if main:
            errs[main] = max(k2 if main == "fused_collect" else k4)

    # 8: teacher-forced collect at config 4: the kernel's own obs and
    # actions through the actor-critic module
    sf, si, model, gen = setup(p4, H4, B4, 5)
    w = fc.flatten_actor_critic(model)
    (_, _, obs, dirs, acts, logp, value, reward, done,
     _) = ops.fused_collect(sf, si, w, 77, p4, T_FORCED)
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

    # 9: Philox sampling statistics. Per group and choice, the kernel's
    # frequency against the mean softmax probability of its own obs.
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
    phase("9 stats", f"collect: {x.shape[0]} samples x {n_groups} groups, "
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
        rows = fa.split_state(sf, si, p6.n_bodies)
        view_probs = []
        for view, wts in ((0, wa), (1, wb)):
            logits6 = fa.mlp_logit_rows(fa.obs_matrix(*rows[:5], p6, view == 1), wts)
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
    phase("9 stats", f"selfplay: {n_calls} x {B4} envs x 2 views x {n_groups} "
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
    traj, (adv, ret) = box["traj"], box["gae"]
    check(tuple(traj.obs.shape) == (fc.feature_rows(p4), 2 * T4 * B4)
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
    m = evals[-1]
    check(abs(m["win_rate_a"] + m["win_rate_b"] + m["draw_rate"] - 1.0) < 1e-9
          and (m["goals"] >= 0).all() and math.isfinite(m["mean_team0_reward"]),
          f"10: evaluation metrics {m}")
    launches = {k: ops.LAUNCHES[k] for k in ("fused_collect", "fused_selfplay_rollout")}
    check(all(n > 0 for n in launches.values()),
          f"10: the main path skipped a kernel: {launches}")
    phase("10 main path", f"collect_rollout_fused + compute_gae, 3v3 B={B4} "
          f"T={T4} hidden {H4}: {ms4:.3f} ms/iteration, "
          f"{B4 * T4 / ms4 * 1e3:.6g} env-steps/s ({iters4} iterations)")
    phase("10 main path", f"evaluate_fused, 2v2 B={B6} T={T6} MLPs {H6}: "
          f"{ms6:.3f} ms/evaluation, {B6 * T6 / ms6 * 1e3:.6g} env-steps/s "
          f"({iters6} evaluations); last: goals {m['goals'].tolist()}, "
          f"win rates {m['win_rate_a']:.4f} / {m['win_rate_b']:.4f}")
    phase("10 main path", f"kernel launches in the main path: {launches}")

    # the kernels alone, then the plain versions at the same batch
    sf4, si4 = ops.pack_state(box["runner"].env_state, p4)
    w4 = fc.flatten_actor_critic(model)
    ms_k2 = time_cuda(lambda i: ops.fused_collect(sf4, si4, w4, 500 + i, p4, T4), 3)
    state6, _ = vector.reset_batch(gen, p6, B6, device=dev)
    sf6, si6 = ops.pack_state(state6, p6)
    ms_k4 = time_cuda(lambda i: ops.fused_selfplay_rollout(
        sf6, si6, wa6, wb6, 600 + i, p6, T6), 5)
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
    phase("10 kernels", f"fused_collect config 4 T={T4}: {ms_k2:.3f} ms "
          f"({ms_k2 / T4:.5f} ms/step); plain version {plain_k2:.1f} ms/step")
    phase("10 kernels", f"fused_selfplay_rollout config 6 T={T6}: {ms_k4:.3f} ms "
          f"({ms_k4 / T6:.5f} ms/step); plain version {plain_k4:.1f} ms/step")
    phase("10 plain", f"collect_rollout + compute_gae, config 4 T={t_plain}: "
          f"{ms_plain4:.1f} ms, {B4 * t_plain / ms_plain4 * 1e3:.6g} env-steps/s")
    phase("10 plain", f"evaluate, config 6 T={t_plain}: {ms_plain6:.1f} ms, "
          f"{B6 * t_plain / ms_plain6 * 1e3:.6g} env-steps/s")
    # bounds per step: state and weights read, state written once per
    # call; K2's obs, per-step rows and bootstrap values, K4's rewards
    # and goals written once. Operations: the env step, and the MLP of
    # both views (K2: one actor-critic; K4: each team's policy)
    ops_k2 = env_step_ops(p4) + 2 * mlp_ops(w4)
    bytes_k2 = (2 * nbytes(sf4, si4) + nbytes(*w4)
                + 4 * 2 * B4 * (fc.feature_rows(p4) * T4 + 6 * T4 + 1))
    bound_k2 = bound(bytes_k2 / T4, B4 * ops_k2)
    ops_k4 = env_step_ops(p6) + mlp_ops(wa6) + mlp_ops(wb6)
    bytes_k4 = (2 * nbytes(sf6, si6) + nbytes(*wa6, *wb6)
                + 4 * B6 * (T6 + 2))
    bound_k4 = bound(bytes_k4 / T6, B6 * ops_k4)
    phase("10 bound", f"fused_collect: {ops_k2} operations per env-step -> "
          f"{bound_k2[0]:.6g} ms/step ({bound_k2[1]}); fused_selfplay_rollout: "
          f"{ops_k4} -> {bound_k4[0]:.6g} ms/step ({bound_k4[1]})")
    return [
        {"name": "fused_collect", "route": "cuda", "source": POLICY_SOURCE,
         "replaces": REPLACES["fused_collect"],
         "launches": launches["fused_collect"],
         "max_abs_err": errs["fused_collect"], "ms": ms_k2 / T4,
         "plain_ms": plain_k2, "bound_ms": bound_k2[0],
         "bound_by": bound_k2[1], "library_ms": None,
         "unit": f"ms per step of the {B4}-env 3v3 batch, hidden {H4}"},
        {"name": "fused_selfplay_rollout", "route": "cuda",
         "source": POLICY_SOURCE, "replaces": REPLACES["fused_selfplay_rollout"],
         "launches": launches["fused_selfplay_rollout"],
         "max_abs_err": errs["fused_selfplay_rollout"], "ms": ms_k4 / T6,
         "plain_ms": plain_k4, "bound_ms": bound_k4[0],
         "bound_by": bound_k4[1], "library_ms": None,
         "unit": f"ms per step of the {B6}-env 2v2 batch, two MLPs {H6}"},
    ]


def compare_update(kernel_out, other_out, terms, label: str,
                   grad_rel: float, metric_rel: float) -> float:
    """Gradients and metric sums of fused_minibatch_grad against another
    computation of them: per leaf the max abs error and the rel-L2
    (within ``grad_rel``); each metric sum's error relative to the sum
    of |per-sample term| in ``terms`` (the plain version's, within
    ``metric_rel``: the surrogate's terms cancel in the sum). Returns the
    largest absolute gradient error."""
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
    m_err = {k: abs(km[k].item() - pm[k].item())
             / max(terms[k].abs().sum().item(), 1e-30) for k in km}
    phase("parity", f"{label}: per leaf max|err|/rel-L2 {' '.join(leaves)}; "
          f"metric sums err " + ", ".join(f"{k} {e:.3g}" for k, e in m_err.items()))
    check(worst_rel <= grad_rel and max(m_err.values()) <= metric_rel,
          f"{label}: disagrees (rel-L2 {worst_rel:.3g} > {grad_rel} or metrics "
          f"{max(m_err.values()):.3g} > {metric_rel})")
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

    fc = importlib.import_module("gym_futbol_tpu_torch.ops.fused_collect")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = ActorCritic(params.players_per_team, obs_size(params), hidden,
                        device=dev)
    cfg = ppo.PPOConfig(rollout_steps=n_steps, shuffle_block=block)
    runner = ppo.init_runner(gen, model, params, cfg, n_envs)
    runner, traj, last_v = ppo.collect_rollout_fused(runner, params, cfg)
    adv, ret = ppo.compute_gae(traj, last_v, cfg)
    ppo.update_epochs_fused(model, runner.optimizer, traj, adv, ret, gen, cfg)
    n_blocks = traj.obs.shape[1] // block
    dirs, acts, logp, value, adv, ret = (
        ppo._flatten_tm(x).reshape(n_blocks, block).contiguous()
        for x in (traj.dirs, traj.acts, traj.logp, traj.value, adv, ret))
    order = torch.randperm(n_blocks, generator=gen, device=dev)
    idx = order[:mb_blocks].to(torch.int32).contiguous()
    adv_mb = adv[idx]
    adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
    args = (fc.flatten_actor_critic(model), traj.obs.contiguous(), dirs, acts,
            logp, value, ret, adv_n, idx)
    kw = dict(n_torso=len(hidden), clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
              ent_coef=cfg.ent_coef, block=block)
    return model, cfg, args, kw


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

    # 11: kernel vs plain version on real minibatches, both modes
    cases = (
        (f"config 4 3v3 {H4} block {K3_BLOCK}", p4, H4, B4, T4, K3_BLOCK, mb4),
        ("custom (32, 16)", custom, (32, 16), B3, 8, K3_BLOCK, 16),
        ("2v2 (128, 128) block 128", p6, (128, 128), 1024, 16, 128, 64),
        ("5v5 (128, 128), G = 10", EnvParams(players_per_team=5), (128, 128),
         1024, 16, K3_BLOCK, 8),
    )
    for n, (label, params, hidden, n_envs, n_steps, block, mb_blocks) in enumerate(
            cases):
        model, cfg, args, kw = update_minibatch(
            dev, params, hidden, n_envs, n_steps, block, mb_blocks, 10 + n)
        routes = "/".join(fu.update_plan(
            args[1].shape[0], hidden, args[0][-4].shape[1], mb_blocks * block,
            mode)["route"] for mode in (bf16, f32))
        tag = (f"11 {label}, {mb_blocks} blocks ({mb_blocks * block} samples, "
               f"bf16/f32 on {routes})")
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
        if n == 0:
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
            k3_args, k3_kw = args, kw

    # 12: the main path: train_iteration at config 4 on both kernels
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = ActorCritic(p4.players_per_team, obs_size(p4), H4, device=dev)
    cfg = ppo.PPOConfig(rollout_steps=T4)
    runner = ppo.init_runner(gen, model, p4, cfg, B4)
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
    first = [p.detach().clone() for p in model.parameters()]
    runner, _ = step(runner, p4, cfg)                            # warm-up
    n_iters, per_iter = 3, cfg.epochs * cfg.minibatches
    check(ops.LAUNCHES["fused_minibatch_grad"] == per_iter,
          f"12: {ops.LAUNCHES['fused_minibatch_grad']} update launches in one "
          f"iteration, not {per_iter}")
    totals, history = [], []
    for i in range(n_iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        runner, metrics = step(runner, p4, cfg)
        end.record()
        totals.append((start, end))
        history.append(metrics)
        check(ops.LAUNCHES["fused_minibatch_grad"] == per_iter * (i + 2),
              "12: update launches per iteration")
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ("fused_collect", "fused_minibatch_grad")}
    check(launches["fused_collect"] == n_iters + 1,
          f"12: the main path's collect launches: {launches}")
    ms = sum(s.elapsed_time(e) for s, e in totals) / n_iters
    ms_collect = sum(s.elapsed_time(e) for s, e in spans["collect"][1:]) / n_iters
    ms_update = sum(s.elapsed_time(e) for s, e in spans["update"][1:]) / n_iters
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
    plan = fu.update_plan
    fu.update_plan = lambda f_dim, widths, g5, m, mode: plan(f_dim, widths, g5, m, f32)
    try:
        ms_chain_bf16 = time_cuda(k3(bf16), 3)
    finally:
        fu.update_plan = plan
    ms_bf16_again = time_cuda(k3(bf16), 10)
    plain_bf16 = time_cuda(lambda i: fu.fused_minibatch_grad_reference(
        *k3_args, **k3_kw, compute_dtype=bf16), 2)
    plain_f32 = time_cuda(lambda i: fu.fused_minibatch_grad_reference(
        *k3_args, **k3_kw, compute_dtype=f32), 2)
    # bound: the minibatch's obs columns, per-sample rows and idx read
    # once, weights read and gradients written once; the layer products'
    # multiply-adds on the tensor cores, the value head's in float32
    w, obs_fm = k3_args[0], k3_args[1]
    m, f = mb4 * K3_BLOCK, w[0].shape[0]
    dims = [f, *H4]
    g5 = w[-4].shape[1]
    layer_macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    head_macs = dims[-1] * g5
    # forward: layers + logits; backward: dh and dW of the logits head and
    # of every layer but the first, whose dW alone is needed
    bf16_macs = (layer_macs + head_macs) + 2 * head_macs + 2 * layer_macs - dims[0] * dims[1]
    f32_macs = 3 * dims[-1]                       # value head: v, dh, dW
    bytes_k3 = (obs_fm.shape[0] * m * 4 + 6 * m * 4 + mb4 * 4
                + 2 * nbytes(*w) + 16)
    bound_bf16 = bound(bytes_k3, 2 * f32_macs * m, 2 * bf16_macs * m)
    bound_f32 = bound(bytes_k3, 2 * (bf16_macs + f32_macs) * m)
    phase("13 kernels", f"fused_minibatch_grad, config 4 minibatch of {m} "
          f"samples: bfloat16 on the tensor cores {ms_bf16:.3f} ms (again after "
          f"the chain: {ms_bf16_again:.3f} ms; bound {bound_bf16[0]:.4g} ms, "
          f"{bound_bf16[1]}; {2 * bf16_macs * m / ms_bf16 / 1e9:.4g} TFLOP/s of "
          f"bf16 products), the CUDA-core chain in bfloat16 {ms_chain_bf16:.3f} "
          f"ms, float32 {ms_f32:.3f} ms (bound {bound_f32[0]:.4g} ms); plain "
          f"version bfloat16 {plain_bf16:.3f} ms, float32 {plain_f32:.3f} ms; "
          f"{(bf16_macs + f32_macs)} multiply-adds per sample")
    # yardstick, never called by the port: cuBLAS on the same eight bf16
    # layer products (forward: layer 1, layer 2, logits; backward: dh and
    # dW of the logits head and of layer 2, dW of layer 1)
    hb = [torch.randn(d, m, device=dev, dtype=bf16) for d in (obs_fm.shape[0], *H4)]
    dl = torch.randn(g5, m, device=dev, dtype=bf16)
    wb = [torch.randn(a, b, device=dev, dtype=bf16) for a, b in
          ((obs_fm.shape[0], H4[0]), (H4[0], H4[1]), (H4[1], g5))]

    def products(i):
        x, h1, h2 = hb
        (w1, w2, wl) = wb
        torch.matmul(w1.T, x)
        torch.matmul(w2.T, h1)
        torch.matmul(wl.T, h2)
        torch.matmul(wl, dl)
        torch.matmul(h2, dl.T)
        torch.matmul(h1, h2.T)
        torch.matmul(w2, h2)
        torch.matmul(x, h1.T)

    products(0)
    ms_cublas = time_cuda(products, 20)
    del hb, dl
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
                    f"samples (3v3, hidden {H4})"}


def recurrent_phases(dev, custom) -> dict:
    """Phases 14-16: fused_recurrent_collect against its plain version,
    the teacher-forced check and sampling statistics, the recurrent
    learners' main path (recurrent PPO and A2C, the CLI) and K5's times.
    Returns K5's entry of the kernels line."""
    import torch

    from gym_futbol_tpu_torch import EnvParams, a2c, obs_size, ops, vector
    from gym_futbol_tpu_torch import recurrent_ppo as rppo
    from gym_futbol_tpu_torch.models.policy import action_log_prob_and_entropy_packed
    from gym_futbol_tpu_torch.models.recurrent import RecurrentActorCritic
    from gym_futbol_tpu_torch.ops.fused_rollout import n_draws_per_step

    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_recurrent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p3, p2 = EnvParams(players_per_team=3), EnvParams(players_per_team=2)

    def setup(params, hidden, lstm, n_envs, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        state, _ = vector.reset_batch(gen, params, n_envs, device=dev)
        model = RecurrentActorCritic(params.players_per_team, obs_size(params),
                                     hidden, lstm, generator=gen, device=dev)
        carries = [torch.randn(2, lstm, n_envs, generator=gen, device=dev) * 0.5
                   for _ in range(2)]
        return (*ops.pack_state(state, params), model, carries, gen)

    # 14: kernel vs plain version from non-zero carries, same uniforms and
    # Philox; the plain version runs T=4 at the main shape
    k5_err = 0.0
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
                                          uniforms=u)
        errs = [compare_policy(got, fr.fused_recurrent_collect_reference(
            sf, si, w, cc, hh, params, uniforms=u), f"{tag}, table", (3, 4))]
        if philox:
            errs.append(compare_policy(
                ops.fused_recurrent_collect(sf, si, w, cc, hh, 5, params, n_steps),
                fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, params,
                                                     n_steps, seed=5),
                f"{tag}, Philox", (3, 4)))
        check(torch.equal(cc, c0) and torch.equal(hh, h0),
              f"{tag}: the input carries changed")
        if params.max_steps <= n_steps:
            check(bool(got[8].any()), f"{tag}: no episode ended in the window")
        if main:
            k5_err = max(errs)

    # 14: teacher-forced at the main shape (episodes ending in the window):
    # the module replayed over the kernel's own obs from its initial carry
    pf = p3.replace(max_steps=12)
    sf, si, model, (cc, hh), gen = setup(pf, HR, LSTM_R, BR, 8)
    w = fr.flatten_recurrent_actor_critic(model)
    (_, _, obs, dirs, acts, logp, value, _, done, _, cc2,
     hh2) = ops.fused_recurrent_collect(sf, si, w, cc, hh, 78, pf, TR)
    f = obs_size(pf)
    x = obs[:, :f].permute(2, 0, 3, 1).reshape(TR, 2 * BR, f)    # [T, 2B, F]

    def flat(a):                                        # [T, 2, B] -> [T, 2B]
        return a.reshape(TR, 2 * BR)

    carry0 = tuple(c.transpose(1, 2).reshape(2 * BR, LSTM_R) for c in (cc, hh))
    with torch.no_grad():
        (c_end, h_end), (logits, v) = model.unroll(carry0, x, flat(done).bool())
        lp, _ = action_log_prob_and_entropy_packed(logits, flat(dirs), flat(acts))
    errs = {"logp": (lp - flat(logp)).abs().max().item(),
            "value": (v - flat(value)).abs().max().item(),
            "carry": max((a - b.transpose(1, 2).reshape(2 * BR, LSTM_R)).abs().max()
                         .item() for a, b in ((c_end, cc2), (h_end, hh2)))}
    n_ends = int(done.sum()) // 2
    phase("14 forced", f"3v3 max_steps 12 B={BR} T={TR} H={LSTM_R}, Philox, module "
          f"replay (TF32 off): " + ", ".join(f"{k} err {e:.3g}" for k, e in errs.items())
          + f" (<= {K5_FORCED_ATOL}); {n_ends} episode ends")
    check(max(errs.values()) <= K5_FORCED_ATOL and n_ends > 0, "14: module replay")

    # 14: sampling statistics of the same collect against its own softmax
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
    phase("14 stats", f"recurrent collect: {probs.shape[0]} samples x {n_groups} "
          f"groups, max |freq - p| / SE {z:.3f} (<= 5)")
    check(z <= 5.0, "14: sampling statistics")

    # 15: the main path: recurrent PPO at the main shape on the kernel,
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
    check(sum(ops.LAUNCHES.values()) == ops.LAUNCHES["fused_recurrent_collect"],
          "15: another kernel ran in the recurrent path")
    phase("15 main path", f"train_iteration_recurrent_ppo (collect_recurrent_rollout_"
          f"fused, compute_gae, update_epochs_recurrent), 3v3 B={BR} T={TR} hidden "
          f"{HR} H={LSTM_R}, {cfg.epochs} x {cfg.minibatches} minibatches of "
          f"{2 * BR // cfg.minibatches} sequences: {ms:.3f} ms/iteration, "
          f"{BR * TR / ms * 1e3:.6g} env-steps/s ({n_iters} iterations after 1 "
          f"warm-up); collect {ms_collect:.3f} ms, update {ms_update:.3f} ms, "
          f"GAE and the rest {ms - ms_collect - ms_update:.3f} ms")
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
    launches = ops.LAUNCHES["fused_recurrent_collect"]
    check(launches == n_iters + 2, f"15: {launches} K5 launches in the main path")
    phase("15 main path", f"kernel launches in the main path: "
          f"{{'fused_recurrent_collect': {launches}}}")

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

    # 16: K5 alone at the main shape, the plain version, the bound
    sf, si = ops.pack_state(runner.env_state, p3)
    cc, hh = (c.transpose(1, 2).contiguous() for c in runner.carry)
    w = fr.flatten_recurrent_actor_critic(model)
    ms_k5 = time_cuda(lambda i: ops.fused_recurrent_collect(
        sf, si, w, cc, hh, 700 + i, p3, TR), 5)
    t_plain = 2
    fr.fused_recurrent_collect_reference(sf, si, w, cc, hh, p3, 1, seed=0)
    plain_k5 = time_cuda(lambda i: fr.fused_recurrent_collect_reference(
        sf, si, w, cc, hh, p3, t_plain, seed=1 + i), 1) / t_plain
    # bound per step: state, weights and input carries read, state and
    # output carries written once per call; obs, the six [T, 2, B] rows
    # and the bootstrap values written once. Operations: the env step and
    # both views' torso, cell ([t; h] x [n_t + H, 4H]) and heads
    n_torso = len(HR)
    wi, wh, bh, wl, bl, wv, bv = w[2 * n_torso:]
    layers = (*w[:2 * n_torso], torch.cat([wi, wh]), bh, wl, bl, wv, bv)
    ops_k5 = env_step_ops(p3) + 2 * mlp_ops(layers)
    f_pad = -(-obs_size(p3) // 8) * 8
    bytes_k5 = (2 * nbytes(sf, si) + nbytes(*w) + 4 * nbytes(cc)
                + 4 * 2 * BR * (f_pad * TR + 6 * TR + 1))
    bound_k5 = bound(bytes_k5 / TR, BR * ops_k5)
    phase("16 kernels", f"fused_recurrent_collect 3v3 B={BR} T={TR}: {ms_k5:.3f} ms "
          f"({ms_k5 / TR:.5f} ms/step); plain version {plain_k5:.1f} ms/step; "
          f"{ops_k5} operations per env-step -> bound {bound_k5[0]:.6g} ms/step "
          f"({bound_k5[1]})")
    for line in ptxas_summary(_build_log()):
        if line.startswith("recurrent_kernel"):
            phase("16 kernels", line)
    box = {"runner": runner}

    def iteration():
        box["runner"], _ = step(box["runner"], p3, cfg)

    busy, wall_ms, rows = device_profile(iteration)
    phase("16 profile", f"train_iteration_recurrent_ppo, one main-path iteration: "
          f"{wall_ms:.3f} ms wall, device busy share {busy:.4f}; device ms by "
          f"kernel: " + "; ".join(f"{name} {n}x {ms:.3f}" for name, n, ms in rows[:12]))
    return {"name": "fused_recurrent_collect", "route": "cuda",
            "source": RECURRENT_SOURCE,
            "replaces": REPLACES["fused_recurrent_collect"], "launches": launches,
            "max_abs_err": k5_err, "ms": ms_k5 / TR, "plain_ms": plain_k5,
            "bound_ms": bound_k5[0], "bound_by": bound_k5[1], "library_ms": None,
            "unit": f"ms per step of the {BR}-env 3v3 batch, hidden {HR}, "
                    f"H {LSTM_R}"}


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (the share of its wall
    time the device was busy, the wall ms, [(kernel, launches, device
    ms)] largest first). One stream, so the kernels do not overlap."""
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
        if e.device_type != DeviceType.CUDA:
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


def env_step_ops(params) -> int:
    """Floating-point operations of one env step, counted by hand from
    csrc/futbol_step.cuh: per solver iteration 40 per body pair (normal
    and friction impulses) and 11 per body and wall (4 walls); per
    substep 20 per pair (contact set-up) and 40 per body (wall set-up,
    integration). The rules, rewards and draws are left out, so the
    bound stays below the true one."""
    nb = 2 * params.players_per_team + 1
    pairs = nb * (nb - 1) // 2
    return params.substeps * (params.solver_iterations * (40 * pairs + 44 * nb)
                              + 20 * pairs + 40 * nb)


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
    from gym_futbol_tpu_torch import EnvParams, RewardConfig, ops, vector
    from gym_futbol_tpu_torch.ops import _build
    from gym_futbol_tpu_torch.ops.fused_rollout import (
        fused_rollout_reference,
        n_draws_per_step,
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

    # 3: replay parity, zero-noise params
    for label, params in (("P", p_test),
                          ("custom", custom.replace(kick_noise=0.0,
                                                    placement_noise=0.0))):
        sf, si, gen = start(params, B3, 1)
        acts = replay_actions(params, gen, T_PARITY, B3)
        got = ops.fused_rollout_replay(sf, si, acts, params)
        want = fused_rollout_reference(sf, si, params, actions=acts)
        errs["fused_rollout_replay"] = max(
            errs["fused_rollout_replay"],
            compare(got, want, f"3 replay {label} B={B3} T={T_PARITY}"))

    # 4: table-mode parity, same uniforms to both
    for label, params, n_envs, n_steps in (
            ("default 2v2", p3, B3, T_PARITY), ("custom", custom, B3, T_PARITY),
            ("default 5v5", p5, B5, 4)):
        sf, si, gen = start(params, n_envs, 2)
        u = torch.rand((n_steps, n_draws_per_step(params), n_envs),
                       generator=gen, device=dev)
        got = ops.fused_rollout(sf, si, 0, params, n_steps, uniforms=u)
        want = fused_rollout_reference(sf, si, params, uniforms=u)
        errs["fused_rollout"] = max(errs["fused_rollout"], compare(
            got, want, f"4 table {label} B={n_envs} T={n_steps}"))

    # 5: Philox mode at config 3
    sf0, si0, gen = start(p3, B3, 3)
    errs["fused_rollout"] = max(errs["fused_rollout"], compare(
        ops.fused_rollout(sf0, si0, 11, p3, T_PARITY),
        fused_rollout_reference(sf0, si0, p3, T_PARITY, seed=11),
        f"5 philox vs plain philox B={B3} T={T_PARITY}"))
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
    launches = {k: ops.LAUNCHES[k] for k in ("fused_rollout", "fused_rollout_replay")}
    check(all(n > 0 for n in launches.values()),
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
    # bounds per step: the state read and written once per call, rewards
    # (and the replayed actions) once; the env step's operations
    ops_k1 = env_step_ops(p3)
    bound_k1 = bound((2 * nbytes(sf, si)) / T3 + B3 * 4, B3 * ops_k1)
    bound_k1b = bound((2 * nbytes(sf, si) + nbytes(acts)) / T_PARITY + B3 * 4,
                      B3 * ops_k1)
    phase("6 bound", f"fused_rollout and replay: {ops_k1} operations per "
          f"env-step -> {bound_k1[0]:.6g} / {bound_k1b[0]:.6g} ms/step "
          f"({bound_k1[1]} / {bound_k1b[1]})")

    policy_record = policy_phases(dev, custom)
    update_record = update_phases(dev, custom)
    recurrent_record = recurrent_phases(dev, custom)

    per_step = f"ms per step of the {B3}-env 2v2 batch"
    record = {"kernels": [
        {"name": "fused_rollout", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_rollout"],
         "launches": launches["fused_rollout"],
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
         "unit": per_step},
        *policy_record,
        update_record,
        recurrent_record,
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
