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
  (2v2, 4096 envs, T=512, two (128, 128) MLPs).
One line per phase; any failed phase exits nonzero with no result line.
The last two lines are the kernels' record and ``{"ok": true, "device":
{...}}``.

Run from the repository root:  python3 chip_smoke.py
It needs a CUDA device and nvcc, and imports nothing of JAX.
"""

from __future__ import annotations

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
REPLACES = {
    "fused_rollout": "gym_futbol_tpu/ops/fused_rollout.py:342",
    "fused_rollout_replay": "gym_futbol_tpu/ops/fused_rollout.py:487",
    "fused_collect": "gym_futbol_tpu/ops/fused_collect.py:304",
    "fused_selfplay_rollout": "gym_futbol_tpu/ops/fused_actor.py:237",
}
# Kernel against plain version on the same inputs: pos/vel rtol 1e-4 /
# atol 1e-3, rewards 1e-4 absolute, integer state exact.
RTOL, ATOL, REW_ATOL = 1e-4, 1e-3, 1e-4
# Policy kernels against plain versions: every float output within 1e-4
# (the same operations in the same order: bitwise in practice), integers
# and sampled actions exact. Teacher-forced logp and value against the
# actor-critic module (cuBLAS f32 with TF32 off, another summation
# order): 1e-4; the kernel's mirrored view against mirror_obs: 1e-6.
POLICY_ATOL, FORCED_ATOL, MIRROR_ATOL = 1e-4, 1e-4, 1e-6


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
    import importlib

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
    return [
        {"name": "fused_collect", "route": "cuda", "source": POLICY_SOURCE,
         "replaces": REPLACES["fused_collect"],
         "launches": launches["fused_collect"],
         "max_abs_err": errs["fused_collect"], "ms": ms_k2 / T4,
         "plain_ms": plain_k2,
         "unit": f"ms per step of the {B4}-env 3v3 batch, hidden {H4}"},
        {"name": "fused_selfplay_rollout", "route": "cuda",
         "source": POLICY_SOURCE, "replaces": REPLACES["fused_selfplay_rollout"],
         "launches": launches["fused_selfplay_rollout"],
         "max_abs_err": errs["fused_selfplay_rollout"], "ms": ms_k4 / T6,
         "plain_ms": plain_k4,
         "unit": f"ms per step of the {B6}-env 2v2 batch, two MLPs {H6}"},
    ]


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
                m = re.search(r"([a-z_]+_kernel)ILi(\d+)E", mangled)
                name = f"{m[1]}<{m[2]}>" if m else mangled
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

    policy_record = policy_phases(dev, custom)

    per_step = f"ms per step of the {B3}-env 2v2 batch"
    record = {"kernels": [
        {"name": "fused_rollout", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_rollout"],
         "launches": launches["fused_rollout"],
         "max_abs_err": errs["fused_rollout"],
         "ms": ms3 / T3, "plain_ms": plain_ms / t_plain, "unit": per_step},
        {"name": "fused_rollout_replay", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["fused_rollout_replay"],
         "launches": launches["fused_rollout_replay"],
         "max_abs_err": errs["fused_rollout_replay"],
         "ms": ms_replay / T_PARITY, "plain_ms": plain_replay_ms / t_plain,
         "unit": per_step},
        *policy_record,
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
