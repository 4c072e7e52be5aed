#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernel from gym_futbol_tpu_torch/csrc with nvcc,
holds it against its plain PyTorch version on the card, and drives the
port's main path: a random-policy auto-reset rollout of 4096 2v2 envs
for 512 steps (bench config 3), a replay of given actions, and one
5v5 rollout of 65536 envs for 64 steps. One line per phase; any failed
phase exits nonzero with no result line. The last two lines are the
kernels' record and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
It needs a CUDA device and nvcc, and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

B3, T3 = 4096, 512          # bench config 3: 2v2
B5, T5 = 65536, 64          # bench config 5 scale: 5v5
T_PARITY = 16
T_STATS = 64
SOURCE = "gym_futbol_tpu_torch/csrc/fused_rollout.cu"
REPLACES = {
    "fused_rollout": "gym_futbol_tpu/ops/fused_rollout.py:342",
    "fused_rollout_replay": "gym_futbol_tpu/ops/fused_rollout.py:487",
}
# Kernel against plain version on the same inputs: pos/vel rtol 1e-4 /
# atol 1e-3, rewards 1e-4 absolute, integer state exact.
RTOL, ATOL, REW_ATOL = 1e-4, 1e-3, 1e-4


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
    """One line per kernel from nvcc's -Xptxas -v report."""
    out, name = [], None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                kind = "random" if "random" in mangled else "replay"
                nb = mangled.split("ILi")[1].split("E")[0]
                name = f"{kind} n_bodies={nb}"
            elif name and "spill stores" in line:
                spill = line.strip()
            elif name and "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                out.append(f"{name}: {regs} registers, {spill}")
                name = None
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
    launches = dict(ops.LAUNCHES)
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
