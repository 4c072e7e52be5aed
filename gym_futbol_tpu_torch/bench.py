"""Throughput benchmark: the root ``bench.py``'s presets on the port.

Counterpart of the JAX package's ``bench.py``, with its presets, flags
and last line. Default run is config 3: 2v2, 4096 envs with auto-reset,
random policy, the whole 512-step rollout in one launch of the
``fused_rollout`` kernel. Prints exactly ONE JSON line, the last line
of its output::

    {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
     "vs_baseline": R}

``vs_baseline`` is ``value / 1e6``, rounded to 3 places, as in the JAX
bench (``bench.py:390-395``), so that the two benches' lines compare key
for key. With ``--assert-floor F`` the line adds ``floor`` and ``ok``,
and the exit code is 1 when the rate is below ``F``.

Presets (``--config``; ``--envs``, ``--steps`` and ``--ppt`` override):
  2: 2v2, 256 envs, T=512, random-policy rollout
  3: 2v2, 4096 envs, T=512, random-policy rollout (the default)
  4: 3v3, 16384 envs, T=128, PPO collection + GAE (hidden (256, 256))
  5: 5v5, 65536 envs, T=64, one whole PPO iteration (collect, GAE,
     4 epochs x 4 minibatches)
  6: 2v2, 4096 envs, T=512, two (128, 128) MLP policies playing

``--impl fused`` (and ``auto``, the default) runs configs 2-5 on the
kernels: ``fused_rollout``; ``fused_collect``, and at config 5
``fused_minibatch_grad``; ``--impl jnp`` (the JAX bench's name) the
plain PyTorch versions: ``parallel.shard_rollout`` over the plain step,
``ppo.collect_rollout`` and ``ppo.update_epochs``. Config 6 always runs
``fused_selfplay_rollout``. Unlike the JAX bench, ``auto`` never falls
back: a kernel that fails to build or launch ends the run with a
nonzero exit and no JSON line, and ``--device cuda`` (the default)
without a card is an error. ``--device cpu`` runs the plain versions
wherever the kernels would run (every wrapper does on CPU tensors).

Each run times ``--iters`` calls (default 10; 40 for config 2) after two
warm-ups: the first builds the kernels (once per source hash, into
``build/torch_kernels/``), the second runs on the state the first left.
The calls chain through the state, and the clock stops after
``torch.cuda.synchronize()``. ``--verbose`` adds ``#`` lines: the card's
name and power limit, the first run's seconds, and every kernel's
launches over the warm-ups and the timed calls (``ops.LAUNCHES``).

``--scaling`` is the weak-scaling sweep: the whole PPO iteration
(``parallel.shard_train_iteration``; on the kernels as config 5 runs it,
the plain versions with ``--impl jnp``) with ``--envs`` envs per rank
(default 512), T ``--steps`` (32), ``--ppt`` (2), on process groups of
the first 1, 2, 4, ... ranks of a torchrun launch (one rank per card
over NCCL, or ranks over gloo with ``--device cpu``; the ranks outside a
group wait). It reports the efficiency at the largest group against
linear, ``vs_baseline`` the efficiency over 0.9, and each group's
env-steps/s. Without torchrun there is one rank and the efficiency is 1.

Usage::

    python -m gym_futbol_tpu_torch.bench [--config 3] [--envs N] [--steps T]
        [--ppt P] [--iters K] [--impl auto|fused|jnp] [--assert-floor F]
        [--verbose] [--device cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m gym_futbol_tpu_torch.bench --scaling
"""

from __future__ import annotations

import argparse
import json
import time

CONFIGS = {
    2: dict(ppt=2, envs=256, steps=512),
    3: dict(ppt=2, envs=4096, steps=512),
    4: dict(ppt=3, envs=16384, steps=128),
    5: dict(ppt=5, envs=65536, steps=64),
    6: dict(ppt=2, envs=4096, steps=512),
}


def _say(args, msg: str) -> None:
    """Print one ``#`` line from the leading rank."""
    if args.lead:
        print(f"# {msg}", flush=True)


def _wait(out) -> None:
    """Wait for the device work behind ``out`` (a tensor)."""
    import torch

    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def _device_line(device) -> str:
    """The device, and for a card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    import subprocess

    import torch

    if device.type != "cuda":
        return f"device {device}"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = (f"{torch.cuda.get_device_name(index)}, power limit not read "
               f"({type(e).__name__})")
    return f"device {device}: {smi}"


def _timed(args, once, state) -> float:
    """The JAX bench's loop: ``once(state, seed) -> (state, out)`` called
    twice as warm-ups with seed 1 (the first builds the kernels), then
    ``args.iters`` times with seeds 2, 3, ..., each call on the state the
    one before returned. The clock stops once ``out`` of the last call is
    on the host's side of a synchronise. Returns seconds per timed call."""
    from . import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, out = once(state, 1)
    _wait(out)
    if args.verbose:
        _say(args, f"first run (the kernels' build, if any, included): "
                   f"{time.perf_counter() - t0:.1f} s on {out.device}")
    state, out = once(state, 1)
    _wait(out)
    t0 = time.perf_counter()
    for i in range(args.iters):
        state, out = once(state, 2 + i)
    _wait(out)
    dt = (time.perf_counter() - t0) / args.iters
    if args.verbose:
        # counted from the first warm-up: iters + 2 calls
        _say(args, f"kernel launches over 2 warm-ups and {args.iters} timed "
                   f"calls: {json.dumps(dict(ops.LAUNCHES))}")
    return dt


def _group(args):
    """The process group of a torchrun launch, or None."""
    return args.env_group.group if args.env_group else None


def bench_rollout_fused(args) -> float:
    """Configs 2-3 on the ``fused_rollout`` kernel: the whole T-step
    rollout, action draws and auto-reset included, in one launch."""
    import torch

    from . import ops
    from .types import EnvParams
    from .vector import reset_batch

    params = EnvParams(players_per_team=args.ppt)
    gen = torch.Generator(device=args.device).manual_seed(0)
    state, _ = reset_batch(gen, params, args.envs, device=args.device)

    def once(s, seed):
        sf, si, rew = ops.fused_rollout(*s, seed, params, args.steps)
        return (sf, si), rew

    dt = _timed(args, once, ops.pack_state(state, params))
    return args.envs * args.steps / dt


def bench_rollout(args) -> float:
    """Configs 2-3 with ``--impl jnp``: the plain rollout of the rank's
    envs (``parallel.shard_rollout``), one batched step at a time."""
    import torch

    from .parallel import shard_env_state, shard_rollout
    from .types import EnvParams
    from .vector import reset_batch

    params = EnvParams(players_per_team=args.ppt)
    run = shard_rollout(_group(args), params, args.steps)
    gen = torch.Generator(device=args.device).manual_seed(0)
    state, _ = reset_batch(gen, params, args.envs, device=args.device)

    def once(s, seed):
        s, outs = run(s, seed)
        return s, outs.reward

    dt = _timed(args, once, shard_env_state(state, _group(args)))
    return args.envs * args.steps / dt


def bench_selfplay_fused(args) -> float:
    """Config 6: two MLP policies (``ops.init_mlp``, hidden (128, 128))
    playing each other, all T steps in one launch of the
    ``fused_selfplay_rollout`` kernel (bfloat16 layer products)."""
    import torch

    from . import ops
    from .types import EnvParams
    from .vector import reset_batch

    params = EnvParams(players_per_team=args.ppt)
    dev = args.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = reset_batch(gen, params, args.envs, device=dev)
    wa = ops.init_mlp(torch.Generator(device=dev).manual_seed(1), params,
                      device=dev)
    wb = ops.init_mlp(torch.Generator(device=dev).manual_seed(2), params,
                      device=dev)

    def once(s, seed):
        sf, si, rew, _ = ops.fused_selfplay_rollout(*s, wa, wb, seed, params,
                                                    args.steps)
        return (sf, si), rew

    dt = _timed(args, once, ops.pack_state(state, params))
    return args.envs * args.steps / dt


def _ppo_runner(args, env_params, cfg, n_envs: int, group):
    """A PPO runner of ``n_envs`` envs (the global count) with a (256, 256)
    actor-critic, initialised from generator 0 on the device; under a
    process group, this rank's share of it."""
    import torch

    from . import ppo
    from .env import obs_size
    from .models.policy import ActorCritic
    from .parallel import shard_runner

    model = ActorCritic(env_params.players_per_team, obs_size(env_params),
                        device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    runner = ppo.init_runner(gen, model, env_params, cfg, n_envs)
    return runner if group is None else shard_runner(runner, group)


def _iteration(args, env_params, cfg, group):
    """The whole PPO iteration on the rank's envs, as the timed loop's
    ``once(runner, seed) -> (runner, loss)``: on the kernels
    (``fused_collect``, ``fused_minibatch_grad``) or, with ``--impl
    jnp``, the plain collect and the autograd update."""
    import functools

    from . import ppo
    from .parallel import shard_train_iteration

    if args.impl == "jnp":
        fns = dict(collect_fn=ppo.collect_rollout, update_fn=ppo.update_epochs)
    else:
        fns = dict(collect_fn=ppo.collect_rollout_fused,
                   update_fn=ppo.update_epochs_fused)
    fn = shard_train_iteration(functools.partial(ppo.train_iteration, **fns),
                               group=group)

    def once(runner, seed):
        runner, metrics = fn(runner, env_params, cfg)
        return runner, metrics["loss"]

    return once


def bench_ppo(args, with_update: bool) -> float:
    """Config 4 (collection into the PPO buffer + GAE) and config 5 (the
    whole PPO iteration). ``--envs`` is the global env count: under
    torchrun each rank runs its share."""
    from . import ppo
    from .types import EnvParams

    env_params = EnvParams(players_per_team=args.ppt)
    cfg = ppo.PPOConfig(rollout_steps=args.steps)
    group = _group(args)
    runner = _ppo_runner(args, env_params, cfg, args.envs, group)

    if with_update:
        once = _iteration(args, env_params, cfg, group)
    else:
        collect_fn = (ppo.collect_rollout if args.impl == "jnp"
                      else ppo.collect_rollout_fused)

        def once(r, seed):
            # the clock stops on the advantages' mean (bench.py:216-220)
            r, traj, last_v = collect_fn(r, env_params, cfg)
            adv, _ = ppo.compute_gae(traj, last_v, cfg)
            return r, adv.mean()

    dt = _timed(args, once, runner)
    return args.envs * args.steps / dt


def bench_scaling(args) -> dict:
    """--scaling: weak scaling of the whole PPO iteration over process
    groups of the first 1, 2, 4, ... ranks, ``per_dev`` envs a rank.
    Every rank takes part in making each group; the ranks outside it wait
    at a barrier. Returns the JAX bench's record (on the leading rank)."""
    import torch.distributed as dist

    from .ppo import PPOConfig
    from .types import EnvParams

    eg = args.env_group
    world, rank = (eg.world_size, eg.rank) if eg else (1, 0)
    counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= world]
    per_dev = args.envs or 512
    steps = args.steps or 32
    env_params = EnvParams(players_per_team=args.ppt or 2)
    cfg = PPOConfig(rollout_steps=steps)

    rates = {}
    for d in counts:
        group = dist.new_group(list(range(d))) if eg else None
        if rank < d:
            n_envs = per_dev * d
            runner = _ppo_runner(args, env_params, cfg, n_envs, group)
            once = _iteration(args, env_params, cfg, group)
            rates[d] = n_envs * steps / _timed(args, once, runner)
            if args.lead:
                _say(args, f"scaling {d:3d} dev x {per_dev} envs: "
                           f"{rates[d]:12.0f} steps/s  efficiency "
                           f"{rates[d] / (d * rates[1]):6.3f}")
        if eg:
            dist.barrier()

    if not args.lead:
        return {}
    d_max = counts[-1]
    return {
        "metric": "weak_scaling_efficiency",
        "value": round(rates[d_max] / (d_max * rates[1]), 4),
        "unit": f"fraction of linear at {d_max} devices "
                f"({per_dev} envs/device)",
        "vs_baseline": round(rates[d_max] / (d_max * rates[1]) / 0.9, 3),
        "steps_per_sec": {str(d): round(r) for d, r in rates.items()},
    }


def build_parser() -> argparse.ArgumentParser:
    """The JAX bench's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(
        prog="python -m gym_futbol_tpu_torch.bench",
        description="Env-steps/s of the port at bench.py's presets; the "
                    "last line is one JSON record.")
    ap.add_argument("--config", type=int, default=3, choices=sorted(CONFIGS))
    ap.add_argument("--scaling", action="store_true",
                    help="weak-scaling efficiency over process groups of "
                         "1, 2, 4, ... ranks of a torchrun launch; --envs "
                         "becomes envs per rank (default 512)")
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ppt", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None,
                    help="timed iterations (default 10; 40 for config 2, "
                         "whose iterations are short)")
    ap.add_argument(
        "--impl", choices=("auto", "fused", "jnp"), default="auto",
        help="configs 2-5: the CUDA kernels ('fused'; 'auto' is the same, "
             "with no fallback) or the plain PyTorch versions ('jnp', the "
             "JAX bench's name)")
    ap.add_argument("--assert-floor", type=float, default=None,
                    help="fail (exit 1, ok:false in the JSON) if the "
                         "measured steps/s is below this floor")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                         "plain versions)")
    return ap


def _run(args) -> dict:
    if args.scaling:
        if args.iters is None:
            args.iters = 10
        return bench_scaling(args)

    preset = CONFIGS[args.config]
    args.envs = args.envs or preset["envs"]
    args.steps = args.steps or preset["steps"]
    args.ppt = args.ppt or preset["ppt"]
    if args.iters is None:
        args.iters = 40 if args.config == 2 else 10

    if args.config in (2, 3):
        fn = bench_rollout if args.impl == "jnp" else bench_rollout_fused
        steps_per_sec = fn(args)
    elif args.config == 6:
        steps_per_sec = bench_selfplay_fused(args)
    else:
        steps_per_sec = bench_ppo(args, with_update=args.config == 5)

    record = {
        "metric": "env_steps_per_sec",
        "value": round(steps_per_sec),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / 1_000_000, 3),
    }
    if args.assert_floor is not None:
        record["floor"] = args.assert_floor
        record["ok"] = steps_per_sec >= args.assert_floor
    return record


def main(argv: list[str] | None = None) -> None:
    """Parse ``argv`` (the command line when None), run, print the
    record as the last line; exit 1 below ``--assert-floor``."""
    args = build_parser().parse_args(argv)

    import torch

    from .parallel import env_group, init_distributed, rank_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: --device cuda, but torch sees no CUDA device "
                         "(--device cpu runs the plain versions)")
    started = init_distributed(device=device)
    args.env_group = env_group()
    args.lead = args.env_group is None or args.env_group.rank == 0
    args.device = rank_device(device) if args.env_group else device
    if args.verbose:
        _say(args, _device_line(args.device))

    record = _run(args)
    if started:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    if not args.lead:
        return
    print(json.dumps(record), flush=True)
    if not record.get("ok", True):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
