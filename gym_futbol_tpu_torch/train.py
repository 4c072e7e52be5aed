"""Training CLI: self-play PPO and A2C on the batched env, feed-forward or
recurrent, in PyTorch.

Counterpart of :mod:`gym_futbol_tpu.train`. Each iteration collects
``--rollout-steps`` steps of ``--envs`` envs, computes GAE and updates:
PPO runs ``--epochs`` x ``--minibatches`` clipped-surrogate updates, A2C
one full-batch RMSProp step. One JSON record per logged iteration, then a
``done`` record::

    python -m gym_futbol_tpu_torch.train --ppt 3 --envs 16384 --iters 100 \\
        --fused-collect
    python -m gym_futbol_tpu_torch.train --recurrent --ppt 2 --envs 8192 \\
        --hidden 128 --lstm-size 128 --fused-collect

``--fused-collect`` collects with the ``fused_collect`` kernel (with
``--recurrent``: ``fused_recurrent_collect``) and, for feed-forward PPO
unless ``--no-fused-update``, updates with the ``fused_minibatch_grad``
kernels (bfloat16 operands), and for recurrent PPO runs the update's
LSTM recurrence in K6 (``ops.fused_bptt``); otherwise both run as plain
PyTorch.
``--recurrent`` trains the LSTM actor-critic: ``--algo ppo`` the
sequence-minibatched clipped surrogate (``recurrent_ppo``), ``--algo
a2c`` full-batch BPTT. ``--rollout-steps`` defaults to 16 with
``--recurrent``, else to the algorithm's own default (PPO 128, A2C 8).
Runs on the card unless ``--device cpu``. ``--eval-episodes N`` then
plays the final policy against uniform random play (the fused evaluator,
or ``evaluate_recurrent`` for the LSTM policy, N envs for one full
episode each) and prints its win, loss and draw rates.

``--normalize-obs`` / ``--normalize-reward`` train feed-forward PPO
through VecNormalize-style statistics (``wrappers``): with
``--fused-collect`` on both kernels (the statistics folded into the
first layer), else on the plain collect. ``--checkpoint-dir`` resumes
from the newest checkpoint there and saves every ``--checkpoint-every``
iterations and at the end; iterations are numbered on across a resume,
so ``--iters`` is the run's total. ``--log-dir`` appends every record to
``metrics.jsonl`` there (and TensorBoard when it imports).
``--debug-nans`` turns on autograd's anomaly detection and checks after
every iteration that the metrics, parameters and statistics are finite.

``--distributed`` shards the envs over the ranks of a torchrun launch
(one process per rank; :mod:`gym_futbol_tpu_torch.parallel`)::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m gym_futbol_tpu_torch.train --distributed --envs 16384 \
        --fused-collect

Every rank builds the whole runner from ``--seed`` and keeps its equal
share of the ``--envs`` envs (which must divide evenly over the ranks)
and a generator stream of its own; each minibatch's gradients and the
normalisers' moments are averaged over the ranks. Each rank runs on its
own device (``cuda:LOCAL_RANK`` modulo the cards; NCCL when every rank
has a card, gloo when ranks share one or with ``--device cpu``). Rank 0
alone prints the records, writes ``metrics.jsonl`` and runs
``--eval-episodes``; every rank saves and resumes its own checkpoint, and
a resume over another number of ranks is refused.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None), train, print the
    records; returns the final runner."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("ppo", "a2c"), default="ppo")
    ap.add_argument("--recurrent", action="store_true",
                    help="train the LSTM actor-critic: --algo a2c full-batch "
                         "BPTT A2C, --algo ppo sequence-minibatched recurrent "
                         "PPO")
    ap.add_argument("--lstm-size", type=int, default=128)
    ap.add_argument("--fused-collect", action="store_true",
                    help="collect with the fused_collect kernel "
                         "(fused_recurrent_collect with --recurrent); for "
                         "feed-forward PPO also update with the "
                         "fused_minibatch_grad kernels unless --no-fused-update")
    ap.add_argument("--no-fused-update", action="store_true",
                    help="with --fused-collect, keep the autograd update")
    ap.add_argument("--ppt", type=int, default=2, help="players per team")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout-steps", type=int, default=None,
                    help="default: 16 with --recurrent, else the algorithm's "
                         "(PPO 128, A2C 8)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-anneal", action="store_true",
                    help="anneal the learning rate linearly from --lr to "
                         "--lr-final over the run's --iters (PPO only)")
    ap.add_argument("--lr-final", type=float, default=None,
                    help="anneal target; unset means a floor of 0.1 * lr")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--hidden", type=int, nargs="+", default=[256, 256])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--eval-episodes", type=int, default=0,
                    help="after training, play this many full episodes of the "
                         "final policy against uniform random play and print "
                         "an eval_vs_random record (with --iters 0: the "
                         "untrained policy; with --normalize-obs the final "
                         "statistics are folded into the evaluated weights)")
    ap.add_argument("--normalize-obs", action="store_true",
                    help="z-score the observations by running statistics the "
                         "policy trains through (feed-forward PPO; with "
                         "--fused-collect folded into the first layer of both "
                         "kernels, else in the plain collect)")
    ap.add_argument("--normalize-reward", action="store_true",
                    help="divide rewards by the running standard deviation "
                         "of the discounted return (feed-forward PPO, either "
                         "collect)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="resume from the newest checkpoint in this directory, "
                         "if any, and save the runner there")
    ap.add_argument("--checkpoint-every", type=int, default=25,
                    help="save every this many iterations (and at the end)")
    ap.add_argument("--log-dir", default=None,
                    help="append each record to metrics.jsonl in this "
                         "directory (and TensorBoard scalars when it imports)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection, and a check after every "
                         "iteration that the metrics, parameters and "
                         "normaliser statistics are finite (debugging only)")
    ap.add_argument("--distributed", action="store_true",
                    help="shard the envs over the ranks of a torchrun launch "
                         "(one process per rank, gradients averaged over "
                         "them); rank 0 prints and logs")
    args = ap.parse_args(argv)
    if args.algo == "a2c" and args.lr_anneal:
        raise SystemExit("--lr-anneal is wired into the PPO optimiser only "
                         "(A2C uses constant-rate RMSProp)")
    normalizing = args.normalize_obs or args.normalize_reward
    if normalizing and (args.algo != "ppo" or args.recurrent):
        raise SystemExit("--normalize-obs/--normalize-reward are wired into "
                         "feed-forward PPO only")
    if normalizing and args.fused_collect and args.no_fused_update:
        raise SystemExit("normalised fused training folds the statistics into "
                         "the fused update; drop --no-fused-update")
    if args.checkpoint_every < 1:
        raise SystemExit("--checkpoint-every must be >= 1")

    import torch

    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return _run(args)


def _run(args):
    import functools

    import torch

    from . import a2c, ppo
    from . import recurrent_ppo as rppo
    from .env import obs_size
    from .models.policy import ActorCritic
    from .models.recurrent import RecurrentActorCritic
    from .types import EnvParams
    from .utils.metrics import MetricsLogger, to_python

    device = torch.device(args.device)
    group, rank = None, 0
    if args.distributed:
        import torch.distributed as dist

        from .parallel import (
            env_group,
            init_distributed,
            rank_device,
            shard_runner,
            shard_train_iteration,
        )

        started = init_distributed(force=True, device=device)
        rank, world, group = env_group()
        device = rank_device(device)
        if args.envs % world:
            raise SystemExit(f"--envs {args.envs} must divide evenly over "
                             f"{world} ranks")
    lead = rank == 0
    env_params = EnvParams(players_per_team=args.ppt, max_steps=args.max_steps)
    rollout_steps = args.rollout_steps
    if rollout_steps is None and args.recurrent:
        rollout_steps = rppo.RecurrentPPOConfig.rollout_steps     # 16
    steps = {} if rollout_steps is None else {"rollout_steps": rollout_steps}
    total_iters = args.iters if args.lr_anneal else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    f = obs_size(env_params)
    if args.recurrent:
        model = RecurrentActorCritic(args.ppt, f, tuple(args.hidden),
                                     args.lstm_size, device=device)
        collect_fn = (functools.partial(
            a2c.collect_recurrent_rollout_fused, compute_dtype=getattr(
                torch, a2c.FUSED_COLLECT_DTYPE[args.algo]))
            if args.fused_collect else a2c.collect_recurrent_rollout)
    else:
        model = ActorCritic(args.ppt, f, tuple(args.hidden), device=device)
        collect_fn = (ppo.collect_rollout_fused if args.fused_collect
                      else ppo.collect_rollout)
    if args.algo == "a2c":
        cfg = a2c.A2CConfig(lr=args.lr, **steps)
        if args.recurrent:
            runner = a2c.init_recurrent_runner(gen, model, env_params, cfg,
                                               args.envs)
            iteration_fn = a2c.train_iteration_recurrent
        else:
            runner = a2c.init_runner(gen, model, env_params, cfg, args.envs)
            iteration_fn = a2c.train_iteration
        iteration_fn = functools.partial(iteration_fn, collect_fn=collect_fn)
    else:
        kw = dict(lr=args.lr, epochs=args.epochs, minibatches=args.minibatches,
                  lr_final=args.lr_final, **steps)
        if args.recurrent:
            cfg = rppo.RecurrentPPOConfig(**kw)
            runner = rppo.init_recurrent_ppo_runner(
                gen, model, env_params, cfg, args.envs, total_iters)
            # the update runs at the collect's precision: K6 behind the
            # fused collect, float32 autograd behind the plain one
            update_fn = functools.partial(
                rppo.update_epochs_recurrent, compute_dtype=getattr(
                    torch, a2c.FUSED_COLLECT_DTYPE["ppo"])
                if args.fused_collect else torch.float32)
            iteration_fn = functools.partial(rppo.train_iteration_recurrent_ppo,
                                             collect_fn=collect_fn,
                                             update_fn=update_fn)
        else:
            cfg = ppo.PPOConfig(**kw)
            runner = ppo.init_runner(
                gen, model, env_params, cfg, args.envs, total_iters,
                normalize_obs=args.normalize_obs,
                normalize_reward=args.normalize_reward)
            if args.normalize_obs or args.normalize_reward:
                collect_fn = (ppo.make_fused_normalized_collect
                              if args.fused_collect else
                              ppo.make_normalized_collect)(
                    args.normalize_obs, args.normalize_reward, group)
            update_fn = (ppo.update_epochs_fused
                         if args.fused_collect and not args.no_fused_update
                         else None)
            iteration_fn = functools.partial(
                ppo.train_iteration, collect_fn=collect_fn, update_fn=update_fn)
    if args.distributed:
        runner = shard_runner(runner, group)
        iteration_fn = shard_train_iteration(iteration_fn, group)

    ckpt, start = None, 0
    if args.checkpoint_dir:
        from .utils.checkpoint import Checkpointer

        ckpt = Checkpointer(args.checkpoint_dir, group=group)
        restored, start = ckpt.restore_latest(runner)
        if restored is not None:
            runner = restored
            if lead:
                print(f"# resumed from iteration {start}", flush=True)
    mlog = MetricsLogger(args.log_dir if lead else None)
    steps_per_iter = args.envs * cfg.rollout_steps
    saved = start
    t_start = time.perf_counter()
    for it in range(start, args.iters):
        t0 = time.perf_counter()
        runner, metrics = iteration_fn(runner, env_params, cfg)
        metrics = to_python(metrics)                         # synchronises
        dt = time.perf_counter() - t0
        if args.debug_nans:
            _check_finite(it, metrics, runner)
        if it % args.log_every == 0 and lead:
            print(json.dumps(mlog.write(it, {
                "env_steps_per_sec": round(steps_per_iter / dt),
                **{k: round(v, 5) for k, v in metrics.items()},
            })), flush=True)
        if ckpt and (it + 1) % args.checkpoint_every == 0:
            ckpt.save(runner, it + 1)
            saved = it + 1
    total = time.perf_counter() - t_start
    n_iters = max(args.iters - start, 0)
    if ckpt and saved < args.iters:
        ckpt.save(runner, args.iters)
    mlog.close()
    if args.eval_episodes and lead:
        from .evaluate import (
            evaluate_fused,
            evaluate_recurrent,
            uniform_random_weights_like,
        )
        from .ops.fused_collect import actor_critic_policy_weights

        if args.recurrent:
            res = evaluate_recurrent(env_params, runner.model,
                                     n_envs=args.eval_episodes,
                                     n_steps=env_params.max_steps, seed=args.seed)
        else:
            w = actor_critic_policy_weights(runner.model)
            if runner.obs_norm is not None:
                # the policy acted through the statistics: fold them in,
                # as the fused collect did
                w = ppo.fold_obs_norm(w, *ppo._obs_norm_scales(runner.obs_norm))
            res = evaluate_fused(env_params, w, uniform_random_weights_like(w),
                                 n_envs=args.eval_episodes,
                                 n_steps=env_params.max_steps, seed=args.seed)
        print(json.dumps({"eval_vs_random": {
            "episodes": args.eval_episodes, "win": res["win_rate_a"],
            "loss": res["win_rate_b"], "draw": res["draw_rate"],
            "goals_per_episode": [round(float(g), 4)
                                  for g in res["goals_per_episode"]],
        }}), flush=True)
    if lead:
        print(json.dumps({
            "done": True,
            "total_env_steps": steps_per_iter * n_iters,
            "wall_s": round(total, 2),
            "env_steps_per_sec": round(steps_per_iter * n_iters / total),
        }), flush=True)
    if args.distributed and started:
        dist.barrier()
        dist.destroy_process_group()
    return runner


def _check_finite(it: int, metrics: dict, runner) -> None:
    """Raise FloatingPointError naming iteration ``it`` and the first
    non-finite leaf of the metrics, the model's parameters or the
    normalisers' statistics."""
    import math

    import torch

    leaves = [(f"metrics.{k}", v) for k, v in metrics.items()]
    leaves += [(f"model.{k}", p) for k, p in runner.model.named_parameters()]
    for name in ("obs_norm", "rew_norm"):
        norm = getattr(runner, name, None)
        if norm is not None:
            leaves += [(f"{name}.{k}", v) for k, v in vars(norm).items()]
    for name, v in leaves:
        ok = (bool(torch.isfinite(v).all()) if isinstance(v, torch.Tensor)
              else math.isfinite(v))
        if not ok:
            raise FloatingPointError(f"iteration {it}: non-finite {name}")


if __name__ == "__main__":
    main()
