"""Training CLI: self-play PPO on the batched env, in PyTorch.

Counterpart of the PPO path of :mod:`gym_futbol_tpu.train`. Each
iteration collects ``--rollout-steps`` steps of ``--envs`` envs, computes
GAE and runs ``--epochs`` x ``--minibatches`` clipped-surrogate updates;
one JSON record per logged iteration, then a ``done`` record::

    python -m gym_futbol_tpu_torch.train --ppt 3 --envs 16384 --iters 100 \\
        --fused-collect

``--fused-collect`` collects with the ``fused_collect`` kernel and, unless
``--no-fused-update``, updates with the ``fused_minibatch_grad`` kernels
(bfloat16 operands); without it both run as plain PyTorch. Runs on the
card unless ``--device cpu``. ``--eval-episodes N`` then plays the final
policy against uniform random play (the fused evaluator, N envs for one
full episode each) and prints its win, loss and draw rates.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None), train, print the
    records; returns the final :class:`ppo.RunnerState`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused-collect", action="store_true",
                    help="collect with the fused_collect kernel; also update "
                         "with the fused_minibatch_grad kernels unless "
                         "--no-fused-update")
    ap.add_argument("--no-fused-update", action="store_true",
                    help="with --fused-collect, keep the autograd update")
    ap.add_argument("--ppt", type=int, default=2, help="players per team")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout-steps", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-anneal", action="store_true",
                    help="anneal the learning rate linearly from --lr to "
                         "--lr-final over the run's --iters")
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
                         "untrained policy)")
    args = ap.parse_args(argv)

    import functools

    import torch

    from . import ppo
    from .env import obs_size
    from .models.policy import ActorCritic
    from .types import EnvParams

    device = torch.device(args.device)
    env_params = EnvParams(players_per_team=args.ppt, max_steps=args.max_steps)
    cfg = ppo.PPOConfig(
        rollout_steps=args.rollout_steps, lr=args.lr, epochs=args.epochs,
        minibatches=args.minibatches, lr_final=args.lr_final,
    )
    iteration_fn = ppo.train_iteration
    if args.fused_collect:
        update_fn = None if args.no_fused_update else ppo.update_epochs_fused
        iteration_fn = functools.partial(
            iteration_fn, collect_fn=ppo.collect_rollout_fused,
            update_fn=update_fn)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = ActorCritic(args.ppt, obs_size(env_params), tuple(args.hidden),
                        device=device)
    runner = ppo.init_runner(
        gen, model, env_params, cfg, args.envs,
        total_iters=args.iters if args.lr_anneal else None)

    steps_per_iter = args.envs * cfg.rollout_steps
    t_start = time.perf_counter()
    for it in range(args.iters):
        t0 = time.perf_counter()
        runner, metrics = iteration_fn(runner, env_params, cfg)
        metrics = {k: float(v) for k, v in metrics.items()}   # synchronises
        dt = time.perf_counter() - t0
        if it % args.log_every == 0:
            print(json.dumps({
                "step": it, "wall_s": round(time.perf_counter() - t_start, 3),
                "env_steps_per_sec": round(steps_per_iter / dt),
                **{k: round(v, 5) for k, v in metrics.items()},
            }), flush=True)
    total = time.perf_counter() - t_start
    if args.eval_episodes:
        from .evaluate import evaluate_fused, uniform_random_weights_like
        from .ops.fused_collect import actor_critic_policy_weights

        w = actor_critic_policy_weights(runner.model)
        res = evaluate_fused(env_params, w, uniform_random_weights_like(w),
                             n_envs=args.eval_episodes,
                             n_steps=env_params.max_steps, seed=args.seed)
        print(json.dumps({"eval_vs_random": {
            "episodes": args.eval_episodes, "win": res["win_rate_a"],
            "loss": res["win_rate_b"], "draw": res["draw_rate"],
            "goals_per_episode": [round(float(g), 4)
                                  for g in res["goals_per_episode"]],
        }}), flush=True)
    print(json.dumps({
        "done": True,
        "total_env_steps": steps_per_iter * args.iters,
        "wall_s": round(total, 2),
        "env_steps_per_sec": round(steps_per_iter * args.iters / total),
    }), flush=True)
    return runner


if __name__ == "__main__":
    main()
