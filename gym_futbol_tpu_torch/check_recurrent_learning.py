"""Recurrent learning gate: the LSTM learners held to the MLP gate's bar.

Counterpart of the JAX package's ``parity/check_recurrent_learning.py``,
with the same flags, defaults and verdict. One algorithm a call
(``--algo``):

- ``a2c``: full-batch BPTT A2C (``a2c.train_iteration_recurrent``,
  constant-rate RMSProp);
- ``ppo``: sequence-minibatched clipped-surrogate recurrent PPO
  (``recurrent_ppo.train_iteration_recurrent_ppo``, the learning rate
  annealed to its 0.1 x lr floor).

``--seeds`` seeds (seed k from ``--seed`` + 1000 k), the mean win rate
against uniform random play at least ``--win-threshold`` (default 0.70),
each final policy beating its 1/3-of-training snapshot head to head, and
a cross-seed league. Every match runs through the carry-threading
``evaluate.evaluate_recurrent`` (the plain env, one batched step at a
time), the opponent a second recurrent model where it is a trained one.
Training collects on the plain loop, or with ``--fused-collect`` on the
``fused_recurrent_collect`` kernel, in the route ``--collect-dtype``
names (``a2c.FUSED_COLLECT_DTYPE`` per algorithm by default; the plain
loop is float32 only).

Finished seeds persist under ``--out-dir`` and a call may train at most
``--max-new-seeds`` of them, as in :mod:`.check_learning`: a call that
leaves seeds untrained prints ``"complete": false`` and exits 2.

Run on the card::

    python -m gym_futbol_tpu_torch.check_recurrent_learning --algo ppo \\
        --fused-collect --iters 1500 --max-new-seeds 1

On the CPU, at a smoke size::

    python -m gym_futbol_tpu_torch.check_recurrent_learning --device cpu \\
        --algo ppo --ppt 1 --envs 8 --iters 3 --hidden 16 --lstm-size 8 \\
        --eval-envs 8 --max-steps 12 --seeds 1 --win-threshold 0
"""

from __future__ import annotations

import argparse
import functools
import json
import time

from .check_learning import (
    _SEED_FLAGS,
    SeedStore,
    add_common_flags,
    match_record,
    model_snapshot,
    print_device,
    round_robin,
    run_seeds,
    seed_flags,
    train_seed,
    verdict,
)

# Per-team-size budgets of the JAX package's recurrent gate. PPO takes 8
# gradient steps an iteration to A2C's 1, so it needs fewer iterations.
PPT_DEFAULTS = {
    1: {"envs": 4096, "iters": {"a2c": 3000, "ppo": 800}},
    2: {"envs": 8192, "iters": {"a2c": 4000, "ppo": 1000}},
    3: {"envs": 16384, "iters": {"a2c": 6000, "ppo": 2000}},
    5: {"envs": 65536, "iters": {"a2c": 6000, "ppo": 2000}},
}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    from .a2c import FUSED_COLLECT_DTYPE

    ap = argparse.ArgumentParser(
        prog="python -m gym_futbol_tpu_torch.check_recurrent_learning",
        description="3-seed learning gate of the LSTM learners")
    ap.add_argument("--algo", choices=("a2c", "ppo"), default="ppo")
    ap.add_argument("--ppt", type=int, default=2,
                    help="players per team (1/2/3/5 have tuned defaults)")
    add_common_flags(ap, log_every=100)
    ap.add_argument("--rollout-steps", type=int, default=16)
    ap.add_argument("--lstm-size", type=int, default=128)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128])
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 7e-4 (a2c) / 3e-4 (ppo)")
    ap.add_argument("--eval-envs", type=int, default=2048)
    ap.add_argument("--fused-collect", action="store_true",
                    help="collect on the fused_recurrent_collect kernel")
    ap.add_argument("--collect-dtype", choices=("bfloat16", "float32"),
                    default=None,
                    help="the fused collect's route: bfloat16 (tensor cores) "
                         "or float32 (exact); default per --algo, "
                         f"{FUSED_COLLECT_DTYPE}; the plain collect is "
                         "float32")
    args = ap.parse_args(argv)
    if args.collect_dtype is None:
        args.collect_dtype = (FUSED_COLLECT_DTYPE[args.algo]
                              if args.fused_collect else "float32")
    elif not args.fused_collect and args.collect_dtype != "float32":
        ap.error(f"--collect-dtype {args.collect_dtype} needs --fused-collect "
                 "(the plain collect is float32)")
    defaults = PPT_DEFAULTS.get(args.ppt, PPT_DEFAULTS[2])
    if args.envs is None:
        args.envs = defaults["envs"]
    if args.iters is None:
        args.iters = defaults["iters"][args.algo]
    if args.lr is None:
        args.lr = 7e-4 if args.algo == "a2c" else 3e-4
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)

    import torch

    from . import a2c
    from . import recurrent_ppo as rppo
    from .env import obs_size
    from .evaluate import evaluate_recurrent
    from .models.recurrent import RecurrentActorCritic
    from .types import EnvParams

    device = torch.device(args.device)
    print_device(device)
    env_params = EnvParams(players_per_team=args.ppt)
    if args.max_steps is None:
        args.max_steps = env_params.max_steps
    env_params = env_params.replace(max_steps=args.max_steps)
    n_steps = env_params.max_steps
    f = obs_size(env_params)

    def new_model():
        return RecurrentActorCritic(args.ppt, f, tuple(args.hidden),
                                    args.lstm_size, device=device)

    collect_fn = (functools.partial(
        a2c.collect_recurrent_rollout_fused,
        compute_dtype=getattr(torch, args.collect_dtype))
        if args.fused_collect else a2c.collect_recurrent_rollout)
    if args.algo == "a2c":
        cfg = a2c.A2CConfig(rollout_steps=args.rollout_steps, lr=args.lr,
                            ent_coef=args.ent_coef)
        iteration = functools.partial(a2c.train_iteration_recurrent,
                                      collect_fn=collect_fn)

        def init_runner(gen):
            return a2c.init_recurrent_runner(gen, new_model(), env_params, cfg,
                                             args.envs)
    else:
        cfg = rppo.RecurrentPPOConfig(rollout_steps=args.rollout_steps,
                                      lr=args.lr, ent_coef=args.ent_coef)
        iteration = functools.partial(rppo.train_iteration_recurrent_ppo,
                                      collect_fn=collect_fn)

        def init_runner(gen):
            return rppo.init_recurrent_ppo_runner(gen, new_model(), env_params,
                                                  cfg, args.envs, args.iters)

    def snapshot(runner):
        return {"model": model_snapshot(runner.model)}

    def restore(snap):
        model = new_model()
        model.load_state_dict(snap["model"])
        return model

    def play(snap_a, snap_b, seed):
        """snap_a as team 0 against snap_b (None: uniform random)."""
        return evaluate_recurrent(
            env_params, restore(snap_a),
            model_b=None if snap_b is None else restore(snap_b),
            n_envs=args.eval_envs, n_steps=n_steps, seed=seed)

    def run_one(k, seed):
        snap, snap_third, curve, train_s = train_seed(
            seed, args, init_runner, iteration, env_params, cfg, snapshot)
        t0 = time.perf_counter()
        rec = match_record(seed, play(snap, None, seed + 7),
                           play(snap, snap_third, seed + 11))
        seconds = {"train": train_s, "eval": time.perf_counter() - t0}
        return rec, seconds, {"final": snap, "third": snap_third}, curve

    stem = f"ppt{args.ppt}_{args.algo}"
    store = SeedStore(args.out_dir, f"recurrent_{stem}", f"recurrent_curve_{stem}",
                      seed_flags(args, _SEED_FLAGS + (
                          "algo", "lstm_size", "fused_collect",
                          "collect_dtype")))
    done = run_seeds(args, store, run_one)
    if done is None:
        return 2
    records, finals, seconds = done

    league = None
    if args.seeds > 1 and not args.no_league:
        league = round_robin(args.seeds, lambda i, j, seed: play(
            finals[i], finals[j], seed))
        store.write_json(f"recurrent_league_{stem}.json", league)

    out = verdict(
        args, metric=f"recurrent_{args.algo}_trained_vs_random_win_rate_mean",
        unit=(f"mean win rate over {args.seeds} seeds x {args.eval_envs} "
              f"matches (LSTM {args.algo})"),
        records=records, league=league,
        steps=args.iters * args.envs * cfg.rollout_steps, seconds=seconds,
        hyperparams={"algo": args.algo, "lr": args.lr,
                     "ent_coef": args.ent_coef, "iters": args.iters,
                     "envs": args.envs, "lstm_size": args.lstm_size,
                     "hidden": args.hidden, "rollout_steps": args.rollout_steps,
                     "max_steps": args.max_steps,
                     "fused_collect": args.fused_collect,
                     "collect_dtype": args.collect_dtype})
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
