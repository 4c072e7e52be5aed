"""How far the recurrent collect's behaviour policy is from the learner.

Recurrent A2C collects a window with the ``fused_recurrent_collect``
kernel and then re-runs the float32 model over it by BPTT
(:func:`a2c.recurrent_a2c_loss`). On the kernel's bfloat16 route the
actions are sampled, and their log-probs and values written, by a policy
whose layer products are rounded to bf16; the learner's are float32.
A2C has no importance ratio, so nothing corrects that gap.

For each snapshot of a gate's seed (``{stem}_seed{k}.pt``: ``third``,
``final``) this script warms up ``--warmup`` windows on the float32
route to reach game states, then collects one window from those states
and carries on each route from the same uniforms table, and reports:

- the share of sampled joint actions (per view, step and env) that
  differ between the routes, over the window and at its first step
  (after the first difference an env's trajectories part);
- on each route's own actions, ``logp_collect - logp_learner`` and
  ``value_collect - value_learner``: the mean and the largest magnitude
  (the learner: the float32 model unrolled over the route's obs and
  dones from the window's first carry, as A2C's loss runs it).

On the card it also times the collect on each route at this shape (the
wrapper as A2C calls it, CUDA events, ``--reps`` windows a route after
one warm-up, the routes in turns). One JSON line per snapshot. Run on
the card::

    python -m gym_futbol_tpu_torch.route_gap \\
        build/learning/recurrent_ppt2_a2c_seed0.pt
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m gym_futbol_tpu_torch.route_gap",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("snapshots", help="a recurrent gate's seed .pt file")
    ap.add_argument("--which", nargs="+", default=["third", "final"])
    ap.add_argument("--ppt", type=int, default=2)
    ap.add_argument("--envs", type=int, default=8192)
    ap.add_argument("--rollout-steps", type=int, default=16)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128])
    ap.add_argument("--lstm-size", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=8,
                    help="float32 windows played before the measured one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed windows a route (on the card)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _stats(x) -> dict:
    return {"mean": float(x.mean()), "max_abs": float(x.abs().max())}


def window_gap(runner, env_params, cfg, uniforms, compute_dtype):
    """One window on ``compute_dtype``'s route from ``runner``: (traj,
    the learner's logp and value of the route's actions ``[T, 2B]``)."""
    import torch

    from . import a2c
    from .models.policy import action_log_prob_and_entropy_packed

    init_carry = a2c._flat_carry(runner.carry, runner.obs.shape[0])
    _, traj, _ = a2c.collect_recurrent_rollout_fused(
        runner, env_params, cfg, uniforms=uniforms, compute_dtype=compute_dtype)
    with torch.no_grad():
        _, (logits, value) = runner.model.unroll(init_carry, traj.obs, traj.done)
        logp, _ = action_log_prob_and_entropy_packed(logits, traj.dirs, traj.acts)
    return traj, logp, value


def measure(runner, env_params, cfg, generator) -> dict:
    """Both routes' windows from ``runner`` on one uniforms table."""
    import torch

    from .ops import n_draws_per_step

    b = runner.obs.shape[0]
    uniforms = torch.rand((cfg.rollout_steps, n_draws_per_step(env_params), b),
                          generator=generator, device=generator.device)
    out = {}
    routes = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        traj, logp, value = window_gap(runner, env_params, cfg, uniforms, dtype)
        routes[name] = traj
        out[name] = {"logp_collect_minus_learner": _stats(traj.logp - logp),
                     "value_collect_minus_learner": _stats(traj.value - value)}
    a, f = routes["bfloat16"], routes["float32"]
    differ = (a.dirs != f.dirs) | (a.acts != f.acts)
    out["actions_differ_share"] = float(differ.float().mean())
    out["actions_differ_share_first_step"] = float(differ[0].float().mean())
    return out


def time_routes(runner, env_params, cfg, reps: int) -> dict:
    """ms per window of the collect on each route, the routes in turns
    (each window from ``runner``'s state)."""
    import torch

    from . import a2c

    routes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    ms = {name: [] for name in routes}
    for name, dtype in routes.items():          # warm-up (and the build)
        a2c.collect_recurrent_rollout_fused(runner, env_params, cfg,
                                            compute_dtype=dtype)
    for _ in range(reps):
        for name, dtype in routes.items():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            a2c.collect_recurrent_rollout_fused(runner, env_params, cfg,
                                                compute_dtype=dtype)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
    return {name: {"ms_per_window": sum(v) / len(v),
                   "ms_per_step": sum(v) / len(v) / cfg.rollout_steps}
            for name, v in ms.items()}


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from . import a2c
    from .check_learning import print_device
    from .env import obs_size
    from .models.recurrent import RecurrentActorCritic
    from .types import EnvParams

    device = torch.device(args.device)
    print_device(device)
    env_params = EnvParams(players_per_team=args.ppt)
    cfg = a2c.A2CConfig(rollout_steps=args.rollout_steps)
    snaps = torch.load(args.snapshots, map_location=device, weights_only=True)
    for which in args.which:
        model = RecurrentActorCritic(args.ppt, obs_size(env_params),
                                     tuple(args.hidden), args.lstm_size,
                                     device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        runner = a2c.init_recurrent_runner(gen, model, env_params, cfg, args.envs)
        model.load_state_dict(snaps[which]["model"])
        for _ in range(args.warmup):
            runner, _, _ = a2c.collect_recurrent_rollout_fused(
                runner, env_params, cfg, compute_dtype=torch.float32)
        rec = {"snapshot": which, "path": args.snapshots, "envs": args.envs,
               "rollout_steps": args.rollout_steps, "warmup": args.warmup,
               **measure(runner, env_params, cfg, gen)}
        if device.type == "cuda":
            rec["times"] = time_routes(runner, env_params, cfg, args.reps)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
