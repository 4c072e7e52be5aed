"""Learning gate: self-play PPO runs must produce policies that beat
uniform random play, across seeds.

Counterpart of the JAX package's ``parity/check_learning.py``, with the
same flags, defaults and verdict:

- trains ``--seeds`` independent seeds (seed k from ``--seed`` + 1000 k)
  through ``ppo.train_iteration`` on the fused collect and the fused
  update (``--plain-collect``: both plain), the learning rate annealed
  linearly to its 0.1 x lr floor, and requires the MEAN win rate against
  uniform random play to reach ``--win-threshold`` (default 0.70);
- evaluates on the self-play kernel (``evaluate.evaluate_fused`` on the
  policy-only weights, ``--plain-eval``: ``evaluate.evaluate``) over
  ``--eval-envs`` full episodes, with a one-off check on seed 0 that the
  plain evaluator agrees within a 4-sigma binomial band;
- checks MONOTONICITY: each final policy must beat, head to head, the
  policy it was at 1/3 of training;
- plays a cross-seed round-robin of the final policies (the league);
- ``--normalize`` trains through VecNormalize-style statistics on both
  kernels, and every evaluation folds the snapshot's own frozen
  statistics into its weights (``make_normalized_policy_fn`` on the
  plain evaluator).

A seed's training is the training CLI's at the same flags and seed
(``python -m gym_futbol_tpu_torch.train --lr-anneal --fused-collect``,
with ``--normalize-obs --normalize-reward`` for ``--normalize``).

The gate can finish its seeds over several calls. Each finished seed
writes its snapshots (final and 1/3, with their statistics), its
learning curve and its record under ``--out-dir``; a later call with the
same flags and the same code loads it and does not train it again, and a
record written under other flags, or by other code (the package's
sources or the torch version), is refused. ``--max-new-seeds N`` trains at most N
seeds in this call: a call that leaves seeds untrained prints one JSON
line with ``"complete": false`` and exits 2; the call that finds every
seed done plays the league and prints the verdict, exit 0 when it
passes, else 1. ``train_seconds_total`` is the sum of the seeds' own
seconds (each seed's training and evaluations), whichever call ran them.

Run on the card (one gate a call; split the long ones)::

    python -m gym_futbol_tpu_torch.check_learning --ppt 2
    python -m gym_futbol_tpu_torch.check_learning --ppt 5 --max-new-seeds 1

On the CPU, at a smoke size (the fused update takes whole 1024-sample
blocks, at least one per minibatch: 2 x envs x rollout steps >= 4096)::

    python -m gym_futbol_tpu_torch.check_learning --device cpu --ppt 1 \\
        --envs 512 --rollout-steps 4 --iters 3 --hidden 16 16 \\
        --eval-envs 16 --max-steps 12 --seeds 2 --win-threshold 0 \\
        --out-dir build/learning/smoke
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import time

# Per-team-size defaults: the env counts are bench configs' scales
# (config 4: 3v3, 16384 envs; config 5: 5v5, 65536 envs).
PPT_DEFAULTS = {
    2: {"envs": 8192, "iters": 500},
    3: {"envs": 16384, "iters": 500},
    5: {"envs": 65536, "iters": 500},
}

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                               "learning")

# The flags that decide what a finished seed holds. A record is reused
# only under the same values; --seeds, --win-threshold, --no-league,
# --out-dir and --max-new-seeds decide only which seeds run and the
# verdict.
_SEED_FLAGS = ("ppt", "iters", "envs", "rollout_steps", "hidden", "lr",
               "ent_coef", "eval_envs", "seed", "max_steps", "log_every",
               "device")


def add_common_flags(ap: argparse.ArgumentParser, log_every: int) -> None:
    """The flags both gates share beyond their own."""
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--envs", type=int, default=None)
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--win-threshold", type=float, default=0.70)
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--no-league", action="store_true",
                    help="skip the trained-vs-trained round-robin")
    ap.add_argument("--log-every", type=int, default=log_every)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and evaluate on (default: "
                         "the card)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="episode length (default: EnvParams' 300); every "
                         "evaluation plays one full episode")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="where each finished seed's snapshots, curve and "
                         "record go, and the league table")
    ap.add_argument("--max-new-seeds", type=int, default=None,
                    help="train at most this many seeds in this call (the "
                         "finished ones under --out-dir are loaded)")


def code_identity() -> dict:
    """What a seed was trained by: a hash of the package's sources (every
    ``.py``, ``.cu`` and ``.cuh`` file under it, by path and content) and
    the torch version."""
    import torch

    h = hashlib.sha256()
    for root, dirs, files in os.walk(PACKAGE_DIR):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    data = f.read()
                rel = os.path.relpath(path, PACKAGE_DIR).encode()
                h.update(b"%d %s %d\n" % (len(rel), rel, len(data)) + data)
    return {"sources": h.hexdigest()[:16], "torch": torch.__version__}


def seed_flags(args: argparse.Namespace, names) -> dict:
    """``{"--flag": value}`` of the flags a finished seed depends on."""
    return {"--" + n.replace("_", "-"): getattr(args, n) for n in names}


class SeedStore:
    """The gate's finished seeds under ``out_dir``: seed k's record
    ``{stem}_seed{k}.json`` (the flags it ran under, the code that trained
    it, its evaluation, its seconds), its snapshots ``{stem}_seed{k}.pt``
    and its learning curve ``{curve_stem}_seed{k}.jsonl``. The record is
    written last, so a seed with a record is whole."""

    def __init__(self, out_dir: str, stem: str, curve_stem: str, flags: dict):
        self.out_dir, self.stem, self.curve_stem = out_dir, stem, curve_stem
        self.flags = flags
        self.code = code_identity()
        os.makedirs(out_dir, exist_ok=True)

    def _path(self, k: int, ext: str, stem: str | None = None) -> str:
        return os.path.join(self.out_dir, f"{stem or self.stem}_seed{k}.{ext}")

    def load(self, k: int, device):
        """Seed k's saved ``(record, seconds, snapshots)``, or None when
        it has not finished. Raises SystemExit, naming what differs, when
        it was written under other flags or by other code."""
        import torch

        path = self._path(k, "json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            saved = json.load(f)
        diff = [f"{name} {saved['flags'].get(name)!r} there, {value!r} here"
                for name, value in self.flags.items()
                if saved["flags"].get(name) != value]
        if diff:
            raise SystemExit(f"{path} was written under other flags: "
                             + "; ".join(diff) + " (use another --out-dir)")
        code = saved.get("code") or {}
        diff = [f"{name} {code.get(name)!r} there, {value!r} here"
                for name, value in self.code.items() if code.get(name) != value]
        if diff:
            raise SystemExit(f"{path} was trained by other code: "
                             + "; ".join(diff) + " (use another --out-dir)")
        snaps = torch.load(self._path(k, "pt"), map_location=device,
                           weights_only=True)
        return saved["record"], saved["seconds"], snaps

    def save(self, k: int, record: dict, seconds: dict, snaps: dict,
             curve: list[dict]) -> None:
        """Write seed k's snapshots, curve and record, each to a temporary
        file renamed over its own."""
        import torch

        def write(path, dump, mode="w"):
            with open(path + ".tmp", mode) as f:
                dump(f)
            os.replace(path + ".tmp", path)

        write(self._path(k, "pt"), lambda f: torch.save(_to_cpu(snaps), f), "wb")
        write(self._path(k, "jsonl", self.curve_stem),
              lambda f: f.writelines(json.dumps(r) + "\n" for r in curve))
        write(self._path(k, "json"), lambda f: json.dump(
            {"flags": self.flags, "code": self.code, "record": record,
             "seconds": seconds}, f, indent=1))

    def write_json(self, name: str, obj) -> None:
        with open(os.path.join(self.out_dir, name), "w") as f:
            json.dump(obj, f, indent=1)


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x.detach().cpu() if hasattr(x, "detach") else x


def model_snapshot(model) -> dict:
    """A copy of ``model``'s parameters, as its ``state_dict``."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_seed(seed: int, args, init_runner, iteration, env_params, cfg,
               snapshot) -> tuple[dict, dict, list[dict], float]:
    """Train seed ``seed`` for ``args.iters`` iterations from
    ``init_runner(generator)``; returns (final snapshot, 1/3 snapshot,
    curve, seconds). ``snapshot(runner)`` copies what an evaluation
    needs; the 1/3 one is taken after iteration ``max(1, iters // 3)``."""
    import torch

    from .utils.metrics import to_python

    t0 = time.perf_counter()
    runner = init_runner(torch.Generator(device=args.device).manual_seed(seed))
    third = max(1, args.iters // 3)
    snap_third, curve = None, []
    for it in range(args.iters):
        runner, metrics = iteration(runner, env_params, cfg)
        if it + 1 == third:
            snap_third = snapshot(runner)
        if it % args.log_every == 0 or it == args.iters - 1:
            m = {k: round(v, 5) for k, v in to_python(metrics).items()}
            curve.append({"iter": it, **m})
            print(f"# seed {seed} iter {it:4d}  {json.dumps(m)}", flush=True)
    snap = snapshot(runner)
    if str(args.device).startswith("cuda"):
        torch.cuda.synchronize()
    return snap, snap_third, curve, time.perf_counter() - t0


def match_record(seed: int, res: dict, mono: dict) -> dict:
    """One seed's record: its win rate and goals against random play,
    and the final-vs-1/3 match."""
    return {
        "seed": seed,
        "win_rate_vs_random": round(float(res["win_rate_a"]), 4),
        "goals_per_episode": [round(float(g), 3)
                              for g in res["goals_per_episode"]],
        "final_vs_third_win": round(float(mono["win_rate_a"]), 4),
        "third_vs_final_win": round(float(mono["win_rate_b"]), 4),
        "monotonic": float(mono["win_rate_a"]) > float(mono["win_rate_b"]),
    }


def consistency_band(win: float, other_win: float, n: int, n_other: int) -> float:
    """4 sigma of the difference of two binomial estimates of one win
    rate over ``n`` and ``n_other`` matches, the variance floored at
    0.01."""
    p = (win + other_win) / 2
    return 4.0 * math.sqrt(max(p * (1 - p), 0.01) * (1 / n + 1 / n_other))


def round_robin(n: int, play) -> dict:
    """Every ordered pair (i, j), i != j, plays once, seed i as team 0:
    ``play(i, j, seed)`` -> evaluation metrics at seed ``9000 + 17 i +
    j``. A win is a point, a draw half; each seed's points over its
    ``2 (n - 1)`` matches."""
    league = {"pairs": [], "points": [0.0] * n}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            res = play(i, j, 9000 + 17 * i + j)
            wa, wb = float(res["win_rate_a"]), float(res["win_rate_b"])
            dr = float(res["draw_rate"])
            league["pairs"].append({"a": i, "b": j, "win_a": round(wa, 4),
                                    "win_b": round(wb, 4), "draw": round(dr, 4)})
            league["points"][i] += wa + 0.5 * dr
            league["points"][j] += wb + 0.5 * dr
            print(f"# league: seed{i} vs seed{j}: {wa:.3f}/{dr:.3f}/{wb:.3f}",
                  flush=True)
    games = 2 * (n - 1)
    league["points"] = [round(p / games, 4) for p in league["points"]]
    return league


def run_seeds(args, store: SeedStore, run_one) -> tuple[list, list, float] | None:
    """Load or train seeds 0 .. ``args.seeds - 1``: ``run_one(k, seed)``
    trains and evaluates one, returning (record, seconds, snapshots,
    curve), and
    is called for at most ``args.max_new_seeds`` seeds. Returns (records,
    final snapshots, seconds in all) when every seed is done; else prints
    the ``"complete": false`` line and returns None."""
    records, finals, total, new = [], [], 0.0, 0
    for k in range(args.seeds):
        seed = args.seed + 1000 * k
        got = store.load(k, args.device)
        if got is None:
            if args.max_new_seeds is not None and new >= args.max_new_seeds:
                continue
            got = run_one(k, seed)
            store.save(k, *got)
            new += 1
        else:
            print(f"# seed {seed}: loaded from {store.out_dir}", flush=True)
        rec, seconds, snaps = got[:3]
        print(f"# seed {seed}: {json.dumps(rec)}", flush=True)
        records.append(rec)
        finals.append(snaps["final"])
        total += seconds["train"] + seconds["eval"]
    if len(records) < args.seeds:
        print(json.dumps({"complete": False, "seeds_done": len(records),
                          "seeds": args.seeds, "trained_now": new,
                          "per_seed": records}), flush=True)
        return None
    return records, finals, total


def verdict(args, metric: str, unit: str, records: list, league, steps: int,
            seconds: float, hyperparams: dict, extra_ok: bool = True) -> dict:
    """The gate's last line: the keys of the JAX package's gate."""
    wins = [r["win_rate_vs_random"] for r in records]
    mean_win = sum(wins) / len(wins)
    monotonic = all(r["monotonic"] for r in records)
    return {
        "metric": metric,
        "ppt": args.ppt,
        "value": round(mean_win, 4),
        "unit": unit,
        "threshold": args.win_threshold,
        "ok": bool(mean_win >= args.win_threshold and monotonic and extra_ok),
        "per_seed": wins,
        "monotonic_all": monotonic,
        "league_points": league["points"] if league else None,
        "train_env_steps_per_seed": steps,
        "train_seconds_total": round(seconds, 1),
        "hyperparams": hyperparams,
    }


def print_device(device) -> None:
    import torch

    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    print(f"# device {dev}: {name}, torch {torch.__version__}", flush=True)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m gym_futbol_tpu_torch.check_learning",
        description="3-seed learning gate of self-play PPO")
    ap.add_argument("--ppt", type=int, default=2,
                    help="players per team (2/3/5 have tuned defaults)")
    add_common_flags(ap, log_every=10)
    ap.add_argument("--rollout-steps", type=int, default=128)
    ap.add_argument("--hidden", type=int, nargs="+", default=[128, 128])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-envs", type=int, default=4096)
    ap.add_argument("--plain-collect", action="store_true",
                    help="train on the plain collect and update instead of "
                         "the fused_collect and fused_minibatch_grad kernels")
    ap.add_argument("--normalize", action="store_true",
                    help="train through VecNormalize-style observation and "
                         "reward statistics (folded into the kernels' first "
                         "layer; with --plain-collect in the plain loop)")
    ap.add_argument("--plain-eval", action="store_true",
                    help="evaluate on the plain evaluator instead of the "
                         "self-play kernel")
    args = ap.parse_args(argv)
    defaults = PPT_DEFAULTS.get(args.ppt, PPT_DEFAULTS[2])
    if args.envs is None:
        args.envs = defaults["envs"]
    if args.iters is None:
        args.iters = defaults["iters"]
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)

    import functools

    import torch

    from . import ppo
    from .env import obs_size
    from .evaluate import evaluate, evaluate_fused, uniform_random_weights_like
    from .models.policy import (
        ActorCritic,
        make_normalized_policy_fn,
        make_policy_fn,
    )
    from .ops.fused_collect import actor_critic_policy_weights
    from .types import EnvParams
    from .wrappers import RunningNorm

    device = torch.device(args.device)
    print_device(device)
    env_params = EnvParams(players_per_team=args.ppt)
    if args.max_steps is None:
        args.max_steps = env_params.max_steps
    env_params = env_params.replace(max_steps=args.max_steps)
    n_steps = env_params.max_steps
    cfg = ppo.PPOConfig(rollout_steps=args.rollout_steps, lr=args.lr,
                        ent_coef=args.ent_coef)
    f = obs_size(env_params)

    if args.plain_collect:
        collect_fn = (ppo.make_normalized_collect() if args.normalize
                      else ppo.collect_rollout)
        update_fn = None
    else:
        collect_fn = (ppo.make_fused_normalized_collect() if args.normalize
                      else ppo.collect_rollout_fused)
        update_fn = ppo.update_epochs_fused
    iteration = functools.partial(ppo.train_iteration, collect_fn=collect_fn,
                                  update_fn=update_fn)

    def init_runner(gen):
        model = ActorCritic(args.ppt, f, tuple(args.hidden), device=device)
        return ppo.init_runner(gen, model, env_params, cfg, args.envs,
                               args.iters, normalize_obs=args.normalize,
                               normalize_reward=args.normalize)

    def snapshot(runner):
        norm = runner.obs_norm
        return {"model": model_snapshot(runner.model),
                "obs_norm": None if norm is None else {
                    "mean": norm.mean.clone(), "var": norm.var.clone(),
                    "count": norm.count.clone()}}

    def restore(snap):
        """(model, frozen statistics or None) of a snapshot."""
        model = ActorCritic(args.ppt, f, tuple(args.hidden), device=device)
        model.load_state_dict(snap["model"])
        norm = snap["obs_norm"]
        return model, None if norm is None else RunningNorm(**norm)

    def fused_weights(snap):
        """The policy-only kernel weights; under --normalize the
        snapshot's own frozen statistics folded into the first layer,
        so the raw-obs kernel plays the policy as it acted."""
        model, norm = restore(snap)
        w = actor_critic_policy_weights(model)
        if norm is not None:
            w = ppo.fold_obs_norm(w, *ppo._obs_norm_scales(norm))
        return w

    def plain_policy(snap):
        model, norm = restore(snap)
        return (make_policy_fn(model) if norm is None
                else make_normalized_policy_fn(model, norm))

    def play(snap_a, snap_b, n_envs, seed):
        """snap_a as team 0 against snap_b (None: uniform random)."""
        if args.plain_eval:
            return evaluate(env_params, plain_policy(snap_a),
                            None if snap_b is None else plain_policy(snap_b),
                            n_envs=n_envs, n_steps=n_steps, seed=seed,
                            device=device)
        w = fused_weights(snap_a)
        wb = (uniform_random_weights_like(w) if snap_b is None
              else fused_weights(snap_b))
        return evaluate_fused(env_params, w, wb, n_envs=n_envs,
                              n_steps=n_steps, seed=seed)

    def run_one(k, seed):
        snap, snap_third, curve, train_s = train_seed(
            seed, args, init_runner, iteration, env_params, cfg, snapshot)
        t0 = time.perf_counter()
        res = play(snap, None, args.eval_envs, seed + 7)
        mono = play(snap, snap_third, args.eval_envs, seed + 11)
        rec = match_record(seed, res, mono)
        # one-off evaluator consistency: the plain evaluator on the same
        # trained weights must agree within binomial error
        if k == 0 and not args.plain_eval:
            win = float(res["win_rate_a"])
            plain = evaluate(env_params, plain_policy(snap), n_envs=1024,
                             n_steps=n_steps, seed=seed + 7, device=device)
            plain_win = float(plain["win_rate_a"])
            band = consistency_band(win, plain_win, args.eval_envs, 1024)
            rec["plain_eval_win_rate"] = round(plain_win, 4)
            rec["fused_plain_consistent"] = bool(abs(win - plain_win) <= band)
        seconds = {"train": train_s, "eval": time.perf_counter() - t0}
        return rec, seconds, {"final": snap, "third": snap_third}, curve

    suffix = "_norm" if args.normalize else ""
    store = SeedStore(args.out_dir, f"learning_ppt{args.ppt}{suffix}",
                      f"learning_curve_ppt{args.ppt}{suffix}",
                      seed_flags(args, _SEED_FLAGS + (
                          "normalize", "plain_collect", "plain_eval")))
    done = run_seeds(args, store, run_one)
    if done is None:
        return 2
    records, finals, seconds = done

    league = None
    if args.seeds > 1 and not args.no_league:
        league = round_robin(args.seeds, lambda i, j, seed: play(
            finals[i], finals[j], args.eval_envs, seed))
        store.write_json(f"league_ppt{args.ppt}{suffix}.json", league)

    out = verdict(
        args,
        metric=("normalized_trained_vs_random_win_rate_mean" if args.normalize
                else "trained_vs_random_win_rate_mean"),
        unit=f"mean win rate over {args.seeds} seeds x {args.eval_envs} matches",
        records=records, league=league,
        steps=args.iters * args.envs * cfg.rollout_steps, seconds=seconds,
        hyperparams={"lr": args.lr, "lr_anneal": "linear->0.1*lr floor",
                     "ent_coef": args.ent_coef, "iters": args.iters,
                     "envs": args.envs, "rollout_steps": args.rollout_steps,
                     "normalize": args.normalize, "hidden": args.hidden,
                     "max_steps": args.max_steps,
                     "plain_collect": args.plain_collect,
                     "plain_eval": args.plain_eval},
        extra_ok=all(r.get("fused_plain_consistent", True) for r in records))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
