"""Times the replay rollout (``ops.fused_rollout_replay``) or, with
``--mode random``, the random-policy rollout (``ops.fused_rollout``) on
the card.

At each shape of :data:`SHAPES` (2v2 at 4096 envs with T=16 and T=128,
3v3 at 16384 envs and 5v5 at 65536 envs with T=16) it builds game
states (a reset batch, then 32 random-policy steps of ``fused_rollout``
from a seed) and random actions, and times one call with CUDA events
over :data:`REPS` calls after one warm-up (the replay of those actions,
or T random-policy steps from one Philox seed): by the package's own
plan, and, with ``--plans``, with the plan (``replay_plan`` or
``rollout_plan``) forced to each given (lanes, threads; lanes 0 is one
thread per env).

``--shapes`` replaces the shapes; ``--params`` sets integer EnvParams
fields (two substep counts split a step's fixed cost, its rules, from
its per-substep physics; two solver iteration counts split the solver
from the rest of a substep).

``--package-root DIR`` imports ``gym_futbol_tpu_torch`` from DIR
instead of this file's checkout: another commit unpacked under
``build/`` times its own design on the same card in the same call (its
kernels build into DIR's own ``build/``). Without the mode's plan and
``lanes_launch`` there, ``--plans`` is refused.

One JSON line per (shape, plan): ms per call and per step, the plan,
the card's name and power limit. Timing two trees in one call: run it
for each, in turns (A, B, B, A). Run from the repository root::

    python3 gym_futbol_tpu_torch/replay_timing.py --plans 0:32,2:64,4:128,8:128
    python3 gym_futbol_tpu_torch/replay_timing.py --mode random --plans 0:32,8:64
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((2, 4096, 16), (2, 4096, 128), (3, 16384, 16), (5, 65536, 16))
WARM_STEPS = 32
REPS = 10


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--mode", choices=("replay", "random"), default="replay")
    ap.add_argument("--plans", default="",
                    help="comma-separated lanes:threads to force, beside the plan's own")
    ap.add_argument("--shapes", default="",
                    help="comma-separated ppt:envs:T in place of SHAPES")
    ap.add_argument("--params", default="",
                    help="comma-separated EnvParams overrides, name=int (e.g. "
                         "substeps=1,solver_iterations=1)")
    return ap.parse_args(argv)


def replay_inputs(params, n_envs: int, n_steps: int, seed: int, device):
    """(statef, statei, actions) at game states: a reset batch, then
    :data:`WARM_STEPS` random-policy steps; actions uniform in [0, 5)."""
    import torch

    from gym_futbol_tpu_torch import ops, vector

    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = vector.reset_batch(gen, params, n_envs, device=device)
    sf, si = ops.pack_state(state, params)
    sf, si, _ = ops.fused_rollout(sf, si, seed + 1, params, WARM_STEPS)
    acts = torch.randint(0, 5, (n_steps, 2 * params.n_players, n_envs),
                         generator=gen, device=device, dtype=torch.int32)
    return sf, si, acts


def time_call(call, reps: int) -> float:
    """Milliseconds per ``call()`` (CUDA events, after one warm-up)."""
    import torch

    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def forced_plan(fr, lanes: int, threads: int):
    """A stand-in for ``replay_plan`` or ``rollout_plan`` that gives
    ``lanes`` per env and ``threads`` a block, lowered a warp at a time
    until the block's records fit the shared memory, as the plans lower
    their own."""
    import importlib

    limit = importlib.import_module("gym_futbol_tpu_torch.ops._build").SMEM_BYTES

    def plan(params, n_envs):
        n = threads
        while fr.lanes_launch(params.n_bodies, n_envs, lanes, n)["smem"] > limit:
            n -= 32
        return dict(lanes=lanes, threads=n, slots=fr.lanes_slots(lanes),
                    **fr.lanes_launch(params.n_bodies, n_envs, lanes, n))
    return plan


def main(argv=None) -> int:
    args = parse_args(argv)
    tree = os.path.abspath(args.package_root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("replay_timing: no CUDA device", file=sys.stderr)
        return 1
    from gym_futbol_tpu_torch import EnvParams, ops

    fr = importlib.import_module("gym_futbol_tpu_torch.ops.fused_rollout")
    plan_name = "replay_plan" if args.mode == "replay" else "rollout_plan"
    plans = [tuple(int(x) for x in p.split(":")) for p in args.plans.split(",") if p]
    if plans and not (hasattr(fr, plan_name) and hasattr(fr, "lanes_launch")):
        print(f"replay_timing: this tree has no {plan_name} and lanes_launch to force",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    own = getattr(fr, plan_name, None)
    shapes = ([tuple(int(x) for x in sh.split(":")) for sh in args.shapes.split(",")]
              if args.shapes else SHAPES)
    extra = {k: int(v) for k, v in (kv.split("=") for kv in args.params.split(",") if kv)}
    for ppt, n_envs, n_steps in shapes:
        params = EnvParams(players_per_team=ppt, **extra)
        sf, si, acts = replay_inputs(params, n_envs, n_steps, 0, dev)
        if args.mode == "replay":
            call = lambda: ops.fused_rollout_replay(sf, si, acts, params)  # noqa: E731
        else:
            call = lambda: ops.fused_rollout(sf, si, 7, params, n_steps)  # noqa: E731
        for forced in [None, *plans]:
            if forced is not None:
                setattr(fr, plan_name, forced_plan(fr, *forced))
            try:
                plan = getattr(fr, plan_name)(params, n_envs) if own is not None else None
                ms = time_call(call, REPS)
            finally:
                if own is not None:
                    setattr(fr, plan_name, own)
            print(json.dumps({
                "tree": tree, "mode": args.mode, "shape": f"{ppt}v{ppt}",
                "n_envs": n_envs, "T": n_steps,
                "params": extra, "plan": "own" if forced is None else "forced",
                "launch": plan, "ms_per_call": ms, "ms_per_step": ms / n_steps,
                "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
