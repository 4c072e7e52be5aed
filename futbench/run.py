"""One run of one benchmark cell: set-up, a measured or traced window,
the comparison with the plain reference, one result line.

    python -m futbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, which holds ``BENCHMARK.json``. The cell
names a configuration (``futbench/configs/<config>.json``) and a traffic
mix (``futbench/traffic/<traffic>.json``, whose ``kind`` picks the timed
loop ``futbench/loops/<kind>.py``); each metric is read by
``futbench/metrics/<metric>.py``. A cell on several chips starts one
process per chip (this module again, with ``--rank``), joined by NCCL.

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the last lines of standard error repeat the checks. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run exits nonzero and
prints no result. ``--device cpu`` runs the program's plain versions on
the host: the harness's own tests use it, at sizes a test can hold.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

PKG = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 340        # a run ends within 360 s
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_futbol_tpu")


class RunError(Exception):
    """A run that cannot give a result."""


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (``gym_futbol_tpu_torch`` is not ``gym_futbol_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """``futbench/<kind>/<name>.py`` as a module."""
    path = os.path.join(PKG, kind, f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no {kind} file {os.path.relpath(path)}")
    spec = importlib.util.spec_from_file_location(f"futbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    path = os.path.join(PKG, kind, f"{name}.json")
    if not os.path.exists(path):
        raise RunError(f"no {kind} file {os.path.relpath(path)}")
    with open(path) as f:
        return json.load(f)


def cell_spec(root: str, workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json``, with the metrics it
    reports: ``e2e`` and ``per_layer`` lists of metric entries."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(cells[workload],
                e2e=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


class Context:
    """What a timed loop is given: the device, the run's seed, this
    rank's place, the process group (None on one chip)."""

    def __init__(self, device, seed: int, rank: int, world: int, group):
        self.device, self.seed = device, seed
        self.rank, self.world, self.group = rank, world, group

    def words(self, n: int, per_rank: bool = False) -> list[int]:
        """``n`` 31-bit seeds drawn from the run's seed (and the rank)."""
        import numpy as np

        key = [self.seed, self.rank] if per_rank else [self.seed]
        state = np.random.SeedSequence(key).generate_state(n, dtype=np.uint32)
        return [int(w) >> 1 for w in state]


def _sync(group, device):
    """``sync(stop) -> bool``: rank 0's decision, the same on every rank
    (one tiny all-reduce a call on several chips)."""
    if group is None:
        return lambda stop: stop
    import torch
    import torch.distributed as dist

    comm = device if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def sync(stop):
        flag = torch.tensor([1 if stop else 0], device=comm)
        dist.broadcast(flag, 0, group=group)
        return bool(flag.item())

    return sync


def timed_window(call, seconds: float, sync):
    """Closed loop of whole calls for ``seconds``: (per-call seconds, the
    window's seconds, calls whose result was not finite)."""
    durations, failed = [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        result = call()
        t1 = time.perf_counter()
        durations.append(t1 - t)
        failed += not math.isfinite(result)
        if sync(t1 - t0 >= seconds):
            break
    return durations, time.perf_counter() - t0, failed


def _power_limit(device) -> str | None:
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run_rank(args, spec: dict, rank: int, world: int) -> dict | None:
    """Set up, measure or trace, check, read the metrics. Returns the
    result on rank 0, None elsewhere."""
    import torch

    args.torch_s = time.time() - args.start
    torch.set_num_threads(1)
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RunError("torch sees no CUDA device")
        if torch.cuda.device_count() < world:
            raise RunError(f"the cell needs {world} cards, torch sees "
                           f"{torch.cuda.device_count()}")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    group = None
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{args.port}",
                                rank=rank, world_size=world)
        group = dist.group.WORLD
    try:
        return _run_cell(args, spec, rank, world, device, group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_cell(args, spec, rank, world, device, group):
    import torch

    config = load_json("configs", spec["config"])
    traffic = load_json("traffic", spec["traffic"])
    if args.fault:
        from futbench import faults

        faults.plant(args.fault, traffic["kind"])
    loop = load_module("loops", traffic["kind"])
    cell = loop.Cell(config, traffic, Context(device, args.seed, rank, world, group))
    cell.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - args.start
    sync = _sync(group, device)
    trace, durations, window_s, failed = None, [], 0.0, 0
    if args.trace:
        from futbench.trace import traced_window

        trace = traced_window(cell.traced_call, traffic["trace_calls"], args.seconds,
                              sync, cuda)
        calls, window_s = trace.calls, trace.window_s
    else:
        durations, window_s, failed = timed_window(cell.call, args.seconds, sync)
        calls = len(durations)
    if forbidden_modules():
        raise RunError(f"the window loaded {forbidden_modules()}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    t_window = time.time()
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = cell.check(control=args.control)
    print(f"futbench: set-up {setup_s:.1f} s (to torch imported {args.torch_s:.1f}, "
          + ", ".join(f"{k} {v:.1f}" for k, v in cell.setup_parts.items())
          + f"), window {window_s:.1f} s, check {time.time() - t_window:.1f} s",
          file=sys.stderr)
    if durations:
        ms = sorted(1e3 * d for d in durations)
        print(f"futbench: {len(ms)} calls, ms min {ms[0]:.2f} median "
              f"{ms[len(ms) // 2]:.2f} max {ms[-1]:.2f}", file=sys.stderr)
    # what a metric reader reads
    run = SimpleNamespace(
        calls=calls, durations=durations, window_s=window_s, world=world,
        steps_per_call=cell.steps_per_call, setup_s=setup_s, trace=trace,
        work=cell.work(), power_limit=_power_limit(device))
    metrics = {}
    for m in spec["per_layer"] if args.trace else spec["e2e"]:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    mine = dict(checks=checks, peak=peak, failed=failed,
                busy_s=trace.busy_s if trace else None)
    everyone = [mine]
    if group is not None:
        import torch.distributed as dist

        everyone = [None] * world
        dist.all_gather_object(everyone, mine, group=group)
    if rank != 0:
        return None
    merged = {}
    for part in everyone:
        for name, value, limit in part["checks"]:
            merged[name] = (max(value, merged.get(name, (value,))[0]), limit)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": world,
           "memory_peak_bytes": max(p["peak"] for p in everyone)}
    if trace:
        dev["busy_s"] = sum(p["busy_s"] for p in everyone) / world
        dev["window_s"] = window_s
    if run.power_limit:
        dev["power_limit"] = run.power_limit
    result = {
        "correct": all(v <= lim for v, lim in merged.values())
        and not any(p["failed"] for p in everyone),
        "attempted": calls,
        "failed": sum(p["failed"] for p in everyone),
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in merged.items()}
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, argv: list[str], world: int) -> int:
    """Start one process per chip, wait for all, and pass rank 0's
    output on."""
    port = _free_port()
    base = [sys.executable, "-m", "futbench", *argv, "--port", str(port),
            "--world", str(world), "--start", repr(args.start)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                base + ["--rank", str(r)],
                stdout=subprocess.PIPE if r == 0 else sys.stderr,
                stderr=sys.stderr, text=True))
        out, _ = procs[0].communicate(timeout=RANK_TIMEOUT_S)
        codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        print("futbench: a rank did not end in time", file=sys.stderr)
        codes = [1]
        out = ""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"futbench: ranks exited {codes}", file=sys.stderr)
        return 1
    sys.stdout.write(out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m futbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the program's plain versions on the host "
                         "(the harness's tests)")
    # readings for the limits, never in a benchmark run: the control in
    # the program's place, or a fault planted in the program
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    # set by the launcher for the ranks of a cell on several chips
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--start", type=float, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None, start: float | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    args.start = args.start or start or time.time()
    root = os.getcwd()
    cache = os.path.join(root, "build", "futbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    try:
        spec = cell_spec(root, args.workload)
        world = args.world or spec["chips"]
        if world > 1 and args.rank is None:
            code = launch(args, argv, world)
            if code == 0 and forbidden_modules():
                print(f"futbench: loaded {forbidden_modules()}", file=sys.stderr)
                return 1
            return code
        result = run_rank(args, spec, args.rank or 0, world)
    except Exception:  # noqa: BLE001 - a run reports its failure and exits
        traceback.print_exc()
        return 1
    if forbidden_modules():
        print(f"futbench: loaded {forbidden_modules()}", file=sys.stderr)
        return 1
    if result is not None:
        for name, c in result["checks"].items():
            ok = "ok" if c["value"] <= c["limit"] else "NOT CORRECT"
            print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 0
