"""The device trace of a traced window: what ran on the card and when.

One ``torch.profiler`` session (host and CUDA activity) around the
traced calls. From its events this module keeps the device's kernels
(name, start, end in microseconds on the profiler's clock), the host's
spans and ops, and reduces them to the numbers the per-layer readers
and the result's ``device`` and ``breakdown`` take: the union of the
device's busy intervals (kernels on several streams overlap; the union
counts each instant once), the kernels' device time by name, and the
idle gaps between busy intervals, each named by the innermost host
span or op that held the host at the gap's middle.
"""

from __future__ import annotations

import re
import time


def _clean(name: str) -> str:
    name = re.sub(r"\([^()]*\)$", "", name)
    return name.replace("(anonymous namespace)::", "").replace("void ", "")[:80]


class Trace:
    """What a traced window saw: the device's kernels, copies and fills
    (not the host's spans that the profiler also draws on the device's
    timeline), and the host's events."""

    def __init__(self, kernels, host, window_s: float, calls: int):
        self.kernels = kernels          # [(name, start_us, end_us)]
        self.host = host                # [(name, start_us, end_us)]
        self.window_s = window_s
        self.calls = calls
        self.busy = _union([(s, e) for _, s, e in kernels])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) / 1e6

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.kernels if rx.search(n))

    def device_ops(self, top: int = 10) -> list:
        per: dict = {}
        for n, s, e in self.kernels:
            per[n] = per.get(n, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in per.items()), key=lambda r: -r[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time between busy intervals, summed by what the
        host was doing at each gap's middle: the innermost benchmark span
        or PyTorch op open then (else the innermost host event)."""
        gaps = sorted(((e0 + s1) / 2, s1 - e0) for (_, e0), (s1, _)
                      in zip(self.busy, self.busy[1:]))
        host = sorted(self.host, key=lambda h: h[1])
        per: dict = {}
        active, i = [], 0
        for mid, length in gaps:
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[2] >= mid]
            named = [h for h in active if h[0].startswith(("futbench.", "aten::"))]
            pick = min(named or active, key=lambda h: h[2] - h[1], default=None)
            key = pick[0] if pick else "(no host event)"
            per[key] = per.get(key, 0.0) + length / 1e6
        return sorted(([k, v] for k, v in per.items()), key=lambda r: -r[1])[:top]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def traced_window(call, n_calls: int, seconds: float, sync, cuda: bool) -> Trace:
    """Run ``call`` under the profiler ``n_calls`` times, or until
    ``seconds`` have passed (``sync(stop) -> bool`` decides, the same on
    every rank); returns the :class:`Trace`. ``cuda`` False (a CPU run of
    the harness's tests) traces the host alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    calls = 0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        while True:
            with record_function("futbench.call"):
                call()
            calls += 1
            if sync(calls >= n_calls or time.perf_counter() - t0 >= seconds):
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a host span projected onto the device's timeline is no work
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(
                    "futbench."):
                kernels.append((_clean(e.name), *rng))
        else:
            host.append((e.name, *rng))
    return Trace(kernels, host, window_s, calls)
