"""Timing and tracing helpers.

Counterpart of :mod:`gym_futbol_tpu.utils.profiling`: a wall clock that
waits for the device, a ``torch.profiler`` trace, and the program's
named spans (:func:`span`, :func:`spanned`), which the profiler records
while it runs and which cost one check while it does not. The JAX package's
``cost_analysis`` (XLA's compiled FLOP and byte estimates) has no
counterpart: the kernels' operations and bytes are counted by hand from
their shapes (``chip_smoke.py``'s ``env_step_ops`` and ``mlp_ops``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Iterator

import torch


def _cuda_devices(x: Any) -> set[torch.device]:
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, (torch.device, str)):
        d = torch.device(x)
        return {d} if d.type == "cuda" else set()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


@contextlib.contextmanager
def timed(label: str = "", sync: Any = None) -> Iterator[dict]:
    """Wall-clock a block: yields ``{"label", "seconds"}``, ``seconds``
    set on exit. ``sync`` (a tensor, a device, or a list, tuple or dict
    of them) names the devices to synchronise before the clock stops, so
    that the work the block queued on a card is included."""
    box = {"label": label, "seconds": None}
    t0 = time.perf_counter()
    yield box
    for device in _cuda_devices(sync):
        torch.cuda.synchronize(device)
    box["seconds"] = time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (host operations, and the
    card's kernels when there is one) and write it as a Chrome trace,
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NoSpan:
    """What :func:`span` returns while no profiler runs: enters and
    leaves doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A named range of the program: ``torch.profiler.record_function``
    while a profiler runs, which records it on the profiler's clock (the
    kernels it launches are drawn on the device's timeline beside it, and
    a span opened inside another is its child), else :data:`NO_SPAN`."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN


def spanned(name: str):
    """Decorator: each call of the function is one :func:`span` ``name``,
    from entry to return."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
