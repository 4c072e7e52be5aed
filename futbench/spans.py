"""Device-idle time inside the program's own spans.

The program names its stages and kernel wrappers with
``torch.profiler.record_function`` ranges while a profiler runs
(``ppo.collect``, ``ppo.gae``, ``ppo.update``; ``ops.<wrapper>``). They
come back among a traced window's host events, on the same clock as the
device's kernels, so the device's idle time can be charged to the stage
the host was in. Nothing of the program is imported here.
"""

from __future__ import annotations

from futbench.trace import _union


def idle_s(trace, prefix: str) -> float | None:
    """Seconds of the traced window in which the host was inside a span
    whose name starts with ``prefix`` and no kernel, copy or fill ran on
    the device: the union of those spans' intervals less the part the
    device's busy intervals cover. None without a trace, without device
    work, or without such a span (a program that draws none)."""
    if trace is None or not trace.kernels:
        return None
    spans = _union([(s, e) for name, s, e in trace.host if name.startswith(prefix)])
    if not spans:
        return None
    busy, j, covered = trace.busy, 0, 0.0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return (sum(e - s for s, e in spans) - covered) / 1e6
