"""call_ms.p95 (ms): the 95th percentile of the wall time of every call
in the measured window, each from its launch until its result is on the
host (host clock)."""

import statistics


def read(run):
    if run.trace is not None or len(run.durations) < 20:
        return None
    return statistics.quantiles(run.durations, n=20)[18] * 1e3
