"""rppo.launches_per_iter (launches): the device kernels of the traced
window (the port's and PyTorch's alike; copies and fills left out) per
recurrent PPO iteration."""

PATTERN = r"^(?!Memcpy|Memset)"


def read(run):
    if run.trace is None or not run.trace.kernels or "k5" not in run.work.get("bounds", {}):
        return None
    return run.trace.kernel_count(PATTERN) / run.trace.calls
