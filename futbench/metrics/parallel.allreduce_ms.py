"""parallel.allreduce_ms (ms): device time of the NCCL kernels (the
gradient and metric all-reduces of each minibatch) per PPO iteration on
rank 0; nothing to read on one chip."""

PATTERN = r"(?i)nccl"


def read(run):
    if run.trace is None or run.world < 2:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return device_s * 1e3 / run.trace.calls
