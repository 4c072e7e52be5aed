"""k1a_roofline (%): K1a's least time (futbench.counts.k1a_bound, at
the active constraints of the checked sample) over the device time of
its kernel, random_rollout_kernel, in the traced window."""

PATTERN = r"random_rollout_kernel"


def read(run):
    bound = run.work.get("bounds", {}).get("k1a")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
