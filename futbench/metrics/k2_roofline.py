"""k2_roofline (%): K2's least time for the whole collect
(futbench.counts.k2_bound, at the active constraints of the checked
sample) over the device time of the collect kernel, collect_tc_kernel
(its float32 route collect_kernel), in the traced window."""

PATTERN = r"^collect_(tc_)?kernel"


def read(run):
    bound = run.work.get("bounds", {}).get("k2")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
