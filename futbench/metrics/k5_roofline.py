"""k5_roofline (%): K5's least time for the whole recurrent collect
(futbench.counts_recurrent.k5_bound, at the active constraints of the
checked sample) over the device time of the collect kernel,
recurrent_tc_kernel (its float32 route recurrent_kernel), in the traced
window."""

PATTERN = r"^recurrent_(tc_)?kernel"


def read(run):
    bound = run.work.get("bounds", {}).get("k5")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
