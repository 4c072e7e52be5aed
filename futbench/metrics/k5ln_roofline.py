"""k5ln_roofline (%): K5's LayerNorm instantiation's least time for the
whole recurrent collect (futbench.counts_lnlstm.k5ln_bound, at the active
constraints of the checked sample) over the device time of its kernel,
recurrent_ln_tc_kernel, in the traced window; nothing to read where the
trace holds no such kernel."""

PATTERN = r"^recurrent_ln_tc_kernel"


def read(run):
    bound = run.work.get("bounds", {}).get("k5ln")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
