"""k6ln_roofline (%): the LayerNorm BPTT kernels' least time for one
iteration's update (futbench.counts_lnlstm.k6ln_bound: the recurrence's
products, three bf16 products each, its LayerNorms and the kernels' own
bytes, over every minibatch) over the device time of the kernels whose
name starts bptt_ln_ (bptt_ln_forward_kernel, bptt_ln_backward_kernel) in
the traced window; nothing to read where the trace holds none."""

PATTERN = r"^bptt_ln_"


def read(run):
    bound = run.work.get("bounds", {}).get("k6ln")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
