"""k3_roofline (%): K3's least time for an iteration's minibatch
gradients (futbench.counts.k3_bound, once per minibatch) over the device
time of K3's kernels (round_obs_kernel, tc_forward_kernel,
tc_backward_kernel) in the traced window."""

PATTERN = r"^(round_obs_kernel|tc_forward_kernel|tc_backward_kernel)"


def read(run):
    bound = run.work.get("bounds", {}).get("k3")
    if run.trace is None or bound is None:
        return None
    device_s = run.trace.kernel_s(PATTERN)
    if device_s <= 0:
        return None
    return 100.0 * bound[0] * 1e-3 * run.trace.calls / device_s
