"""device.idle (%): the share of the traced window's wall time in which
no operation ran on the card (1 minus the union of the device's busy
intervals over the window; on several chips, rank 0's)."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
