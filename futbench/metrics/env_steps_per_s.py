"""env_steps_per_s (steps/s): the env-steps of every call completed in
the measured window, summed over the ranks, over the window's seconds
(host clock, from the first call's launch to the last call's result)."""


def read(run):
    if run.trace is not None or not run.calls:
        return None
    return run.calls * run.steps_per_call * run.world / run.window_s
