"""ppo.collect.idle_ms (ms): device-idle time per PPO iteration while the
host was inside the program's ``ppo.collect`` span (``ppo.train_iteration``'s
collect, around ``collect_fn``), on rank 0; nothing to read where the
program draws no such span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "ppo.collect")
    return None if s is None else s * 1e3 / run.trace.calls
