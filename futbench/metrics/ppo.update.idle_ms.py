"""ppo.update.idle_ms (ms): device-idle time per PPO iteration while the
host was inside the program's ``ppo.update`` span (``ppo.train_iteration``'s
update, around ``update_fn``), on rank 0; nothing to read where the
program draws no such span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "ppo.update")
    return None if s is None else s * 1e3 / run.trace.calls
