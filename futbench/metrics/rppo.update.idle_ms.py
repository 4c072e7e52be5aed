"""rppo.update.idle_ms (ms): device-idle time per recurrent PPO iteration
while the host was inside the program's ``rppo.update`` span
(``recurrent_ppo.train_iteration_recurrent_ppo``'s update, around
``update_fn``); nothing to read where the program draws no such span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "rppo.update")
    return None if s is None else s * 1e3 / run.trace.calls
