"""rppo.gae.idle_ms (ms): device-idle time per recurrent PPO iteration
while the host was inside the program's ``rppo.gae`` span
(``recurrent_ppo.train_iteration_recurrent_ppo``'s GAE, around
``compute_gae``); nothing to read where the program draws no such span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "rppo.gae")
    return None if s is None else s * 1e3 / run.trace.calls
