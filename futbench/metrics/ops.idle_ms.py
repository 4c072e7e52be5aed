"""ops.idle_ms (ms): device-idle time per call of the cell while the
host was inside one of the program's kernel wrappers (its ``ops.<name>``
spans: ``ops.fused_rollout``, ``ops.fused_collect``,
``ops.fused_minibatch_grad``, ...), on rank 0: the wrappers' own host
work between launches; nothing to read where the program draws no such
span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "ops.")
    return None if s is None else s * 1e3 / run.trace.calls
