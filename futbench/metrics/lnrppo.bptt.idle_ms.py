"""lnrppo.bptt.idle_ms (ms): device-idle time per recurrent PPO iteration
while the host was inside the program's ``ops.fused_lnlstm_bptt`` span
(the layer-normalised LSTM's BPTT autograd node, forward and backward:
the LayerNorm work outside the kernels and the kernels); nothing to read
where the program draws no such span."""

from futbench.spans import idle_s


def read(run):
    s = idle_s(run.trace, "ops.fused_lnlstm_bptt")
    return None if s is None else s * 1e3 / run.trace.calls
