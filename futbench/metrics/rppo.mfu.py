"""rppo.mfu (%): the model FLOPs of the traced recurrent PPO iterations
(both views' LSTM actor-critic forward in the collect, the BPTT update's
forward and backward over its epochs; futbench.counts.ppo_model_flops
over futbench.counts_recurrent.lstm_dims), over the window's wall time
times the card's bf16 peak (989 TFLOP/s, at 700 W; the card's power
limit is the result's device.power_limit); nothing to read where the
trace holds no device work."""

from futbench.counts import BF16_PER_S


def read(run):
    if run.trace is None or not run.trace.kernels or "k5" not in run.work.get("bounds", {}):
        return None
    flops = run.work.get("model_flops")
    return 100.0 * flops * run.trace.calls / (run.trace.window_s * BF16_PER_S)
