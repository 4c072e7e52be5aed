"""ppo.mfu (%): the model FLOPs of the traced PPO iterations (both
views' policy forward in the collect, the update's forward and backward
over its epochs; futbench.counts.ppo_model_flops) on every rank, over
the window's wall time times the chips' bf16 peak (989 TFLOP/s each, at
700 W; the card's power limit is the result's device.power_limit)."""

from futbench.counts import BF16_PER_S


def read(run):
    flops = run.work.get("model_flops")
    if run.trace is None or flops is None:
        return None
    return 100.0 * flops * run.trace.calls / (run.trace.window_s * BF16_PER_S)
