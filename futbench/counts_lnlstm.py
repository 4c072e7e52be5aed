"""Operations, bytes and least times of the layer-normalised LSTM
learner's kernels (stable-baselines' ``MlpLnLstmPolicy`` cell), by
:mod:`futbench.counts`'s rules and peaks.

LayerNorm adds no product: the model's products are
:func:`futbench.counts_recurrent.lstm_dims`'s. It adds, per row it
normalises, element-wise float32 work, counted here at 8 operations an
element: the sum and the sum of squares (2 each), then the centring, the
scaling, the gain and the bias (1 each); and for its backward 10: the
two row sums of the incoming gradient (3), then the centring, the
scaling and the gain again (4), and the gains' and biases' gradients (3).
A cell step normalises two rows of 4H (``t Wi`` and ``h Wh``) and one of
H (c'). A LayerNorm needs no bytes of its own that a design must move:
its statistics fit on the chip beside the row they describe.
"""

from __future__ import annotations

from futbench import counts, counts_recurrent

LN_FWD_OPS = 8      # per element a LayerNorm forward normalises
LN_BWD_OPS = 10     # per element of its backward


def ln_ops(hsize: int, backward: bool = False) -> int:
    """Float32 operations of one cell step's three LayerNorms (4H, 4H and
    H elements), forward, or forward and backward."""
    n = 9 * hsize
    return n * (LN_FWD_OPS + (LN_BWD_OPS if backward else 0))


def k5ln_bound(ppt: int, dims, hsize: int, f_pad: int, n_envs: int, n_steps: int,
               shares: dict, substeps: int = 5, solver_iterations: int = 10):
    """K5's LayerNorm instantiation's least ms for a whole collect:
    :func:`futbench.counts_recurrent.k5_bound`'s bytes and operations,
    and both views' LayerNorms each step (:func:`ln_ops`) in float32."""
    ops_all, ops_bf16 = counts.k2_ops(ppt, dims, shares, substeps, solver_iterations)
    ops_all += 2 * ln_ops(hsize)
    weight_bytes = 4 * sum(a * b + b for a, b in dims)
    carry_bytes = 2 * 4 * 2 * 2 * hsize * n_envs
    n_bytes = (2 * counts.state_bytes(ppt, n_envs) + weight_bytes + carry_bytes
               + 4 * 2 * n_envs * (f_pad * n_steps + 6 * n_steps + 1))
    work = n_envs * n_steps
    return counts.bound(n_bytes, work * (ops_all - ops_bf16), work * ops_bf16)


def k6ln_bound(hsize: int, n_seq: int, n_steps: int, n_minibatches: int):
    """The LayerNorm BPTT kernels' least ms over ``n_minibatches``
    minibatches of ``n_seq`` sequences over ``n_steps`` steps: the
    recurrence's products ``h_{t-1} Wh`` forward and ``dy_t Wh^T``
    backward, 2 S T H 4H operations each, three bf16 products each (hi +
    lo terms, as K6 counts them); the recurrent LayerNorms (``h Wh``'s and
    c''s) forward and backward in float32; and the kernels' own inputs and
    outputs, f32 but dy (two bf16 terms): the gates' input side (4H) read,
    every h written (H), the heads' dh read (H), dy (4H), the gates'
    pre-activation gradients (4H) and LN(c')'s output's gradients (H)
    written. Their saved state (the gates, c', y = h Wh, the statistics)
    is the design's, as K6's bound leaves out its own."""
    rows = n_seq * n_steps * n_minibatches
    bf16_ops = rows * 3 * 2 * (2 * hsize * 4 * hsize)
    f32_ops = rows * 5 * hsize * (LN_FWD_OPS + LN_BWD_OPS)
    n_bytes = rows * 4 * (4 * hsize + hsize + hsize + 4 * hsize + 4 * hsize + hsize)
    return counts.bound(n_bytes, f32_ops, bf16_ops)


def work(ppt: int, obs: int, hidden, hsize: int, n_logits: int, f_pad: int, n_envs: int,
         n_steps: int, shares: dict, cfg: dict, substeps: int = 5,
         solver_iterations: int = 10) -> dict:
    """What the LayerNorm cell's metric readers read: each kernel's least
    ms for one iteration (``k5ln``: the collect; ``k6ln``: the update's
    ``epochs`` x ``minibatches`` minibatches of ``2 B / minibatches``
    sequences) and the iteration's model FLOPs
    (:func:`futbench.counts.ppo_model_flops`: LayerNorm's element-wise
    work left out, as the activations are)."""
    dims = counts_recurrent.lstm_dims(obs, hidden, hsize, n_logits)
    n_mb = cfg["epochs"] * cfg["minibatches"]
    return {
        "bounds": {
            "k5ln": k5ln_bound(ppt, dims, hsize, f_pad, n_envs, n_steps, shares, substeps,
                               solver_iterations),
            "k6ln": k6ln_bound(hsize, 2 * n_envs // cfg["minibatches"], n_steps, n_mb)},
        "shares": shares,
        "model_flops": counts.ppo_model_flops(dims, 2 * n_envs * n_steps, cfg["epochs"]),
    }
