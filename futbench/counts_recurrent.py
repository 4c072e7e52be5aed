"""Operations, bytes and least times of the recurrent learner's work, by
:mod:`futbench.counts`'s rules and peaks.

The LSTM actor-critic's products are listed as ``(in, out)`` pairs in
:func:`futbench.counts.mlp_dims`'s order, the cell as one product of its
input ``[t, h]`` (``n_t + H`` rows) to its four gates (``4H``) with one
bias: the torso, the cell, the logits head, the value head last. The
gates' sigmoid and tanh and the carries' updates are left out, as the
activations are, so every bound here is at most the true least time.
"""

from __future__ import annotations

from futbench import counts


def lstm_dims(obs: int, hidden, hsize: int, n_logits: int) -> list[tuple[int, int]]:
    """(in, out) of each product: the torso, the cell ``(n_t + H, 4H)``,
    the logits head, the value head last."""
    dims = [obs, *hidden]
    return [*zip(dims[:-1], dims[1:]), (dims[-1] + hsize, 4 * hsize),
            (hsize, n_logits), (hsize, 1)]


def k5_bound(ppt: int, dims, hsize: int, f_pad: int, n_envs: int, n_steps: int,
             shares: dict, substeps: int = 5, solver_iterations: int = 10):
    """K5's least ms for a whole collect: the state read and written and
    the weights read once, the ``[2, F_pad, T, B]`` obs buffer, its
    per-step rows (two action words, logp, value, reward, done) and the
    bootstrap values written once, both views' carries c and h ``[2, H,
    B]`` read and written once; the operations of
    :func:`futbench.counts.k2_ops` over :func:`lstm_dims`: the env step
    at ``shares``, both views' torso, cell and logits head on the tensor
    cores, the biases and the value head in float32."""
    ops_all, ops_bf16 = counts.k2_ops(ppt, dims, shares, substeps, solver_iterations)
    weight_bytes = 4 * sum(a * b + b for a, b in dims)
    carry_bytes = 2 * 4 * 2 * 2 * hsize * n_envs
    n_bytes = (2 * counts.state_bytes(ppt, n_envs) + weight_bytes + carry_bytes
               + 4 * 2 * n_envs * (f_pad * n_steps + 6 * n_steps + 1))
    work = n_envs * n_steps
    return counts.bound(n_bytes, work * (ops_all - ops_bf16), work * ops_bf16)
