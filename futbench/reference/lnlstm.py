"""The layer-normalised LSTM actor-critic, its unroll over a window and its
clipped-surrogate BPTT update, that the benchmark holds the program's
``MlpLnLstmPolicy`` iteration to.

Plain PyTorch under autograd, in float32, written from the published
description: stable-baselines 2.x ``MlpLnLstmPolicy`` (``LstmPolicy`` with
``layer_norm=True``: tanh dense layers, ``tf_layers.lstm(...,
layer_norm=True)``, linear ``pi`` and ``vf`` heads on its output) trained
by PPO2. The cell, from ``tf_layers.lstm`` and ``_ln(x, g, b, eps=1e-5,
axes=[1])``::

    gates = LN(t Wi; gx, bx) + LN(h Wh; gh, bh) + b     # LN over the 4H row
    c' = sigmoid(f) c + sigmoid(i) tanh(g)
    h' = sigmoid(o) tanh(LN(c'; gc, bc))                # LN over the H units
    LN(y; g, b) = (y - mean(y)) / sqrt(var(y) + 1e-5) * g + b   # population var

It imports nothing of the program; the torso, the heads, the sampling,
GAE and Adam are :mod:`futbench.reference.recurrent`'s and
:mod:`futbench.reference.ppo`'s.

Weights are :mod:`futbench.reference.recurrent`'s leaves followed by the
six LayerNorm leaves ``[..., Wl, bl, Wv, bv, gx, bx, gh, bh, gc, bc]``:
``gx, bx, gh, bh`` ``[4H]``, ``gc, bc`` ``[H]``, the three biases ``b``
(the cell's), ``bx`` and ``bh`` kept apart (Adam steps each).

Departures from the published description, each the program's, besides
:mod:`futbench.reference.recurrent`'s (the carry zeroed after an
episode's last step, Adam's epsilon, the benchmark's initialisation):

* the gates are ordered (i, f, g, o), stable-baselines' (i, f, o, g),
  with the columns of ``Wi``, ``Wh``, ``b`` and the gains and biases
  ``gx, bx, gh, bh`` permuted alike: LayerNorm's statistics over the whole
  row do not depend on the columns' order, so it is the same function;
* the LayerNorm leaves are drawn by the benchmark (gains 1 + 0.1 x
  normal, biases 0.01 x normal), where stable-baselines starts them at 1
  and 0.

``mode`` sets the precision of the products as
:mod:`futbench.reference.recurrent`'s does; LayerNorm (statistics,
normalisation, gains and biases), the gates, the carries and the value
head stay float32 in every mode.
"""

from __future__ import annotations

import torch

from . import ppo
from . import recurrent as rec

EPS = 1e-5
N_LN = 6        # gx, bx, gh, bh, gc, bc


def plain(w: list) -> list:
    """The leaves :mod:`futbench.reference.recurrent` reads (the torso, the
    cell's kernels and bias, the heads)."""
    return w[:-N_LN]


def layer_norm(y: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_ln``: over the last axis, population variance, eps inside the
    square root."""
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) / torch.sqrt(var + EPS) * g + b


def cell(w: list, t: torch.Tensor, c: torch.Tensor, h: torch.Tensor, mode: str):
    """One layer-normalised LSTM step on the torso's output ``t`` ``[S,
    n_t]`` and the carry ``c``, ``h`` ``[S, H]``; returns (c', h')."""
    k = 2 * rec.n_torso(plain(w))
    wi, wh, b = w[k:k + 3]
    gx, bx, gh, bh, gc, bc = w[-N_LN:]
    gates = (layer_norm(rec._rounded(t, mode) @ rec._rounded(wi, mode), gx, bx)
             + layer_norm(rec._rounded(h, mode) @ rec._rounded(wh, mode), gh, bh) + b)
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(layer_norm(c, gc, bc))


def forward(w: list, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor, mode: str):
    """One step of the actor-critic on ``x`` ``[S, F]`` and its carry:
    (logits, value, c', h')."""
    ppo.no_tf32()
    c, h = cell(w, rec.torso(plain(w), x, mode), c, h, mode)
    return (*rec.heads(plain(w), h, mode), c, h)


def unroll(w: list, obs: torch.Tensor, done: torch.Tensor, c: torch.Tensor,
           h: torch.Tensor, mode: str):
    """The actor-critic over a window, as
    :func:`futbench.reference.recurrent.unroll`: (logits ``[T, S, G*5]``,
    value ``[T, S]``)."""
    ts = rec.torso(plain(w), obs, mode)
    hs = []
    for t, d in zip(ts.unbind(0), done.unbind(0)):
        c, h = cell(w, t, c, h, mode)
        hs.append(h)
        keep = (1.0 - d.float())[:, None]
        c, h = c * keep, h * keep
    return rec.heads(plain(w), torch.stack(hs), mode)


def ppo_loss(w: list, seq: dict, cfg: dict, mode: str) -> torch.Tensor:
    """PPO2's clipped-surrogate loss of one minibatch of whole sequences,
    as :func:`futbench.reference.recurrent.ppo_loss`, on this cell."""
    logits, value = unroll(w, seq["obs"], seq["done"], seq["c0"], seq["h0"], mode)
    logp, entropy = ppo.logp_entropy(logits, seq["idx"])
    ratio = torch.exp(logp - seq["logp"])
    adv = seq["adv"]
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = cfg["clip_eps"]
    pg = -torch.minimum(ratio * adv_n, torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n).mean()
    v_old, ret = seq["value"], seq["ret"]
    v_clip = v_old + torch.clamp(value - v_old, -eps, eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
    return pg + cfg["vf_coef"] * v_loss - cfg["ent_coef"] * entropy.mean()


def update(w: list, opt: ppo.Adam, buf: dict, perms: torch.Tensor, cfg: dict,
           mode: str) -> float:
    """The BPTT update of :func:`futbench.reference.recurrent.update` on
    this cell's :func:`ppo_loss`. Updates ``w`` in place; returns the mean
    loss."""
    ppo.no_tf32()
    s = buf["logp"].shape[1]
    block = cfg["shuffle_block"]
    mb_blocks = s // block // cfg["minibatches"]
    losses = []
    for perm in perms:
        for mb in perm[: cfg["minibatches"] * mb_blocks].reshape(cfg["minibatches"], mb_blocks):
            cols = (mb[:, None] * block + torch.arange(block, device=mb.device)).reshape(-1)
            seq = {k: (v[cols] if k in ("c0", "h0") else v[:, cols]) for k, v in buf.items()}
            leaves = [x.detach().requires_grad_(True) for x in w]
            loss = ppo_loss(leaves, seq, cfg, mode)
            grads = torch.autograd.grad(loss, leaves)
            opt.step(w, list(grads))
            losses.append(loss.detach())
    return torch.stack(losses).mean().item()
