"""The plain LSTM actor-critic, its unroll over a window and its
clipped-surrogate BPTT update, that the benchmark holds the program's
recurrent PPO iteration to.

Plain PyTorch under autograd, in float32, written from the published
description: stable-baselines 2.x ``MlpLstmPolicy`` (``LstmPolicy`` in
legacy mode: tanh dense layers, an LSTM, linear ``pi`` and ``vf`` heads
on its output) trained by PPO2 (Schulman et al. 2017, arXiv:1707.06347),
which minibatches recurrent policies over whole env sequences and
re-runs the LSTM over each from the state the window started with
(backpropagation through time). It imports nothing of the program; the
sampling, GAE and Adam are :mod:`futbench.reference.ppo`'s.

Weights are a list of leaves ``[Wt1, bt1, ..., Wtk, btk, Wi, Wh, bh,
Wl, bl, Wv, bv]``, each ``W`` ``[in, out]`` and ``b`` ``[out]``: the
torso, the cell's input and recurrent kernels with one bias, the logits
head of five-way groups and the value head.

Departures from the published description, each the program's:

* the cell's gates are ordered (i, f, g, o), stable-baselines' (i, f, o,
  g): a permutation of the kernels' columns, the same function;
* the cell has one bias (stable-baselines' ``b`` too) and no forget-gate
  bias;
* the carry is zeroed after a step whose episode ended, where
  stable-baselines multiplies it by the next step's mask: the same
  carry reaches the next step;
* the weights are drawn by the benchmark (lecun-normal, biases 0.01 x
  normal), not stable-baselines' orthogonal initialisation (scale
  sqrt(2) for the torso, 1 for the cell and the value head, 0.01 for the
  policy head);
* Adam's epsilon is 1e-8 (PPO2's 1e-5) and comes after the bias
  correction, as optax's.

``mode`` sets the precision of the torso's, the cell's and the logits
head's products: ``"bf16"`` rounds both operands to bfloat16 and sums in
float32 (the configuration's precision), ``"fp8"`` rounds them to float8
e4m3 (the control), ``"f32"`` rounds nothing. The gates, the carries and
the value head (on the unrounded h) stay float32 in every mode. Products
run in float32 with TF32 off: :func:`forward` and :func:`update` turn it
off (:func:`futbench.reference.ppo.no_tf32`).
"""

from __future__ import annotations

import torch

from . import ppo

_ROUND = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    return x.to(_ROUND[mode]).to(torch.float32)


def n_torso(w: list) -> int:
    """Torso layers of a leaf list (two leaves each; the cell three, the
    heads four)."""
    return (len(w) - 7) // 2


def torso(w: list, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The tanh torso on ``x`` ``[..., F]``."""
    t = x.float()
    for li in range(n_torso(w)):
        t = torch.tanh(_rounded(t, mode) @ _rounded(w[2 * li], mode) + w[2 * li + 1])
    return t


def cell(w: list, t: torch.Tensor, c: torch.Tensor, h: torch.Tensor, mode: str):
    """One LSTM step on the torso's output ``t`` ``[S, n_t]`` and the carry
    ``c``, ``h`` ``[S, H]``: the gates ``[t, h] @ [Wi; Wh] + bh``, one sum
    over both inputs; returns (c', h')."""
    k = 2 * n_torso(w)
    wi, wh, bh = w[k:k + 3]
    gates = (_rounded(torch.cat([t, h], -1), mode)
             @ _rounded(torch.cat([wi, wh]), mode) + bh)
    i, f, g, o = gates.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def heads(w: list, h: torch.Tensor, mode: str):
    """(logits ``[..., G*5]``, value ``[...]``) of the cell's output."""
    logits = _rounded(h, mode) @ _rounded(w[-4], mode) + w[-3]
    return logits, (h @ w[-2] + w[-1])[..., 0]


def forward(w: list, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor, mode: str):
    """One step of the actor-critic on ``x`` ``[S, F]`` and its carry:
    (logits, value, c', h')."""
    ppo.no_tf32()
    c, h = cell(w, torso(w, x, mode), c, h, mode)
    return (*heads(w, h, mode), c, h)


def unroll(w: list, obs: torch.Tensor, done: torch.Tensor, c: torch.Tensor,
           h: torch.Tensor, mode: str):
    """The actor-critic over a window, ``obs`` ``[T, S, F]``, from the
    carry ``c``, ``h`` ``[S, H]``, the carry zeroed after each step ``t``
    where ``done[t]`` ``[S]``: (logits ``[T, S, G*5]``, value ``[T, S]``)."""
    ts = torso(w, obs, mode)
    hs = []
    for t, d in zip(ts.unbind(0), done.unbind(0)):
        c, h = cell(w, t, c, h, mode)
        hs.append(h)
        keep = (1.0 - d.float())[:, None]
        c, h = c * keep, h * keep
    return heads(w, torch.stack(hs), mode)


def ppo_loss(w: list, seq: dict, cfg: dict, mode: str) -> torch.Tensor:
    """The clipped-surrogate loss of one minibatch of whole sequences,
    re-run from the carry they started the window with: ``seq`` holds
    ``obs`` ``[T, S, F]``, ``done``, ``logp``, ``value``, ``adv``, ``ret``
    ``[T, S]``, ``idx`` ``[T, S, G]``, ``c0``, ``h0`` ``[S, H]``.
    Advantages normalised over all T*S (population std + 1e-8), the
    policy term, the clipped value term, an entropy bonus."""
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
    """``epochs`` x ``minibatches`` steps over one window's ``S``
    sequences, each minibatch whole blocks of ``shuffle_block``
    consecutive sequences in each epoch's block permutation ``perms[e]``.
    ``buf`` holds :func:`ppo_loss`'s fields over every sequence, on the
    device the update runs on. Updates ``w`` in place; returns the mean
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
