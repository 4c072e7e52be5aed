"""Recurrent (LSTM) actor-critic for FutbolEnv.

Counterpart of :mod:`gym_futbol_tpu.models.recurrent`: a tanh MLP torso,
an LSTM cell carried across env steps (zeroed where ``done``), and the
flat-logits categorical heads and value head of
:mod:`gym_futbol_tpu_torch.models.policy`.

The cell is flax's ``OptimizedLSTMCell``: gates in (i, f, g, o) order,
input kernels without bias, recurrent kernels with one bias,
``c' = sigmoid(f) * c + sigmoid(i) * tanh(g)``,
``h' = sigmoid(o) * tanh(c')``, no forget-gate bias. It is written out
over two ``nn.Linear`` layers (``nn.LSTMCell`` carries two biases and
initialises otherwise), initialised as flax initialises: truncated
lecun-normal input kernels, an orthogonal ``[H, H]`` recurrent kernel
per gate, zero biases.

With ``layer_norm=True`` the cell is stable-baselines 2.x's
layer-normalised LSTM (``tf_layers.lstm(..., layer_norm=True)``, the cell
of ``MlpLnLstmPolicy``): each product normalised over its whole 4H row
before the one bias, and c' over its H units before the tanh,
``gates = LN(t Wi; gx, bx) + LN(h Wh; gh, bh) + b``,
``h' = sigmoid(o) * tanh(LN(c'; gc, bc))``, ``LN(y) = (y - mean(y)) /
sqrt(var(y) + 1e-5) * g + b`` (population variance; ``nn.LayerNorm``).
Its six leaves are three ``nn.LayerNorm`` modules after the heads,
``ln_i``, ``ln_h`` (4H, gates in the cell's order) and ``ln_c`` (H),
gains 1 and biases 0 as stable-baselines starts them; ``b`` stays
``cell_h.bias``. The plain cell's leaves, their order and their
initialisation are the same in both.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..types import EnvParams
from .policy import _TRUNC_STD, N_CHOICES

GATES = "ifgo"   # flax OptimizedLSTMCell gate order
LN_EPS = 1e-5    # stable-baselines' tf_layers._ln


def lstm_cell(gates: torch.Tensor, c: torch.Tensor, dim: int = -1,
              sigmoid=torch.sigmoid):
    """flax's cell from the pre-activations ``gates`` (i, f, g, o blocks of
    H along ``dim``) and ``c`` (H along ``dim``): (c', h')."""
    i, f, g, o = gates.chunk(4, dim)
    c_new = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    return c_new, sigmoid(o) * torch.tanh(c_new)


class RecurrentActorCritic(nn.Module):
    """MLP torso -> LSTM cell -> flat categorical heads + value head.

    ``forward(carry, obs [B, obs_dim]) -> (carry', (logits [B,
    n_players*2*5], value [B]))`` with ``carry = (c, h)``, each ``[B,
    lstm_size]``; :meth:`initial_carry` is the zero state. Initialised as
    flax initialises (module docstring), from ``generator`` when given.
    ``layer_norm``: the layer-normalised cell (module docstring).
    """

    def __init__(self, n_players: int, obs_dim: int,
                 hidden: Sequence[int] = (128,), lstm_size: int = 128,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cuda", layer_norm: bool = False):
        super().__init__()
        self.n_players = n_players
        self.obs_dim = obs_dim
        self.hidden = tuple(hidden)
        self.lstm_size = lstm_size
        dims = [obs_dim, *self.hidden]
        self.torso = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(len(self.hidden)))
        # flax's i{g} kernels (no bias) and h{g} kernels with their biases,
        # each with the four gates' blocks stacked on the output axis
        self.cell_i = nn.Linear(dims[-1], 4 * lstm_size, bias=False,
                                device=device)
        self.cell_h = nn.Linear(lstm_size, 4 * lstm_size, device=device)
        self.logits = nn.Linear(lstm_size, n_players * 2 * N_CHOICES,
                                device=device)
        self.value = nn.Linear(lstm_size, 1, device=device)
        self.layer_norm = layer_norm
        if layer_norm:
            self.ln_i = nn.LayerNorm(4 * lstm_size, eps=LN_EPS, device=device)
            self.ln_h = nn.LayerNorm(4 * lstm_size, eps=LN_EPS, device=device)
            self.ln_c = nn.LayerNorm(lstm_size, eps=LN_EPS, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in (*self.torso, self.cell_i, self.logits, self.value):
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)
        for block in self.cell_h.weight.chunk(4, 0):
            nn.init.orthogonal_(block, generator=generator)
        nn.init.zeros_(self.cell_h.bias)
        for ln in self.layer_norms():
            ln.reset_parameters()

    def layer_norms(self) -> tuple:
        """``(ln_i, ln_h, ln_c)`` of the layer-normalised cell, else ()."""
        return (self.ln_i, self.ln_h, self.ln_c) if self.layer_norm else ()

    def _cell(self, x_in: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
        """One step from the input side of the gates ``x_in`` (``cell_i(t)``,
        or ``ln_i(cell_i(t)) + b`` with LayerNorm): (c', h')."""
        if not self.layer_norm:
            return lstm_cell(self.cell_h(h) + x_in, c)
        i, f, g, o = (self.ln_h(F.linear(h, self.cell_h.weight)) + x_in).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(self.ln_c(c))

    def _input_side(self, t: torch.Tensor) -> torch.Tensor:
        x = self.cell_i(t)
        return self.ln_i(x) + self.cell_h.bias if self.layer_norm else x

    def initial_carry(self, batch_size: int):
        z = torch.zeros((batch_size, self.lstm_size),
                        device=self.logits.weight.device)
        return (z, z.clone())

    def _torso(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.logits.weight.dtype)
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return x

    def _heads(self, h: torch.Tensor):
        return self.logits(h), self.value(h).squeeze(-1)

    def forward(self, carry, obs: torch.Tensor):
        c, h = carry
        c, h = self._cell(self._input_side(self._torso(obs)), c, h)
        return (c, h), self._heads(h)

    def unroll(self, carry, obs: torch.Tensor, done: torch.Tensor,
               compute_dtype=None):
        """:meth:`forward` over a window: ``obs`` ``[T, S, obs_dim]``, the
        carry zeroed after step t where ``done[t]`` ``[S]``. The torso and
        the input kernels run once over all T steps (they do not depend
        on the carry). Returns (carry after the window, (logits ``[T, S,
        G*5]``, value ``[T, S]``)).

        ``compute_dtype`` None or float32: the cell step by step under
        autograd. bfloat16: the recurrence forward and backward in K6
        (:func:`gym_futbol_tpu_torch.ops.fused_bptt.fused_lstm_bptt`: the
        kernels on a CUDA tensor, their plain version on the CPU), its
        products on the tensor cores from bf16 operand pairs (hi + lo)
        held to float32's result; the torso and the heads in float32 as
        on the other route; the carry returned carries no gradient. With
        LayerNorm, K6's LayerNorm instantiation
        (:func:`~gym_futbol_tpu_torch.ops.fused_bptt.fused_lnlstm_bptt`)."""
        if compute_dtype == torch.bfloat16:
            from ..ops.fused_bptt import fused_lnlstm_bptt, fused_lstm_bptt

            args = (self._torso(obs), self.cell_i.weight, self.cell_h.weight,
                    self.cell_h.bias)
            if self.layer_norm:
                h_all, carry = fused_lnlstm_bptt(
                    *args, [p for ln in self.layer_norms() for p in (ln.weight, ln.bias)],
                    carry, done)
            else:
                h_all, carry = fused_lstm_bptt(*args, carry, done)
            return carry, self._heads(h_all)
        if compute_dtype not in (None, torch.float32):
            raise ValueError("compute_dtype must be None, torch.float32 or "
                             "torch.bfloat16")
        x_in = self._input_side(self._torso(obs))
        keep = (1.0 - done.to(x_in.dtype))[..., None]
        hs = []
        c, h = carry
        # unbind, not x_in[t]: each step's backward is then a slice of one
        # stack, not a zero-filled copy of the whole window
        for x_t, keep_t in zip(x_in.unbind(0), keep):
            c, h = self._cell(x_t, c, h)
            hs.append(h)
            c, h = c * keep_t, h * keep_t
        return (c, h), self._heads(torch.stack(hs))


def reset_carry_where_done(carry, done: torch.Tensor):
    """Zero the LSTM state of finished episodes (``done`` ``[B]``)."""
    mask = (1.0 - done.to(carry[0].dtype))[:, None]
    return tuple(c * mask for c in carry)


def init_recurrent_params(generator: torch.Generator,
                          model: RecurrentActorCritic,
                          env_params: EnvParams) -> RecurrentActorCritic:
    """(Re)initialise ``model`` from ``generator`` for ``env_params``'s
    observation; returns it."""
    from ..env import obs_size

    if model.obs_dim != obs_size(env_params):
        raise ValueError(f"model.obs_dim={model.obs_dim} but the env's "
                         f"observation has {obs_size(env_params)} features")
    model.reset_parameters(generator)
    return model


@torch.no_grad()
def recurrent_rollout(model: RecurrentActorCritic, env_state, obs: torch.Tensor,
                      carry, generator: torch.Generator, env_params: EnvParams,
                      n_steps: int):
    """``n_steps`` steps of ``model`` controlling every player of the
    batch (the obs ``[B, obs_dim]`` are the world's, as
    :func:`gym_futbol_tpu_torch.vector.step_batch` returns them), the
    carry zeroed at episode ends. Action draws and the env's noise come
    from ``generator``. Returns (env_state, obs, carry, (value, logp,
    reward, done) stacked ``[T, B]``)."""
    from ..vector import step_batch
    from .policy import sample_actions

    ys = []
    for _ in range(n_steps):
        carry, (logits, value) = model(carry, obs)
        actions, logp = sample_actions(logits, generator=generator)
        env_state, out = step_batch(env_state, actions, env_params, generator)
        carry = reset_carry_where_done(carry, out.done)
        obs = out.obs
        ys.append((value, logp, out.reward, out.done))
    return env_state, obs, carry, tuple(torch.stack(y) for y in zip(*ys))
