"""Actor-critic policy network for FutbolEnv, and its categorical math.

Counterpart of :mod:`gym_futbol_tpu.models.policy`: one shared tanh
torso, a flat logits head of ``G*5`` logits (``G = n_players*2`` groups,
player-major then slot: group ``2*p`` is player p's direction, ``2*p+1``
its act) and a value head.

The categorical math runs in ROW form, as the JAX package's does: the
flat logits are moved once to ``[G*5, ..]`` and every distribution is
five ``[..]`` rows, so the sampling order and arithmetic are the fused
kernels' (:mod:`gym_futbol_tpu_torch.ops.fused_collect`). Actions cross
the trajectory buffer bit-packed, 3 bits per player in one int32 word
per slot.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..types import EnvParams

N_CHOICES = 5  # both action slots are 5-way categoricals (ACTION SPEC)

# flax's lecun_normal: a normal truncated at two standard deviations,
# scaled so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class ActorCritic(nn.Module):
    """Shared-torso MLP actor-critic: ``forward(obs [B, obs_dim]) ->
    (logits [B, n_players*2*5], value [B])``.

    Initialised as flax's ``Dense`` initialises (truncated lecun-normal
    kernels, zero biases), from ``generator`` when given.
    """

    def __init__(self, n_players: int, obs_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.n_players = n_players
        self.obs_dim = obs_dim
        self.hidden = tuple(hidden)
        dims = [obs_dim, *self.hidden]
        self.torso = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(len(self.hidden)))
        self.logits = nn.Linear(dims[-1], n_players * 2 * N_CHOICES,
                                device=device)
        self.value = nn.Linear(dims[-1], 1, device=device)
        self.reset_parameters(generator)

    def dense_layers(self) -> list[nn.Linear]:
        """Torso, logits and value layers: flax's ``Dense_0..Dense_{L+1}``."""
        return [*self.torso, self.logits, self.value]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in self.dense_layers():
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = obs.to(self.logits.weight.dtype)
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return self.logits(x), self.value(x).squeeze(-1)


# ---------------------------------------------------------------------------
# Row-form categorical math (all intermediates are [..] rows)
# ---------------------------------------------------------------------------


def _group_rows(logits: torch.Tensor) -> list[list[torch.Tensor]]:
    """``[.., G*5]`` flat logits -> G groups of 5 rows, each row ``[..]``."""
    g5 = logits.shape[-1]
    if g5 % N_CHOICES:
        raise ValueError(f"logit dim {g5} is not a multiple of {N_CHOICES}")
    lt = logits.movedim(-1, 0)
    return [[lt[g * N_CHOICES + i] for i in range(N_CHOICES)]
            for g in range(g5 // N_CHOICES)]


def _log_softmax_rows(rows: list[torch.Tensor]):
    """Returns (logp rows, exp rows, Z) for one 5-way distribution."""
    m = rows[0]
    for r in rows[1:]:
        m = torch.maximum(m, r)
    exps = [torch.exp(r - m) for r in rows]
    z = exps[0]
    for e in exps[1:]:
        z = z + e
    logz = torch.log(z)
    return [r - m - logz for r in rows], exps, z


def sample_group(rows: list[torch.Tensor], u: torch.Tensor):
    """Inverse-CDF sample of one 5-way distribution (its five logit rows)
    with the uniform row ``u``: (index int32, its log-prob)."""
    logp, exps, z = _log_softmax_rows(rows)
    target = u * z
    cum = exps[0]
    idx = (target > cum).to(torch.int32)
    for i in range(1, N_CHOICES - 1):
        cum = cum + exps[i]
        idx = idx + (target > cum).to(torch.int32)
    taken = logp[0]
    for i in range(1, N_CHOICES):
        taken = torch.where(idx == i, logp[i], taken)
    return idx, taken


def sample_actions(
    logits: torch.Tensor, uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample joint actions from flat ``[.., G*5]`` logits by the inverse
    CDF, one uniform per group: ``uniforms`` ``[G, ..]`` when given (JAX
    draws exactly ``jax.random.uniform(key, (G,) + batch)``), else drawn
    from ``generator``. Returns (actions int32 ``[.., n_players, 2]``,
    joint log-prob ``[..]``)."""
    groups = _group_rows(logits)
    n_groups = len(groups)
    batch = logits.shape[:-1]
    if uniforms is None:
        uniforms = torch.rand((n_groups, *batch), generator=generator,
                              dtype=logits.dtype, device=logits.device)
    elif tuple(uniforms.shape) != (n_groups, *batch):
        raise ValueError(f"uniforms must be {(n_groups, *batch)}, got "
                         f"{tuple(uniforms.shape)}")
    idx_rows, logp_total = [], None
    for g, rows in enumerate(groups):
        idx, taken = sample_group(rows, uniforms[g])
        idx_rows.append(idx)
        logp_total = taken if logp_total is None else logp_total + taken
    actions = torch.stack(idx_rows, -1).reshape(*batch, n_groups // 2, 2)
    return actions, logp_total


def pack_actions(actions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[.., n_players, 2]`` int -> (dirs_packed, acts_packed) ``[..]``
    int32, 3 bits per player (at most 10 players)."""
    n_players = actions.shape[-2]
    if n_players > 10:
        raise ValueError("bit-packing supports at most 10 players")
    a = actions.to(torch.int32)
    dirs = torch.zeros(a.shape[:-2], dtype=torch.int32, device=a.device)
    acts = torch.zeros_like(dirs)
    for p in range(n_players):
        dirs = dirs | (a[..., p, 0] << (3 * p))
        acts = acts | (a[..., p, 1] << (3 * p))
    return dirs, acts


def action_log_prob_and_entropy_packed(
    logits: torch.Tensor, dirs_packed: torch.Tensor, acts_packed: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint log-prob of packed actions and the total entropy, from flat
    logits, in row form."""
    logp_total, ent_total = None, None
    for g, rows in enumerate(_group_rows(logits)):
        p, slot = g // 2, g % 2
        packed = dirs_packed if slot == 0 else acts_packed
        a = (packed >> (3 * p)) & 7
        logp, exps, z = _log_softmax_rows(rows)
        taken = logp[0]
        ent = -exps[0] * logp[0]
        for i in range(1, N_CHOICES):
            taken = torch.where(a == i, logp[i], taken)
            ent = ent - exps[i] * logp[i]
        ent = ent / z
        logp_total = taken if logp_total is None else logp_total + taken
        ent_total = ent if ent_total is None else ent_total + ent
    return logp_total, ent_total


def action_log_prob_and_entropy(
    logits: torch.Tensor, actions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint log-prob of ``[.., n_players, 2]`` actions and the total
    entropy (over the independent per-player, per-slot categoricals)."""
    return action_log_prob_and_entropy_packed(logits, *pack_actions(actions))


def make_policy_fn(model: ActorCritic):
    """Adapter to the ``policy(generator, obs) -> actions`` signature of
    :func:`gym_futbol_tpu_torch.vector.rollout`."""

    @torch.no_grad()
    def policy(generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        logits, _ = model(obs)
        return sample_actions(logits, generator=generator)[0]

    return policy


def init_params(generator: torch.Generator, model: ActorCritic,
                env_params: EnvParams) -> ActorCritic:
    """(Re)initialise ``model`` from ``generator`` for ``env_params``'s
    observation; returns it."""
    from ..env import obs_size

    if model.obs_dim != obs_size(env_params):
        raise ValueError(f"model.obs_dim={model.obs_dim} but the env's "
                         f"observation has {obs_size(env_params)} features")
    model.reset_parameters(generator)
    return model
