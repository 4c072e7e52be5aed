"""Carry parameters, state and weights across from the JAX package.

Nothing here imports JAX: a parameter set is read by attribute, and a
state, a set of weights or a normaliser's statistics arrive as numpy
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.policy import ActorCritic
from .models.recurrent import GATES, RecurrentActorCritic
from .types import EnvParams, EnvState, RewardConfig
from .wrappers import RewardNorm, RunningNorm


def params_from_reference(obj) -> EnvParams:
    """Any object with the ``EnvParams`` fields (the JAX package's
    included) -> this package's :class:`EnvParams`."""
    kw = {}
    for f in dataclasses.fields(EnvParams):
        if f.name == "rewards":
            rc = getattr(obj, "rewards")
            kw["rewards"] = RewardConfig(**{
                g.name: getattr(rc, g.name)
                for g in dataclasses.fields(RewardConfig)
            })
        else:
            kw[f.name] = getattr(obj, f.name)
    return EnvParams(**kw)


def state_from_numpy(pos, vel, possession, score, t,
                     device: torch.device | str = "cuda") -> EnvState:
    """The leaves of a batched JAX ``EnvState`` (``pos``/``vel``
    ``[B, n, 2]``, ``possession``/``t`` ``[B]``, ``score`` ``[B, 2]``) as
    numpy arrays -> :class:`EnvState` on ``device``. Floats keep their
    dtype; integer leaves become int32."""
    def ints(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return EnvState(
        pos=torch.tensor(np.asarray(pos), device=device),
        vel=torch.tensor(np.asarray(vel), device=device),
        possession=ints(possession),
        score=ints(score),
        t=ints(t),
    )


def actor_critic_from_flax(variables, n_players: int,
                           device: torch.device | str = "cuda"
                           ) -> ActorCritic:
    """Flax ``ActorCritic`` variables as a nested dict of numpy arrays
    (``params/Dense_i/{kernel, bias}``, torso layers first, then the
    logits and value heads) -> this package's :class:`ActorCritic` with
    the same weights. A flax kernel is ``[in, out]``; an ``nn.Linear``
    weight is ``[out, in]``."""
    dense = variables["params"]
    kernels = [np.asarray(dense[f"Dense_{i}"]["kernel"], np.float32)
               for i in range(len(dense))]
    hidden = [k.shape[1] for k in kernels[:-2]]
    model = ActorCritic(n_players, kernels[0].shape[0], hidden, device=device)
    with torch.no_grad():
        for i, layer in enumerate(model.dense_layers()):
            bias = np.asarray(dense[f"Dense_{i}"]["bias"], np.float32)
            layer.weight.copy_(torch.tensor(kernels[i].T))
            layer.bias.copy_(torch.tensor(bias))
    return model


def recurrent_actor_critic_from_flax(variables, n_players: int,
                                     device: torch.device | str = "cuda"
                                     ) -> RecurrentActorCritic:
    """Flax ``RecurrentActorCritic`` variables as a nested dict of numpy
    arrays (``params/Dense_i/{kernel, bias}`` for the torso layers, then
    the logits and value heads; ``params/OptimizedLSTMCell_0`` with the
    input kernels ``i{g}/kernel`` and the recurrent ``h{g}/{kernel,
    bias}``, g in i, f, g, o) -> this package's
    :class:`RecurrentActorCritic` with the same weights."""
    p = variables["params"]
    cell = p["OptimizedLSTMCell_0"]

    def arr(x):
        return torch.tensor(np.asarray(x, np.float32))

    n_torso = len(p) - 3
    hidden = [np.shape(p[f"Dense_{i}"]["kernel"])[1] for i in range(n_torso)]
    obs_dim = np.shape(cell["ii"]["kernel"] if not n_torso
                       else p["Dense_0"]["kernel"])[0]
    lstm_size = np.shape(cell["hi"]["kernel"])[0]
    model = RecurrentActorCritic(n_players, obs_dim, hidden, lstm_size,
                                 device=device)
    dense = [*model.torso, model.logits, model.value]
    with torch.no_grad():
        for i, layer in enumerate(dense):
            layer.weight.copy_(arr(p[f"Dense_{i}"]["kernel"]).T)
            layer.bias.copy_(arr(p[f"Dense_{i}"]["bias"]))
        model.cell_i.weight.copy_(torch.cat(
            [arr(cell[f"i{g}"]["kernel"]) for g in GATES], 1).T)
        model.cell_h.weight.copy_(torch.cat(
            [arr(cell[f"h{g}"]["kernel"]) for g in GATES], 1).T)
        model.cell_h.bias.copy_(torch.cat(
            [arr(cell[f"h{g}"]["bias"]) for g in GATES]))
    return model


def mlp_weights_from_numpy(weights, device: torch.device | str = "cuda"
                           ) -> tuple[torch.Tensor, ...]:
    """A flat ``(W1, b1, ..., Wl, bl)`` tuple of numpy arrays (as the JAX
    package's ``ops.fused_actor.init_mlp`` gives it: ``W`` ``[in, out]``,
    ``b`` ``[out, 1]``) -> the same tuple of float32 tensors."""
    return tuple(torch.tensor(np.asarray(w, np.float32), device=device)
                 for w in weights)


def _floats(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def running_norm_from_numpy(mean, var, count,
                            device: torch.device | str = "cuda") -> RunningNorm:
    """The fields of a JAX ``wrappers.RunningNorm`` (``mean``, ``var``
    ``[obs_dim]``, ``count`` ``[]``) as numpy arrays -> this package's
    :class:`~gym_futbol_tpu_torch.wrappers.RunningNorm`, float32, on
    ``device``."""
    return RunningNorm(mean=_floats(mean, device), var=_floats(var, device),
                       count=_floats(count, device))


def reward_norm_from_numpy(ret, mean, var, count,
                           device: torch.device | str = "cuda") -> RewardNorm:
    """The fields of a JAX ``wrappers.RewardNorm`` (``ret`` ``[B]``,
    ``mean``, ``var``, ``count`` ``[]``) as numpy arrays -> this package's
    :class:`~gym_futbol_tpu_torch.wrappers.RewardNorm`, float32, on
    ``device``."""
    return RewardNorm(ret=_floats(ret, device), mean=_floats(mean, device),
                      var=_floats(var, device), count=_floats(count, device))
