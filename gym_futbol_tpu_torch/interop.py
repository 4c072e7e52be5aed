"""Carry parameters, state and weights across from the JAX package.

Nothing here imports JAX: a parameter set is read by attribute, and a
state or a set of weights arrives as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.policy import ActorCritic
from .types import EnvParams, EnvState, RewardConfig


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


def mlp_weights_from_numpy(weights, device: torch.device | str = "cuda"
                           ) -> tuple[torch.Tensor, ...]:
    """A flat ``(W1, b1, ..., Wl, bl)`` tuple of numpy arrays (as the JAX
    package's ``ops.fused_actor.init_mlp`` gives it: ``W`` ``[in, out]``,
    ``b`` ``[out, 1]``) -> the same tuple of float32 tensors."""
    return tuple(torch.tensor(np.asarray(w, np.float32), device=device)
                 for w in weights)
