"""Carry parameters and state across from the JAX package.

Nothing here imports JAX: a parameter set is read by attribute, and a
state arrives as the numpy arrays of its leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def state_from_numpy(pos, vel, possession, score, t) -> EnvState:
    """The leaves of a batched JAX ``EnvState`` (``pos``/``vel``
    ``[B, n, 2]``, ``possession``/``t`` ``[B]``, ``score`` ``[B, 2]``) as
    numpy arrays -> :class:`EnvState` on the CPU. Floats keep their
    dtype; integer leaves become int32."""
    def ints(x):
        return torch.tensor(np.asarray(x, np.int32))

    return EnvState(
        pos=torch.tensor(np.asarray(pos)),
        vel=torch.tensor(np.asarray(vel)),
        possession=ints(possession),
        score=ints(score),
        t=ints(t),
    )
