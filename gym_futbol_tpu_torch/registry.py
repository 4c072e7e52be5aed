"""Env ids, the ``gym.make`` counterpart.

Counterpart of :mod:`gym_futbol_tpu.registry`, with the same ids: a
registry of string ids to :class:`EnvParams` factories, without gym::

    from gym_futbol_tpu_torch import make, make_params
    env = make("futbol-v0")                    # FutbolEnv on the card
    params = make_params("futbol-3v3-v0")      # the params alone

Registered ids: ``futbol-v0`` (2v2, the default) and ``futbol-1v1-v0``
.. ``futbol-5v5-v0``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .types import EnvParams

_REGISTRY: dict[str, Callable[[], EnvParams]] = {}


def register(env_id: str, factory: Callable[[], EnvParams]) -> None:
    """Register an env id; an id registered already raises (gym's
    contract)."""
    if env_id in _REGISTRY:
        raise ValueError(f"env id already registered: {env_id!r}")
    _REGISTRY[env_id] = factory


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)


def make_params(env_id: str, **overrides: Any) -> EnvParams:
    """An env id -> its :class:`EnvParams`, with ``overrides`` replaced."""
    try:
        factory = _REGISTRY[env_id]
    except KeyError:
        raise KeyError(
            f"unknown env id {env_id!r}; registered: {registered_ids()}"
        ) from None
    params = factory()
    return dataclasses.replace(params, **overrides) if overrides else params


def make(env_id: str, seed: int = 0, device: torch.device | str = "cuda",
         **overrides: Any):
    """The Gym-style constructor: a :class:`~gym_futbol_tpu_torch.env.FutbolEnv`
    of ``env_id``'s params on ``device``."""
    from .env import FutbolEnv

    return FutbolEnv(make_params(env_id, **overrides), seed=seed, device=device)


def _register_defaults() -> None:
    register("futbol-v0", lambda: EnvParams(players_per_team=2))
    for ppt in (1, 2, 3, 4, 5):
        register(f"futbol-{ppt}v{ppt}-v0",
                 lambda ppt=ppt: EnvParams(players_per_team=ppt))


_register_defaults()
