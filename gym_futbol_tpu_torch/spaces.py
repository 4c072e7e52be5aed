"""Action and observation spaces with gym's small API, without gym.

Counterpart of :mod:`gym_futbol_tpu.spaces`: ``shape``, ``dtype``,
``contains`` and ``sample``, which draws on the space's device from an
explicit ``torch.Generator`` on that device.
"""

from __future__ import annotations

import numpy as np
import torch


class Space:
    shape: tuple
    dtype: torch.dtype
    device: torch.device

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    """A box of reals, gym's ``Box``: ``low + u * (high - low)`` for a
    uniform ``u`` per element, as the JAX package samples it (an unbounded
    side samples to a non-finite value, as there)."""

    def __init__(self, low, high, shape=None, dtype=torch.float32,
                 device: torch.device | str = "cuda"):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self.low = torch.as_tensor(low, dtype=dtype, device=self.device
                                   ).broadcast_to(self.shape)
        self.high = torch.as_tensor(high, dtype=dtype, device=self.device
                                    ).broadcast_to(self.shape)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(self.shape, generator=generator, dtype=self.dtype,
                       device=self.device)
        return self.low + u * (self.high - self.low)

    def contains(self, x) -> bool:
        x = torch.as_tensor(x, device=self.device)
        return bool(tuple(x.shape) == self.shape and (x >= self.low).all()
                    and (x <= self.high).all())

    def __repr__(self):
        return f"Box(shape={self.shape}, dtype={self.dtype})"


class Discrete(Space):
    """The integers ``0 .. n-1``."""

    def __init__(self, n: int, device: torch.device | str = "cuda"):
        self.n = int(n)
        self.shape = ()
        self.dtype = torch.int32
        self.device = torch.device(device)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randint(0, self.n, (), generator=generator,
                             dtype=torch.int32, device=self.device)

    def contains(self, x) -> bool:
        x = int(x)
        return 0 <= x < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """Independent discrete dimensions, gym's ``MultiDiscrete``. The joint
    action of the ``2 * ppt`` players is ``[[5, 5]] * n_players`` (each
    picks a direction and an act), kept 2-D as in the JAX package;
    sampled as ``floor(u * nvec)``."""

    def __init__(self, nvec, device: torch.device | str = "cuda"):
        self.nvec = np.asarray(nvec, dtype=np.int32)
        self.shape = self.nvec.shape
        self.dtype = torch.int32
        self.device = torch.device(device)
        self._nvec = torch.as_tensor(self.nvec, device=self.device)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(self.shape, generator=generator, device=self.device)
        return torch.floor(u * self._nvec).to(torch.int32)

    def contains(self, x) -> bool:
        x = np.asarray(torch.as_tensor(x).cpu())
        return bool(x.shape == self.shape and (x >= 0).all()
                    and (x < self.nvec).all())

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"
