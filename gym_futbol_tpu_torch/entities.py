"""Entity views: ``Ball``, ``Player`` and ``Team`` accessors over the
flat :class:`EnvState`.

Counterpart of :mod:`gym_futbol_tpu.entities`: read-only views with the
reference's per-body ergonomics (positions, velocities, who has the ball)
for debugging, rendering and scripted policies, copying nothing. Every
accessor indexes the body axis from the right, so a single env's state
(``FutbolEnv.state``: ``[n_bodies, 2]`` leaves) and a batch's (``[B,
n_bodies, 2]``) work alike.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import EnvParams, EnvState

BALL = 0  # body index of the ball


@dataclasses.dataclass(frozen=True)
class Ball:
    """Read-only view of body 0."""

    state: EnvState

    @property
    def position(self) -> torch.Tensor:
        return self.state.pos[..., BALL, :]

    @property
    def velocity(self) -> torch.Tensor:
        return self.state.vel[..., BALL, :]

    @property
    def owner(self) -> torch.Tensor:
        """Body index of the possessing player, or -1 if free."""
        return self.state.possession

    @property
    def is_free(self) -> torch.Tensor:
        return self.state.possession < 0


@dataclasses.dataclass(frozen=True)
class Player:
    """Read-only view of one player body."""

    state: EnvState
    body: int            # body index, 1 .. 2*ppt
    params: EnvParams

    def __post_init__(self):
        if not 1 <= self.body <= self.params.n_players:
            raise IndexError(f"player body index out of range: {self.body}")

    @property
    def team(self) -> int:
        return 0 if self.body <= self.params.players_per_team else 1

    @property
    def position(self) -> torch.Tensor:
        return self.state.pos[..., self.body, :]

    @property
    def velocity(self) -> torch.Tensor:
        return self.state.vel[..., self.body, :]

    @property
    def has_ball(self) -> torch.Tensor:
        return self.state.possession == self.body


@dataclasses.dataclass(frozen=True)
class Team:
    """Read-only view of one team's players."""

    state: EnvState
    team: int            # 0 (attacks right goal) or 1 (attacks left)
    params: EnvParams

    @property
    def _sl(self) -> slice:
        ppt = self.params.players_per_team
        lo = 1 + self.team * ppt
        return slice(lo, lo + ppt)

    @property
    def players(self) -> tuple[Player, ...]:
        sl = self._sl
        return tuple(
            Player(self.state, b, self.params)
            for b in range(sl.start, sl.stop)
        )

    @property
    def positions(self) -> torch.Tensor:
        return self.state.pos[..., self._sl, :]

    @property
    def velocities(self) -> torch.Tensor:
        return self.state.vel[..., self._sl, :]

    @property
    def has_ball(self) -> torch.Tensor:
        sl = self._sl
        p = self.state.possession
        return (p >= sl.start) & (p < sl.stop)

    @property
    def score(self) -> torch.Tensor:
        return self.state.score[..., self.team]
