"""Core types for the PyTorch port of the FutbolEnv engine.

Counterpart of :mod:`gym_futbol_tpu.types`. :class:`RewardConfig` and
:class:`EnvParams` carry the same field names, defaults and derived
properties, so a parameter set moves between the two packages by
attribute (see :func:`gym_futbol_tpu_torch.interop.params_from_reference`).

:class:`EnvState` is batch-first: every tensor has a leading env axis.
It holds no RNG key; randomness comes from a ``torch.Generator`` that
the caller passes to each function that draws.

Body layout convention (everywhere in this package):
    index 0                      -> ball
    indices 1 .. ppt             -> team 0 ("home", attacks x = width)
    indices ppt+1 .. 2*ppt       -> team 1 ("away", attacks x = 0)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Shaped-reward coefficients, from a team's perspective."""

    goal: float = 10.0                 # scoring team, per goal
    concede: float = -10.0             # conceding team, per goal
    ball_to_goal_delta: float = 0.1    # * (decrease in ball->opp-goal dist)
    player_to_ball_delta: float = 0.01 # * (decrease in nearest-player->ball dist)
    possession_bonus: float = 0.001    # per step while a team member owns ball
    oob_penalty: float = -0.1          # ball forced back in bounds (non-goal)
    time_penalty: float = 0.0          # per step


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """All static environment configuration (frozen and hashable)."""

    # --- team structure ---
    players_per_team: int = 2

    # --- geometry ---
    width: float = 600.0
    height: float = 400.0
    goal_size: float = 100.0           # opening in each side wall, centered
    player_radius: float = 15.0
    ball_radius: float = 10.0

    # --- masses / material ---
    player_mass: float = 20.0
    ball_mass: float = 1.0
    player_elasticity: float = 0.2     # circle-circle restitution (product rule)
    ball_elasticity: float = 0.6
    wall_elasticity: float = 0.8
    friction: float = 0.4              # tangential (Coulomb) coefficient

    # --- integration ---
    dt: float = 0.1                    # one env.step advances this much sim time
    substeps: int = 5                  # physics sub-steps per env.step
    damping: float = 0.95              # velocity kept per second
    solver_iterations: int = 10
    collision_slop: float = 0.1        # allowed penetration
    baumgarte: float = 0.2             # positional-bias fraction per substep
    max_speed: float = 500.0           # hard speed clamp (stability)

    # --- action semantics ---
    move_force: float = 2000.0         # continuous force while arrow held
    dash_multiplier: float = 2.5       # dash: move_force * this
    possession_radius: float = 40.0    # press/grab reach (center-to-center)
    dribble_offset: float = 2.0        # ball sits this far beyond player radius
    pass_power: float = 300.0          # impulse magnitude on pass
    shoot_power: float = 600.0         # impulse magnitude on shoot
    kick_noise: float = 0.05           # stddev (radians) of kick direction noise

    # --- placement ---
    placement_noise: float = 0.02      # kickoff jitter, fraction of height

    # --- episode ---
    max_steps: int = 300               # done when t >= max_steps

    # --- rewards ---
    rewards: RewardConfig = dataclasses.field(default_factory=RewardConfig)

    @property
    def n_players(self) -> int:
        return 2 * self.players_per_team

    @property
    def n_bodies(self) -> int:
        """Ball + all players."""
        return 1 + 2 * self.players_per_team

    @property
    def goal_y_lo(self) -> float:
        return (self.height - self.goal_size) / 2.0

    @property
    def goal_y_hi(self) -> float:
        return (self.height + self.goal_size) / 2.0

    def replace(self, **kw: Any) -> "EnvParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class EnvState:
    """World state of a batch of ``B`` environments.

    ``possession`` is the owner's *body* index (1..2*ppt) or -1 for a
    free ball.
    """

    pos: torch.Tensor          # [B, n_bodies, 2] float
    vel: torch.Tensor          # [B, n_bodies, 2] float
    possession: torch.Tensor   # [B] int32
    score: torch.Tensor        # [B, 2] int32, goals by team 0 / team 1
    t: torch.Tensor            # [B] int32, env steps elapsed this episode

    @property
    def ball_pos(self) -> torch.Tensor:
        return self.pos[:, 0]

    @property
    def ball_vel(self) -> torch.Tensor:
        return self.vel[:, 0]


@dataclasses.dataclass
class StepOutput:
    """Everything ``step`` returns besides the new state (batch-first)."""

    obs: torch.Tensor          # [B, obs_dim]
    reward: torch.Tensor       # [B] float, team-0 perspective
    team_reward: torch.Tensor  # [B, 2] float, per-team shaped reward
    done: torch.Tensor         # [B] bool
    info: dict[str, torch.Tensor]


def _per_body(params: EnvParams, ball: float, player: float, dtype,
              device) -> torch.Tensor:
    return torch.tensor([ball] + [player] * params.n_players, dtype=dtype,
                        device=device)


def body_masses(params: EnvParams, dtype=torch.float32,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``[n_bodies]`` masses: ball first, then players."""
    return _per_body(params, params.ball_mass, params.player_mass, dtype, device)


def body_radii(params: EnvParams, dtype=torch.float32,
               device: torch.device | str | None = None) -> torch.Tensor:
    """``[n_bodies]`` radii: ball first, then players."""
    return _per_body(params, params.ball_radius, params.player_radius, dtype,
                     device)


def body_elasticities(params: EnvParams, dtype=torch.float32,
                      device: torch.device | str | None = None) -> torch.Tensor:
    """``[n_bodies]`` per-shape elasticities (a pair's restitution is the
    product of its two, the Chipmunk rule)."""
    return _per_body(params, params.ball_elasticity, params.player_elasticity,
                     dtype, device)


def team_of_body(params: EnvParams,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """``[n_bodies]`` int32: -1 for the ball, 0 / 1 for the players."""
    ppt = params.players_per_team
    return torch.tensor([-1] + [0] * ppt + [1] * ppt, dtype=torch.int32,
                        device=device)
