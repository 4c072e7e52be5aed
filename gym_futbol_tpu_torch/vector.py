"""Vectorized FutbolEnv in PyTorch: thousands of envs in lockstep.

Counterpart of :mod:`gym_futbol_tpu.vector`. The env axis is the
leading dimension of every state tensor, and auto-reset is built into
:func:`step_batch`: wherever ``done`` is hit, the outputs report the
terminal transition and the carried state is a fresh episode.

Every function takes its randomness from a ``torch.Generator`` on the
state's device. :func:`rollout` is the plain Python loop over steps; the
hot path for a random policy is the fused kernel in
:mod:`gym_futbol_tpu_torch.ops.fused_rollout`.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import env as env_core
from .types import EnvParams, EnvState, StepOutput

Policy = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def reset_batch(
    generator: torch.Generator, params: EnvParams, n_envs: int,
    device: torch.device | str | None = None, dtype=torch.float32,
) -> tuple[EnvState, torch.Tensor]:
    """A fresh batch of envs. Returns (state, obs ``[B, obs_dim]``)."""
    return env_core.reset(generator, params, n_envs, device, dtype)


def step_batch(
    state: EnvState, actions: torch.Tensor, params: EnvParams,
    generator: torch.Generator,
) -> tuple[EnvState, StepOutput]:
    """Batched step with auto-reset, drawing the kick and kickoff noise
    from ``generator``. ``actions``: ``[B, n_players, 2]``."""
    theta, noise = env_core.sample_step_noise(
        generator, params, state.pos.shape[0], state.pos.device,
        state.pos.dtype,
    )
    return env_core.step(state, actions, theta, noise, params, auto_reset=True)


def rollout(
    state: EnvState, policy: Policy, generator: torch.Generator,
    params: EnvParams, n_steps: int,
) -> tuple[EnvState, StepOutput]:
    """Run ``n_steps`` batched steps. ``policy(generator, obs) ->
    actions [B, n_players, 2]``. Returns the final state and the
    time-stacked outputs (``[T, B, ...]``)."""
    obs = env_core.observe(state, params)
    outs = []
    for _ in range(n_steps):
        actions = policy(generator, obs)
        state, out = step_batch(state, actions, params, generator)
        obs = out.obs
        outs.append(out)
    stacked = StepOutput(
        obs=torch.stack([o.obs for o in outs]),
        reward=torch.stack([o.reward for o in outs]),
        team_reward=torch.stack([o.team_reward for o in outs]),
        done=torch.stack([o.done for o in outs]),
        info={k: torch.stack([o.info[k] for o in outs]) for k in outs[0].info},
    )
    return state, stacked


def random_policy(params: EnvParams) -> Policy:
    """Uniform-random joint action policy."""

    def policy(generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        return torch.randint(
            0, 5, (obs.shape[0], params.n_players, 2), generator=generator,
            dtype=torch.int32, device=obs.device,
        )

    return policy


class VectorFutbolEnv:
    """Stateful convenience wrapper over the batched core."""

    def __init__(
        self, n_envs: int, params: EnvParams | None = None, seed: int = 0,
        device: torch.device | str = "cpu", dtype=torch.float32,
    ):
        self.params = params or EnvParams()
        self.n_envs = n_envs
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state: EnvState | None = None

    def reset(self) -> torch.Tensor:
        self._state, obs = reset_batch(
            self.generator, self.params, self.n_envs, self.device, self.dtype
        )
        return obs

    def step(self, actions: torch.Tensor):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        self._state, out = step_batch(
            self._state, actions, self.params, self.generator
        )
        return out.obs, out.reward, out.done, out.info

    @property
    def state(self) -> EnvState:
        return self._state
