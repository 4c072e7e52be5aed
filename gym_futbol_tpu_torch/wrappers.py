"""Env wrappers over the batched API: episode statistics, and observation
and reward normalisation with VecNormalize semantics.

Counterpart of :mod:`gym_futbol_tpu.wrappers`. Each wrapper is a
dataclass of tensors on one device plus a step function over
:func:`vector.step_batch`; an update returns a new object and never
writes into the tensors of the old one, so a runner may hold one while
another is made from it.

The JAX package's ``axis_name`` (a mean of the batch statistics across a
device mesh, for sharded training) is left out: the statistics here are
those of the batch each call sees. The all-reduce comes with the
distributed learner.
"""

from __future__ import annotations

import dataclasses

import torch

from .types import EnvParams, EnvState, StepOutput
from .vector import step_batch


# ---------------------------------------------------------------------------
# Episode statistics (VecMonitor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpisodeStats:
    """Per-env running episode accumulators and the last finished
    episode's totals, all ``[B]``: read ``last_return`` / ``last_length``
    wherever ``done`` was true that step."""

    acc_return: torch.Tensor     # running sum of team-0 reward
    acc_length: torch.Tensor     # running step count, int32
    last_return: torch.Tensor    # return of the most recent finished episode
    last_length: torch.Tensor    # int32
    episodes: torch.Tensor       # finished-episode count, int32

    @classmethod
    def init(cls, n_envs: int, device: torch.device | str = "cuda",
             dtype=torch.float32) -> "EpisodeStats":
        z = torch.zeros((n_envs,), dtype=dtype, device=device)
        zi = torch.zeros((n_envs,), dtype=torch.int32, device=device)
        return cls(acc_return=z, acc_length=zi, last_return=z.clone(),
                   last_length=zi.clone(), episodes=zi.clone())


def step_with_stats(
    state: EnvState, stats: EpisodeStats, actions: torch.Tensor,
    params: EnvParams, generator: torch.Generator,
) -> tuple[EnvState, EpisodeStats, StepOutput]:
    """:func:`vector.step_batch` plus episode accounting (auto-reset
    aware)."""
    state, out = step_batch(state, actions, params, generator)
    acc_r = stats.acc_return + out.reward
    acc_l = stats.acc_length + 1
    done = out.done
    stats = EpisodeStats(
        acc_return=torch.where(done, 0.0, acc_r),
        acc_length=torch.where(done, 0, acc_l),
        last_return=torch.where(done, acc_r, stats.last_return),
        last_length=torch.where(done, acc_l, stats.last_length),
        episodes=stats.episodes + done.to(torch.int32),
    )
    return state, stats, out


# ---------------------------------------------------------------------------
# Observation normalisation (VecNormalize, observation side)
# ---------------------------------------------------------------------------


def _merge(mean, var, count, b_mean, b_var, b_count):
    """Chan et al.'s parallel merge of (mean, population variance, count)
    with a batch's, in the JAX package's order of operations."""
    delta = b_mean - mean
    tot = count + b_count
    new_mean = mean + delta * b_count / tot
    m2 = var * count + b_var * b_count + delta ** 2 * count * b_count / tot
    return new_mean, m2 / tot, tot


@dataclasses.dataclass(frozen=True)
class RunningNorm:
    """Running mean and population variance of the observations, merged
    batch by batch."""

    mean: torch.Tensor    # [obs_dim]
    var: torch.Tensor     # [obs_dim]
    count: torch.Tensor   # [], starts at 1e-4

    @classmethod
    def init(cls, obs_dim: int, device: torch.device | str = "cuda",
             dtype=torch.float32) -> "RunningNorm":
        return cls(mean=torch.zeros((obs_dim,), dtype=dtype, device=device),
                   var=torch.ones((obs_dim,), dtype=dtype, device=device),
                   count=torch.full((), 1e-4, dtype=dtype, device=device))

    def update(self, obs: torch.Tensor) -> "RunningNorm":
        """Merge the batch ``obs`` ``[N, obs_dim]``."""
        var, mean = torch.var_mean(obs, dim=0, correction=0)
        return self.update_moments(
            mean, var, torch.full((), obs.shape[0], dtype=obs.dtype,
                                  device=obs.device))

    def update_moments(self, b_mean: torch.Tensor, b_var: torch.Tensor,
                       b_count: torch.Tensor) -> "RunningNorm":
        """Merge a batch given by its moments (mean and population
        variance ``[obs_dim]``, count ``[]``): a feature-major buffer
        updates the statistics without a row-major copy."""
        mean, var, count = _merge(self.mean, self.var, self.count, b_mean,
                                  b_var, b_count)
        return RunningNorm(mean=mean, var=var, count=count)

    def normalize(self, obs: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
        """``(obs - mean) / sqrt(var + 1e-8)``, clipped to ``±clip``."""
        z = (obs - self.mean) / torch.sqrt(self.var + 1e-8)
        return torch.clamp(z, -clip, clip)


def step_normalized(
    state: EnvState, norm: RunningNorm, actions: torch.Tensor,
    params: EnvParams, generator: torch.Generator, update: bool = True,
) -> tuple[EnvState, RunningNorm, StepOutput]:
    """:func:`vector.step_batch` returning normalised observations; the
    statistics take in the raw ones first unless ``update`` is false
    (evaluation)."""
    state, out = step_batch(state, actions, params, generator)
    if update:
        norm = norm.update(out.obs)
    return state, norm, dataclasses.replace(out, obs=norm.normalize(out.obs))


# ---------------------------------------------------------------------------
# Reward normalisation (VecNormalize, reward side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RewardNorm:
    """Running variance of the discounted return, stable-baselines
    VecNormalize semantics: rewards are divided by the return's running
    standard deviation (no mean subtracted, so signs are kept)."""

    ret: torch.Tensor     # [B] per-env discounted return
    mean: torch.Tensor    # [] running mean of returns (tracked, unused)
    var: torch.Tensor     # [] running variance of returns
    count: torch.Tensor   # [], starts at 1e-4

    @classmethod
    def init(cls, n_envs: int, device: torch.device | str = "cuda",
             dtype=torch.float32) -> "RewardNorm":
        return cls(ret=torch.zeros((n_envs,), dtype=dtype, device=device),
                   mean=torch.zeros((), dtype=dtype, device=device),
                   var=torch.ones((), dtype=dtype, device=device),
                   count=torch.full((), 1e-4, dtype=dtype, device=device))

    def update(self, reward: torch.Tensor, done: torch.Tensor,
               gamma: float = 0.99) -> "RewardNorm":
        """Fold one step's rewards ``[B]`` into the return statistics; the
        return accumulator restarts from 0 where ``done``."""
        ret = self.ret * gamma + reward
        b_var, b_mean = torch.var_mean(ret, correction=0)
        b_count = torch.full((), ret.shape[0], dtype=reward.dtype,
                             device=reward.device)
        mean, var, count = _merge(self.mean, self.var, self.count, b_mean, b_var,
                                  b_count)
        return RewardNorm(ret=torch.where(done, 0.0, ret), mean=mean, var=var,
                          count=count)

    def normalize(self, reward: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
        """``reward / sqrt(var + 1e-8)``, clipped to ``±clip``."""
        return torch.clamp(reward / torch.sqrt(self.var + 1e-8), -clip, clip)


def step_reward_normalized(
    state: EnvState, rnorm: RewardNorm, actions: torch.Tensor,
    params: EnvParams, generator: torch.Generator, gamma: float = 0.99,
    update: bool = True,
) -> tuple[EnvState, RewardNorm, StepOutput]:
    """:func:`vector.step_batch` with ``reward`` and ``team_reward``
    divided by the running standard deviation of discounted returns; the
    statistics follow the team-0 reward."""
    state, out = step_batch(state, actions, params, generator)
    if update:
        rnorm = rnorm.update(out.reward, out.done, gamma)
    return state, rnorm, dataclasses.replace(
        out, reward=rnorm.normalize(out.reward),
        team_reward=rnorm.normalize(out.team_reward))
