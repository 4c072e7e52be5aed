"""Env wrappers over the batched API: episode statistics, and observation
and reward normalisation with VecNormalize semantics.

Counterpart of :mod:`gym_futbol_tpu.wrappers`. Each wrapper is a
dataclass of tensors on one device plus a step function over
:func:`vector.step_batch`; an update returns a new object and never
writes into the tensors of the old one, so a runner may hold one while
another is made from it.

The JAX package's ``axis_name`` is ``group`` here: with a process group
of equal env shares (:mod:`gym_futbol_tpu_torch.parallel`), each update
merges the moments of the whole batch across the ranks
(:func:`global_moments`), so every rank carries the one global normaliser.
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


def global_moments(b_mean: torch.Tensor, b_var: torch.Tensor,
                   b_count: torch.Tensor, group):
    """A batch's moments (mean, population variance, count; tensors of one
    shape, or several batches' stacked elementwise) -> those of
    the union of every rank's equal share in ``group``: the mean of the
    means, the mean of ``var + mean**2`` less the squared mean, the count
    times the world size (the JAX package's ``wrappers.py:114-121``; one
    all-reduce, which also carries the counts: unequal shares raise
    ``ValueError`` on every rank). With ``group`` None or of one rank, the
    moments as given."""
    from .parallel.mesh import all_mean, rank_and_size

    world = rank_and_size(group)[1]
    if world == 1:
        return b_mean, b_var, b_count
    g_mean, g_sq, c_mean, c_sq = all_mean(
        [b_mean, b_var + b_mean ** 2, b_count, b_count ** 2], group)
    if bool((c_sq - c_mean ** 2 != 0).any()):
        raise ValueError("the ranks' batches differ in size: the normaliser "
                         "needs an equal share of the envs on every rank")
    return g_mean, g_sq - g_mean ** 2, b_count * world


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

    def update(self, obs: torch.Tensor, group=None) -> "RunningNorm":
        """Merge the batch ``obs`` ``[N, obs_dim]`` (with ``group``: every
        rank's equal share of it, :func:`global_moments`)."""
        var, mean = torch.var_mean(obs, dim=0, correction=0)
        return self.update_moments(
            mean, var, torch.full((), obs.shape[0], dtype=obs.dtype,
                                  device=obs.device), group)

    def update_moments(self, b_mean: torch.Tensor, b_var: torch.Tensor,
                       b_count: torch.Tensor, group=None) -> "RunningNorm":
        """Merge a batch given by its moments (mean and population
        variance ``[obs_dim]``, count ``[]``): a feature-major buffer
        updates the statistics without a row-major copy. With ``group``
        the moments are this rank's share's (:func:`global_moments`)."""
        b_mean, b_var, b_count = global_moments(b_mean, b_var, b_count, group)
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
    group=None,
) -> tuple[EnvState, RunningNorm, StepOutput]:
    """:func:`vector.step_batch` returning normalised observations; the
    statistics take in the raw ones first unless ``update`` is false
    (evaluation)."""
    state, out = step_batch(state, actions, params, generator)
    if update:
        norm = norm.update(out.obs, group)
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

    def returns(self, reward: torch.Tensor, gamma: float = 0.99):
        """One step's discounted returns ``self.ret * gamma + reward``
        ``[B]`` and their batch moments (mean, population variance,
        count): what :meth:`update` merges."""
        ret = self.ret * gamma + reward
        b_var, b_mean = torch.var_mean(ret, correction=0)
        return ret, b_mean, b_var, torch.full((), ret.shape[0], dtype=reward.dtype,
                                              device=reward.device)

    def merge(self, ret: torch.Tensor, done: torch.Tensor, b_mean: torch.Tensor,
              b_var: torch.Tensor, b_count: torch.Tensor) -> "RewardNorm":
        """The statistics with a step's return moments merged in, and the
        accumulator ``ret`` restarted from 0 where ``done``."""
        mean, var, count = _merge(self.mean, self.var, self.count, b_mean, b_var,
                                  b_count)
        return RewardNorm(ret=torch.where(done, 0.0, ret), mean=mean, var=var,
                          count=count)

    def update(self, reward: torch.Tensor, done: torch.Tensor,
               gamma: float = 0.99, group=None) -> "RewardNorm":
        """Fold one step's rewards ``[B]`` into the return statistics; the
        return accumulator restarts from 0 where ``done``. With ``group``
        the batch is this rank's share (:func:`global_moments`)."""
        ret, b_mean, b_var, b_count = self.returns(reward, gamma)
        return self.merge(ret, done, *global_moments(b_mean, b_var, b_count,
                                                     group))

    def normalize(self, reward: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
        """``reward / sqrt(var + 1e-8)``, clipped to ``±clip``."""
        return torch.clamp(reward / torch.sqrt(self.var + 1e-8), -clip, clip)


def step_reward_normalized(
    state: EnvState, rnorm: RewardNorm, actions: torch.Tensor,
    params: EnvParams, generator: torch.Generator, gamma: float = 0.99,
    update: bool = True, group=None,
) -> tuple[EnvState, RewardNorm, StepOutput]:
    """:func:`vector.step_batch` with ``reward`` and ``team_reward``
    divided by the running standard deviation of discounted returns; the
    statistics follow the team-0 reward."""
    state, out = step_batch(state, actions, params, generator)
    if update:
        rnorm = rnorm.update(out.reward, out.done, gamma, group)
    return state, rnorm, dataclasses.replace(
        out, reward=rnorm.normalize(out.reward),
        team_reward=rnorm.normalize(out.team_reward))
