"""Policy evaluation: head-to-head matches of two team policies.

Counterpart of :mod:`gym_futbol_tpu.evaluate`. The env is two-sided, so
evaluation composes per-team policies into a joint policy (team 1's
policy sees the mirrored observation and its directions are
un-mirrored) and plays ``n_envs`` matches of ``n_steps`` in lockstep.

- :func:`evaluate`: any team policies ``(generator, obs) -> actions``,
  one batched step at a time over :func:`vector.rollout`.
- :func:`evaluate_fused`: two MLP policies, all steps in one launch of
  the self-play kernel on a CUDA device
  (:mod:`gym_futbol_tpu_torch.ops.fused_actor`).

Both return the same metrics: total goals per team, goals per match,
win and draw rates over the per-env goal totals, and the mean team-0
shaped reward.
"""

from __future__ import annotations

from typing import Callable

import torch

from .env import mirror_actions, mirror_obs
from .types import EnvParams
from .vector import reset_batch, rollout

# A team policy maps (generator, obs [B, obs_dim]) -> actions [B, ppt, 2]
TeamPolicy = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def random_team_policy(params: EnvParams) -> TeamPolicy:
    def policy(generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        return torch.randint(0, 5, (obs.shape[0], params.players_per_team, 2),
                             generator=generator, dtype=torch.int32,
                             device=obs.device)

    return policy


def joint_policy(params: EnvParams, policy_a: TeamPolicy,
                 policy_b: TeamPolicy) -> TeamPolicy:
    """Compose two team policies into the env's joint-action policy;
    ``policy_b`` sees the mirrored observation (plays 'as team 0')."""

    def policy(generator: torch.Generator, obs: torch.Tensor) -> torch.Tensor:
        act_a = policy_a(generator, obs)
        act_b = mirror_actions(policy_b(generator, mirror_obs(obs, params)))
        return torch.cat([act_a, act_b], dim=-2)

    return policy


def _match_metrics(per_env: torch.Tensor, mean_team0_reward: torch.Tensor,
                   n_envs: int) -> dict:
    """Metrics from per-env goal totals ``[2, B]``."""
    per_env = per_env.cpu().numpy()
    goals = per_env.sum(axis=1)
    return {
        "goals": goals,
        # total goals over the n_envs parallel matches (one match per env)
        "goals_per_episode": goals / n_envs,
        "win_rate_a": float((per_env[0] > per_env[1]).mean()),
        "win_rate_b": float((per_env[1] > per_env[0]).mean()),
        "draw_rate": float((per_env[0] == per_env[1]).mean()),
        "mean_team0_reward": float(mean_team0_reward),
    }


@torch.no_grad()
def evaluate(
    params: EnvParams, policy_a: TeamPolicy | None = None,
    policy_b: TeamPolicy | None = None, n_envs: int = 256,
    n_steps: int = 300, seed: int = 0, device: torch.device | str = "cuda",
) -> dict:
    """Play ``n_envs`` matches of ``n_steps``; uniform random policies
    for any side not given."""
    policy = joint_policy(params, policy_a or random_team_policy(params),
                          policy_b or random_team_policy(params))
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = reset_batch(gen, params, n_envs, device=device)
    _, outs = rollout(state, policy, gen, params, n_steps)
    per_env = outs.info["goal"].sum(0).T            # [2, B]
    return _match_metrics(per_env, outs.team_reward[..., 0].mean(), n_envs)


def uniform_random_weights_like(weights: tuple) -> tuple:
    """All-zero weights shaped like ``weights``: the MLP then gives
    all-zero logits, i.e. uniform action sampling, the distribution of
    :func:`random_team_policy` (use as ``weights_b`` of
    :func:`evaluate_fused` for trained-vs-random matches)."""
    return tuple(torch.zeros_like(w) for w in weights)


def evaluate_fused(
    params: EnvParams, weights_a: tuple, weights_b: tuple | None = None,
    n_envs: int = 4096, n_steps: int = 300, seed: int = 0,
) -> dict:
    """Policy-vs-policy evaluation with both teams' MLPs inside the
    self-play kernel, on the weights' device (the plain version on the
    CPU). ``weights_a``/``weights_b``: flat (W1, b1, ..., Wl, bl) tuples
    (``ops.fused_actor.init_mlp``); ``weights_b`` defaults to
    ``weights_a`` (self-play). Same metrics as :func:`evaluate`."""
    from .ops import pack_state
    from .ops.fused_actor import fused_selfplay_rollout

    weights_b = weights_a if weights_b is None else weights_b
    device = weights_a[0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    state, _ = reset_batch(gen, params, n_envs, device=device)
    sf, si = pack_state(state, params)
    _, _, rew, goals = fused_selfplay_rollout(
        sf, si, weights_a, weights_b, seed + 1, params, n_steps)
    return _match_metrics(goals, rew.mean(), n_envs)
