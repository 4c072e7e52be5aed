"""Env-sharded data parallelism over ``torch.distributed`` (counterpart
of :mod:`gym_futbol_tpu.parallel`)."""

from .mesh import env_group, init_distributed, rank_device  # noqa: F401
from .rollout import (  # noqa: F401
    check_replicated,
    ppo_runner_specs,
    shard_env_state,
    shard_fused_rollout,
    shard_rollout,
    shard_runner,
    shard_train_iteration,
)

__all__ = [
    "init_distributed",
    "env_group",
    "rank_device",
    "ppo_runner_specs",
    "shard_env_state",
    "shard_fused_rollout",
    "shard_rollout",
    "shard_runner",
    "shard_train_iteration",
    "check_replicated",
]
