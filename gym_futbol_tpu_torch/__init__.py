"""gym_futbol_tpu_torch: the FutbolEnv engine in PyTorch, with its hot
path as a hand-written CUDA kernel for NVIDIA Hopper.

A port of :mod:`gym_futbol_tpu` that keeps its module names. It imports
``torch`` and never JAX. The batched env (physics, game rules, rewards,
auto-reset) runs as plain PyTorch on any device; the random-policy
rollout runs as one CUDA kernel per rollout on a CUDA device
(:mod:`gym_futbol_tpu_torch.ops.fused_rollout`).

Quick start::

    import torch
    from gym_futbol_tpu_torch import EnvParams, ops, vector

    params = EnvParams(players_per_team=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, obs = vector.reset_batch(gen, params, 4096, device="cuda")
    statef, statei = ops.pack_state(state, params)
    statef, statei, rewards = ops.fused_rollout(statef, statei, 1, params, 512)
"""

from .env import observe, obs_size, reset, step
from .types import EnvParams, EnvState, RewardConfig, StepOutput

__version__ = "0.1.0"

__all__ = [
    "EnvParams",
    "EnvState",
    "RewardConfig",
    "StepOutput",
    "reset",
    "step",
    "observe",
    "obs_size",
    "__version__",
]
