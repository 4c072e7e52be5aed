"""gym_futbol_tpu_torch: the FutbolEnv engine in PyTorch, with its hot
paths as hand-written CUDA kernels for NVIDIA Hopper.

A port of :mod:`gym_futbol_tpu` that keeps its module names. It imports
``torch`` and never JAX. The batched env (physics, game rules, rewards,
auto-reset) runs as plain PyTorch on any device; on a CUDA device three
paths run as one kernel launch each (``ops``): the random-policy rollout
(``fused_rollout``), self-play PPO collection (``ppo.collect_rollout_fused``
over ``fused_collect``) and policy-vs-policy evaluation
(``evaluate.evaluate_fused`` over ``fused_selfplay_rollout``).

Quick start::

    import torch
    from gym_futbol_tpu_torch import EnvParams, evaluate, obs_size, ops, ppo, vector
    from gym_futbol_tpu_torch.models import ActorCritic

    gen = torch.Generator(device="cuda").manual_seed(0)

    # random-policy rollout
    params = EnvParams(players_per_team=2)
    state, obs = vector.reset_batch(gen, params, 4096, device="cuda")
    statef, statei = ops.pack_state(state, params)
    statef, statei, rewards = ops.fused_rollout(statef, statei, 1, params, 512)

    # self-play PPO collection and advantages
    params3 = EnvParams(players_per_team=3)
    model = ActorCritic(3, obs_size(params3), (256, 256), device="cuda")
    cfg = ppo.PPOConfig(rollout_steps=128)
    runner = ppo.init_runner(gen, model, params3, cfg, n_envs=16384)
    runner, traj, last_value = ppo.collect_rollout_fused(runner, params3, cfg)
    adv, returns = ppo.compute_gae(traj, last_value, cfg)

    # policy-vs-policy evaluation
    w = ops.init_mlp(gen, params, (128, 128), device="cuda")
    metrics = evaluate.evaluate_fused(params, w, n_envs=4096, n_steps=512)

    # one env, Gym-style
    from gym_futbol_tpu_torch import make
    env = make("futbol-v0")
    obs = env.reset()
    obs, reward, done, info = env.step(env.action_space.sample(env.generator))

Env-sharded training over several processes: :mod:`.parallel` and the
CLI's ``--distributed``.
"""

from .entities import Ball, Player, Team
from .env import (
    FutbolEnv,
    mirror_actions,
    mirror_obs,
    observe,
    obs_size,
    reset,
    step,
)
from .registry import make, make_params, register, registered_ids
from .spaces import Box, Discrete, MultiDiscrete
from .types import EnvParams, EnvState, RewardConfig, StepOutput

__version__ = "0.1.0"

__all__ = [
    "EnvParams",
    "EnvState",
    "RewardConfig",
    "StepOutput",
    "FutbolEnv",
    "reset",
    "step",
    "observe",
    "obs_size",
    "mirror_obs",
    "mirror_actions",
    "make",
    "make_params",
    "register",
    "registered_ids",
    "Ball",
    "Player",
    "Team",
    "Box",
    "Discrete",
    "MultiDiscrete",
    "__version__",
]
