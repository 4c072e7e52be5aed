"""Self-play PPO experience collection and advantages, in PyTorch.

Counterpart of the collection half of :mod:`gym_futbol_tpu.ppo`: one
per-team actor-critic plays both sides of every env. It sees team 0's
observation and team 1's mirrored one (:func:`env.mirror_obs`), the two
action sets drive both teams, and both perspectives' transitions enter
the buffer, each with its own team's reward. Rows ``[:B]`` of a
``[T, 2B]`` field are team 0's, rows ``[B:]`` team 1's in its mirrored
frame.

Two collectors give the same :class:`Transition`:
:func:`collect_rollout`, the plain per-step loop over the model and
``vector.step_batch`` (obs ``[T, 2B, F]``), and
:func:`collect_rollout_fused` over the fused kernel
(:mod:`gym_futbol_tpu_torch.ops.fused_collect`; obs feature-major
``[F_pad, 2*T*B]`` with samples ordered (view, step, env)).
"""

from __future__ import annotations

import dataclasses

import torch

from . import env as env_core
from .models.policy import ActorCritic, init_params, pack_actions, sample_actions
from .types import EnvParams, EnvState
from .vector import reset_batch, step_batch


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The settings collection and GAE read (the JAX package's defaults);
    the update's settings arrive with the update."""

    rollout_steps: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95


@dataclasses.dataclass
class Transition:
    """A rollout's experience: ``[T, 2B]`` fields (actions bit-packed, 3
    bits per player, one int32 word per slot) and ``obs`` either
    ``[T, 2B, F]`` (plain collect) or feature-major ``[F_pad, 2*T*B]``
    with samples ordered (view, step, env) (fused collect)."""

    obs: torch.Tensor
    dirs: torch.Tensor
    acts: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class RunnerState:
    model: ActorCritic
    env_state: EnvState          # batched
    obs: torch.Tensor            # [B, obs_dim] raw observation
    generator: torch.Generator   # on the model's device

    def replace(self, **kw) -> "RunnerState":
        return dataclasses.replace(self, **kw)


def _both_views(obs: torch.Tensor, env_params: EnvParams) -> torch.Tensor:
    """``[B, F]`` world obs -> ``[2B, F]``: rows ``[:B]`` the team-0 view,
    rows ``[B:]`` the team-1 view (:func:`env.mirror_obs`)."""
    return torch.cat([obs, env_core.mirror_obs(obs, env_params)], 0)


def _check_model(model: ActorCritic, env_params: EnvParams) -> None:
    if model.n_players != env_params.players_per_team:
        raise ValueError(
            f"self-play PPO trains a per-team policy: model.n_players="
            f"{model.n_players} must equal players_per_team="
            f"{env_params.players_per_team}")


@torch.no_grad()
def collect_rollout(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    action_uniforms: torch.Tensor | None = None,
) -> tuple[RunnerState, Transition, torch.Tensor]:
    """``cfg.rollout_steps`` steps of self-play experience, one batched
    step at a time. Action draws come from ``runner.generator``, or from
    ``action_uniforms`` ``[T, G, 2B]`` (per step, the uniforms
    ``models.policy.sample_actions`` takes for the ``[2B]`` logits);
    the env's kick and kickoff noise come from the generator. Returns
    (runner, traj ``[T, 2B, ...]``, bootstrap value ``[2B]``)."""
    model = runner.model
    _check_model(model, env_params)
    b = runner.obs.shape[0]
    state, obs, gen = runner.env_state, runner.obs, runner.generator
    steps = []
    for t in range(cfg.rollout_steps):
        obs2 = _both_views(obs, env_params)
        logits, value = model(obs2)
        u = None if action_uniforms is None else action_uniforms[t]
        action2, logp = sample_actions(logits, u, generator=gen)
        joint = torch.cat(
            [action2[:b], env_core.mirror_actions(action2[b:])], dim=1)
        state, out = step_batch(state, joint, env_params, gen)
        dirs, acts = pack_actions(action2)
        steps.append(Transition(
            obs=obs2, dirs=dirs, acts=acts, logp=logp, value=value,
            reward=torch.cat([out.team_reward[:, 0], out.team_reward[:, 1]]),
            done=torch.cat([out.done, out.done]),
        ))
        obs = out.obs
    traj = Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(Transition)})
    _, last_value = model(_both_views(obs, env_params))
    return runner.replace(env_state=state, obs=obs), traj, last_value


@torch.no_grad()
def collect_rollout_fused(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    uniforms: torch.Tensor | None = None,
) -> tuple[RunnerState, Transition, torch.Tensor]:
    """:func:`collect_rollout` on the fused kernel: both views' forward,
    sampling, the env step and auto-reset for all T steps in one launch
    on a CUDA device (its plain version on the CPU). The sampling seed
    is drawn from ``runner.generator``; ``uniforms`` ``[T, n_draws, B]``
    replaces the kernel's Philox stream. logp and value are the kernel's
    own for its own actions. Returns (runner, traj with feature-major
    obs, bootstrap value ``[2B]``)."""
    from .ops import pack_state, unpack_state
    from .ops.fused_collect import flatten_actor_critic, fused_collect

    _check_model(runner.model, env_params)
    gen = runner.generator
    sf, si = pack_state(runner.env_state, env_params)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    (sf, si, obs, dirs, acts, logp, value, reward, done,
     last_v) = fused_collect(sf, si, flatten_actor_critic(runner.model), seed,
                             env_params, cfg.rollout_steps, uniforms=uniforms)
    t, b = cfg.rollout_steps, sf.shape[1]
    f = obs.shape[1]  # F_pad
    traj = Transition(
        # [2, F, T, B] -> [F, 2, T*B] -> [F, 2*T*B]: columns (view, step, env)
        obs=obs.reshape(2, f, t * b).transpose(0, 1).reshape(f, 2 * t * b),
        dirs=dirs.reshape(t, 2 * b),
        acts=acts.reshape(t, 2 * b),
        logp=logp.reshape(t, 2 * b),
        value=value.reshape(t, 2 * b),
        reward=reward.reshape(t, 2 * b),
        done=done.reshape(t, 2 * b).bool(),
    )
    env_state = unpack_state(sf, si, env_params)
    runner = runner.replace(env_state=env_state,
                            obs=env_core.observe(env_state, env_params))
    return runner, traj, last_v.reshape(2 * b)


def compute_gae(
    traj: Transition, last_value: torch.Tensor, cfg: PPOConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, a reverse loop over the steps.
    Returns (advantages ``[T, 2B]``, returns ``[T, 2B]``)."""
    gamma, lam = cfg.gamma, cfg.gae_lambda
    adv = torch.empty_like(traj.value)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.value.shape[0])):
        value = traj.value[t]
        nonterminal = 1.0 - traj.done[t].to(value.dtype)
        delta = traj.reward[t] + gamma * next_value * nonterminal - value
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = value
    return adv, adv + traj.value


def init_runner(
    generator: torch.Generator, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig, n_envs: int,
) -> RunnerState:
    """Initialise ``model`` from ``generator`` (flax's initialisers) and
    reset ``n_envs`` envs on the model's device; the runner keeps the
    generator for every later draw."""
    init_params(generator, model, env_params)
    device = model.logits.weight.device
    env_state, obs = reset_batch(generator, env_params, n_envs, device=device)
    return RunnerState(model=model, env_state=env_state, obs=obs,
                       generator=generator)
