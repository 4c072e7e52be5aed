"""Self-play PPO in PyTorch: experience collection, advantages and the
clipped-surrogate update.

Counterpart of :mod:`gym_futbol_tpu.ppo`: one per-team actor-critic
plays both sides of every env. It sees team 0's
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

Two updates take that experience through ``cfg.epochs`` x
``cfg.minibatches`` optimiser steps over shuffled sample blocks:
:func:`update_epochs`, :func:`ppo_loss` under autograd, and
:func:`update_epochs_fused`, each minibatch's forward and hand-written
backward in the kernels of :mod:`gym_futbol_tpu_torch.ops.fused_update`.
:func:`train_iteration` chains collect, GAE and update.
"""

from __future__ import annotations

import dataclasses

import torch

from . import env as env_core
from .models.policy import (
    ActorCritic,
    action_log_prob_and_entropy_packed,
    init_params,
    pack_actions,
    sample_actions,
)
from .types import EnvParams, EnvState
from .vector import reset_batch, step_batch


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Collection, GAE and update settings, with the JAX package's
    defaults."""

    rollout_steps: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    lr: float = 3e-4
    # Final learning rate of the linear anneal (only with total_iters in
    # make_optimizer); None anneals to a floor of 0.1 * lr.
    lr_final: float | None = None
    epochs: int = 4
    minibatches: int = 4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    # Samples per shuffled block: a minibatch is whole blocks of
    # consecutive samples (shuffle_block envs of one view and step).
    shuffle_block: int = 1024


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


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: when the global norm of
    ``grads`` reaches ``max_norm`` each is scaled to ``g / norm *
    max_norm`` (not ``clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm)
    div = torch.where(norm < max_norm, 1.0, norm)
    for g in grads:
        g.div_(div).mul_(scale)


class Optimizer:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), adam(lr))``
    over ``params``, read from their ``.grad``: the gradients are clipped
    (:func:`clip_by_global_norm`), then Adam (b1 0.9, b2 0.999, eps 1e-8)
    steps with the learning rate of update ``k`` (0-based):
    ``lr + (lr_final - lr) * min(k / steps, 1)`` over ``steps`` updates,
    or ``lr`` throughout when ``steps`` is None."""

    def __init__(self, params, lr: float, max_grad_norm: float,
                 lr_final: float | None = None, steps: int | None = None):
        self.params = list(params)
        self.lr, self.lr_final, self.steps = lr, lr_final, steps
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def lr_at(self, k: int) -> float:
        if not self.steps:
            return self.lr
        return self.lr + (self.lr_final - self.lr) * min(k / self.steps, 1.0)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def clip_grads(self) -> None:
        clip_by_global_norm([p.grad for p in self.params], self.max_grad_norm)

    def step(self) -> None:
        """Clip the gradients, then one Adam step at ``lr_at(count)``."""
        self.clip_grads()
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1


def make_optimizer(model: ActorCritic, cfg: PPOConfig,
                   total_iters: int | None = None) -> Optimizer:
    """The update's optimiser over ``model``'s parameters. With
    ``total_iters`` the learning rate anneals linearly from ``cfg.lr`` to
    ``cfg.lr_final`` (None: ``0.1 * cfg.lr``) over ``total_iters *
    cfg.epochs * cfg.minibatches`` updates; without, it stays
    ``cfg.lr``."""
    steps = lr_final = None
    if total_iters:
        lr_final = 0.1 * cfg.lr if cfg.lr_final is None else cfg.lr_final
        steps = total_iters * cfg.epochs * cfg.minibatches
    return Optimizer(model.parameters(), cfg.lr, cfg.max_grad_norm,
                     lr_final, steps)


@dataclasses.dataclass
class RunnerState:
    model: ActorCritic
    env_state: EnvState          # batched
    obs: torch.Tensor            # [B, obs_dim] raw observation
    generator: torch.Generator   # on the model's device
    optimizer: Optimizer | None = None

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
    state, obs, gen = runner.env_state, runner.obs, runner.generator
    steps = []
    for t in range(cfg.rollout_steps):
        obs2 = _both_views(obs, env_params)
        logits, value = model(obs2)
        u = None if action_uniforms is None else action_uniforms[t]
        state, out, tr = selfplay_step(state, obs2, logits, value, u, gen,
                                       env_params)
        steps.append(tr)
        obs = out.obs
    _, last_value = model(_both_views(obs, env_params))
    return (runner.replace(env_state=state, obs=obs), stack_steps(steps),
            last_value)


def selfplay_step(state: EnvState, obs2: torch.Tensor, logits: torch.Tensor,
                  value: torch.Tensor, uniforms: torch.Tensor | None,
                  generator: torch.Generator, env_params: EnvParams):
    """One self-play step from both views' ``[2B]`` logits: sample the
    actions (``uniforms`` ``[G, 2B]`` or the generator), un-mirror team
    1's, step the env. Returns (state, step output, the step's
    :class:`Transition` with ``[2B]`` fields)."""
    b = obs2.shape[0] // 2
    action2, logp = sample_actions(logits, uniforms, generator=generator)
    joint = torch.cat([action2[:b], env_core.mirror_actions(action2[b:])], dim=1)
    state, out = step_batch(state, joint, env_params, generator)
    dirs, acts = pack_actions(action2)
    return state, out, Transition(
        obs=obs2, dirs=dirs, acts=acts, logp=logp, value=value,
        reward=torch.cat([out.team_reward[:, 0], out.team_reward[:, 1]]),
        done=torch.cat([out.done, out.done]))


def stack_steps(steps: list[Transition]) -> Transition:
    """Per-step transitions -> one with ``[T, ...]`` fields."""
    return Transition(**{
        f.name: torch.stack([getattr(s, f.name) for s in steps])
        for f in dataclasses.fields(Transition)})


@torch.no_grad()
def collect_rollout_fused(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    uniforms: torch.Tensor | None = None, compute_dtype=torch.bfloat16,
) -> tuple[RunnerState, Transition, torch.Tensor]:
    """:func:`collect_rollout` on the fused kernel: both views' forward,
    sampling, the env step and auto-reset for all T steps in one launch
    on a CUDA device (its plain version on the CPU). The sampling seed
    is drawn from ``runner.generator``; ``uniforms`` ``[T, n_draws, B]``
    replaces the kernel's Philox stream. ``compute_dtype``: bfloat16 (the
    layer products' operands rounded as the JAX kernel's are on its chip,
    the tensor-core kernel) or float32 (exact), as
    :func:`ops.fused_collect.fused_collect` takes it. logp and value are
    the kernel's own for its own actions. Returns (runner, traj with
    feature-major obs, bootstrap value ``[2B]``)."""
    from .ops import pack_state, unpack_state
    from .ops.fused_collect import flatten_actor_critic, fused_collect

    _check_model(runner.model, env_params)
    gen = runner.generator
    sf, si = pack_state(runner.env_state, env_params)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    (sf, si, obs, dirs, acts, logp, value, reward, done,
     last_v) = fused_collect(sf, si, flatten_actor_critic(runner.model), seed,
                             env_params, cfg.rollout_steps, uniforms=uniforms,
                             compute_dtype=compute_dtype)
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


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------


def _forward_fm(model: ActorCritic, obs_fm: torch.Tensor):
    """The actor-critic forward on a feature-major ``[F, S]`` obs matrix:
    the module's weights and math with the samples on the second axis.
    Obs rows beyond the model's input (the fused collect's zero pad rows
    up to F_pad) meet zero weight columns. Returns (logit rows
    ``[G*5, S]``, value ``[S]``)."""
    x = obs_fm.to(model.logits.weight.dtype)
    for i, layer in enumerate(model.torso):
        w = layer.weight
        if i == 0 and x.shape[0] > w.shape[1]:
            w = torch.nn.functional.pad(w, (0, x.shape[0] - w.shape[1]))
        x = torch.tanh(w @ x + layer.bias[:, None])
    logits = model.logits.weight @ x + model.logits.bias[:, None]
    value = (model.value.weight @ x + model.value.bias[:, None])[0]
    return logits, value


def ppo_loss(
    model: ActorCritic, obs_fm: torch.Tensor, dirs: torch.Tensor,
    acts: torch.Tensor, logp_old: torch.Tensor, value_old: torch.Tensor,
    adv: torch.Tensor, returns: torch.Tensor, cfg: PPOConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Clipped-surrogate PPO loss over one feature-major minibatch:
    ``obs_fm`` ``[F, S]``, every other tensor ``[S]``. The advantage is
    normalised over the minibatch (population std, plus 1e-8). Returns
    (total loss, metrics)."""
    logit_rows, value = _forward_fm(model, obs_fm)
    logp, entropy = action_log_prob_and_entropy_packed(logit_rows.T, dirs, acts)
    return clipped_surrogate(logp, entropy, value, logp_old, value_old, adv,
                             returns, cfg)


def clipped_surrogate(
    logp: torch.Tensor, entropy: torch.Tensor, value: torch.Tensor,
    logp_old: torch.Tensor, value_old: torch.Tensor, adv: torch.Tensor,
    returns: torch.Tensor, cfg: PPOConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """PPO's loss from the new log-probs, entropies and values and the
    behaviour policy's, over tensors of any one shape (means over all of
    it): (total loss, metrics)."""
    ratio = torch.exp(logp - logp_old)

    norm_adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * norm_adv
    pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * norm_adv
    pg_loss = -torch.minimum(pg1, pg2).mean()

    v_clipped = value_old + torch.clamp(value - value_old, -cfg.clip_eps,
                                        cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - returns) ** 2,
                                 (v_clipped - returns) ** 2).mean()
    ent = entropy.mean()

    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    metrics = {
        "loss": total,
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": ent,
        "approx_kl": ((ratio - 1) - torch.log(ratio)).mean(),
    }
    return total, metrics


def _flatten_tm(x: torch.Tensor) -> torch.Tensor:
    """``[T, 2B]`` time-major self-play field -> ``[N]`` samples ordered
    (view, step, env), the fused collect's obs column order."""
    t, b2 = x.shape
    return x.reshape(t, 2, b2 // 2).transpose(0, 1).reshape(t * b2)


def _obs_to_fm(obs3: torch.Tensor) -> torch.Tensor:
    """Row-major stacked obs ``[T, 2B, F]`` (plain collect) -> the
    feature-major ``[F, N]`` matrix in :func:`_flatten_tm`'s order."""
    t, b2, f = obs3.shape
    return obs3.reshape(t, 2, b2 // 2, f).permute(3, 1, 0, 2).reshape(f, t * b2)


def _shuffle_block_for(n: int, cfg: PPOConfig) -> int:
    """The largest divisor of ``n`` that is at most ``cfg.shuffle_block``
    and leaves at least ``cfg.minibatches`` blocks."""
    b = min(cfg.shuffle_block, n // max(cfg.minibatches, 1))
    while b > 1 and n % b:
        b -= 1
    return max(b, 1)


def _epoch_perms(n_blocks: int, cfg: PPOConfig, generator: torch.Generator,
                 perms: torch.Tensor | None) -> torch.Tensor:
    """One block permutation per epoch, ``[epochs, n_blocks]``: drawn from
    ``generator``, or ``perms`` as given (tests feed JAX's)."""
    if perms is None:
        return torch.stack([
            torch.randperm(n_blocks, generator=generator, device=generator.device)
            for _ in range(cfg.epochs)])
    if tuple(perms.shape) != (cfg.epochs, n_blocks):
        raise ValueError(f"perms must be [{cfg.epochs}, {n_blocks}]")
    if int(perms.min()) < 0 or int(perms.max()) >= n_blocks:
        raise ValueError(f"perms hold a block index outside [0, {n_blocks})")
    return perms


def _mean_metrics(history: list[dict]) -> dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}


def update_epochs(
    model: ActorCritic, optimizer: Optimizer, traj: Transition,
    adv: torch.Tensor, returns: torch.Tensor, generator: torch.Generator,
    cfg: PPOConfig, perms: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """``cfg.epochs`` x ``cfg.minibatches`` optimiser steps of
    :func:`ppo_loss` under autograd over the flattened buffer, shuffled
    in blocks of :func:`_shuffle_block_for` samples (one permutation per
    epoch; module docstring). ``traj.obs`` may be feature-major
    ``[F, N]`` or row-major ``[T, 2B, F]``. Updates ``model`` in place;
    returns each metric's mean over the steps."""
    t, b2 = traj.reward.shape
    n = t * b2
    obs_fm = traj.obs if traj.obs.dim() == 2 else _obs_to_fm(traj.obs)
    if obs_fm.shape[1] != n:
        raise ValueError(f"feature-major obs has {obs_fm.shape[1]} samples, "
                         f"the buffer {n}")
    block = _shuffle_block_for(n, cfg)
    n_blocks = n // block
    f_dim = obs_fm.shape[0]
    obs_blk = obs_fm.reshape(f_dim, n_blocks, block)
    flat = {k: _flatten_tm(v).reshape(n_blocks, block) for k, v in (
        ("dirs", traj.dirs), ("acts", traj.acts), ("logp", traj.logp),
        ("value", traj.value), ("adv", adv), ("ret", returns))}
    mb_blocks = n_blocks // cfg.minibatches
    mb_size = mb_blocks * block
    history = []
    for perm in _epoch_perms(n_blocks, cfg, generator, perms):
        for idx in perm[: cfg.minibatches * mb_blocks].reshape(
                cfg.minibatches, mb_blocks):
            f = {k: v[idx].reshape(mb_size) for k, v in flat.items()}
            optimizer.zero_grad()
            loss, metrics = ppo_loss(
                model, obs_blk[:, idx].reshape(f_dim, mb_size), f["dirs"],
                f["acts"], f["logp"], f["value"], f["adv"], f["ret"], cfg)
            loss.backward()
            optimizer.step()
            history.append({k: v.detach() for k, v in metrics.items()})
    return _mean_metrics(history)


def update_epochs_fused(
    model: ActorCritic, optimizer: Optimizer, traj: Transition,
    adv: torch.Tensor, returns: torch.Tensor, generator: torch.Generator,
    cfg: PPOConfig, perms: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """:func:`update_epochs` on the fused minibatch gradient
    (:func:`ops.fused_update.fused_minibatch_grad`): each minibatch's
    forward, loss and hand-written backward read the feature-major buffer
    through the block indices, with no gathered copy of the obs. Needs
    the feature-major ``[F_pad, N]`` obs (:func:`collect_rollout_fused`)
    with N a multiple of ``cfg.shuffle_block``. ``compute_dtype``
    bfloat16 (operands of the layer products rounded, sums in float32)
    or float32. The obs are raw: :class:`Transition` carries no
    normalisation statistics, whose fold into the first layer comes with
    the normalised collect (ROADMAP item 11)."""
    from .ops.fused_collect import flatten_actor_critic
    from .ops.fused_update import fused_minibatch_grad, unflatten_actor_critic

    t, b2 = traj.reward.shape
    n = t * b2
    if traj.obs.dim() != 2 or traj.obs.shape[1] != n:
        raise ValueError("update_epochs_fused needs the feature-major [F, N] "
                         "obs of collect_rollout_fused")
    block = cfg.shuffle_block
    if n % block or n // block < cfg.minibatches:
        raise ValueError(f"a buffer of {n} samples needs a multiple of "
                         f"shuffle_block={block} with at least "
                         f"{cfg.minibatches} blocks")
    n_blocks = n // block
    flat = {k: _flatten_tm(v).reshape(n_blocks, block).contiguous() for k, v in (
        ("dirs", traj.dirs), ("acts", traj.acts), ("logp", traj.logp),
        ("value", traj.value), ("adv", adv), ("ret", returns))}
    mb_blocks = n_blocks // cfg.minibatches
    inv_m = 1.0 / (mb_blocks * block)
    obs_fm = traj.obs.contiguous()
    history = []
    for perm in _epoch_perms(n_blocks, cfg, generator, perms):
        for idx in perm[: cfg.minibatches * mb_blocks].reshape(
                cfg.minibatches, mb_blocks):
            idx = idx.to(torch.int32).contiguous()
            adv_mb = flat["adv"][idx]
            adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
            grads, sums = fused_minibatch_grad(
                flatten_actor_critic(model), obs_fm, flat["dirs"], flat["acts"],
                flat["logp"], flat["value"], flat["ret"], adv_n, idx,
                n_torso=len(model.hidden), clip_eps=cfg.clip_eps,
                vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, block=block,
                compute_dtype=compute_dtype)
            unflatten_actor_critic(grads, model)
            optimizer.step()
            metrics = {k: v * inv_m for k, v in sums.items()}
            metrics["loss"] = (metrics["pg_loss"] + cfg.vf_coef * metrics["v_loss"]
                               - cfg.ent_coef * metrics["entropy"])
            history.append(metrics)
    return _mean_metrics(history)


def train_iteration(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    collect_fn=None, update_fn=None,
) -> tuple[RunnerState, dict[str, torch.Tensor]]:
    """One PPO iteration: collect (``collect_fn``, default
    :func:`collect_rollout`; :func:`collect_rollout_fused` for the kernel)
    -> GAE -> epochs of updates (``update_fn``, default
    :func:`update_epochs`; :func:`update_epochs_fused` for the kernel)
    with the runner's optimiser. Returns (runner, metrics): the update's
    mean ``loss``, ``pg_loss``, ``v_loss``, ``entropy``, ``approx_kl``
    and ``mean_reward`` over the team-0 rows, as 0-dim tensors."""
    collect_fn = collect_fn or collect_rollout
    update_fn = update_fn or update_epochs
    runner, traj, last_value = collect_fn(runner, env_params, cfg)
    adv, returns = compute_gae(traj, last_value, cfg)
    metrics = update_fn(runner.model, runner.optimizer, traj, adv, returns,
                        runner.generator, cfg)
    # rows [:B] are team 0's view, as evaluate() reports
    metrics["mean_reward"] = traj.reward[:, : traj.reward.shape[1] // 2].mean()
    return runner, metrics


def init_runner(
    generator: torch.Generator, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig, n_envs: int, total_iters: int | None = None,
) -> RunnerState:
    """Initialise ``model`` from ``generator`` (flax's initialisers),
    build its optimiser (:func:`make_optimizer`, annealed over
    ``total_iters`` when given) and reset ``n_envs`` envs on the model's
    device; the runner keeps the generator for every later draw."""
    init_params(generator, model, env_params)
    device = model.logits.weight.device
    env_state, obs = reset_batch(generator, env_params, n_envs, device=device)
    return RunnerState(model=model, env_state=env_state, obs=obs,
                       generator=generator,
                       optimizer=make_optimizer(model, cfg, total_iters))
