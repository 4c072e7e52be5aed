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

Both train through VecNormalize-style normalisation
(:mod:`gym_futbol_tpu_torch.wrappers`; statistics on the runner, made by
``init_runner(..., normalize_obs=, normalize_reward=)``):
:func:`make_normalized_collect` normalises inside the plain loop and
stores normalised obs; the fused collect folds the statistics of the
iteration before into the first layer (:func:`fold_obs_norm`), stores the
raw obs with those statistics on ``traj.norm`` for
:func:`update_epochs_fused` to fold the same way, and scales the rewards
after the kernel (:func:`posthoc_reward_norm`).

Two updates take that experience through ``cfg.epochs`` x
``cfg.minibatches`` optimiser steps over shuffled sample blocks:
:func:`update_epochs`, :func:`ppo_loss` under autograd, and
:func:`update_epochs_fused`, each minibatch's forward and hand-written
backward in the kernels of :mod:`gym_futbol_tpu_torch.ops.fused_update`.
:func:`train_iteration` chains collect, GAE and update.

Each takes ``group``, a ``torch.distributed`` process group over which
the envs are sharded (:mod:`gym_futbol_tpu_torch.parallel`; None: an
undistributed run, the default): the updates average each minibatch's
gradients and metrics over the ranks in one all-reduce before the
optimiser's clip (:func:`average_grads`), the normalisers merge every
rank's moments, and ``mean_reward`` is the mean over all envs.
"""

from __future__ import annotations

import dataclasses
import functools

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
from .utils.profiling import span
from .vector import reset_batch, step_batch
from .wrappers import RewardNorm, RunningNorm


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
    with samples ordered (view, step, env) (fused collect). ``norm``: the
    frozen observation statistics a normalised fused collect acted
    through, which the update folds into the first layer as the collect
    did (its obs are raw); None on every other path (the plain normalised
    collect stores normalised obs)."""

    obs: torch.Tensor
    dirs: torch.Tensor
    acts: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    norm: RunningNorm | None = None


# the Transition fields that hold the experience itself
TRAJ_FIELDS = ("obs", "dirs", "acts", "logp", "value", "reward", "done")


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

    def state_dict(self) -> dict:
        """Adam's moments and step counts, and ``count``: the anneal's
        position."""
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = state["count"]


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
    # VecNormalize statistics, carried across iterations by the
    # normalised collects; None when off
    obs_norm: RunningNorm | None = None
    rew_norm: RewardNorm | None = None

    def replace(self, **kw) -> "RunnerState":
        return dataclasses.replace(self, **kw)


def average_grads(params, metrics: dict, group) -> dict:
    """The ``.grad`` of each of ``params`` and the 0-dim ``metrics``
    averaged over ``group``'s ranks in ONE all-reduce, the gradients in
    place (the JAX package's ``pmean`` of both, ``ppo.py:711-713``). It
    comes before the optimiser's global-norm clip, which then clips the
    averaged gradients, as optax does. With ``group`` None, nothing
    changes. Returns the metrics."""
    if group is None:
        return metrics
    from .parallel.mesh import all_mean

    grads = [p.grad for p in params]
    names = list(metrics)
    out = all_mean(grads + [metrics[k] for k in names], group)
    for g, mean in zip(grads, out):
        g.copy_(mean)
    return dict(zip(names, out[len(grads):]))


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
    return _collect(runner, env_params, cfg, action_uniforms)


def make_normalized_collect(normalize_obs: bool = True,
                            normalize_reward: bool = True, group=None):
    """:func:`collect_rollout` with VecNormalize semantics, the JAX
    package's ``make_normalized_collect``: the policy acts on, and the
    buffer stores, z-scored observations and rewards divided by the
    running standard deviation of the discounted return. The statistics
    (``runner.obs_norm`` / ``rew_norm``, from ``init_runner(...,
    normalize_obs=True, normalize_reward=True)``) are updated every step.
    Both views are mirrored from the RAW observation (``mirror_obs``'s
    ``x -> 1 - x`` holds for field coordinates, not for z-scores), then
    normalised with one set of statistics, updated on both; the reward
    statistics follow team 0's reward; the bootstrap value reads the
    statistics after the last step, without updating them. With ``group``
    every step merges the moments of every rank's share, so each rank
    applies the one global normaliser. Returns a drop-in for
    :func:`collect_rollout`."""
    return functools.partial(_collect, normalize_obs=normalize_obs,
                             normalize_reward=normalize_reward, group=group)


def _check_norms(runner: RunnerState, normalize_obs: bool,
                 normalize_reward: bool) -> None:
    if normalize_obs and runner.obs_norm is None:
        raise ValueError("init_runner(..., normalize_obs=True) required")
    if normalize_reward and runner.rew_norm is None:
        raise ValueError("init_runner(..., normalize_reward=True) required")


@torch.no_grad()
def _collect(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    action_uniforms: torch.Tensor | None = None, *,
    normalize_obs: bool = False, normalize_reward: bool = False, group=None,
) -> tuple[RunnerState, Transition, torch.Tensor]:
    model = runner.model
    _check_model(model, env_params)
    _check_norms(runner, normalize_obs, normalize_reward)
    onorm, rnorm = runner.obs_norm, runner.rew_norm
    state, obs, gen = runner.env_state, runner.obs, runner.generator
    steps = []
    for t in range(cfg.rollout_steps):
        obs2 = _both_views(obs, env_params)
        if normalize_obs:
            onorm = onorm.update(obs2, group)
            obs2 = onorm.normalize(obs2)
        logits, value = model(obs2)
        u = None if action_uniforms is None else action_uniforms[t]
        state, out, tr = selfplay_step(state, obs2, logits, value, u, gen,
                                       env_params)
        if normalize_reward:
            rnorm = rnorm.update(out.team_reward[:, 0], out.done, cfg.gamma,
                                 group)
            tr.reward = rnorm.normalize(tr.reward)
        steps.append(tr)
        obs = out.obs
    obs2 = _both_views(obs, env_params)
    _, last_value = model(onorm.normalize(obs2) if normalize_obs else obs2)
    return (runner.replace(env_state=state, obs=obs, obs_norm=onorm,
                           rew_norm=rnorm), stack_steps(steps), last_value)


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
        name: torch.stack([getattr(s, name) for s in steps])
        for name in TRAJ_FIELDS})


def _obs_norm_scales(obs_norm: RunningNorm, eps: float = 1e-8):
    """(mean, inv_std) of a :class:`~gym_futbol_tpu_torch.wrappers.RunningNorm`:
    the affine map ``z = (x - mean) * inv_std`` that :func:`fold_obs_norm`
    bakes into the weights. The folded path applies no ``±10`` clip
    (``RunningNorm.normalize`` does): the env's observations are bounded
    (field-normalised positions and velocities, 0/1 flags), so the clip
    binds only while the variance rests on a few batches."""
    return obs_norm.mean, torch.rsqrt(obs_norm.var + eps)


def fold_obs_norm(w: tuple, mean: torch.Tensor, inv_std: torch.Tensor) -> tuple:
    """Fold frozen z-score statistics into the FIRST layer of a flat
    kernel-order weight tuple (:func:`ops.fused_collect.flatten_actor_critic`:
    ``W`` ``[in, out]``, ``b`` ``[out, 1]``): ``W1' = diag(inv_std) W1``,
    ``b1' = b1 - W1'^T mean``. The network on RAW observations then
    computes the original network on z-scored ones (without the ``±10``
    clip, :func:`_obs_norm_scales`), so the kernels, which build raw obs
    or read the raw buffer, train through the normalisation unchanged."""
    w0f = w[0] * inv_std[:, None]
    b0f = w[1] - (w0f * mean[:, None]).sum(0)[:, None]
    return (w0f, b0f, *w[2:])


def unfold_obs_norm_grads(g: tuple, mean: torch.Tensor,
                          inv_std: torch.Tensor) -> tuple:
    """The chain rule back through :func:`fold_obs_norm`: gradients with
    respect to the folded ``(W1', b1')`` -> with respect to ``(W1, b1)``:
    ``dW1 = diag(inv_std) (dW1' - mean db1'^T)``, ``db1 = db1'``."""
    g0 = inv_std[:, None] * (g[0] - mean[:, None] * g[1].reshape(1, -1))
    return (g0, g[1], *g[2:])


@torch.no_grad()
def collect_rollout_fused(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    uniforms: torch.Tensor | None = None, compute_dtype=torch.bfloat16,
    normalize_obs: bool = False, normalize_reward: bool = False, group=None,
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
    feature-major obs, bootstrap value ``[2B]``).

    ``normalize_obs`` / ``normalize_reward`` give VecNormalize semantics
    with the kernel unchanged: ``runner.obs_norm`` as the iteration
    starts (the lagged statistics) is folded into the first layer
    (:func:`fold_obs_norm`) and rides on ``traj.norm`` for
    :func:`update_epochs_fused`; the raw buffer's moments then merge into
    ``obs_norm`` for the next iteration (:func:`merge_buffer_moments`),
    and the rewards are scaled by :func:`posthoc_reward_norm`, the
    plain normalised collect's per-step sequence replayed; with ``group``
    both merge every rank's moments."""
    from .ops import pack_state, unpack_state
    from .ops.fused_collect import flatten_actor_critic, fused_collect

    _check_model(runner.model, env_params)
    _check_norms(runner, normalize_obs, normalize_reward)
    w = flatten_actor_critic(runner.model)
    frozen = runner.obs_norm if normalize_obs else None
    if frozen is not None:
        w = fold_obs_norm(w, *_obs_norm_scales(frozen))
    gen = runner.generator
    sf, si = pack_state(runner.env_state, env_params)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    (sf, si, obs, dirs, acts, logp, value, reward, done,
     last_v) = fused_collect(sf, si, w, seed, env_params, cfg.rollout_steps,
                             uniforms=uniforms, compute_dtype=compute_dtype)
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
        norm=frozen,
    )
    obs_norm, rew_norm = runner.obs_norm, runner.rew_norm
    if normalize_obs:
        obs_norm = merge_buffer_moments(obs_norm, traj.obs,
                                        env_core.obs_size(env_params), group)
    if normalize_reward:
        rew_norm, traj.reward = posthoc_reward_norm(rew_norm, traj.reward,
                                                    traj.done, cfg.gamma, group)
    env_state = unpack_state(sf, si, env_params)
    runner = runner.replace(env_state=env_state,
                            obs=env_core.observe(env_state, env_params),
                            obs_norm=obs_norm, rew_norm=rew_norm)
    return runner, traj, last_v.reshape(2 * b)


def merge_buffer_moments(obs_norm: RunningNorm, obs_fm: torch.Tensor,
                         n_feat: int, group=None) -> RunningNorm:
    """``obs_norm`` with the moments of a feature-major ``[F_pad, N]``
    buffer merged in: its ``n_feat`` real rows only (never the zero pad
    rows), one reduction along each row, no transpose. With ``group`` the
    buffer is this rank's share of the batch."""
    rows = obs_fm[:n_feat]
    var, mean = torch.var_mean(rows, dim=1, correction=0)
    return obs_norm.update_moments(
        mean, var, torch.full((), rows.shape[1], dtype=rows.dtype,
                              device=rows.device), group)


def posthoc_reward_norm(rew_norm: RewardNorm, reward: torch.Tensor,
                        done: torch.Tensor, gamma: float, group=None):
    """VecNormalize reward scaling after a fused collect, over its ``[T,
    2B]`` buffers: step by step, the update and scaling of the plain
    normalised collect (:func:`make_normalized_collect`): the statistics
    follow team 0's rows, both views are scaled by the statistics through
    that step. Returns (the updated :class:`RewardNorm`, the scaled
    rewards ``[T, 2B]``).

    The discounted returns, and so their batch moments, do not depend on
    the running statistics: all T steps' moments are computed first,
    each by the same operations as :meth:`RewardNorm.update`, and with
    ``group`` merged across the ranks in one all-reduce of the stacked
    moments (:func:`wrappers.global_moments`) instead of T; the merges
    then run in sequence. Bitwise the per-step sequence."""
    from .wrappers import global_moments

    b = reward.shape[1] // 2
    steps, acc = [], rew_norm
    for t in range(reward.shape[0]):
        ret, *moments = acc.returns(reward[t, :b], gamma)
        acc = dataclasses.replace(acc, ret=torch.where(done[t, :b], 0.0, ret))
        steps.append((ret, moments))
    if group is not None:
        stacked = global_moments(*(torch.stack(m) for m in zip(*(
            moments for _, moments in steps))), group)
        steps = [(ret, m) for (ret, _), m in zip(steps, zip(*(
            x.unbind() for x in stacked)))]
    scaled = torch.empty_like(reward)
    for t, (ret, moments) in enumerate(steps):
        rew_norm = rew_norm.merge(ret, done[t, :b], *moments)
        scaled[t] = rew_norm.normalize(reward[t])
    return rew_norm, scaled


def make_fused_normalized_collect(normalize_obs: bool = True,
                                  normalize_reward: bool = True, group=None):
    """The fused twin of :func:`make_normalized_collect`: a drop-in for
    :func:`collect_rollout_fused` with the given normalisations (with
    ``group``: the global statistics); pair it with
    :func:`update_epochs_fused`, which reads ``traj.norm``."""
    return functools.partial(collect_rollout_fused, normalize_obs=normalize_obs,
                             normalize_reward=normalize_reward, group=group)


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
    cfg: PPOConfig, perms: torch.Tensor | None = None, group=None,
) -> dict[str, torch.Tensor]:
    """``cfg.epochs`` x ``cfg.minibatches`` optimiser steps of
    :func:`ppo_loss` under autograd over the flattened buffer, shuffled
    in blocks of :func:`_shuffle_block_for` samples (one permutation per
    epoch; module docstring). ``traj.obs`` may be feature-major
    ``[F, N]`` or row-major ``[T, 2B, F]``. A normalised fused collect's
    trajectory (``traj.norm`` set, raw obs) is refused: it belongs to
    :func:`update_epochs_fused`, which folds the statistics in. With
    ``group`` each step's gradients and metrics are averaged over the
    ranks first (:func:`average_grads`). Updates ``model`` in place;
    returns each metric's mean over the steps."""
    if traj.norm is not None:
        raise ValueError(
            "a normalised fused trajectory (traj.norm set, raw obs) is "
            "consumed by update_epochs_fused, which folds the statistics "
            "into the first layer; update_epochs would train on raw obs")
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
            metrics = average_grads(optimizer.params, {
                k: v.detach() for k, v in metrics.items()}, group)
            optimizer.step()
            history.append(metrics)
    return _mean_metrics(history)


def update_epochs_fused(
    model: ActorCritic, optimizer: Optimizer, traj: Transition,
    adv: torch.Tensor, returns: torch.Tensor, generator: torch.Generator,
    cfg: PPOConfig, perms: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16, group=None,
) -> dict[str, torch.Tensor]:
    """:func:`update_epochs` on the fused minibatch gradient
    (:func:`ops.fused_update.fused_minibatch_grad`): each minibatch's
    forward, loss and hand-written backward read the feature-major buffer
    through the block indices, with no gathered copy of the obs. Needs
    the feature-major ``[F_pad, N]`` obs (:func:`collect_rollout_fused`)
    with N a multiple of ``cfg.shuffle_block``. ``compute_dtype``
    bfloat16 (operands of the layer products rounded, sums in float32)
    or float32. With ``traj.norm`` set (a normalised fused collect, raw
    obs) every launch gets the weights with those statistics folded in
    (:func:`fold_obs_norm`), as the collect acted, and its gradients
    are chained back (:func:`unfold_obs_norm_grads`); the buffer's zero
    pad rows meet zero weight rows either way. With ``group`` each
    launch's gradients and metrics are averaged over the ranks before the
    optimiser step (:func:`average_grads`)."""
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
    scales = None if traj.norm is None else _obs_norm_scales(traj.norm)
    history = []
    for perm in _epoch_perms(n_blocks, cfg, generator, perms):
        for idx in perm[: cfg.minibatches * mb_blocks].reshape(
                cfg.minibatches, mb_blocks):
            idx = idx.to(torch.int32).contiguous()
            adv_mb = flat["adv"][idx]
            adv_n = (adv_mb - adv_mb.mean()) / (adv_mb.std(correction=0) + 1e-8)
            w = flatten_actor_critic(model)
            if scales is not None:
                w = fold_obs_norm(w, *scales)
            grads, sums = fused_minibatch_grad(
                w, obs_fm, flat["dirs"], flat["acts"], flat["logp"],
                flat["value"], flat["ret"], adv_n, idx,
                n_torso=len(model.hidden), clip_eps=cfg.clip_eps,
                vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, block=block,
                compute_dtype=compute_dtype)
            if scales is not None:
                grads = unfold_obs_norm_grads(grads, *scales)
            unflatten_actor_critic(grads, model)
            metrics = {k: v * inv_m for k, v in sums.items()}
            metrics["loss"] = (metrics["pg_loss"] + cfg.vf_coef * metrics["v_loss"]
                               - cfg.ent_coef * metrics["entropy"])
            metrics = average_grads(optimizer.params, metrics, group)
            optimizer.step()
            history.append(metrics)
    return _mean_metrics(history)


def train_iteration(
    runner: RunnerState, env_params: EnvParams, cfg: PPOConfig,
    collect_fn=None, update_fn=None, group=None,
) -> tuple[RunnerState, dict[str, torch.Tensor]]:
    """One PPO iteration: collect (``collect_fn``, default
    :func:`collect_rollout`; :func:`collect_rollout_fused` for the kernel)
    -> GAE -> epochs of updates (``update_fn``, default
    :func:`update_epochs`; :func:`update_epochs_fused` for the kernel)
    with the runner's optimiser. Returns (runner, metrics): the update's
    mean ``loss``, ``pg_loss``, ``v_loss``, ``entropy``, ``approx_kl``
    and ``mean_reward`` over the team-0 rows, as 0-dim tensors. With
    ``group`` (the runner one rank's share, as ``parallel.shard_runner``
    gives it) the update averages over the ranks and ``mean_reward`` is
    the mean over every rank's envs; a normalised ``collect_fn`` takes
    the group when it is made (:func:`make_normalized_collect`). The
    three stages are the spans ``ppo.collect``, ``ppo.gae`` and
    ``ppo.update`` while a profiler runs."""
    collect_fn = collect_fn or collect_rollout
    update_fn = update_fn or update_epochs
    with span("ppo.collect"):
        runner, traj, last_value = collect_fn(runner, env_params, cfg)
    with span("ppo.gae"):
        adv, returns = compute_gae(traj, last_value, cfg)
    with span("ppo.update"):
        metrics = update_fn(runner.model, runner.optimizer, traj, adv, returns,
                            runner.generator, cfg, group=group)
    metrics["mean_reward"] = mean_reward(traj, group)
    return runner, metrics


def mean_reward(traj: Transition, group=None) -> torch.Tensor:
    """The mean reward of the team-0 rows ``[:B]`` (as ``evaluate``
    reports it), over every rank's envs with ``group``."""
    from .parallel.mesh import all_mean

    return all_mean([traj.reward[:, : traj.reward.shape[1] // 2].mean()],
                    group)[0]


def init_runner(
    generator: torch.Generator, model: ActorCritic, env_params: EnvParams,
    cfg: PPOConfig, n_envs: int, total_iters: int | None = None,
    normalize_obs: bool = False, normalize_reward: bool = False,
) -> RunnerState:
    """Initialise ``model`` from ``generator`` (flax's initialisers),
    build its optimiser (:func:`make_optimizer`, annealed over
    ``total_iters`` when given) and reset ``n_envs`` envs on the model's
    device; the runner keeps the generator for every later draw.
    ``normalize_obs`` / ``normalize_reward`` start the statistics the
    normalised collects carry: a ``RunningNorm`` over the observation's
    features, a ``RewardNorm`` over the ``n_envs`` envs."""
    init_params(generator, model, env_params)
    device = model.logits.weight.device
    env_state, obs = reset_batch(generator, env_params, n_envs, device=device)
    return RunnerState(
        model=model, env_state=env_state, obs=obs, generator=generator,
        optimizer=make_optimizer(model, cfg, total_iters),
        obs_norm=(RunningNorm.init(env_core.obs_size(env_params), device)
                  if normalize_obs else None),
        rew_norm=RewardNorm.init(n_envs, device) if normalize_reward else None)
