"""A2C in PyTorch: the feed-forward learner and the recurrent (LSTM) one.

Counterpart of :mod:`gym_futbol_tpu.a2c`. The feed-forward learner
reuses PPO's self-play collect (:func:`ppo.collect_rollout`, or
:func:`ppo.collect_rollout_fused` on the ``fused_collect`` kernel), GAE
with ``gae_lambda`` 1 (the plain n-step advantage) and ONE full-batch
gradient step per iteration, no clipping and no minibatch epochs, with
RMSProp (:class:`RMSProp`, optax's, the stable-baselines A2C default).

The recurrent learner (the ``MlpLstmPolicy`` analog) collects with a
:class:`~gym_futbol_tpu_torch.models.recurrent.RecurrentActorCritic`
whose (c, h) carry, one per view, is zeroed where an episode ends:
:func:`collect_recurrent_rollout` steps the model and the env one batch
at a time, :func:`collect_recurrent_rollout_fused` runs the whole window
in one launch of the ``fused_recurrent_collect`` kernel. The loss
(:func:`recurrent_a2c_loss`) re-runs the model over the window from the
carry it started with, resetting at the same episode ends, so gradients
flow through time (BPTT). :mod:`gym_futbol_tpu_torch.recurrent_ppo`
shares the collect and the runner.

Where the package picks the fused recurrent collect's route for the
user (:data:`FUSED_COLLECT_DTYPE`: the recurrent gate's default, the
CLI's ``--recurrent --fused-collect``), recurrent A2C takes K5's exact
float32 route and recurrent PPO its bfloat16 tensor-core route. A2C has
no importance ratio to absorb the gap between the bf16 behaviour policy
that samples the window and the float32 model its BPTT step re-runs:
its gradient weighs every sampled action by the learner's log-prob as if
the learner had sampled it. PPO's ratio ``exp(logp_learner -
logp_collect)``, clipped, does absorb it. JAX's A2C gate trains on its
exact plain collect.

Both iterations take ``group``, a ``torch.distributed`` process group
over which the envs are sharded (:mod:`gym_futbol_tpu_torch.parallel`):
the gradients and metrics are averaged over the ranks before RMSProp's
clip, ``mean_reward`` over every rank's envs.
"""

from __future__ import annotations

import dataclasses

import torch

from . import env as env_core
from .models.policy import ActorCritic, action_log_prob_and_entropy_packed, init_params
from .models.recurrent import (
    RecurrentActorCritic,
    init_recurrent_params,
    reset_carry_where_done,
)
from .ppo import (
    TRAJ_FIELDS,
    RunnerState,
    Transition,
    _both_views,
    _check_model,
    _flatten_tm,
    _forward_fm,
    average_grads,
    clip_by_global_norm,
    collect_rollout,
    compute_gae,
    mean_reward,
    selfplay_step,
    stack_steps,
)
from .types import EnvParams, EnvState
from .vector import reset_batch


# K5's route (``compute_dtype``) for the recurrent learners' fused collect
# wherever the package picks it for the user: the recurrent gate's
# --collect-dtype default and the training CLI's --recurrent
# --fused-collect. A2C's is exact (see the module docstring).
FUSED_COLLECT_DTYPE = {"a2c": "float32", "ppo": "bfloat16"}


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """Collection, advantage and RMSProp settings, with the JAX package's
    defaults."""

    rollout_steps: int = 8
    gamma: float = 0.99
    gae_lambda: float = 1.0      # 1.0: the plain n-step advantage
    lr: float = 7e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    rms_decay: float = 0.99
    rms_eps: float = 1e-5


class RMSProp:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), rmsprop(lr,
    decay, eps))`` over ``params``, read from their ``.grad``: the
    gradients are clipped (:func:`ppo.clip_by_global_norm`), then ``nu =
    (1 - decay) * g**2 + decay * nu`` (from zero) and ``p -= lr * g /
    sqrt(nu + eps)``. optax takes the root of ``nu + eps``; PyTorch's
    ``RMSprop`` adds ``eps`` to the root, which at eps 1e-5 gives steps
    orders of magnitude apart on the first updates."""

    def __init__(self, params, lr: float, max_grad_norm: float, decay: float,
                 eps: float):
        self.params = list(params)
        self.lr, self.max_grad_norm, self.decay, self.eps = (
            lr, max_grad_norm, decay, eps)
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        clip_by_global_norm([p.grad for p in self.params], self.max_grad_norm)
        for p, nu in zip(self.params, self.nu):
            g = p.grad
            nu.copy_((1 - self.decay) * (g * g) + self.decay * nu)
            p.add_(-self.lr * (torch.rsqrt(nu + self.eps) * g))
        self.count += 1

    def state_dict(self) -> dict:
        return {"nu": list(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for nu, saved in zip(self.nu, state["nu"], strict=True):
            nu.copy_(saved)
        self.count = state["count"]


def make_optimizer(model: torch.nn.Module, cfg: A2CConfig) -> RMSProp:
    """RMSProp over ``model``'s parameters at ``cfg``'s constant rate."""
    return RMSProp(model.parameters(), cfg.lr, cfg.max_grad_norm,
                   cfg.rms_decay, cfg.rms_eps)


def init_runner(generator: torch.Generator, model: ActorCritic,
                env_params: EnvParams, cfg: A2CConfig, n_envs: int) -> RunnerState:
    """:func:`ppo.init_runner` with the A2C optimiser."""
    init_params(generator, model, env_params)
    env_state, obs = reset_batch(generator, env_params, n_envs,
                                 device=model.logits.weight.device)
    return RunnerState(model=model, env_state=env_state, obs=obs,
                       generator=generator, optimizer=make_optimizer(model, cfg))


def _loss(logp, entropy, value, adv, returns, cfg: A2CConfig):
    pg_loss = -(adv.detach() * logp).mean()
    v_loss = 0.5 * ((value - returns) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss,
                   "entropy": ent}


def a2c_loss(model: ActorCritic, traj: Transition, adv: torch.Tensor,
             returns: torch.Tensor, cfg: A2CConfig):
    """The actor-critic loss on a flat batch: ``traj.obs`` ``[N, F]``,
    every other field, ``adv`` and ``returns`` ``[N]``. Returns (total
    loss, metrics)."""
    logits, value = model(traj.obs)
    logp, entropy = action_log_prob_and_entropy_packed(logits, traj.dirs,
                                                       traj.acts)
    return _loss(logp, entropy, value, adv, returns, cfg)


def a2c_loss_fm(model: ActorCritic, obs_fm: torch.Tensor, dirs: torch.Tensor,
                acts: torch.Tensor, adv: torch.Tensor, returns: torch.Tensor,
                cfg: A2CConfig):
    """:func:`a2c_loss` on a feature-major ``[F, N]`` obs matrix, the
    fused collect's layout."""
    logit_rows, value = _forward_fm(model, obs_fm)
    logp, entropy = action_log_prob_and_entropy_packed(logit_rows.T, dirs, acts)
    return _loss(logp, entropy, value, adv, returns, cfg)


def _step(optimizer, loss: torch.Tensor, metrics: dict, traj: Transition,
          group=None):
    """One optimiser step on ``loss``, its gradients and the metrics
    averaged over ``group`` first (:func:`ppo.average_grads`); the metrics
    detached, with the team-0 rows' mean reward."""
    optimizer.zero_grad()
    loss.backward()
    metrics = average_grads(optimizer.params, {
        k: v.detach() for k, v in metrics.items()}, group)
    optimizer.step()
    metrics["mean_reward"] = mean_reward(traj, group)
    return metrics


def train_iteration(runner: RunnerState, env_params: EnvParams, cfg: A2CConfig,
                    collect_fn=None, group=None
                    ) -> tuple[RunnerState, dict[str, torch.Tensor]]:
    """One A2C iteration: collect (``collect_fn``, default
    :func:`ppo.collect_rollout`; :func:`ppo.collect_rollout_fused` for the
    kernel) -> advantages -> one gradient step with the runner's
    optimiser, averaged over ``group``'s ranks. Returns (runner, metrics:
    ``loss``, ``pg_loss``, ``v_loss``, ``entropy``, ``mean_reward``)."""
    collect_fn = collect_fn or collect_rollout
    runner, traj, last_value = collect_fn(runner, env_params, cfg)
    adv, returns = compute_gae(traj, last_value, cfg)
    if traj.obs.dim() == 2:
        # the fused collect's feature-major [F, N] obs, samples ordered
        # (view, step, env)
        loss, metrics = a2c_loss_fm(
            runner.model, traj.obs, _flatten_tm(traj.dirs), _flatten_tm(traj.acts),
            _flatten_tm(adv), _flatten_tm(returns), cfg)
    else:
        n = traj.reward.numel()
        flat = Transition(**{name: getattr(traj, name).reshape(
            (n,) + getattr(traj, name).shape[2:]) for name in TRAJ_FIELDS})
        loss, metrics = a2c_loss(runner.model, flat, adv.reshape(n),
                                 returns.reshape(n), cfg)
    return runner, _step(runner.optimizer, loss, metrics, traj, group)


# ---------------------------------------------------------------------------
# Recurrent (LSTM) A2C
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecurrentRunnerState:
    model: RecurrentActorCritic
    env_state: EnvState          # batched
    obs: torch.Tensor            # [B, obs_dim] raw observation
    carry: tuple                 # (c, h), each [2, B, H]: view 0, view 1
    generator: torch.Generator   # on the model's device
    optimizer: object = None

    def replace(self, **kw) -> "RecurrentRunnerState":
        return dataclasses.replace(self, **kw)


def init_recurrent_runner(
    generator: torch.Generator, model: RecurrentActorCritic,
    env_params: EnvParams, cfg, n_envs: int, optimizer=None,
) -> RecurrentRunnerState:
    """Initialise ``model`` from ``generator`` (flax's initialisers),
    reset ``n_envs`` envs on its device with zero carries; ``optimizer``
    defaults to :func:`make_optimizer` (``cfg`` an :class:`A2CConfig`)."""
    init_recurrent_params(generator, model, env_params)
    device = model.logits.weight.device
    env_state, obs = reset_batch(generator, env_params, n_envs, device=device)
    z = torch.zeros((2, n_envs, model.lstm_size), device=device)
    return RecurrentRunnerState(
        model=model, env_state=env_state, obs=obs, carry=(z, z.clone()),
        generator=generator, optimizer=optimizer or make_optimizer(model, cfg))


def _flat_carry(carry, b: int):
    """``[2, B, H]`` carries -> ``[2B, H]``, the rows of ``_both_views``."""
    return tuple(c.reshape(2 * b, c.shape[-1]) for c in carry)


@torch.no_grad()
def collect_recurrent_rollout(
    runner: RecurrentRunnerState, env_params: EnvParams, cfg,
    action_uniforms: torch.Tensor | None = None,
) -> tuple[RecurrentRunnerState, Transition, torch.Tensor]:
    """``cfg.rollout_steps`` steps of recurrent self-play, one batched step
    at a time, in :func:`ppo.collect_rollout`'s layout (obs ``[T, 2B,
    F]``; rows ``[:B]`` team 0, ``[B:]`` team 1 mirrored), each view's
    carry zeroed where an episode ends. Action draws come from the
    runner's generator or ``action_uniforms`` ``[T, G, 2B]``. Returns
    (runner with the carried carries, traj, bootstrap value ``[2B]``)."""
    model = runner.model
    _check_model(model, env_params)
    b = runner.obs.shape[0]
    state, obs, gen = runner.env_state, runner.obs, runner.generator
    carry = _flat_carry(runner.carry, b)
    steps = []
    for t in range(cfg.rollout_steps):
        obs2 = _both_views(obs, env_params)
        carry, (logits, value) = model(carry, obs2)
        u = None if action_uniforms is None else action_uniforms[t]
        state, out, tr = selfplay_step(state, obs2, logits, value, u, gen,
                                       env_params)
        carry = reset_carry_where_done(carry, tr.done)
        steps.append(tr)
        obs = out.obs
    _, (_, last_value) = model(carry, _both_views(obs, env_params))
    carry = tuple(c.reshape(2, b, -1) for c in carry)
    return (runner.replace(env_state=state, obs=obs, carry=carry),
            stack_steps(steps), last_value)


@torch.no_grad()
def collect_recurrent_rollout_fused(
    runner: RecurrentRunnerState, env_params: EnvParams, cfg,
    uniforms: torch.Tensor | None = None, compute_dtype=torch.bfloat16,
) -> tuple[RecurrentRunnerState, Transition, torch.Tensor]:
    """:func:`collect_recurrent_rollout` on the fused kernel: both views'
    forward with their carries, sampling, the env step, auto-reset and
    the carry resets for all T steps in one launch on a CUDA device (its
    plain version on the CPU). The sampling seed is drawn from the
    runner's generator; ``uniforms`` ``[T, n_draws, B]`` replaces the
    kernel's Philox stream. ``compute_dtype``: bfloat16 (the main path,
    the tensor-core kernel) or float32 (exact), as
    :func:`~gym_futbol_tpu_torch.ops.fused_recurrent.fused_recurrent_collect`
    takes it. The kernel's obs ``[2, F_pad, T, B]`` become the ``[T, 2B,
    F]`` the BPTT loss steps through; carries cross as ``[2, H, B]``.
    Returns (runner, traj, bootstrap value ``[2B]``)."""
    from .ops import pack_state, unpack_state
    from .ops.fused_recurrent import (
        flatten_recurrent_actor_critic,
        fused_recurrent_collect,
    )

    _check_model(runner.model, env_params)
    gen = runner.generator
    sf, si = pack_state(runner.env_state, env_params)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    cc, hh = (c.transpose(1, 2).contiguous() for c in runner.carry)
    (sf, si, obs, dirs, acts, logp, value, reward, done, last_v, cc,
     hh) = fused_recurrent_collect(
        sf, si, flatten_recurrent_actor_critic(runner.model), cc, hh, seed,
        env_params, cfg.rollout_steps, uniforms=uniforms, compute_dtype=compute_dtype)
    t, b = cfg.rollout_steps, sf.shape[1]
    f = env_core.obs_size(env_params)
    traj = Transition(
        # [2, F_pad, T, B] -> [T, 2, B, F] -> [T, 2B, F]
        obs=obs[:, :f].permute(2, 0, 3, 1).reshape(t, 2 * b, f),
        dirs=dirs.reshape(t, 2 * b),
        acts=acts.reshape(t, 2 * b),
        logp=logp.reshape(t, 2 * b),
        value=value.reshape(t, 2 * b),
        reward=reward.reshape(t, 2 * b),
        done=done.reshape(t, 2 * b).bool(),
    )
    env_state = unpack_state(sf, si, env_params)
    runner = runner.replace(env_state=env_state,
                            obs=env_core.observe(env_state, env_params),
                            carry=(cc.transpose(1, 2), hh.transpose(1, 2)))
    return runner, traj, last_v.reshape(2 * b)


def recurrent_a2c_loss(model: RecurrentActorCritic, traj: Transition, init_carry,
                       adv: torch.Tensor, returns: torch.Tensor, cfg: A2CConfig):
    """The actor-critic loss through time: the model re-run over the
    window (``traj`` fields ``[T, S(, F)]``) from ``init_carry`` (``[S,
    H]`` each), resetting at the window's episode ends. Returns (total
    loss, metrics)."""
    _, (logits, value) = model.unroll(init_carry, traj.obs, traj.done)
    logp, entropy = action_log_prob_and_entropy_packed(logits, traj.dirs,
                                                       traj.acts)
    return _loss(logp, entropy, value, adv, returns, cfg)


def train_iteration_recurrent(
    runner: RecurrentRunnerState, env_params: EnvParams, cfg: A2CConfig,
    collect_fn=None, group=None,
) -> tuple[RecurrentRunnerState, dict[str, torch.Tensor]]:
    """One recurrent A2C iteration: collect (``collect_fn``, default
    :func:`collect_recurrent_rollout`; :func:`collect_recurrent_rollout_fused`
    for the kernel) -> advantages -> one full-batch BPTT step from the
    carry the window started with, averaged over ``group``'s ranks.
    Returns (runner, metrics)."""
    collect_fn = collect_fn or collect_recurrent_rollout
    init_carry = _flat_carry(runner.carry, runner.obs.shape[0])
    runner, traj, last_value = collect_fn(runner, env_params, cfg)
    adv, returns = compute_gae(traj, last_value, cfg)
    loss, metrics = recurrent_a2c_loss(runner.model, traj, init_carry, adv,
                                       returns, cfg)
    return runner, _step(runner.optimizer, loss, metrics, traj, group)


def recurrent_runner_specs() -> RecurrentRunnerState:
    """Which leaves of a :class:`RecurrentRunnerState` are this rank's
    share of the envs and which are replicated, as
    :func:`gym_futbol_tpu_torch.parallel.ppo_runner_specs` gives them for
    PPO's runner: the carries ``[2, B, H]`` hold the envs on dim 1."""
    from .parallel.rollout import ENV, PER_RANK, REPLICATED, Sharded

    return RecurrentRunnerState(
        model=REPLICATED,
        env_state=EnvState(pos=ENV, vel=ENV, possession=ENV, score=ENV, t=ENV),
        obs=ENV,
        carry=(Sharded(1), Sharded(1)),
        generator=PER_RANK,
        optimizer=REPLICATED,
    )
