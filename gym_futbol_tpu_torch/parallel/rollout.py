"""Env-sharded rollouts and training over a ``torch.distributed`` group.

Counterpart of :mod:`gym_futbol_tpu.parallel.rollout`. Every rank builds
the same whole runner from one seed (model, optimiser and every env), then
keeps its share (:func:`shard_runner`): a contiguous, equal slice of the
envs along each env-sharded leaf (:func:`ppo_runner_specs`), and a
generator stream of its own, so that sampling and the minibatch
permutations differ between ranks. The step itself needs no collective:

- :func:`shard_rollout`, :func:`shard_fused_rollout`: the plain rollout
  and the ``fused_rollout`` kernel on the rank's envs (the kernel's seed
  folded with the rank); the sharded replay is
  ``ops.fused_rollout_replay`` on the rank's envs and actions, both from
  :func:`shard_env_state`;
- :func:`shard_train_iteration`: a whole training iteration on the
  rank's envs; its updates average each minibatch's gradients over the
  ranks in one all-reduce before the optimiser step, so the replicated
  leaves stay bitwise equal on every rank (:func:`check_replicated`).

Each entry point takes the rank's share, and ``group`` (a process group,
``mesh.env_group().group``); the JAX package's take the global arrays
and a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from .. import ppo, vector
from ..types import EnvParams, EnvState
from ..wrappers import RewardNorm, RunningNorm
from .mesh import comm_device, fold_seed, rank_and_size


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf whose axis ``dim`` holds the envs: each rank keeps its
    contiguous, equal share."""

    dim: int = 0


ENV = Sharded(0)
# the same on every rank, bitwise (model, optimiser, normaliser statistics)
REPLICATED = "replicated"
# each rank's own, not a share of a whole (the generator's stream)
PER_RANK = "per_rank"


def shard_env_state(x, group, dim: int = 0):
    """This rank's share of a batch: a tensor, or a dataclass or tuple of
    tensors (an ``EnvState``), each split along ``dim`` into equal,
    contiguous shares, one per rank (copies, so the whole batch can be
    freed). Raises ``ValueError`` when the batch does not divide evenly
    over the ranks."""
    rank, world = rank_and_size(group)
    if isinstance(x, tuple):
        return tuple(shard_env_state(v, group, dim) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: shard_env_state(getattr(x, f.name), group, dim)
            for f in dataclasses.fields(x)})
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"a batch of {n} envs does not divide evenly over "
                         f"{world} ranks")
    share = n // world
    return x.narrow(dim, rank * share, share).clone()


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """Rank ``rank``'s stream of a runner's ``generator``: rank 0 keeps it
    (so a one-rank run draws exactly what the undistributed one does),
    every other rank gets a fresh generator on the same device seeded
    from (the generator's seed, rank), folded as the JAX package folds
    the mesh position into its kernel seed (:func:`mesh.fold_seed`)."""
    if rank == 0:
        return generator
    seed = fold_seed(generator.initial_seed(), rank) % 2**32
    return torch.Generator(device=generator.device).manual_seed(seed)


def ppo_runner_specs(normalize_obs: bool = False,
                     normalize_reward: bool = False) -> ppo.RunnerState:
    """Which leaves of a :class:`ppo.RunnerState` are the rank's share of
    the envs (:data:`ENV`), its own (:data:`PER_RANK`) or replicated
    (:data:`REPLICATED`), as a runner of those markers: envs, their
    observations and ``RewardNorm``'s per-env return accumulator live with
    their rank, as does the generator's stream; the model, the optimiser
    and the normalisers' statistics are replicated (their updates merge
    every rank's moments, so each rank carries the one global
    normaliser). The counterpart of the JAX package's
    ``ppo_runner_specs`` (``rollout.py:91``)."""
    return ppo.RunnerState(
        model=REPLICATED,
        env_state=EnvState(pos=ENV, vel=ENV, possession=ENV, score=ENV, t=ENV),
        obs=ENV,
        generator=PER_RANK,
        optimizer=REPLICATED,
        obs_norm=(RunningNorm(mean=REPLICATED, var=REPLICATED, count=REPLICATED)
                  if normalize_obs else None),
        rew_norm=(RewardNorm(ret=ENV, mean=REPLICATED, var=REPLICATED,
                             count=REPLICATED) if normalize_reward else None),
    )


def runner_specs_for(runner):
    """The specs of ``runner``'s kind: :func:`a2c.recurrent_runner_specs`
    for a recurrent runner, else :func:`ppo_runner_specs` with its
    normalisers."""
    from ..a2c import RecurrentRunnerState, recurrent_runner_specs

    if isinstance(runner, RecurrentRunnerState):
        return recurrent_runner_specs()
    return ppo_runner_specs(runner.obs_norm is not None,
                            runner.rew_norm is not None)


def _map(fn, x, spec, name="runner"):
    """``x`` with each leaf marked by ``spec`` (a runner of markers)
    replaced by ``fn(leaf, marker, name)``."""
    if spec is None:
        return x
    if isinstance(spec, (Sharded, str)):
        return fn(x, spec, name)
    if isinstance(spec, tuple):
        return tuple(_map(fn, v, s, f"{name}[{i}]")
                     for i, (v, s) in enumerate(zip(x, spec)))
    return dataclasses.replace(x, **{
        f.name: _map(fn, getattr(x, f.name), getattr(spec, f.name),
                     f"{name}.{f.name}")
        for f in dataclasses.fields(spec)})


def shard_runner(runner, group, runner_specs=None):
    """This rank's share of a runner that every rank built whole from
    the same seed: each :data:`ENV`-marked leaf cut to the rank's envs
    (:func:`shard_env_state`), the generator turned into the rank's own
    stream (:func:`rank_generator`), the replicated leaves kept.
    ``runner_specs`` defaults to :func:`runner_specs_for`'s."""
    specs = runner_specs or runner_specs_for(runner)
    rank = rank_and_size(group)[0]

    def share(x, marker, name):
        if isinstance(marker, Sharded):
            return shard_env_state(x, group, marker.dim)
        if marker == PER_RANK:
            return rank_generator(x, rank)
        return x

    return _map(share, runner, specs)


def _replicated_leaves(runner, runner_specs=None) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every replicated leaf of ``runner``: parameters,
    optimiser state (moments, step counts) and normaliser statistics,
    numbers as float64 tensors."""
    from ..utils.checkpoint import _state

    specs = runner_specs or runner_specs_for(runner)
    out = []

    def flat(x, name):
        if isinstance(x, torch.Tensor):
            out.append((name, x.detach()))
        elif isinstance(x, (bool, int, float)):
            out.append((name, torch.tensor(float(x), dtype=torch.float64)))
        elif isinstance(x, dict):
            for k, v in x.items():
                flat(v, f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                flat(v, f"{name}[{i}]")

    def visit(x, marker, name):
        if marker == REPLICATED:
            flat(_state(x), name)
        return x

    _map(visit, runner, specs)
    return out


def check_replicated(runner, group, runner_specs=None) -> None:
    """Raise ``RuntimeError`` on every rank unless each replicated leaf of
    ``runner`` (parameters, optimiser state, normaliser statistics) is
    bitwise equal to rank 0's: rank 0 broadcasts the leaves' bytes, each
    rank compares its own, and an all-reduce tells every rank whether any
    differed. A collective: every rank of ``group`` calls it."""
    if group is None:
        return
    leaves = _replicated_leaves(runner, runner_specs)
    dev = comm_device(group)
    parts = [t.reshape(-1).contiguous().view(torch.uint8).to(dev)
             for _, t in leaves]
    mine = torch.cat(parts)

    def any_rank(cond: bool) -> bool:
        flag = torch.tensor([float(cond)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag)

    theirs = torch.tensor([mine.numel()], dtype=torch.int64, device=dev)
    dist.broadcast(theirs, 0, group=group)
    if any_rank(int(theirs) != mine.numel()):
        raise RuntimeError("the ranks' replicated leaves differ in size")
    theirs = mine.clone()
    dist.broadcast(theirs, 0, group=group)
    bad, offset = [], 0
    for (name, _), part in zip(leaves, parts):
        if not torch.equal(part, theirs[offset: offset + part.numel()]):
            bad.append(name)
        offset += part.numel()
    if any_rank(bool(bad)):
        rank = rank_and_size(group)[0]
        raise RuntimeError(f"replicated leaves differ across ranks (rank {rank} "
                           f"against rank 0: {bad or 'none here'})")


def shard_rollout(group, params: EnvParams, n_steps: int,
                  policy: vector.Policy | None = None):
    """A T-step plain rollout of the rank's envs (``policy`` default
    uniform random). Returns ``f(state, seed) -> (state, outs)`` over
    :func:`vector.rollout`: ``state`` the rank's share
    (:func:`shard_env_state`), its draws from a generator on the state's
    device seeded with ``seed`` folded with the rank
    (:func:`mesh.fold_seed`), as :func:`shard_fused_rollout` seeds the
    kernel. No collective."""
    policy = policy or vector.random_policy(params)
    rank = rank_and_size(group)[0]

    def run(state: EnvState, seed: int):
        gen = torch.Generator(device=state.pos.device).manual_seed(
            fold_seed(seed, rank) % 2**32)
        return vector.rollout(state, policy, gen, params, n_steps)

    return run


def shard_fused_rollout(group, params: EnvParams, n_steps: int):
    """The ``fused_rollout`` kernel on the rank's envs. Returns
    ``f(statef, statei, seed) -> (statef, statei, rewards)`` on the rank's
    packed tiles (``ops.pack_state`` of its share), launching the kernel
    with ``seed`` folded with the rank (:func:`mesh.fold_seed`), as the
    JAX package de-correlates its shards' streams (``rollout.py:78``). No
    collective."""
    from ..ops import fused_rollout

    rank = rank_and_size(group)[0]

    def run(statef: torch.Tensor, statei: torch.Tensor, seed: int):
        return fused_rollout(statef, statei, fold_seed(seed, rank), params,
                             n_steps)

    return run


def shard_train_iteration(iteration_fn: Callable = ppo.train_iteration,
                          group=None):
    """A whole training iteration on the rank's envs: returns
    ``f(runner, env_params, cfg) -> (runner, metrics)`` calling
    ``iteration_fn`` (default :func:`ppo.train_iteration`; any of the
    package's iterations, e.g. :func:`a2c.train_iteration`,
    :func:`recurrent_ppo.train_iteration_recurrent_ppo`) with ``group``:
    the counterpart of the JAX package's ``shard_train_iteration``
    (``rollout.py:128``). ``runner`` is the rank's share from
    :func:`shard_runner`, whose generator is the rank's own stream: each
    rank samples its actions and draws its minibatch permutations from
    it (rank 0's is the undistributed runner's, which makes a one-rank
    run bitwise the undistributed iteration), while the averaged updates
    keep the replicated leaves equal. The metrics are the means over
    every rank. The JAX package's ``runner_specs`` belong to
    :func:`shard_runner` and :func:`check_replicated` here: the
    iteration itself needs none."""

    def step(runner, env_params: EnvParams, cfg):
        return iteration_fn(runner, env_params, cfg, group=group)

    return step
