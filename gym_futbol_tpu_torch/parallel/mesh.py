"""Process groups for env-sharded data parallelism over ``torch.distributed``.

Counterpart of :mod:`gym_futbol_tpu.parallel.mesh`. The JAX package lays
one ``'env'`` mesh axis over its devices; here each rank is one process
driving one device and holding an equal share of the envs. The env step
needs no collective: envs and trajectories stay on their rank. The model
and optimiser are replicated, kept in lockstep by averaging each
minibatch's gradients (one all-reduce, :func:`all_mean`) before the
optimiser step, as the JAX package's ``pmean`` does. ``group`` below is
a ``torch.distributed`` process group (:func:`env_group` gives the
default one); ``None`` means an undistributed run, with no collective.

Launch one process per rank under torchrun (``python -m
torch.distributed.run --nproc_per_node N ...``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address; the training
CLI's ``--distributed`` calls :func:`init_distributed`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

# the per-rank seed fold of the JAX package's shard_fused_rollout
# (gym_futbol_tpu/parallel/rollout.py:78)
SEED_FOLD = 0x1F123BB5


class EnvGroup(NamedTuple):
    rank: int
    world_size: int
    group: dist.ProcessGroup


def _launched() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:(LOCAL_RANK %
    device_count)`` for the card (ranks beyond the card count share
    cards), the CPU for ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local % torch.cuda.device_count())


def default_backend(device: torch.device | str = "cuda") -> str:
    """NCCL when every local rank has a card of its own, gloo when ranks
    share a card or run on the CPU. NCCL refuses two ranks on one device
    (a machine with one H100 and two ranks takes gloo); gloo's
    all-reduce here goes through host memory. Either way each rank keeps
    its work on its own device."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(force: bool = False, device: torch.device | str = "cuda",
                     **kw) -> bool:
    """Bring up the default process group; the counterpart of the JAX
    package's ``init_distributed`` (``mesh.py:23``).

    With keyword arguments for ``torch.distributed.init_process_group``
    (``init_method``, ``rank``, ``world_size``, ``backend``), with
    ``force`` (the training CLI's ``--distributed``) or under torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), initialise it
    for ``device``'s type: the backend is :func:`default_backend`'s unless
    given, and with NCCL the rank's card (:func:`rank_device`) becomes the
    current one. Otherwise, or when a group is already up, a no-op that
    touches nothing. Returns whether this call initialised the group."""
    if dist.is_initialized() or not (kw or force or _launched()):
        return False
    if "init_method" not in kw and not _launched():
        raise RuntimeError(
            "a distributed run needs torchrun's environment (RANK, WORLD_SIZE, "
            "MASTER_ADDR, MASTER_PORT): launch it with python -m "
            "torch.distributed.run --nproc_per_node N ...")
    backend = kw.pop("backend", None) or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, **kw)
    return True


def env_group() -> EnvGroup | None:
    """(rank, world size, group) of the default process group, or None in
    an undistributed run. Takes the place of the JAX package's
    ``make_mesh``, ``env_sharding`` and ``replicated_sharding``: the
    rank's share of the envs is :func:`~gym_futbol_tpu_torch.parallel.rollout.shard_env_state`'s,
    everything else is replicated."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return EnvGroup(dist.get_rank(), dist.get_world_size(), dist.group.WORLD)


def rank_and_size(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def comm_device(group) -> torch.device:
    """Where ``group``'s collectives take their buffers: the current card
    for NCCL, host memory for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_mean(tensors, group) -> list[torch.Tensor]:
    """Each tensor's mean over ``group``'s ranks, all in ONE all-reduce of
    their flat concatenation: a sum, then a division by the world size,
    as ``jax.lax.pmean``. Returns new tensors, each on its input's device
    and in its shape (a one-rank group's are bitwise its inputs); with
    ``group`` None, the inputs themselves."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    buf = flat.to(comm_device(group))
    dist.all_reduce(buf, group=group)
    buf = buf.to(flat.device).div_(dist.get_world_size(group))
    return [x.view_as(t) for x, t in zip(buf.split([t.numel() for t in tensors]),
                                         tensors)]


def fold_seed(seed: int, rank: int) -> int:
    """``seed + rank * 0x1F123BB5`` wrapped to a signed 32-bit integer, as
    the JAX package's int32 arithmetic wraps it (``rollout.py:78``)."""
    return (seed + rank * SEED_FOLD + 2**31) % 2**32 - 2**31
