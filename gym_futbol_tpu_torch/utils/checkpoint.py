"""Checkpoint and resume of a training runner.

Counterpart of :mod:`gym_futbol_tpu.utils.checkpoint`, without orbax:
the whole runner round-trips through ``torch.save``, so a run resumes
mid-episode, bitwise where it would have gone on. That covers every field
of :class:`ppo.RunnerState` and :class:`a2c.RecurrentRunnerState`: the
model, the optimiser (PPO's Adam moments and its ``count``, the anneal's
position, or A2C's RMSProp), the env state and raw observations, the LSTM
carry, the normalisers' statistics (``RewardNorm.ret`` included) and the
generator's state, CUDA or CPU. Reading the JAX package's orbax
checkpoints is out of scope.

In a distributed run (``group``, :mod:`gym_futbol_tpu_torch.parallel`)
every rank saves and restores its own runner, in its own file
(``checkpoint_<step>.rank<r>-of-<n>.pt``): its envs, generator and
``RewardNorm.ret`` are its own, its replicated leaves equal the other
ranks'. A resume takes the newest step every rank saved, and refuses a
directory written by another number of ranks.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch

_FILE = re.compile(r"^checkpoint_(\d+)(?:\.rank(\d+)-of-(\d+))?\.pt$")


def _state(x: Any) -> Any:
    """A runner field -> what ``torch.save`` stores for it (tensors,
    containers and plain values only, so ``weights_only`` loads it)."""
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor) or x is None:
        return x
    if isinstance(x, tuple):
        return tuple(_state(v) for v in x)
    if hasattr(x, "state_dict"):                 # module, optimiser
        return x.state_dict()
    if dataclasses.is_dataclass(x):
        return {f.name: _state(getattr(x, f.name)) for f in dataclasses.fields(x)}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _restore(template: Any, saved: Any, name: str) -> Any:
    """``saved`` (from :func:`_state`) loaded into ``template``'s field:
    modules, optimisers and generators in place, tensors onto the
    template's device."""
    if (saved is None) != (template is None):
        raise ValueError(f"{name}: the checkpoint holds "
                         f"{'none' if saved is None else 'one'}, the template "
                         f"{'none' if template is None else 'one'}")
    if template is None:
        return None
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if isinstance(template, torch.Tensor):
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"{name}: saved {saved.dtype} {tuple(saved.shape)}, "
                             f"template {template.dtype} {tuple(template.shape)}")
        return saved.to(template.device)
    if isinstance(template, tuple):
        if len(saved) != len(template):
            raise ValueError(f"{name}: {len(saved)} saved, {len(template)} in "
                             f"the template")
        return tuple(_restore(t, s, f"{name}[{i}]")
                     for i, (t, s) in enumerate(zip(template, saved)))
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return template
    names = [f.name for f in dataclasses.fields(template)]
    if sorted(saved) != sorted(names):
        raise ValueError(f"{name}: saved fields {sorted(saved)}, template "
                         f"{sorted(names)}")
    return dataclasses.replace(template, **{
        k: _restore(getattr(template, k), saved[k], f"{name}.{k}") for k in names})


class Checkpointer:
    """Runner checkpoints in ``directory``, one file per training
    iteration (``checkpoint_<step>.pt``; with a ``group`` of several
    ranks, one per rank and iteration, the directory shared by the
    ranks), the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        from ..parallel.mesh import rank_and_size

        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        self._rank, self._world = rank_and_size(group)
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        name = (f"checkpoint_{step}.pt" if self._world == 1 else
                f"checkpoint_{step}.rank{self._rank}-of-{self._world}.pt")
        return os.path.join(self._dir, name)

    def _files(self) -> list[tuple[int, int, int]]:
        """(step, rank, world size) of every checkpoint in the directory."""
        return [(int(m[1]), int(m[2] or 0), int(m[3] or 1))
                for m in map(_FILE.match, os.listdir(self._dir)) if m]

    def steps(self) -> list[int]:
        """The steps this rank checkpointed in the directory, oldest
        first."""
        return sorted(s for s, r, w in self._files()
                      if (r, w) == (self._rank, self._world))

    def save(self, runner: Any, step: int) -> None:
        """Write ``runner`` as iteration ``step``: to a temporary file,
        flushed to disk, then renamed over the step's file, so a reader
        finds the old checkpoint or the whole new one. Then drop all but
        the newest ``max_to_keep``."""
        blob = {"kind": type(runner).__name__, "rank": self._rank,
                "world_size": self._world, "runner": _state(runner)}
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.steps()[:-self._keep]:
            os.remove(self._path(old))

    def restore_latest(self, template: Any) -> tuple[Any | None, int]:
        """Load the newest checkpoint into ``template``, a runner built as
        the saved one was (same kind, shapes and normalisers): its model,
        optimiser and generator take the saved state in place, the other
        fields are replaced, every tensor on the template's device.
        Returns (the runner, its step), or (None, 0) when the directory
        holds no checkpoint. With several ranks each loads its own file of
        the newest step that every rank saved; checkpoints written by
        another number of ranks raise ``ValueError`` (the envs' shares,
        generators and return accumulators would not match)."""
        files = self._files()
        if not files:
            return None, 0
        worlds = sorted({w for _, _, w in files})
        if worlds != [self._world]:
            raise ValueError(
                f"{self._dir} holds checkpoints of a run over {worlds} rank(s); "
                f"this run has {self._world}: resume with as many ranks")
        ranks = {}
        for s, r, _ in files:
            ranks.setdefault(s, set()).add(r)
        complete = [s for s, rs in ranks.items() if len(rs) == self._world]
        if not complete:
            raise ValueError(f"{self._dir}: no step was saved by all "
                             f"{self._world} ranks")
        step = max(complete)
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        if blob["kind"] != type(template).__name__:
            raise ValueError(f"the checkpoint holds a {blob['kind']}, the "
                             f"template is a {type(template).__name__}")
        if (blob.get("rank", 0), blob.get("world_size", 1)) != (self._rank,
                                                               self._world):
            raise ValueError(f"{self._path(step)} holds rank {blob.get('rank')} "
                             f"of {blob.get('world_size')}")
        return _restore(template, blob["runner"], "runner"), step

    def wait(self) -> None:
        """Saves are synchronous: every one has reached the disk when
        :meth:`save` returns."""
