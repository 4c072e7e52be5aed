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
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch

_FILE = re.compile(r"^checkpoint_(\d+)\.pt$")


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
    iteration (``checkpoint_<step>.pt``), the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"checkpoint_{step}.pt")

    def steps(self) -> list[int]:
        """The steps checkpointed in the directory, oldest first."""
        return sorted(int(m[1]) for m in map(_FILE.match, os.listdir(self._dir))
                      if m)

    def save(self, runner: Any, step: int) -> None:
        """Write ``runner`` as iteration ``step``: to a temporary file,
        flushed to disk, then renamed over the step's file, so a reader
        finds the old checkpoint or the whole new one. Then drop all but
        the newest ``max_to_keep``."""
        blob = {"kind": type(runner).__name__, "runner": _state(runner)}
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
        holds no checkpoint."""
        steps = self.steps()
        if not steps:
            return None, 0
        blob = torch.load(self._path(steps[-1]), map_location="cpu",
                          weights_only=True)
        if blob["kind"] != type(template).__name__:
            raise ValueError(f"the checkpoint holds a {blob['kind']}, the "
                             f"template is a {type(template).__name__}")
        return _restore(template, blob["runner"], "runner"), steps[-1]

    def wait(self) -> None:
        """Saves are synchronous: every one has reached the disk when
        :meth:`save` returns."""
