"""The metrics log of a training run.

Counterpart of :mod:`gym_futbol_tpu.utils.metrics`: one JSON line per
logged iteration in ``metrics.jsonl``, and TensorBoard scalars through
``torch.utils.tensorboard`` where that imports. Device tensors cross to
the host once per record.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any, Mapping

import torch


def to_python(metrics: Mapping[str, Any]) -> dict:
    """``metrics`` with every 0-dim tensor turned into a Python float,
    all of them in one device-to-host copy (which waits for the device);
    other values unchanged."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    if keys:
        vals = torch.stack([metrics[k].detach().reshape(()).to(torch.float64)
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


class MetricsLogger:
    """JSONL (and TensorBoard) metrics writer; with no ``directory`` it
    writes nothing and only builds the records::

        log = MetricsLogger("runs/exp1")
        log.write(step, {"loss": ..., "mean_reward": ...})
        log.close()
    """

    def __init__(self, directory: str | None = None, tensorboard: bool = True):
        self._jsonl: IO[str] | None = None
        self._tb = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._jsonl = open(os.path.join(directory, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None       # no TensorBoard: JSONL only
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(os.path.join(directory, "tb"))
        self._t0 = time.time()

    def write(self, step: int, metrics: Mapping[str, Any]) -> dict:
        """Log ``metrics`` for iteration ``step``; returns the record
        ``{"step", "wall_s" (since the logger was made), **metrics}``."""
        vals = to_python(metrics)
        record = {"step": step, "wall_s": round(time.time() - self._t0, 3),
                  **vals}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in vals.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._tb.add_scalar(k, v, step)
        return record

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
