"""Metrics containers and trackers, port of
``emmax_tpu/training/metrics.py``: the ``Tracker`` protocol,
``JSONLinesTracker`` (``run-metrics.jsonl`` + ``{run_id}.jsonl``) and the
metric containers on one deque-smoothed base: ``Metrics`` (the VLM
pretraining stages), ``VLAMetrics`` (per-dataset keys) and the Emma-X
container, ``VLADiscreteMetrics``.
There is no network here, so a W&B tracker is refused rather than
silently dropped.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Protocol

import numpy as np


class Tracker(Protocol):
    def write_hyperparameters(self, hparams: Dict) -> None: ...

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None: ...

    def finalize(self) -> None: ...


class JSONLinesTracker:
    def __init__(self, run_id: str, run_dir, hparams: Optional[Dict] = None
                 ) -> None:
        self.run_id, self.run_dir = run_id, Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.hparams = hparams or {}

    def write_hyperparameters(self, hparams: Optional[Dict] = None) -> None:
        with open(self.run_dir / "run-metrics.jsonl", "a") as f:
            f.write(json.dumps({"run_id": self.run_id,
                                "hparams": hparams or self.hparams},
                               default=str) + "\n")

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None:
        with open(self.run_dir / f"{self.run_id}.jsonl", "a") as f:
            f.write(json.dumps({"step": global_step, **metrics},
                               default=float) + "\n")

    def finalize(self) -> None:
        pass


def build_trackers(kinds, run_id: str, run_dir, hparams=None
                   ) -> List[Tracker]:
    out: List[Tracker] = []
    for kind in kinds:
        if kind == "jsonl":
            out.append(JSONLinesTracker(run_id, run_dir, hparams))
        elif kind == "wandb":
            raise ValueError("the wandb tracker needs a network; use "
                             "--trackers jsonl")
        else:
            raise ValueError(f"unknown tracker {kind!r}")
    return out


class _SmoothedMetrics:
    """Deque-smoothed means of committed values, pushed to the trackers
    with wall-clock step times."""

    def __init__(self, trackers: List[Tracker], window: int = 128) -> None:
        self.trackers = trackers
        self.window = window
        self.deques: Dict[str, deque] = {}
        self.global_step = 0
        self._t_last = time.time()
        self.step_times: deque = deque(maxlen=window)

    def commit(self, **values: float) -> None:
        for k, v in values.items():
            self.deques.setdefault(k, deque(maxlen=self.window)).append(
                float(v))

    def _means(self) -> Dict[str, float]:
        return {k: float(np.mean(d)) for k, d in self.deques.items() if d}

    def push(self, lr: float, extra: Optional[Dict] = None
             ) -> Dict[str, float]:
        now = time.time()
        self.step_times.append(now - self._t_last)
        self._t_last = now
        out = self._means()
        out["lr"] = lr
        out["step_time_s"] = float(np.mean(self.step_times))
        if extra:
            out.update(extra)
        for t in self.trackers:
            t.write(self.global_step, out)
        self.global_step += 1
        return out

    def finalize(self) -> None:
        for t in self.trackers:
            t.finalize()

    def status(self, epoch: int, lr: float) -> str:
        m = self._means()
        return (f"epoch {epoch:03d} step {self.global_step:06d} | "
                f"loss={m.get('loss', float('nan')):.4f} lr={lr:.2e}")


class Metrics(_SmoothedMetrics):
    """VLM pretraining metrics (loss, grad norm, lr, step time)."""


class VLAMetrics(_SmoothedMetrics):
    """VLA metrics with per-dataset keys (``{dataset}/{name}``)."""

    def commit_for_dataset(self, dataset_name: str, **values: float) -> None:
        self.commit(**{f"{dataset_name}/{k}": v for k, v in values.items()})


class VLADiscreteMetrics(_SmoothedMetrics):
    """Emma-X GCOT training metrics: loss, action-token accuracy and L1,
    grad norm, Solver-eval scores."""

    def status(self, epoch: int, lr: float) -> str:
        m = self._means()
        return (f"epoch {epoch:03d} step {self.global_step:06d} | "
                f"loss={m.get('loss', float('nan')):.4f} "
                f"act_acc={m.get('action_accuracy', float('nan')):.3f} "
                f"act_l1={m.get('action_l1', float('nan')):.4f} "
                f"lr={lr:.2e}")
