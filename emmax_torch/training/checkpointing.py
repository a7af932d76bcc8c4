"""Train-state checkpoints with resume, port of
``emmax_tpu/training/checkpointing.py``.

Orbax is JAX-only: a checkpoint here is a directory holding ``state.pt``,
the ``torch.save`` of the step, the parameter tree and the optimizer
state, written synchronously. Directory names and sidecars are the JAX
package's (and the reference's): ``checkpoints/step-XXXXXX-epoch-XX-
loss=X.XXXX`` beside ``config.json`` and ``dataset_statistics.json``. An
imported checkpoint (``models.load.save_pretrained``) is named
``step-XXXXXX`` and holds the parameters alone.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Optional, Tuple

import torch

from emmax_torch.training.train_state import TrainState

log = logging.getLogger(__name__)

# a diverged run may print its loss as nan/inf; the name must still parse.
# An imported checkpoint has no epoch or loss.
_CKPT_RE = re.compile(
    r"step-(\d+)(?:-epoch-(\d+)-loss=([0-9.]+|nan|inf))?$")
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, run_dir, max_to_keep: Optional[int] = None) -> None:
        self.run_dir = Path(run_dir).absolute()
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def save(self, state: TrainState, *, step: int, epoch: int,
             loss: float) -> Path:
        name = f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"
        path = self.ckpt_dir / name
        if path.exists():
            # a periodic and a final save can land on one step: skip
            log.info("checkpoint %s already exists; skipping", name)
            return path
        tmp = path.with_name(name + ".tmp")
        tmp.mkdir(parents=True, exist_ok=True)
        torch.save({"step": state.step, "params": state.params,
                    "opt_state": state.opt_state}, tmp / STATE_FILE)
        tmp.rename(path)
        log.info("saved checkpoint %s", name)
        self._gc()
        return path

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def _gc(self) -> None:
        if self.max_to_keep is None:
            return
        for path, _ in self.list_checkpoints()[:-self.max_to_keep]:
            shutil.rmtree(path, ignore_errors=True)

    def list_checkpoints(self):
        out = []
        for p in self.ckpt_dir.iterdir() if self.ckpt_dir.is_dir() else []:
            m = _CKPT_RE.match(p.name)
            if m and p.is_dir():
                out.append((p, int(m.group(1))))
        return sorted(out, key=lambda t: t[1])

    def latest(self) -> Optional[Path]:
        ckpts = self.list_checkpoints()
        return ckpts[-1][0] if ckpts else None

    def restore(self, path: Optional[Path] = None,
                device="cpu") -> TrainState:
        """The saved state, its tensors on ``device``."""
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        blob = torch.load(Path(path) / STATE_FILE, map_location=device,
                          weights_only=True)
        log.info("restored checkpoint %s", Path(path).name)
        return TrainState(step=blob["step"], params=blob["params"],
                          opt_state=blob["opt_state"])

    @staticmethod
    def parse_name(path) -> Tuple[int, int, float]:
        m = _CKPT_RE.match(Path(path).name)
        if not m:
            raise ValueError(f"not a checkpoint dir name: {path}")
        return (int(m.group(1)), int(m.group(2) or 0),
                float(m.group(3) or "nan"))


def write_sidecars(run_dir, config_blob: dict,
                   dataset_statistics: Optional[dict] = None) -> None:
    """``config.json`` and ``dataset_statistics.json`` beside the
    checkpoints."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.json", "w") as f:
        json.dump(config_blob, f, indent=2, default=str)
    if dataset_statistics is not None:
        with open(run_dir / "dataset_statistics.json", "w") as f:
            json.dump(dataset_statistics, f, indent=2, default=float)
