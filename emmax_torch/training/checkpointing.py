"""Train-state checkpoints with resume, port of
``emmax_tpu/training/checkpointing.py``.

Orbax is JAX-only: a checkpoint here is a directory holding ``state.pt``,
the ``torch.save`` of the step, the parameter tree and the optimizer
state, written synchronously. Directory names and sidecars are the JAX
package's (and the reference's): ``checkpoints/step-XXXXXX-epoch-XX-
loss=X.XXXX`` beside ``config.json`` and ``dataset_statistics.json``. An
imported checkpoint (``models.load.save_pretrained``) is named
``step-XXXXXX`` and holds the parameters alone.

Under a mesh (``CheckpointManager(run_dir, mesh=mesh)``) the state holds
each rank's blocks: a save gathers the full tree leaf by leaf, rank 0
writes it in the same format (so ``models.load.load_vla`` reads it), and
a restore reads the full tree on every rank and keeps each rank's
blocks. Both end at a barrier.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Optional, Tuple

import torch

from emmax_torch.parallel.distributed import barrier
from emmax_torch.parallel.sharding import (gather_params,
                                           param_partition_specs, shard_leaf,
                                           shard_params)
from emmax_torch.training.train_state import TrainState

log = logging.getLogger(__name__)

# a diverged run may print its loss as nan/inf; the name must still parse.
# An imported checkpoint has no epoch or loss.
_CKPT_RE = re.compile(
    r"step-(\d+)(?:-epoch-(\d+)-loss=([0-9.]+|nan|inf))?$")
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, run_dir, max_to_keep: Optional[int] = None,
                 mesh=None) -> None:
        self.run_dir = Path(run_dir).absolute()
        self.ckpt_dir = self.run_dir / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh

    def _writer(self) -> bool:
        """The rank that writes (rank 0; the only one without a mesh)."""
        return self.mesh is None or self.mesh.get_rank() == 0

    def save(self, state: TrainState, *, step: int, epoch: int,
             loss: float) -> Path:
        name = f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"
        path = self.ckpt_dir / name
        if path.exists():
            # a periodic and a final save can land on one step: skip (every
            # rank sees the directory before rank 0 can write: the gathers
            # below wait for all of them)
            log.info("checkpoint %s already exists; skipping", name)
            return path
        params, opt_state = state.params, state.opt_state
        if self.mesh is not None:
            kw = dict(device="cpu", keep=self._writer())
            params = gather_params(params, self.mesh, **kw)
            opt_state = {**opt_state,
                         "mu": gather_params(opt_state["mu"], self.mesh, **kw),
                         "nu": gather_params(opt_state["nu"], self.mesh, **kw)}
        if self._writer():
            tmp = path.with_name(name + ".tmp")
            tmp.mkdir(parents=True, exist_ok=True)
            torch.save({"step": state.step, "params": params,
                        "opt_state": opt_state}, tmp / STATE_FILE)
            tmp.rename(path)
            log.info("saved checkpoint %s", name)
            self._gc()
        if self.mesh is not None:
            barrier("checkpoint save")
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
        """The saved state, its tensors on ``device`` (under a mesh: each
        rank's blocks on its own device)."""
        if self.mesh is not None:
            barrier("checkpoint restore")
        path = path or self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt_dir}")
        if self.mesh is None:
            blob = torch.load(Path(path) / STATE_FILE, map_location=device,
                              weights_only=True)
        else:
            blob = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                              weights_only=True, mmap=True)
            specs = param_partition_specs(blob["params"], self.mesh)
            flat = list(specs.values())
            blob["params"] = shard_params(blob["params"], self.mesh, specs)
            for key in ("mu", "nu"):
                blob["opt_state"][key] = [
                    None if m is None else shard_leaf(m, s, self.mesh)
                    for m, s in zip(blob["opt_state"][key], flat)]
            barrier("checkpoint restore")
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
