"""The port's multi-process training path, run for real, mirroring
``tests/test_multiprocess.py``: two CPU processes under ``python -m
torch.distributed.run --nproc_per_node 2`` join a gloo group through
``initialize_distributed`` (torchrun's environment), build a (1, 2, 1)
mesh, and each feeds only its own half of the global batch. One step
gives the same loss on both ranks, equal to a single-process run of the
global batch (JAX's on 8 virtual devices, and the port's own); a
checkpoint written by rank 0 restores every rank's blocks exactly.
"""

import json
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import vlm as t_vlm
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_tpu.models.llama import IGNORE_INDEX
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.parallel.sharding import shard_batch
from emmax_tpu.training.train_state import create_train_state, make_optimizer
from emmax_tpu.training.train_step import jit_train_step, make_train_step

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, os, pickle, sys
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import torch
torch.set_num_threads(1)
from emmax_torch.bridge import params_from_numpy
from emmax_torch.models.tree import leaves_with_path
from emmax_torch.models.vlm import tiny_vlm_config
from emmax_torch.parallel import (initialize_distributed, make_mesh,
                                  shard_batch, shard_params)
from emmax_torch.training.checkpointing import CheckpointManager
from emmax_torch.training.train_state import create_train_state, make_optimizer
from emmax_torch.training.train_step import make_train_step

rank = initialize_distributed(device_type="cpu")   # torchrun's variables
assert torch.distributed.get_world_size() == 2
mesh = make_mesh((1, -1, 1), device_type="cpu")
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    params, batch = pickle.load(f)
cfg = tiny_vlm_config()
params = params_from_numpy(params)
tx, _ = make_optimizer(params, learning_rate=1e-3, weight_decay=0.0,
                       max_grad_norm=1.0, lr_scheduler_type="constant",
                       total_steps=10, stage="vla-full-train")
state = create_train_state(shard_params(params, mesh), tx)
step = make_train_step(cfg, tx, remat=False, compute_dtype=torch.float32,
                       mesh=mesh)
# this process feeds ONLY its half of the global batch
lo, hi = rank * 4, (rank + 1) * 4
local = {k: ({n: torch.from_numpy(a[lo:hi]) for n, a in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v[lo:hi]))
         for k, v in batch.items()}
state, metrics = step(state, shard_batch(local, mesh))
loss = float(metrics["loss"])
mgr = CheckpointManager(out_dir, mesh=mesh)
path = mgr.save(state, step=state.step, epoch=0, loss=loss)
restored = mgr.restore(path)
diff = sum(float((a - b).abs().sum()) for (_, a), (_, b) in zip(
    leaves_with_path(restored.params), leaves_with_path(state.params)))
diff += sum(float((a - b).abs().sum())
            for key in ("mu", "nu")
            for a, b in zip(restored.opt_state[key], state.opt_state[key])
            if a is not None)
with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
    json.dump({"rank": rank, "loss": loss, "restore_absdiff": diff,
               "restored_step": restored.step}, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _global_batch(cfg):
    """``tests/test_multiprocess.py``'s global batch, as numpy."""
    rng = np.random.default_rng(0)
    B, L = 8, 12
    ids = rng.integers(3, cfg.llm.vocab_size, size=(B, L))
    ids[:, 0] = 1
    labels = ids.copy()
    labels[:, :4] = IGNORE_INDEX
    pixels = {name: rng.normal(size=(B, v.img_size, v.img_size, 3))
              .astype(np.float32) for name, v in cfg.vision}
    return {"input_ids": ids.astype(np.int32),
            "attention_mask": np.ones((B, L), bool),
            "labels": labels.astype(np.int32), "pixel_values": pixels}


def _jax_reference_loss(cfg, params, batch) -> float:
    """Single-process 8-device JAX run of the same global batch."""
    mesh = make_mesh((1, 8, 1))
    tx, _ = make_optimizer(params, learning_rate=1e-3, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=10, stage="vla-full-train")
    state = create_train_state(shard_params(params, mesh), tx)
    step = jit_train_step(make_train_step(cfg, tx, remat=False,
                                          compute_dtype=jnp.float32),
                          donate=False)
    _, m = step(state, shard_batch(batch, mesh))
    return float(m["loss"])


def _port_reference_loss(host, batch) -> float:
    params = params_from_numpy(host)
    tx, _ = t_state.make_optimizer(params, learning_rate=1e-3,
                                   weight_decay=0.0, max_grad_norm=1.0,
                                   lr_scheduler_type="constant",
                                   total_steps=10, stage="vla-full-train")
    step = t_step.make_train_step(t_vlm.tiny_vlm_config(), tx, remat=False,
                                  compute_dtype=torch.float32)
    b = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in batch.items()}
    _, m = step(t_state.create_train_state(params, tx), b)
    return float(m["loss"])


def test_two_process_train_step_and_checkpoint(tmp_path):
    cfg = tiny_vlm_config()
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    batch = _global_batch(cfg)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((host, batch), f)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port",
         str(_free_port()), str(script), str(REPO), str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    results = [json.loads((tmp_path / f"result_{r}.json").read_text())
               for r in range(2)]
    # both processes report the same global loss...
    assert results[0]["loss"] == results[1]["loss"]
    # ...the loss of one process stepping the whole batch
    assert results[0]["loss"] == pytest.approx(
        _jax_reference_loss(cfg, params, batch), rel=1e-5)
    assert results[0]["loss"] == pytest.approx(
        _port_reference_loss(host, batch), rel=1e-5)
    for r in results:
        assert r["restore_absdiff"] == 0.0
        assert r["restored_step"] == 1
    assert len(list((tmp_path / "checkpoints").iterdir())) == 1
