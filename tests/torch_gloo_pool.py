"""A pool of CPU processes joined in one gloo process group, for the port's
multi-rank tests (``tests/test_torch_sharded_*.py``, ``..._parallel.py``,
``..._ring_attention.py``).

One pool per test file (a module fixture), started once, so the spawn
and the import of torch are paid once. Each worker joins the group
through ``emmax_torch.parallel.initialize_distributed`` on gloo and then
runs the tasks below by name, every rank the same task; arguments and
results are numpy arrays, numbers and dicts of them. The workers import
``emmax_torch`` only: never JAX or ``emmax_tpu``, which run in the test
process on its 8 virtual devices. A task that fails on one rank leaves
the others in a collective, so the pool is killed and the test fails
with the worker's traceback.
"""

from __future__ import annotations

import multiprocessing
import socket
import time
import traceback

import numpy as np

WORLD = 8
TIMEOUT = 300.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class GlooPool:
    def __init__(self, world: int = WORLD) -> None:
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self.world = world
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(rank, world, port, child),
                               daemon=True)
            proc.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(proc)
        ready = self._collect()
        if sorted(ready) != list(range(world)):
            self.close()
            raise RuntimeError(f"workers reported ranks {ready}")

    def _collect(self) -> list:
        out = [None] * self.world
        deadline = time.monotonic() + TIMEOUT
        for rank, conn in enumerate(self.conns):
            while not conn.poll(0.2):
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise RuntimeError(f"gloo workers {dead} died or timed "
                                       "out")
            status, value = conn.recv()
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return out

    def run(self, task: str, **kwargs) -> list:
        """``task(**kwargs)`` on every rank; the results by rank."""
        for conn in self.conns:
            conn.send((task, kwargs))
        return self._collect()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self.procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        for conn in self.conns:
            conn.close()


def _worker(rank: int, world: int, port: int, conn) -> None:
    import sys

    import torch
    import torch.distributed as dist

    from emmax_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    try:
        got = initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device_type="cpu")
        conn.send(("ok", got))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, kwargs = msg
        try:
            if "jax" in sys.modules or "emmax_tpu" in sys.modules:
                raise RuntimeError("a gloo worker imported JAX")
            conn.send(("ok", TASKS[name](**kwargs)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


# --- tasks (run in the workers) -----------------------------------------------

_MESHES = {}


def _mesh(shape):
    """One DeviceMesh per shape and worker (building one is a collective
    that makes new groups)."""
    from emmax_torch.parallel import make_mesh

    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, device_type="cpu")
    return _MESHES[shape]


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else tree.detach().float().numpy()


def placement(params, mesh_shape):
    """This rank's blocks of ``params``: {path: (spec, local shape)}, and
    the tree gathered back, which must be ``params`` bit for bit."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.parallel import gather_params, shard_params
    from emmax_torch.parallel.sharding import spec_of

    mesh = _mesh(mesh_shape)
    full = params_from_numpy(params)
    local = shard_params(full, mesh)
    table = {p: (spec_of(t), tuple(t.shape))
             for p, t in leaves_with_path(local)}
    back = gather_params(local, mesh)
    equal = all(torch_equal(a, b) for (_, a), (_, b) in
                zip(leaves_with_path(back), leaves_with_path(full)))
    return {"table": table, "round_trip_equal": equal,
            "coordinate": mesh.get_coordinate()}


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def train_steps(params, batch, mesh_shape=None, *, vocab_size=512,
                stage="vla-full-train", remat=True, accum=1, steps=1,
                lr=1e-3, max_grad_norm=1.0, weight_decay=0.0,
                ce_chunk=None, return_params=False):
    """``steps`` train steps of the tiny VLM from ``params`` on ``batch``
    (the global batch; each rank takes its rows), on the mesh (None: the
    unwrapped step on every rank). Returns the metrics of each step and,
    with ``return_params``, the full params after the last one."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.parallel import gather_params, shard_batch, shard_params
    from emmax_torch.parallel.sharding import batch_rows
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    import torch

    cfg = tiny_vlm_config(vocab_size=vocab_size)
    mesh = _mesh(mesh_shape) if mesh_shape is not None else None
    tparams = params_from_numpy(params)
    tx, _ = make_optimizer(tparams, learning_rate=lr,
                           weight_decay=weight_decay,
                           max_grad_norm=max_grad_norm,
                           lr_scheduler_type="constant", total_steps=10,
                           stage=stage)
    freeze = trainable_mask(tparams, stage)
    if mesh is not None:
        tparams = shard_params(tparams, mesh)
    state = create_train_state(tparams, tx)
    from emmax_torch.training.train_step import make_train_step

    step = make_train_step(cfg, tx, remat=remat, compute_dtype=torch.float32,
                           grad_accum_steps=accum, freeze_mask=freeze,
                           ce_chunk=ce_chunk, mesh=mesh)
    b = _tensors(batch)
    if mesh is not None:
        b = shard_batch(batch_rows(b, mesh), mesh)
    out = []
    for _ in range(steps):
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    result = {"metrics": out}
    if return_params:
        full = (gather_params(state.params, mesh) if mesh is not None
                else state.params)
        result["params"] = _numpy(full)
    return result


def checkpoint_round_trip(params, batch, mesh_shape, run_dir):
    """One step on the mesh, a save (rank 0 writes the full tree) and a
    restore (every rank keeps its blocks); the restored blocks and the
    saved file against the live state."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.parallel import gather_params, shard_batch, shard_params
    from emmax_torch.parallel.sharding import batch_rows
    from emmax_torch.training.checkpointing import CheckpointManager
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer)
    from emmax_torch.training.train_step import make_train_step
    import torch

    cfg = tiny_vlm_config()
    mesh = _mesh(mesh_shape)
    tparams = params_from_numpy(params)
    tx, _ = make_optimizer(tparams, learning_rate=1e-3, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=10, stage="vla-full-train")
    state = create_train_state(shard_params(tparams, mesh), tx)
    step = make_train_step(cfg, tx, remat=False, compute_dtype=torch.float32,
                           mesh=mesh)
    state, m = step(state, shard_batch(batch_rows(_tensors(batch), mesh),
                                       mesh))
    mgr = CheckpointManager(run_dir, mesh=mesh)
    path = mgr.save(state, step=state.step, epoch=0, loss=float(m["loss"]))
    restored = mgr.restore(path)
    diff = 0.0
    for (_, a), (_, b) in zip(leaves_with_path(restored.params),
                              leaves_with_path(state.params)):
        diff += float((a - b).abs().sum())
    for key in ("mu", "nu"):
        for a, b in zip(restored.opt_state[key], state.opt_state[key]):
            if a is not None:
                diff += float((a - b).abs().sum())
    full = gather_params(state.params, mesh)
    blob = torch.load(path / "state.pt", weights_only=True)
    file_diff = sum(float((a - t).abs().sum()) for (_, a), (_, t) in zip(
        leaves_with_path(blob["params"]), leaves_with_path(full)))
    return {"loss": float(m["loss"]), "restore_absdiff": diff,
            "file_absdiff": file_diff, "step": restored.step}


def serve(params, pixels, prompt, mesh_shape=None, *, vocab_size=512,
          max_new=8, quantize=None):
    """Greedy tokens of the tiny VLM's ``ServingEngine`` (sharded on the
    mesh, or unsharded on every rank when ``mesh_shape`` is None)."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.parallel import shard_params
    from emmax_torch.serving.engine import GenerateOptions, ServingEngine
    from emmax_torch.serving.quant import quantize_vlm_params
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    cfg = tiny_vlm_config(vocab_size=vocab_size)
    tok = ByteLevelTokenizer(vocab_size)
    tparams = params_from_numpy(params)
    if quantize is not None:
        tparams = quantize_vlm_params(tparams, bits=quantize)
    mesh = _mesh(mesh_shape) if mesh_shape is not None else None
    if mesh is not None:
        tparams = shard_params(tparams, mesh)
    engine = ServingEngine(cfg, tparams, tok,
                           options=GenerateOptions(eos_id=tok.eos_id),
                           device="cpu", mesh=mesh)
    return engine.generate_ids([prompt], _tensors(pixels),
                               max_new_tokens=max_new)[0]


def ring(q, k, v, mesh_shape, axis_name, causal, kv_mask=None):
    """This rank's output block of ``ring_attention`` on the global q/k/v
    split over ``axis_name``, and the rank's position on it."""
    from emmax_torch.ops.ring_attention import ring_attention

    mesh = _mesh(mesh_shape)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    i = mesh.get_local_rank(axis_name)
    L = q.shape[1] // n

    def block(a):
        return _tensors(a)[:, i * L:(i + 1) * L]

    out = ring_attention(block(q), block(k), block(v), mesh=mesh,
                         axis_name=axis_name,
                         kv_mask=None if kv_mask is None else block(kv_mask),
                         causal=causal)
    return {"index": i, "out": out.numpy()}


def oom_risk(params, mesh_shape, hbm_bytes):
    """``_spec_bf16_oom_risk`` of this rank's blocks."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.parallel import shard_params
    from emmax_torch.serving.speculative import _spec_bf16_oom_risk

    local = shard_params(params_from_numpy(params), _mesh(mesh_shape))
    return _spec_bf16_oom_risk(local, hbm_bytes)


TASKS = {f.__name__: f for f in (placement, train_steps,
                                 checkpoint_round_trip, serve, ring,
                                 oom_risk)}
