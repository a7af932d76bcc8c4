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

A ``mesh_shape`` smaller than the pool (``(1, 1, 2)`` of 8 ranks) is a
mesh of the first ranks: every rank builds it (making its groups is a
collective of the whole group), the ranks outside it skip the task, and
``run`` returns the mesh's ranks' results.
"""

from __future__ import annotations

import math
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
        """``task(**kwargs)`` on every rank; the results by rank (the mesh's
        ranks' for a mesh smaller than the pool)."""
        for conn in self.conns:
            conn.send((task, kwargs))
        out = self._collect()
        shape = kwargs.get("mesh_shape")
        return out if shape is None else out[:math.prod(shape)]

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
            shape = kwargs.get("mesh_shape")
            if shape is not None and _mesh(shape).get_coordinate() is None:
                conn.send(("ok", None))      # outside a smaller mesh
                continue
            conn.send(("ok", TASKS[name](**kwargs)))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    dist.destroy_process_group()


# --- tasks (run in the workers) -----------------------------------------------

_MESHES = {}


def _mesh(shape):
    """One DeviceMesh per shape and worker (building one is a collective
    that makes new groups); a shape smaller than the world is a mesh of
    its first ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from emmax_torch.parallel import make_mesh
    from emmax_torch.parallel.mesh import AXIS_NAMES

    shape = tuple(shape)
    if shape not in _MESHES:
        n = math.prod(shape)
        _MESHES[shape] = (
            make_mesh(shape, device_type="cpu")
            if n == dist.get_world_size()
            else DeviceMesh("cpu", torch.arange(n).reshape(shape),
                            mesh_dim_names=AXIS_NAMES))
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


def _tiny_engine_args(params, mesh_shape, vocab_size, quantize=None,
                      cfg=None, n_kv_heads=None):
    """(tiny config, or ``cfg``'s (``_vlm_config``), this rank's tree,
    tokenizer, mesh) for the serving tasks below: the whole tree on every
    rank when ``mesh_shape`` is None."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.parallel import shard_params
    from emmax_torch.serving.quant import quantize_vlm_params
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    tparams = params_from_numpy(params)
    if quantize is not None:
        tparams = quantize_vlm_params(tparams, bits=quantize)
    mesh = _mesh(mesh_shape) if mesh_shape is not None else None
    if mesh is not None:
        tparams = shard_params(tparams, mesh)
    return (_vlm_config(cfg, vocab_size, n_kv_heads), tparams,
            ByteLevelTokenizer(vocab_size), mesh)


def serve(params, pixels, prompt, mesh_shape=None, *, vocab_size=512,
          max_new=8, quantize=None, cfg=None, n_kv_heads=None,
          cache_heads=False):
    """Greedy tokens of the tiny VLM's (or ``cfg``'s; ``n_kv_heads`` for
    the tiny decoder's KV heads) ``ServingEngine`` (sharded on the mesh,
    or unsharded on every rank when ``mesh_shape`` is None); with
    ``cache_heads`` also the KV heads of the engine's cache on this
    rank."""
    from emmax_torch.serving import engine as eng_mod
    from emmax_torch.serving.engine import GenerateOptions, ServingEngine

    cfg, tparams, tok, mesh = _tiny_engine_args(params, mesh_shape,
                                                vocab_size, quantize, cfg,
                                                n_kv_heads)
    engine = ServingEngine(cfg, tparams, tok,
                           options=GenerateOptions(eos_id=tok.eos_id),
                           device="cpu", mesh=mesh)
    heads = []
    real = eng_mod.init_kv_cache

    def recorded(*args, **kw):
        cache = real(*args, **kw)
        heads.append(cache["k"].shape[3])
        return cache

    eng_mod.init_kv_cache = recorded
    try:
        ids = engine.generate_ids([prompt], _tensors(pixels),
                                  max_new_tokens=max_new)[0]
    finally:
        eng_mod.init_kv_cache = real
    return {"tokens": ids, "cache_heads": heads} if cache_heads else ids


def speculative(params, patches, calls, mesh_shape=None, *, vocab_size=512,
                quantize=None, engine_kw=None, n_kv_heads=None):
    """``SpeculativeEngine`` of the tiny VLM (``n_kv_heads``: its
    decoder's KV heads; sharded on the mesh) over ``calls``, each
    ``{"prompts", "max_new", "forced"?}``, on one engine and one patch
    tensor (so a call may refresh the previous call's tail): per call the
    tokens, ``last_steps`` and ``last_prefill``."""
    from emmax_torch.serving.engine import GenerateOptions
    from emmax_torch.serving.speculative import SpeculativeEngine

    cfg, tparams, tok, mesh = _tiny_engine_args(params, mesh_shape,
                                                vocab_size, quantize,
                                                n_kv_heads=n_kv_heads)
    engine = SpeculativeEngine(cfg, tparams, tok,
                               options=GenerateOptions(eos_id=tok.eos_id),
                               device="cpu", mesh=mesh, **(engine_kw or {}))
    vision = {"patches": _tensors(patches)}
    out = []
    for call in calls:
        ids = engine.generate_ids(call["prompts"], vision,
                                  max_new_tokens=call["max_new"],
                                  forced_tokens=call.get("forced"))
        out.append({"tokens": ids, "steps": engine.last_steps,
                    "prefill": engine.last_prefill})
    return out


def batched(params, patches, requests, mesh_shape=None, *, engine,
            vocab_size=512, engine_kw=None, n_kv_heads=None):
    """The paged (``engine="paged"``) or slot-pool (``"continuous"``)
    engine of the tiny VLM (``n_kv_heads``: its decoder's KV heads),
    sharded on the mesh, over ``requests`` [(prompt, patch index,
    max_new)] against ``patches`` (a list): each request's tokens,
    whether every page went back to the free list, and the KV heads of
    this rank's page pool or slot pool."""
    from emmax_torch.serving.continuous import ContinuousServingEngine
    from emmax_torch.serving.paged import PagedServingEngine

    cfg, tparams, tok, mesh = _tiny_engine_args(params, mesh_shape,
                                                vocab_size,
                                                n_kv_heads=n_kv_heads)
    cls = {"paged": PagedServingEngine,
           "continuous": ContinuousServingEngine}[engine]
    eng = cls(cfg, tparams, tok, device="cpu", mesh=mesh,
              **(engine_kw or {}))
    vision = [{"patches": _tensors(p)} for p in patches]
    rids = [eng.submit(prompt, vision[i], max_new_tokens=n)
            for prompt, i, n in requests]
    done = eng.run_until_complete()
    pages = getattr(eng, "free_pages", None)
    return {"tokens": [done[r] for r in rids],
            "pages_back": pages is None
            or sorted(pages) == list(range(eng.n_pages)),
            "kv_heads": int(eng.pool["k"].shape[
                0 if engine == "paged" else 3])}


def vla_actions(params, frames, prompts, mesh_shape=None, *, vocab_size=512,
                max_new=16, vla_kw=None):
    """``EmmaXVLA(..., mesh=)`` (sharded on the mesh) over one closed loop
    of ``frames`` [uint8 HxWx3] and ``prompts``: per frame the actions,
    the text and the engine's ``last_steps`` / ``last_prefill``."""
    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.ops.image import ImageTransformConfig

    cfg, tparams, tok, mesh = _tiny_engine_args(params, mesh_shape,
                                                vocab_size)
    vla = EmmaXVLA(cfg, tparams, tok,
                   {n: ImageTransformConfig(size=v.img_size)
                    for n, v in cfg.vision},
                   device="cpu", mesh=mesh, **(vla_kw or {}))
    out = []
    for frame, prompt in zip(frames, prompts):
        actions, text = vla.generate_actions(frame, prompt,
                                             max_new_tokens=max_new)
        out.append({"actions": [np.asarray(a) for a in actions],
                    "text": text,
                    "steps": getattr(vla.engine, "last_steps", None),
                    "prefill": getattr(vla.engine, "last_prefill", None)})
    return out


def speculative_guards(params, mesh_shape, *, vocab_size=512):
    """On the mesh: a greedy ``SpeculativeEngine`` is built (the guard
    that refused a mesh is gone), a sampling one still raises; the
    message of each raise."""
    from emmax_torch.serving.engine import GenerateOptions
    from emmax_torch.serving.speculative import SpeculativeEngine

    cfg, tparams, tok, mesh = _tiny_engine_args(params, mesh_shape,
                                                vocab_size)
    built = SpeculativeEngine(cfg, tparams, tok, device="cpu", mesh=mesh)
    try:
        SpeculativeEngine(cfg, tparams, tok, device="cpu", mesh=mesh,
                          options=GenerateOptions(temperature=0.7))
        sampling = None
    except ValueError as e:
        sampling = str(e)
    return {"built_on_mesh": built.mesh is mesh, "sampling_raises": sampling}


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


def _vlm_config(cfg, vocab_size=512, n_kv_heads=None):
    """The tiny VLM (``cfg`` None; ``n_kv_heads`` replaces its decoder's 4
    KV heads, the tests' grouped-query config) or the one ``cfg``
    describes: ``{"vision": [(name, ViTConfig kwargs)], "phi": PhiConfig
    kwargs}``."""
    import dataclasses

    from emmax_torch.models.phi import PhiConfig
    from emmax_torch.models.vit import ViTConfig
    from emmax_torch.models.vlm import VLMConfig, tiny_vlm_config

    if cfg is None:
        tiny = tiny_vlm_config(vocab_size=vocab_size)
        if n_kv_heads is None:
            return tiny
        return dataclasses.replace(tiny, llm=dataclasses.replace(
            tiny.llm, n_kv_heads=n_kv_heads))
    return VLMConfig(vision=tuple((n, ViTConfig(**kw))
                                  for n, kw in cfg["vision"]),
                     llm=PhiConfig(**cfg["phi"]))


def _full_grads(leaves, mesh):
    """{path: the whole gradient} of (path, leaf) pairs, each block's
    gradient gathered back to the whole leaf; a leaf the forward did not
    read (a tower's final norm) has none."""
    from emmax_torch.parallel.sharding import (all_gather_leaf, is_sharded,
                                               spec_of)

    return {p: (all_gather_leaf(t.grad, spec_of(t), mesh)
                if is_sharded(spec_of(t)) else t.grad).numpy()
            for p, t in leaves if t.grad is not None}


def split_forward(params, ids, mask, grad_w, mesh_shape, *, vocab_size=512,
                  cache_len=32, cfg=None, n_kv_heads=None):
    """The tiny decoder (fp32; Phi-2's where ``cfg`` names one, the tiny
    one's ``n_kv_heads`` where given) on the mesh, from token ids: the
    embedded rows, the uncached logits, the
    gradient of ``sum(logits * grad_w)`` for every decoder leaf (each block
    gathered to the whole leaf; None on a mesh with data axes, where the
    ranks would sum the same batch's gradients), the logits of a cached
    prefill and of one decode step after it, this rank's cache heads, and
    the split's counts: collectives over ``tensor`` in the uncached
    forward and ``all_gather_leaf`` calls over ``tensor`` in all the
    forwards."""
    import torch

    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models import llama
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import llm_apply
    from emmax_torch.parallel import gather as pgather
    from emmax_torch.parallel import shard_params
    from emmax_torch.parallel import tensor as ptensor
    from emmax_torch.parallel.sharding import data_extent

    cfg = _vlm_config(cfg, vocab_size, n_kv_heads).llm
    mesh = _mesh(mesh_shape)
    llm = shard_params(params_from_numpy(params), mesh)["llm"]
    split = ptensor.decoder_split(llm, cfg, mesh)
    calls = []
    real = pgather.all_gather_leaf

    def counted(x, spec, m):
        calls.append("tensor" in spec)
        return real(x, spec, m)

    pgather.all_gather_leaf = counted
    try:
        ids_t, mask_t = _tensors(ids), _tensors(mask)
        leaves = [(p, t.requires_grad_()) for p, t in
                  leaves_with_path(llm)]
        ptensor.reset_counts()
        embeds = llama.embed_tokens(llm, ids_t, mesh)
        logits, _ = llm_apply(llm, cfg, embeds, mask=mask_t,
                              attn_impl="torch", mesh=mesh)
        sums = ptensor.counts["sums"]
        grads = None
        if data_extent(mesh) == 1:      # every rank holds the whole batch
            (logits * _tensors(grad_w)).sum().backward()
            grads = _full_grads(leaves, mesh)
        with torch.inference_mode():
            cache = llama.init_kv_cache(cfg, ids_t.shape[0], cache_len,
                                        dtype=torch.float32, split=split.t)
            cached, _ = llm_apply(
                llm, cfg, llama.embed_tokens(llm, ids_t, mesh), mask=mask_t,
                kv_cache=cache, attn_impl="torch", mesh=mesh)
            nxt = cached[:, -1].argmax(-1)
            step, _ = llm_apply(
                llm, cfg, llama.embed_tokens(llm, nxt[:, None], mesh),
                kv_cache=cache, attn_impl="torch", mesh=mesh)
    finally:
        pgather.all_gather_leaf = real
    return {"t": split.t, "embeds": embeds.detach().numpy(),
            "logits": logits.detach().numpy(), "grads": grads,
            "cached": cached.numpy(), "step": step.numpy(),
            "cache_heads": cache["k"].shape[3], "sums": sums,
            "tensor_gathers": sum(calls)}


def split_encode(params, pixels, grad_w, mesh_shape, *, cfg=None):
    """``encode_images`` of the tiny VLM (fp32) on the mesh: the
    features, each tower's split, the counts over ``tensor`` (sums,
    exchanges, weight bytes gathered) and, where every rank holds the
    whole batch, the gradient of ``sum(features * grad_w)`` for every
    tower and projector leaf (each block gathered to the whole leaf)."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import encode_images
    from emmax_torch.parallel import shard_params
    from emmax_torch.parallel import tensor as ptensor
    from emmax_torch.parallel.sharding import data_extent

    vcfg = _vlm_config(cfg)
    mesh = _mesh(mesh_shape)
    tree = shard_params(params_from_numpy(params), mesh)
    leaves = [(p, t.requires_grad_()) for p, t in leaves_with_path(
        {"vision": tree["vision"], "projector": tree["projector"]})]
    ptensor.reset_counts()
    feats = encode_images(tree, vcfg, _tensors(pixels), attn_impl="torch",
                          mesh=mesh)
    counts = dict(ptensor.counts)
    grads = None
    if data_extent(mesh) == 1:
        (feats * _tensors(grad_w)).sum().backward()
        grads = _full_grads(leaves, mesh)
    return {"feats": feats.detach().numpy(), "counts": counts,
            "towers_t": [ptensor.tower_split(tree["vision"][n], v, mesh).t
                         for n, v in vcfg.vision],
            "grads": grads}


def split_ce(h, lm_head, labels, mesh_shape, *, chunk=5):
    """``chunked_ce_loss_and_preds`` on the mesh from the global ``h`` and
    ``labels`` (each rank its rows) and ``lm_head`` placed as the decoder's
    (vocab on ``tensor``): the loss, this rank's preds, the weight bytes
    gathered over ``tensor``, the sums over it, and where every rank holds
    the whole batch the gradients of the loss for ``h`` and the lm_head."""
    from emmax_torch.models.llama import chunked_ce_loss_and_preds
    from emmax_torch.parallel import shard_params
    from emmax_torch.parallel import tensor as ptensor
    from emmax_torch.parallel.sharding import batch_rows, data_extent

    mesh = _mesh(mesh_shape)
    head = shard_params({"llm": {"lm_head": _tensors(lm_head)}},
                        mesh)["llm"]["lm_head"].requires_grad_()
    rows = batch_rows({"h": _tensors(h), "labels": _tensors(labels)}, mesh)
    hb = rows["h"].requires_grad_()
    ptensor.reset_counts()
    loss, preds = chunked_ce_loss_and_preds(hb, head, rows["labels"],
                                            chunk=chunk, mesh=mesh)
    out = {"loss": float(loss), "preds": preds.numpy(),
           "sums": ptensor.counts["sums"]}
    loss.backward()
    out["gathered_bytes"] = ptensor.counts["gathered_bytes"]
    if data_extent(mesh) == 1:
        out["grads"] = {"h": hb.grad.numpy(),
                        **_full_grads([("lm_head", head)], mesh)}
    return out


def embed_rows(params, ids, mesh_shape):
    """``embed_tokens`` of the tiny decoder's table on the mesh (vocab
    split on ``tensor`` where it has > 1 rank) for ``ids``, and whether
    the table was read vocab-parallel."""
    from emmax_torch.bridge import params_from_numpy
    from emmax_torch.models import llama
    from emmax_torch.parallel import shard_params
    from emmax_torch.parallel.tensor import vocab_split

    mesh = _mesh(mesh_shape)
    llm = shard_params(params_from_numpy(params), mesh)["llm"]
    return {"rows": llama.embed_tokens(llm, _tensors(ids), mesh).numpy(),
            "split": vocab_split(llm["embed"], 0, mesh)}


TASKS = {f.__name__: f for f in (placement, train_steps,
                                 checkpoint_round_trip, serve, speculative,
                                 batched, vla_actions, speculative_guards,
                                 ring, oom_risk, split_forward,
                                 split_encode, split_ce, embed_rows)}
