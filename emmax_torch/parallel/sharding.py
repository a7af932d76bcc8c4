"""Sharding rules for the VLM parameter tree, port of
``emmax_tpu/parallel/sharding.py``.

The JAX package states where each leaf lives as a PartitionSpec and lets
GSPMD insert the collectives. Here the same rules place each leaf, and
the collectives are explicit (``parallel/gather.py``). A spec is a tuple
with one entry per dimension: ``None`` or the mesh axis that dimension is
split over.

Rules (first match wins; megatron-style tensor split + ZeRO-3 FSDP):

- attention q/k/v and MLP up projections ``[L, D_in, D_out]``: in-dim on
  ``fsdp``, out-dim on ``tensor``;
- attention out and MLP down projections: the other way round;
- embeddings / lm_head: vocab on ``tensor``, model dim on ``fsdp``;
- norms, biases, layerscale, cls / register / position tokens, and the
  ``q4`` / ``scale`` / ``q8`` leaves of a quantized weight: replicated.

An axis of size 1, or one that does not divide its dimension, is dropped
from the spec (that dimension is replicated), so on one device every
spec is all ``None``.

``shard_params`` keeps only this rank's block of every leaf, as a plain
tensor; the spec stays beside it as the tensor's ``_emmax_spec``
attribute (``spec_of``), which the model code reads where it gathers.
(``models.tree`` is imported inside the functions: the models import this
package.)
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]
DATA_AXES = ("replica", "fsdp")
_SPEC_ATTR = "_emmax_spec"

# (regex over the "/"-joined path, spec); specs are trimmed to the leaf's
# rank from the left
_RULES: List[Tuple[str, Spec]] = [
    # --- LLM ---
    (r"llm/embed$", ("tensor", "fsdp")),
    (r"llm/lm_head$", ("fsdp", "tensor")),
    (r"llm/layers/(wq|wk|wv)$", (None, "fsdp", "tensor")),
    (r"llm/layers/wo$", (None, "tensor", "fsdp")),
    (r"llm/layers/(w_gate|w_up)$", (None, "fsdp", "tensor")),
    (r"llm/layers/w_down$", (None, "tensor", "fsdp")),
    (r"llm/layers/(attn_norm|mlp_norm)$", ()),
    (r"llm/final_norm$", ()),
    # --- ViT towers ---
    (r"vision/.*/patch_embed/kernel$", ("fsdp", "tensor")),
    (r"vision/.*/blocks/wqkv$", (None, "fsdp", "tensor")),
    (r"vision/.*/blocks/wo$", (None, "tensor", "fsdp")),
    (r"vision/.*/blocks/w1$", (None, "fsdp", "tensor")),
    (r"vision/.*/blocks/w2$", (None, "tensor", "fsdp")),
    (r"vision/.*/(pos_embed|cls_token|reg_tokens)$", ()),
    (r"vision/.*", ()),          # biases, norms, layerscale
    # --- projector ---
    (r"projector/layers/\d+/kernel$", ("fsdp", "tensor")),
    (r"projector/.*", ()),
    # --- fallback ---
    (r".*", ()),
]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of a plain mapping (the
    shape-only callers: placement tables without a process group)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for_path(path_str: str, ndim: int, mesh) -> Spec:
    """The first matching rule's spec for a leaf at ``path_str`` (the tree
    walkers' "/"-joined keys, as JAX's ``_path_str`` joins them)."""
    for pattern, spec in _RULES:
        if re.fullmatch(pattern, path_str):
            return _fit_spec(spec, ndim, mesh)
    return (None,) * ndim


def _fit_spec(spec: Spec, ndim: int, mesh) -> Spec:
    """Trim / pad ``spec`` to ``ndim`` entries and drop size-1 axes."""
    sizes = axis_sizes(mesh)
    entries = list(spec)[:ndim] + [None] * (ndim - len(spec))
    return tuple(e if e is not None and sizes[e] > 1 else None
                 for e in entries)


def leaf_spec(path_str: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of one leaf: its rule's, with every axis that does not
    divide its dimension dropped (replicated on that axis)."""
    sizes = axis_sizes(mesh)
    spec = spec_for_path(path_str, len(shape), mesh)
    return tuple(e if e is not None and dim % sizes[e] == 0 else None
                 for dim, e in zip(shape, spec))


def param_partition_specs(params: Any, mesh) -> Dict[str, Spec]:
    """{leaf path: spec} for every tensor of ``params`` (full shapes), in
    the tree's leaf order (a spec is a tuple, which the tree walkers would
    enter, so the table is flat)."""
    from emmax_torch.models.tree import leaves_with_path

    return {p: leaf_spec(p, tuple(leaf.shape), mesh)
            for p, leaf in leaves_with_path(params)
            if isinstance(leaf, torch.Tensor)}


def placements(spec: Spec, mesh) -> list:
    """``spec`` as DTensor placements, one per mesh axis: ``Shard(d)``
    where dimension ``d`` is split over the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = (mesh.mesh_dim_names if not isinstance(mesh, dict)
             else tuple(mesh))
    out = []
    for axis in names:
        dims = [d for d, e in enumerate(spec) if e == axis]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    sizes = axis_sizes(mesh)
    return tuple(d // sizes[e] if e is not None else d
                 for d, e in zip(shape, spec))


def spec_of(t) -> Optional[Spec]:
    """The spec ``shard_params`` recorded beside a local tensor (None for
    a tensor it did not place)."""
    return getattr(t, _SPEC_ATTR, None)


def with_spec(t: torch.Tensor, spec: Optional[Spec]) -> torch.Tensor:
    """``t`` carrying ``spec`` (a cast or a layer slice of a placed
    leaf keeps its block's spec)."""
    if spec is not None:
        setattr(t, _SPEC_ATTR, spec)
    return t


def sliced(t: torch.Tensor, index) -> torch.Tensor:
    """``t[index]`` of a stacked ``[L, ...]`` leaf with its spec kept (the
    layer axis dropped from it for an int ``index``). The rules never split
    the layer axis, so a placed leaf's slice is this rank's block of the
    sliced leaf."""
    spec = spec_of(t)
    out = t[index]
    if spec is not None:
        with_spec(out, spec[1:] if isinstance(index, int) else spec)
    return out


def is_sharded(spec: Optional[Spec]) -> bool:
    return spec is not None and any(e is not None for e in spec)


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_block(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    sizes = axis_sizes(mesh)
    out = full
    for d, e in enumerate(spec):
        if e is not None:
            n = full.shape[d] // sizes[e]
            out = out.narrow(d, mesh.get_local_rank(e) * n, n)
    return out


def shard_leaf(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` on the mesh's device, tagged with
    ``spec``. A replicated leaf already on that device is returned as it
    is (no copy: on one device sharding moves nothing)."""
    dev = mesh_device(mesh)
    if not is_sharded(spec) and full.device == dev:
        return with_spec(full, spec)
    block = _local_block(full, spec, mesh)
    if block.device == dev:      # a view into ``full``: own its memory
        block = block.clone(memory_format=torch.contiguous_format)
    else:
        block = block.to(dev).contiguous()
    return with_spec(block, spec)


def shard_params(params: Any, mesh,
                 specs: Optional[Dict[str, Spec]] = None) -> Any:
    """Keep this rank's block of every leaf (``specs``: the table of
    :func:`param_partition_specs`, computed when not given). Leaves that
    are not tensors (none in a VLM tree) are kept as they are."""
    from emmax_torch.models.tree import map_with_path

    if specs is None:
        specs = param_partition_specs(params, mesh)
    return map_with_path(lambda p, leaf: shard_leaf(leaf, specs[p], mesh)
                         if isinstance(leaf, torch.Tensor) else leaf, params)


def dist_fn(name: str, old_name: str):
    """``torch.distributed.<name>``, or its older spelling on a torch that
    lacks it (the card's torch has ``all_gather_into_tensor`` /
    ``reduce_scatter_tensor``; newer ones warn on those names)."""
    import torch.distributed as dist

    return getattr(dist, name, None) or getattr(dist, old_name)


def all_gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's block (a collective: every rank of
    the mesh calls it). No autograd; ``parallel.gather.gather`` is the
    differentiable version. Over ``tensor`` the blocks are gathered by
    ``parallel.tensor.gather_axis`` (an exact all-reduce) and their bytes
    counted."""
    from emmax_torch.parallel.tensor import gather_axis

    all_gather = dist_fn("all_gather_single", "all_gather_into_tensor")
    sizes = axis_sizes(mesh)
    for d, e in enumerate(spec):
        if e is None:
            continue
        if e == "tensor":
            x = gather_axis(x.contiguous(), d, mesh, "gathered_bytes")
            continue
        xs = x.movedim(d, 0).contiguous()
        out = xs.new_empty((sizes[e] * xs.shape[0],) + xs.shape[1:])
        all_gather(out, xs, group=mesh.get_group(e))
        x = out.movedim(0, d)
    return x


def gather_params(params: Any, mesh, *, device=None, keep: bool = True):
    """The full tree from the ranks' blocks, leaf by leaf (every rank
    calls it). Each gathered leaf moves to ``device`` (default: where it
    was gathered); a rank with ``keep=False`` takes part in the gathers
    but drops the results (None leaves), so only the rank that writes a
    checkpoint holds the full tree. Untagged leaves are taken as
    replicated."""
    from emmax_torch.models.tree import map_with_path

    def one(_, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = spec_of(leaf)
        full = (all_gather_leaf(leaf, spec, mesh) if is_sharded(spec)
                else leaf)
        if not keep:
            return None
        full = full.contiguous()
        return full.to(device) if device is not None else full

    return map_with_path(one, params)


# --- batches -----------------------------------------------------------------

def data_extent(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in DATA_AXES)


def data_index(mesh) -> int:
    """This rank's position on the data axes (replica major, fsdp minor:
    the order of the JAX package's ``P(("replica", "fsdp"))``)."""
    sizes = axis_sizes(mesh)
    return (mesh.get_local_rank("replica") * sizes["fsdp"]
            + mesh.get_local_rank("fsdp"))


def batch_sharding(mesh, ndim: int = 2,
                   batch_dim_size: Optional[int] = None) -> list:
    """Placements of a data leaf, one per mesh axis: the batch dim over
    (replica, fsdp), the rest replicated; replicated when the batch does
    not divide the data axes (tiny smoke batches) and for a scalar."""
    from torch.distributed.tensor import Replicate, Shard

    split = ndim > 0 and (batch_dim_size is None
                          or batch_dim_size % data_extent(mesh) == 0)
    return [Shard(0) if split and axis in DATA_AXES else Replicate()
            for axis in axis_sizes(mesh)]


def batch_rows(batch: Any, mesh) -> Any:
    """This rank's rows of a global batch (the same on every rank), as
    :func:`batch_sharding` places them: data rank ``k`` of ``dp`` takes
    rows ``[k B/dp, (k+1) B/dp)``, or every row when B does not divide."""
    dp, k = data_extent(mesh), data_index(mesh)

    def take(a):
        if isinstance(a, dict):
            return {key: take(v) for key, v in a.items()}
        if not hasattr(a, "shape") or len(a.shape) == 0:
            return a
        B = a.shape[0]
        if B % dp:
            return a
        return a[k * (B // dp):(k + 1) * (B // dp)]

    return take(batch)


def shard_batch(batch: Any, mesh) -> Any:
    """Place this rank's share of the global batch on its device.

    One process drives one device, so every rank passes its OWN rows (the
    JAX package's multi-process path): the trainer's
    ``BatchLoader(num_shards=data extent, shard_index=data index)`` yields
    them, and :func:`batch_rows` cuts them from a global batch. The
    global batch is the data ranks' rows in data-index order; ranks that
    differ only on ``tensor`` pass the same rows."""
    dev = mesh_device(mesh)

    def put(a):
        if isinstance(a, dict):
            return {key: put(v) for key, v in a.items()}
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    return put(batch)
