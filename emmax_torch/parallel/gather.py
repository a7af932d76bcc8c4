"""Gather-at-use: the collectives GSPMD inserts in the JAX package, made
explicit.

Each rank holds its block of every sharded leaf (``parallel/sharding``).
Where the model reads a sharded weight (one layer of a stacked leaf, the
embedding, the lm_head, a projector or patch-embedding kernel) it calls
:func:`gather`, which all-gathers the full weight over the mesh axes the
leaf is split on; only that weight is full while it is in use. Its
backward returns the block's gradient:

- over a data axis (``replica`` / ``fsdp``) each rank saw its own rows,
  so the full gradient is summed over the axis and scattered back
  (reduce-scatter);
- over ``tensor`` every rank saw the same rows and holds the same full
  gradient, so the rank keeps its slice and sums nothing (a sum would
  multiply it by the axis size).

Gradients of leaves not split on a data axis are summed over that axis
once after the backward (:func:`reduce_gradients`). The loss and the
metrics divide global sums by global counts (:func:`data_sum`), so the
step equals the single-device step on the whole batch. With a leaf not
split (every spec entry None, as on one device) nothing is copied and no
collective runs.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional

import torch

from emmax_torch.parallel.sharding import (DATA_AXES, Spec, all_gather_leaf,
                                           axis_sizes, dist_fn, is_sharded,
                                           spec_of, with_spec)


def _block_grad(g: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The gradient of a rank's block from the full leaf's gradient
    (module docstring)."""
    sizes = axis_sizes(mesh)
    reduce_scatter = dist_fn("reduce_scatter_single", "reduce_scatter_tensor")
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = g.shape[d] // sizes[e]
        if e in DATA_AXES:
            gs = g.movedim(d, 0).contiguous()
            out = gs.new_empty((n,) + gs.shape[1:])
            reduce_scatter(out, gs, group=mesh.get_group(e))
            g = out.movedim(0, d)
        else:
            g = g.narrow(d, mesh.get_local_rank(e) * n, n)
    return g.contiguous()


class _GatherAtUse(torch.autograd.Function):
    """All-gather a block in the forward, the block's gradient back."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return all_gather_leaf(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _block_grad(g, ctx.spec, ctx.mesh), None, None


def gather(x, mesh):
    """The full weight of a placed block (its ``spec_of``), differentiable;
    ``x`` itself without a mesh, for an untagged tensor, a quantized
    weight's dict or a replicated block."""
    return gather_axes(x, mesh, ("replica", "fsdp", "tensor"))


def gather_axes(x, mesh, axes):
    """:func:`gather` over ``axes`` only: a block split on another axis
    stays this rank's block there (``parallel/tensor.py`` gathers the
    decoder's split blocks over the data axes alone)."""
    if mesh is None or not isinstance(x, torch.Tensor):
        return x
    spec = spec_of(x)
    if spec is None:
        return x
    spec = tuple(e if e in axes else None for e in spec)
    if not is_sharded(spec):
        return x
    return _GatherAtUse.apply(x, spec, mesh)


def gather_tree(p: dict, mesh) -> dict:
    """:func:`gather` over the tensors of one layer's dict."""
    if mesh is None:
        return p
    return {k: gather(v, mesh) for k, v in p.items()}


def layer_blocks(stacked: dict, n_layers: int, mesh=None) -> List[dict]:
    """Per-layer dicts of a stacked ``[L, ...]`` tree's dense leaves,
    unbound once (under autograd the stack's gradient is then built
    once); each layer's block keeps the stacked leaf's spec without its
    layer axis, for :func:`gather_tree` at use."""
    unbound = {}
    for k, v in stacked.items():
        views = torch.unbind(v)
        spec = spec_of(v) if mesh is not None else None
        if is_sharded(spec):     # a replicated block needs no tag
            views = [with_spec(t, spec[1:]) for t in views]
        unbound[k] = views
    return [{k: v[i] for k, v in unbound.items()} for i in range(n_layers)]


def _ordered_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A small tensor summed over ``axes``: gathered, then added in rank
    order, so every rank holds the same bits (an all-reduce may add in a
    different order on each rank, as gloo does; the loss, the metrics and
    the norm that decides the clip must agree everywhere)."""
    import torch.distributed as dist

    sizes = axis_sizes(mesh)
    for axis in axes:
        if sizes[axis] > 1:
            parts = [torch.empty_like(x) for _ in range(sizes[axis])]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
            x = torch.stack(parts).sum(dim=0)
    return x


def data_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the data axes (a new tensor, no autograd); ``x``
    detached without a mesh."""
    out = x.detach().clone()
    return out if mesh is None else _ordered_sum(out, mesh, DATA_AXES)


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh):
    """``total / count`` over the whole global batch: the value is the
    data-summed total over the data-summed count, and the gradient is
    this rank's ``total`` over the global count, so the ranks' gradients
    add up to the gradient of the global mean. Rows repeated on several
    data ranks (a batch that did not divide) weigh as often in the sum
    as in the count, so the mean is that of the batch."""
    if mesh is None:
        return total / torch.clamp(count, min=1)
    g_count = torch.clamp(data_sum(count, mesh), min=1)
    # the value is exactly the global mean on every rank; the second term
    # is 0 and carries the gradient
    return (data_sum(total, mesh) / g_count
            + (total - total.detach()) / g_count)


def reduce_gradients(grads: Iterable[torch.Tensor],
                     specs: Iterable[Optional[Spec]], mesh) -> None:
    """Sum each gradient, in place, over the data axes its leaf is not
    split on (those split on one were reduce-scattered in the backward);
    0-d placeholders of frozen leaves are skipped."""
    import torch.distributed as dist

    if mesh is None:
        return
    sizes = axis_sizes(mesh)
    for g, spec in zip(grads, specs):
        if g.dim() == 0:
            continue
        for axis in DATA_AXES:
            if sizes[axis] > 1 and axis not in (spec or ()):
                dist.all_reduce(g, group=mesh.get_group(axis))


def sum_of_squares(leaves, specs, mesh) -> torch.Tensor:
    """sum of squares over every leaf, each element once: a block held by
    k ranks (k = the product of the axes it is not split on) weighs 1/k,
    then one sum over every axis of the mesh."""
    sizes = axis_sizes(mesh) if mesh is not None else {}
    total = None
    for g, spec in zip(leaves, specs):
        sq = g.float().square().sum()
        if mesh is not None:
            copies = math.prod(n for axis, n in sizes.items()
                               if axis not in (spec or ()))
            if copies > 1:
                sq = sq / copies
        total = sq if total is None else total + sq
    if mesh is not None:
        total = _ordered_sum(total, mesh, tuple(sizes))
    return total
