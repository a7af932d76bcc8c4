"""The decoder split over the ``tensor`` axis: the compute GSPMD derives in
the JAX package from its Megatron rules (``parallel/sharding.py``), made
explicit.

Under a mesh whose ``tensor`` axis has ``t > 1`` ranks, a Llama-family
decoder layer whose seven matmul weights are dense ``tensor`` blocks
computes only its own block (:func:`decoder_split`):

- column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``: the
  rank's ``n_heads / t`` query heads, ``n_kv_heads / t`` KV heads (query
  head ``h`` reads KV head ``h // (n_heads / n_kv_heads)``, so a rank's
  heads and their KV heads are one contiguous block of each) and
  ``hidden_dim / t`` MLP columns. The block is gathered over the data
  axes only. The input is Megatron's *f* (:func:`enter`): itself in the
  forward, its gradient summed over ``tensor`` in the backward;
- row-parallel ``wo`` / ``w_down``: the rank's rows, then one sum of the
  partial outputs over ``tensor`` (*g*, :func:`reduce`; the identity in
  the backward);
- the embedding (vocab on ``tensor``): each rank reads the ids in its own
  rows, zeros elsewhere, and the rows are summed over ``tensor``;
- the logits (the lm_head's vocab on ``tensor``): each rank computes its
  ``V / t`` columns, which are put together into the whole ``[..., V]``
  on every rank.

Every collective here is an all-reduce of a buffer in which each rank
writes its own slice and zeros elsewhere, reduced as bytes: each element
is one rank's bits plus zeros, so the result is exact and the same on
every rank whatever order the backend adds in (gloo may add in a
different order on each rank, and gloo on CUDA tensors offers little
beyond all-reduce). Sums of partials then add the gathered parts in rank
order, in fp32, on every rank: every rank holds the same bits, and the
engines' host loops, which every rank runs on the same requests, take the
same tokens.

A layer whose heads or KV heads do not divide by ``t``, or whose weights
are quantized (``q4`` / ``q8`` leaves are replicated) or not ``tensor``
blocks, runs whole, gathered as before (``parallel/gather.py``). With no
mesh, or ``tensor`` of size 1, nothing is split and no collective runs.

``counts`` tallies the forward's collectives over ``tensor`` (``sums``)
and the bytes all-gathered over ``tensor`` for a weight at use
(``gathered_bytes``, from ``sharding.all_gather_leaf``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from emmax_torch.parallel.gather import gather_axes, gather_tree
from emmax_torch.parallel.sharding import DATA_AXES, axis_sizes, spec_of

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")
counts: Dict[str, int] = {"sums": 0, "gathered_bytes": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def _tensor(mesh):
    """(size, this rank's index) of the ``tensor`` axis."""
    return (axis_sizes(mesh)["tensor"], mesh.get_local_rank("tensor"))


def stacked(x: torch.Tensor, mesh, weight: bool = False) -> torch.Tensor:
    """``[t, *x.shape]``: every rank's ``x`` in rank order, the same bits on
    every rank (module docstring). A collective over ``tensor``, counted
    as a sum, or for a ``weight`` as the bytes it gathers."""
    import torch.distributed as dist

    t, r = _tensor(mesh)
    buf = x.new_zeros((t,) + tuple(x.shape))
    buf[r] = x
    dist.all_reduce(buf.view(torch.uint8), group=mesh.get_group("tensor"))
    if weight:
        counts["gathered_bytes"] += buf.numel() * buf.element_size()
    else:
        counts["sums"] += 1
    return buf


def gather_axis(x: torch.Tensor, dim: int, mesh,
                weight: bool = False) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated in rank
    order: the whole tensor on every rank."""
    return torch.cat(stacked(x, mesh, weight).unbind(0), dim=dim)


def rank_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` summed over ``tensor`` in rank order, in fp32 (in
    ``x``'s dtype for a wider one), cast back to ``x``'s dtype."""
    parts = stacked(x, mesh).unbind(0)
    acc = parts[0].float() if parts[0].element_size() < 4 else parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.to(x.dtype)


class _Enter(torch.autograd.Function):
    """Megatron's *f*: the identity, its gradient summed over ``tensor``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rank_sum(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    """Megatron's *g*: the sum over ``tensor``, the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return rank_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' column blocks concatenated; the backward keeps this
    rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return gather_axis(x, -1, mesh)

    @staticmethod
    def backward(ctx, g):
        _, r = _tensor(ctx.mesh)
        return g.narrow(-1, r * ctx.n, ctx.n).contiguous(), None


def enter(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Enter.apply(x, mesh)


def reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh)


def vocab_split(leaf, dim: int, mesh) -> bool:
    """Whether ``leaf`` (the embedding, ``dim`` 0, or the lm_head, ``dim``
    -1) is a dense block with its vocab on a ``tensor`` axis of > 1."""
    if mesh is None or not isinstance(leaf, torch.Tensor):
        return False
    spec = spec_of(leaf)
    return spec is not None and spec[dim] == "tensor"


def data_gather(x, mesh):
    """A placed block gathered over the data axes only (its ``tensor``
    split kept), differentiable; ``x`` where it is not split on one."""
    return gather_axes(x, mesh, DATA_AXES)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, mesh
                ) -> torch.Tensor:
    """Rows of the embedding from this rank's vocab block ``table``
    ``[V / t, D]`` (gathered over the data axes): an id in the block reads
    its row, any other zeros, and the ranks' rows are summed. An id past
    the table reads the last row, which lies on the last rank."""
    t, r = _tensor(mesh)
    n = table.shape[0]
    local = ids.clamp(max=n * t - 1) - r * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce(rows, mesh)


def vocab_logits(h: torch.Tensor, lm_head: torch.Tensor, mesh
                 ) -> torch.Tensor:
    """``h @ lm_head`` from this rank's vocab columns ``[D, V / t]``
    (gathered over the data axes): each rank's ``V / t`` logits, put
    together into the whole ``[..., V]`` on every rank."""
    return _GatherLast.apply(enter(h, mesh) @ lm_head, mesh)


@dataclasses.dataclass(frozen=True)
class DecoderSplit:
    """How one forward runs the decoder's layers: ``t`` 1 runs them whole
    (each block gathered at use), ``t`` > 1 computes this rank's share
    (module docstring)."""

    mesh: Any = None
    t: int = 1

    def weights(self, p: dict) -> dict:
        """One layer's weights as the layer reads them."""
        if self.t == 1:
            return gather_tree(p, self.mesh)
        return {k: data_gather(v, self.mesh) for k, v in p.items()}

    def heads(self, cfg):
        """(query heads, KV heads) this rank computes."""
        return cfg.n_heads // self.t, cfg.n_kv_heads // self.t

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else enter(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else reduce(x, self.mesh)


WHOLE = DecoderSplit()


def decoder_split(llm_params: dict, cfg, mesh) -> DecoderSplit:
    """The split of a Llama-family decoder under ``mesh``: ``t`` is the
    ``tensor`` axis's size where the heads and KV heads divide by it and
    every one of the layers' seven matmul weights is a dense block split
    on ``tensor`` (columns for ``COLUMN``, rows for ``ROW``), else 1. A
    decoder without those weights (Phi-2) runs whole."""
    if mesh is None:
        return WHOLE
    t = axis_sizes(mesh).get("tensor", 1)
    if t == 1 or cfg.n_heads % t or cfg.n_kv_heads % t:
        return DecoderSplit(mesh)
    layers = llm_params["layers"]
    for keys, dim in ((COLUMN, -1), (ROW, -2)):
        for key in keys:
            leaf = layers.get(key)
            spec = (spec_of(leaf) if isinstance(leaf, torch.Tensor)
                    else None)
            if spec is None or spec[dim] != "tensor":
                return DecoderSplit(mesh)
    return DecoderSplit(mesh, t)
