"""The split over the ``tensor`` axis: the compute GSPMD derives in the JAX
package from its Megatron rules (``parallel/sharding.py``), made
explicit, for every block those rules place on ``tensor``.

Under a mesh whose ``tensor`` axis has ``t > 1`` ranks, a :class:`Split`
with ``t > 1`` computes only the rank's share:

- the Llama-family decoder (:func:`decoder_split`, where its seven matmul
  weights are dense ``tensor`` blocks): column-parallel ``wq`` / ``wk`` /
  ``wv`` / ``w_gate`` / ``w_up``, the rank's ``n_heads / t`` query heads,
  ``n_kv_heads / t`` KV heads and ``hidden_dim / t`` MLP columns. Under
  grouped-query attention (``G = n_heads / n_kv_heads`` > 1, Mistral's 4)
  query head ``h`` reads KV head ``h // G``; where ``t`` divides
  ``n_kv_heads``, rank ``r``'s query heads ``[r H / t, (r + 1) H / t)``
  read exactly its KV heads ``[r KV / t, (r + 1) KV / t)``, so the rank
  attends its local KV heads ``[0, KV / t)`` at the same ``G``, the
  split leaving the grouping unchanged. The
  input is Megatron's *f* (:func:`enter`: itself in the forward, its
  gradient summed over ``tensor`` in the backward); row-parallel ``wo`` /
  ``w_down``, the rank's rows, then one sum of the partial outputs over
  ``tensor`` (*g*, :func:`reduce`: the identity in the backward);
- Phi-2's attention (:func:`decoder_split`): ``wq`` / ``wk`` / ``wv`` by
  columns with the rank's slices of the replicated ``bq`` / ``bk`` /
  ``bv`` (:meth:`Split.cols`), ``wo`` by rows, then the sum and ``bo``
  once. JAX's rules leave Phi-2's ``w1`` / ``w2`` replicated, so its MLP
  runs whole on every rank and needs no collective;
- the vision towers (:func:`tower_split`): the patch embedding by columns,
  put together (:meth:`Split.gather`) before the replicated bias; each
  block's fused ``wqkv`` by columns, whose ``[q | k | v]`` column blocks
  are not whole heads (at t = 2 rank 0 holds all of q and half of k), so
  the ranks' blocks are exchanged and each keeps its own ``n_heads / t``
  heads of q, k and v (:meth:`Split.exchange`); ``wo`` and ``w2`` by rows,
  each summed before its bias and layer scale; ``w1`` by columns with the
  rank's slice of ``b1``;
- the projector (:func:`column_split` per layer): each kernel by columns
  with the bias slice and GELU on the local columns, then put together;
- the embedding (vocab on ``tensor``): each id is read as JAX's gather
  reads the whole table (a negative id from the end, then clamped), the
  rank whose block holds the row gives it, the others zeros, and the
  rows are summed over ``tensor``;
- the logits (the lm_head's vocab on ``tensor``): each rank computes its
  ``V / t`` columns, put together on every rank (serving), or the loss
  from them without putting them together (:func:`vocab_nll`: the max
  over ranks, the rank-order sum of ``exp``, the target's logit from the
  rank that owns it; the first index of the global max as the pred).

Each weight block is gathered over the data axes only. A replicated bias
is added once to each element: to the rank's own columns, or after a sum.
A replicated leaf whose slice a rank reads (a bias, through
:meth:`Split.cols`) has its gradient summed over ``tensor`` in the
backward, so every rank holds the whole gradient; a split block's
gradient is the rank's own.

Every collective here is an all-reduce of a buffer in which each rank
writes its own slice and zeros elsewhere, reduced as bytes: each element
is one rank's bits plus zeros, so the result is exact and the same on
every rank whatever order the backend adds in (gloo may add in a
different order on each rank, and gloo on CUDA tensors offers little
beyond all-reduce). Sums of partials then add the gathered parts in rank
order, in fp32, on every rank: every rank holds the same bits, and the
engines' host loops, which every rank runs on the same requests, take the
same tokens.

A decoder or tower whose heads (or KV heads: a GQA decoder's 2 at t =
4, whose groups would straddle ranks) do not divide by ``t``, or
whose weights are quantized (``q4`` / ``q8`` leaves are replicated) or
not ``tensor`` blocks, runs whole, gathered as before
(``parallel/gather.py``); so does a projector layer whose kernel is not
split on ``tensor``. With no mesh, or ``tensor`` of size 1, nothing is
split and no collective runs.

``counts`` tallies the forward's collectives over ``tensor``: ``sums``
(sums of partials, columns put together, the embedding's rows, the
loss's max and sums) and ``exchanges`` (the towers' ``wqkv`` blocks), and
the bytes all-gathered over ``tensor`` for a weight at use
(``gathered_bytes``, from ``sharding.all_gather_leaf``). A forward of a
split Emma-X prefill counts ``2 n_layers + 2`` decoder sums, ``2`` sums
and ``1`` exchange a tower block, ``1`` sum a tower and ``1`` a projector
layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from emmax_torch.parallel.gather import gather, gather_axes, gather_tree
from emmax_torch.parallel.sharding import DATA_AXES, axis_sizes, spec_of

ATTENTION = ((("wq", "wk", "wv"), -1), (("wo",), -2))
MLP = ((("w_gate", "w_up"), -1), (("w_down",), -2))
counts: Dict[str, int] = {"sums": 0, "exchanges": 0, "gathered_bytes": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def _tensor(mesh):
    """(size, this rank's index) of the ``tensor`` axis."""
    return (axis_sizes(mesh)["tensor"], mesh.get_local_rank("tensor"))


def _all_reduce_bytes(buf: torch.Tensor, mesh) -> None:
    """In place: ``buf`` summed over ``tensor`` as bytes (exact where each
    element is one rank's bits and zeros elsewhere)."""
    import torch.distributed as dist

    dist.all_reduce(buf.view(torch.uint8), group=mesh.get_group("tensor"))


def stacked(x: torch.Tensor, mesh, count: str = "sums") -> torch.Tensor:
    """``[t, *x.shape]``: every rank's ``x`` in rank order, the same bits on
    every rank (module docstring). A collective over ``tensor``, counted
    in ``counts[count]``: one, or for ``"gathered_bytes"`` (a weight) the
    bytes it gathers."""
    t, r = _tensor(mesh)
    buf = x.new_zeros((t,) + tuple(x.shape))
    buf[r] = x
    _all_reduce_bytes(buf, mesh)
    counts[count] += (buf.numel() * buf.element_size()
                      if count == "gathered_bytes" else 1)
    return buf


def gather_axis(x: torch.Tensor, dim: int, mesh,
                count: str = "sums") -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated in rank
    order: the whole tensor on every rank."""
    return torch.cat(stacked(x, mesh, count).unbind(0), dim=dim)


def rank_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' ``x`` summed over ``tensor`` in rank order, in fp32 (in
    ``x``'s dtype for a wider one), cast back to ``x``'s dtype."""
    parts = stacked(x, mesh).unbind(0)
    acc = parts[0].float() if parts[0].element_size() < 4 else parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc.to(x.dtype)


def _columns(x: torch.Tensor, ranges) -> torch.Tensor:
    """The last-dim ``ranges`` ((start, size), ...) of ``x``, in order."""
    parts = [x.narrow(-1, start, n) for start, n in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _scatter_sum(g: torch.Tensor, width: int, ranges, mesh) -> torch.Tensor:
    """``[..., width]``: every rank's ``g`` written at its own ``ranges``,
    zeros elsewhere, summed over ``tensor``. Each element has one writer,
    so the sum is exact and the same on every rank."""
    buf = g.new_zeros(tuple(g.shape[:-1]) + (width,))
    o = 0
    for start, n in ranges:
        buf[..., start:start + n] = g[..., o:o + n]
        o += n
    _all_reduce_bytes(buf, mesh)
    return buf


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


class _Take(torch.autograd.Function):
    """The ``ranges`` columns of a replicated tensor (a bias); the
    backward gives every rank the whole gradient: each rank's columns'
    gradient, summed over ``tensor``."""

    @staticmethod
    def forward(ctx, x, ranges, mesh):
        ctx.mesh, ctx.ranges, ctx.width = mesh, ranges, x.shape[-1]
        return _columns(x, ranges)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_sum(g.contiguous(), ctx.width, ctx.ranges,
                             ctx.mesh), None, None)


class _HeadExchange(torch.autograd.Function):
    """The ranks' column blocks of a fused projection put together, of
    which this rank keeps the columns ``ranges`` (its heads). In the
    backward a rank's block reads gradient from the ranks whose heads
    its columns feed: every rank writes its heads' gradient into a zero
    buffer of the whole width, the buffers are summed over ``tensor``
    (one non-zero writer an element: exact), and the rank keeps its own
    block. (``_GatherLast``'s backward would assume the gradient is
    replicated and drop the other ranks' parts.)"""

    @staticmethod
    def forward(ctx, x, ranges, mesh):
        ctx.mesh, ctx.ranges, ctx.n = mesh, ranges, x.shape[-1]
        return _columns(gather_axis(x, -1, mesh, "exchanges"), ranges)

    @staticmethod
    def backward(ctx, g):
        t, r = _tensor(ctx.mesh)
        full = _scatter_sum(g.contiguous(), ctx.n * t, ctx.ranges, ctx.mesh)
        return full.narrow(-1, r * ctx.n, ctx.n).contiguous(), None, None


def enter(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Enter.apply(x, mesh)


def reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh)


def _on_tensor(leaf, dim: int) -> bool:
    """Whether ``leaf`` is a dense block whose ``dim`` is split on
    ``tensor``."""
    if not isinstance(leaf, torch.Tensor):
        return False
    spec = spec_of(leaf)
    return spec is not None and spec[dim] == "tensor"


def vocab_split(leaf, dim: int, mesh) -> bool:
    """Whether ``leaf`` (the embedding, ``dim`` 0, or the lm_head, ``dim``
    -1) is a dense block with its vocab on a ``tensor`` axis of > 1."""
    return mesh is not None and _on_tensor(leaf, dim)


def data_gather(x, mesh):
    """A placed block gathered over the data axes only (its ``tensor``
    split kept), differentiable; ``x`` where it is not split on one."""
    return gather_axes(x, mesh, DATA_AXES)


def table_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of an ``n``-row table that JAX's gather ``table[ids]``
    reads: a negative id counts from the end (``i + n``), then an id
    still outside the table is clamped to its nearest row (-1 reads row
    ``n - 1``, ``-n - 1`` row 0, ``n + 2`` row ``n - 1``)."""
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, mesh
                ) -> torch.Tensor:
    """Rows of the embedding from this rank's vocab block ``table``
    ``[V / t, D]`` (gathered over the data axes): each id is read as JAX
    reads it from the whole ``V``-row table (:func:`table_rows`), the
    rank whose block holds that row gives it, the others zeros, and the
    ranks' rows are summed. An id past the table reads the last row, on
    the last rank; a negative one counts from the end of the whole
    vocab."""
    t, r = _tensor(mesh)
    n = table.shape[0]
    local = table_rows(ids, n * t) - r * n
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


def vocab_nll(h: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, mesh):
    """Cross entropy from this rank's vocab columns ``lm_head`` ``[D, V /
    t]`` (gathered over the data axes) without putting the logits
    together: (sum over the ``valid`` positions of -log p(target), the
    greedy preds [B, L] int32). Each rank's fp32 logits ``[B, L, V / t]``;
    the max over ranks; log of the rank-order sum of ``exp(logit - max)``;
    the target's logit from the rank whose block holds it. The pred is
    the first index of the global max: the first of each rank's block,
    the lowest rank's across blocks, as ``jnp.argmax``. In the backward
    each rank's logits get ``softmax - onehot`` on its own columns; no
    lm_head is gathered over ``tensor``."""
    t, r = _tensor(mesh)
    logits = (enter(h, mesh) @ lm_head).float()
    n = logits.shape[-1]
    with torch.no_grad():
        idx = logits.argmax(dim=-1)
        best = stacked(torch.stack([logits.gather(-1, idx[..., None])[..., 0],
                                    (idx + r * n).float()]), mesh)
        winner = best[:, 0].argmax(dim=0, keepdim=True)
        preds = best[:, 1].gather(0, winner)[0].to(torch.int32)
        m = best[:, 0].amax(dim=0)
    local = targets.long() - r * n
    inside = valid & (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    both = reduce(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(inside, picked, torch.zeros_like(picked))]), mesh)
    nll = torch.log(both[0]) - (both[1] - m)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), preds


@dataclasses.dataclass(frozen=True)
class Split:
    """How one forward runs a decoder, a tower or a projector layer: ``t``
    1 runs it whole (each block gathered at use), ``t`` > 1 computes this
    rank's share (module docstring)."""

    mesh: Any = None
    t: int = 1

    def weights(self, p: dict) -> dict:
        """One layer's weights as the layer reads them."""
        if self.t == 1:
            return gather_tree(p, self.mesh)
        return {k: data_gather(v, self.mesh) for k, v in p.items()}

    def weight(self, w):
        """One weight as the split reads it."""
        return gather(w, self.mesh) if self.t == 1 else data_gather(
            w, self.mesh)

    def heads(self, cfg):
        """(query heads, KV heads) this rank computes."""
        kv = getattr(cfg, "n_kv_heads", cfg.n_heads)
        return cfg.n_heads // self.t, kv // self.t

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else enter(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.t == 1 else reduce(x, self.mesh)

    def _block(self, width: int):
        """(start, size) of this rank's block of ``width`` columns."""
        n = width // self.t
        return self.mesh.get_local_rank("tensor") * n, n

    def cols(self, b: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim of a replicated ``b`` (the
        bias of a column-parallel product); its gradient summed over
        ``tensor``."""
        if self.t == 1:
            return b
        return _Take.apply(b, (self._block(b.shape[-1]),), self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' column blocks of ``x`` put together, for a replicated
        consumer."""
        return x if self.t == 1 else _GatherLast.apply(x, self.mesh)

    def exchange(self, x: torch.Tensor, parts: int) -> torch.Tensor:
        """From this rank's column block of a fused ``[p_1 | ... |
        p_parts]`` projection (``wqkv``: q, k, v), this rank's heads of
        each part, ``[..., parts * width / t]``."""
        if self.t == 1:
            return x
        width = x.shape[-1] * self.t // parts
        start, n = self._block(width)
        ranges = tuple((j * width + start, n) for j in range(parts))
        return _HeadExchange.apply(x, ranges, self.mesh)


WHOLE = Split()


def _split(mesh, divides: bool, leaves) -> Split:
    """``Split(mesh, t)`` where the ``tensor`` axis's ``t`` > 1, the heads
    divide (``divides``) and every (leaf, dim) of ``leaves`` is a dense
    block split on ``tensor`` there; else whole."""
    if mesh is None:
        return WHOLE
    t = axis_sizes(mesh).get("tensor", 1)
    if t == 1 or not divides(t):
        return Split(mesh)
    if not all(_on_tensor(leaf, dim) for leaf, dim in leaves):
        return Split(mesh)
    return Split(mesh, t)


def decoder_split(llm_params: dict, cfg, mesh) -> Split:
    """The split of a decoder under ``mesh``: ``t`` is the ``tensor``
    axis's size where the heads and KV heads divide by it and every
    attention weight is a dense block split on ``tensor`` (columns for
    ``wq`` / ``wk`` / ``wv``, rows for ``wo``), and for the Llama family
    its three MLP weights too, else 1. Phi-2 (``w1`` / ``w2``, replicated
    by the rules) splits its attention alone.

    Grouped-query attention (``G = n_heads / n_kv_heads``): rank ``r``
    computes query heads ``[r H / t, (r + 1) H / t)`` and holds KV heads
    ``[r KV / t, (r + 1) KV / t)``, its local ``[0, KV / t)``, which its
    query heads read at the unsplit ``G`` (query head ``h`` reads KV head
    ``h // G`` in both numberings). Where ``t`` does not divide
    ``n_kv_heads`` (2 KV heads at t = 4) a rank's query heads would need
    another rank's KV head, so the decoder runs whole, gathered, where
    GSPMD splits it anyway: a difference by design, as for heads that do
    not divide."""
    layers = llm_params["layers"]
    groups = ATTENTION if "w1" in layers else ATTENTION + MLP
    return _split(mesh, lambda t: not (cfg.n_heads % t or cfg.n_kv_heads % t),
                  [(layers.get(k), dim) for keys, dim in groups
                   for k in keys])


def tower_split(params: dict, cfg, mesh) -> Split:
    """The split of a vision tower under ``mesh``: ``t`` is the
    ``tensor`` axis's size where the heads divide by it and the patch
    embedding, ``wqkv`` and ``w1`` are dense blocks split on ``tensor`` by
    columns and ``wo`` and ``w2`` by rows (a hidden width that ``t`` does
    not divide is replicated by the rules), else 1."""
    blocks = params["blocks"]
    return _split(mesh, lambda t: cfg.n_heads % t == 0, [
        (params["patch_embed"]["kernel"], -1), (blocks["wqkv"], -1),
        (blocks["w1"], -1), (blocks["wo"], -2), (blocks["w2"], -2)])


def column_split(kernel, mesh) -> Split:
    """The split of one column-parallel product (a projector layer): ``t``
    where ``kernel`` is a dense block split on ``tensor`` by columns,
    else 1."""
    return _split(mesh, lambda t: True, [(kernel, -1)])
