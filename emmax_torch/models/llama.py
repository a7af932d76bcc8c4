"""Llama-family decoder (Llama-2, Mistral), port of
``emmax_tpu/models/llama.py``.

Parameters keep the JAX layout: ``[in, out]`` weights with every decoder
layer stacked on a leading axis. ``w[i]`` of a contiguous stacked tensor
is a view, so the layer loop reads each layer in place; an int4 weight
stays stacked with the layer index attached (``{"q4", "scale", "layer"}``)
and the kernel reads ``q4[layer]`` directly.

Numerics follow transformers' Llama: RMSNorm in fp32, rotate-half RoPE with
fp32 cos/sin, SwiGLU MLP, fp32 attention softmax.

The KV cache is preallocated (``init_kv_cache``) and updated in place: a
cached call writes its K/V at slots ``[len, len + L)`` of each layer,
reads the layer's whole cache back as a view, and advances ``len``.
``len`` is a host int shared by every row (the single-request engine packs
prompts left-padded) or a [B] tensor of per-row cursors (the slot-pool
engine, ``serving/continuous.py``): each row then writes at its own slot,
takes RoPE at its own position and masks causally at its own cursor. An
int8 cache (``quantized=True``) stores absmax/127 rows with fp32 scales
and is read back dequantized in the compute dtype, as in JAX.

The uncached path is the training path: each layer may be rematerialized
(``remat``), and the loss heads (``cross_entropy_loss``, the
memory-lean ``chunked_ce_loss_and_preds``) are here as in JAX.

``mesh`` (a ``DeviceMesh``; None on one device): the params are this
rank's blocks (``parallel.shard_params``). Under a ``tensor`` axis of t >
1 ranks that the heads and KV heads divide, with dense weights, each
layer computes its own heads and MLP columns and sums its two partial
outputs over ``tensor`` (``parallel/tensor.py``; each rank's KV cache
holds its ``n_kv_heads / t`` heads, ``init_kv_cache(split=t)``, which its
``n_heads / t`` query heads read in groups of ``n_heads / n_kv_heads``,
as the whole decoder's do: attention repeats the rank's KV heads by that
group), and the
embedding, the logits and the chunked loss are vocab-parallel; else each
layer gathers its full weights where it starts. The gathers run inside the remat region,
so a rematerialized backward gathers again. The losses divide global
sums by global counts (``parallel/gather.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from emmax_torch.models.tree import ParamTree
from emmax_torch.ops.attention import multi_head_attention, per_row
from emmax_torch.ops.norms import rms_norm
from emmax_torch.ops.rope import apply_rope, rope_cos_sin
from emmax_torch.parallel.constraints import constrain_batch_sharded
from emmax_torch.parallel.gather import gather, global_mean, layer_blocks
from emmax_torch.parallel.sharding import sliced
from emmax_torch.parallel.tensor import (WHOLE, Split, data_gather,
                                         decoder_split, table_rows,
                                         vocab_embed, vocab_logits,
                                         vocab_nll, vocab_split)

Params = Dict[str, Any]
IGNORE_INDEX = -100
Remat = Union[bool, str]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32064          # llama-2 32000 + <PAD>, padded to 64
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# Llama-2-7B with the Emma-X padded vocab; Llama-2-13B; Mistral-7B v0.1
# (grouped-query attention: 32 query heads on 8 KV heads).
LLAMA2_7B = LlamaConfig()
LLAMA2_13B = LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                         hidden_dim=13824)
MISTRAL_7B = LlamaConfig(vocab_size=32064, dim=4096, n_layers=32, n_heads=32,
                         n_kv_heads=8, hidden_dim=14336, max_seq_len=2048)


def init_llama_params(generator: torch.Generator, cfg: LlamaConfig,
                      dtype: torch.dtype = torch.float32,
                      device="cpu") -> Params:
    """Random init with the JAX package's distributions (normal 0.02,
    unit norms). Sampled straight into ``dtype`` on ``device``, so a bf16
    7B tree never holds an fp32 copy of a stacked leaf."""
    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    L, D, H, KV, hd, Fh = (cfg.n_layers, cfg.dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim)
    return {
        "embed": normal(cfg.vocab_size, D),
        "layers": {
            "attn_norm": ones(L, D),
            "wq": normal(L, D, H * hd),
            "wk": normal(L, D, KV * hd),
            "wv": normal(L, D, KV * hd),
            "wo": normal(L, H * hd, D),
            "mlp_norm": ones(L, D),
            "w_gate": normal(L, D, Fh),
            "w_up": normal(L, D, Fh),
            "w_down": normal(L, Fh, D),
        },
        "final_norm": ones(D),
        "lm_head": normal(D, cfg.vocab_size),
    }


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device="cpu", quantized: bool = False,
                  split: int = 1) -> Params:
    """Cache layout: k/v ``[n_layers, B, S, KV, hd]``, the ``[B, S]`` slot
    mask, and ``len``, the host-side write cursor shared by every row
    (serving packs prompts left-padded; the slot-pool engine replaces it
    with a [B] tensor of per-row cursors).

    ``quantized=True`` stores K/V as int8 with fp32 per-(position, head)
    scales ``k_scale``/``v_scale`` [..., 1]; ``dtype`` then names only the
    dtype the cache is read back in. ``split``: the decoder's tensor split
    (``decoder_split(...).t``); this rank's cache holds KV / split heads."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads // split,
             cfg.head_dim)
    cache = {"mask": torch.zeros((batch, max_len), dtype=torch.bool,
                                 device=device),
             "len": 0}
    if quantized:
        sshape = shape[:-1] + (1,)
        cache.update(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=device))
    else:
        cache.update(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def _quantize_kv(x: torch.Tensor):
    """[B, L, KV, hd] -> (int8 values, fp32 scales [B, L, KV, 1]): absmax
    / 127, round half to even, clip to +-127 (the dense cache's
    convention; the page pool's is ``serving/paged._row_quantize``)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that understands quantized weights: a dense tensor,
    ``{"q8": int8 [..., in, out], "scale": f32 [..., 1, out]}`` or
    ``{"q4": int8 [..., in/2, out], "scale": bf16 [..., G, out]}`` (+
    ``"layer"`` for a stacked int4 weight), the latter through the int4
    kernel."""
    if isinstance(w, dict):
        if "q4" in w:
            from emmax_torch.ops.int4_matmul import int4_matmul

            return int4_matmul(x, w)
        return (x @ w["q8"].to(x.dtype)) * w["scale"].to(x.dtype)
    return x @ w


def layer_slice(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked layer params, as views. Int4 weights stay
    stacked with the index attached, for the kernel to read in place.
    Each dense block keeps the stacked leaf's spec, for
    ``Split.weights`` to gather where the layer runs; quantized
    leaves are replicated and read as they are."""
    out = {}
    for key, val in layers.items():
        if isinstance(val, dict) and "q4" in val:
            out[key] = {**val, "layer": i}
        elif isinstance(val, dict):
            out[key] = {k: v[i] for k, v in val.items()}
        else:
            out[key] = sliced(val, i)
    return out


def layer_list(layers: Params, n_layers: int, mesh=None) -> List[Params]:
    """Every layer's params. Dense stacked leaves are unbound once
    (``torch.unbind``), so under autograd the backward stacks the layers'
    gradients once; indexing ``w[i]`` per layer would instead add a zero
    tensor the size of the whole stack for every layer. Under a mesh each
    layer's blocks keep their spec, for the gather where the layer runs."""
    dense = layer_blocks({k: v for k, v in layers.items()
                          if isinstance(v, torch.Tensor)}, n_layers, mesh)
    rest = {k: v for k, v in layers.items() if not isinstance(v, torch.Tensor)}
    out = []
    for i in range(n_layers):
        p = layer_slice(rest, i)
        p.update(dense[i])
        out.append(p)
    return out


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the matmul
    outputs, recompute the rest (JAX's ``dots_saveable``)."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: Remat, fn, *args):
    """``fn(*args)`` under the remat policy: False/"none" stores every
    activation; True/"full" keeps only the inputs and re-runs ``fn`` in
    the backward (non-reentrant ``torch.utils.checkpoint``); "dots" keeps
    the matmul outputs and recomputes the elementwise ops."""
    if not remat or remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat is True or remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_matmuls))
    raise ValueError(f"unknown remat policy {remat!r}")


def attn_mlp_tail(h: torch.Tensor, attn_flat: torch.Tensor, p: Params,
                  eps: float, split: Split = WHOLE) -> torch.Tensor:
    """The output projection's residual, then the gated MLP's: the part
    of a layer after attention (``attn_flat`` [B, L, heads * hd]); under
    a ``split`` each product is this rank's block, summed over
    ``tensor``."""
    h = h + split.reduce(mm(attn_flat, p["wo"]))
    x = split.enter(rms_norm(h, p["mlp_norm"], eps))
    return h + split.reduce(mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]),
                               p["w_down"]))


def _layer(h, p, cos, sin, kv_mask, cfg: LlamaConfig, attn_impl: str,
           split: Split = WHOLE):
    """One decoder layer (uncached path, causal)."""
    p = split.weights(p)
    B, L, _ = h.shape
    H, KV = split.heads(cfg)
    x = split.enter(rms_norm(h, p["attn_norm"], cfg.norm_eps))
    q = mm(x, p["wq"]).reshape(B, L, H, cfg.head_dim)
    k = mm(x, p["wk"]).reshape(B, L, KV, cfg.head_dim)
    v = mm(x, p["wv"]).reshape(B, L, KV, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    return attn_mlp_tail(h, attn.reshape(B, L, H * cfg.head_dim), p,
                         cfg.norm_eps, split)


def _row_slots(t0: torch.Tensor, L: int, S: int):
    """(row index [B, 1], slots [B, L]) of L new tokens per row at the
    per-row cursors ``t0``; the start is clamped so the L slots fit, as
    the JAX package's ``dynamic_update_slice`` clamps it."""
    start = torch.clamp(t0.long(), 0, S - L)
    rows = torch.arange(t0.shape[0], device=t0.device)[:, None]
    return rows, start[:, None] + torch.arange(L, device=t0.device)[None]


def _cache_write(cache: Params, key: str, i: int, new: torch.Tensor,
                 t0) -> None:
    """Write ``new`` [B, L, ...] into layer ``i`` of ``cache[key]`` at slot
    ``t0`` (host int) or at each row's cursor (a [B] tensor), in place."""
    buf = cache[key][i]                               # [B, S, ...] view
    L = new.shape[1]
    if per_row(t0):
        rows, slots = _row_slots(t0, L, buf.shape[1])
        buf[rows, slots] = new.to(buf.dtype)
    else:
        buf[:, t0:t0 + L] = new


def _cache_read(cache: Params, key: str, i: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Layer ``i`` of ``cache[key]``: a view, or int8 rows dequantized to
    ``dtype`` (values and scales each cast first, as JAX's ``_read``)."""
    vals = cache[key][i]
    if f"{key}_scale" not in cache:
        return vals
    return vals.to(dtype) * cache[f"{key}_scale"][i].to(dtype)


def cache_update(cache: Params, i: int, t0, k_new: torch.Tensor,
                 v_new: torch.Tensor, dtype: torch.dtype):
    """Write layer ``i``'s new K/V [B, L, KV, hd] at ``t0`` (int8 rows and
    their scales in a quantized cache) and return the layer's whole cache
    (k, v) [B, S, KV, hd] in ``dtype``."""
    if "k_scale" in cache:
        for key, new in (("k", k_new), ("v", v_new)):
            qv, sc = _quantize_kv(new)
            _cache_write(cache, key, i, qv, t0)
            _cache_write(cache, f"{key}_scale", i, sc, t0)
    else:
        _cache_write(cache, "k", i, k_new, t0)
        _cache_write(cache, "v", i, v_new, t0)
    return (_cache_read(cache, "k", i, dtype),
            _cache_read(cache, "v", i, dtype))


def _cached_layer(h, p, cos, sin, cache, i: int, t0, slot_mask,
                  cfg: LlamaConfig, attn_impl: str, chunk_mask=None,
                  split: Split = WHOLE):
    """One decoder layer that writes its K/V into the cache at ``t0`` (host
    int or per-row [B] cursors) and attends over the layer's whole cache
    (the chunk's own slots under ``chunk_mask`` where one is given)."""
    p = split.weights(p)
    B, L, _ = h.shape
    H, KV = split.heads(cfg)
    x = split.enter(rms_norm(h, p["attn_norm"], cfg.norm_eps))
    k_new = mm(x, p["wk"]).reshape(B, L, KV, cfg.head_dim)
    v_new = mm(x, p["wv"]).reshape(B, L, KV, cfg.head_dim)
    k_new = apply_rope(k_new, cos, sin)
    k_c, v_c = cache_update(cache, i, t0, k_new, v_new, h.dtype)
    q = mm(x, p["wq"]).reshape(B, L, H, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    # query i (at slot t0 + i) attends to valid slots j <= t0 + i, or
    # under a tree chunk mask to its ancestors' chunk slots
    attn = multi_head_attention(q, k_c, v_c, kv_mask=slot_mask, causal=True,
                                q_offset=t0, impl=attn_impl,
                                chunk_mask=chunk_mask)
    return attn_mlp_tail(h, attn.reshape(B, L, H * cfg.head_dim), p,
                         cfg.norm_eps, split)


def default_positions(inputs_embeds: torch.Tensor,
                      mask: Optional[torch.Tensor],
                      positions: Optional[torch.Tensor],
                      kv_cache: Optional[Params]) -> torch.Tensor:
    """``positions`` as given, else the RoPE positions of the L tokens:
    the running count of valid tokens under ``mask`` (0 .. L-1 without
    one), offset by the cache's cursor (per row for [B] cursors)."""
    if positions is not None:
        return positions
    B, L, _ = inputs_embeds.shape
    if mask is not None:
        positions = torch.clamp(
            torch.cumsum(mask.to(torch.int32), dim=-1) - 1, min=0)
    else:
        positions = torch.arange(L, dtype=torch.int32,
                                 device=inputs_embeds.device).expand(B, L)
    if kv_cache is not None:
        t0 = kv_cache["len"]
        positions = positions + (t0[:, None] if per_row(t0) else t0)
    return positions


def mark_slots(kv_cache: Params, mask: Optional[torch.Tensor],
               L: int) -> None:
    """Mark the cache slots of L new tokens at the cursor valid (or as
    ``mask`` says), per row for [B] cursors; a shared cursor that would
    run past the cache raises."""
    t0 = kv_cache["len"]
    S = kv_cache["k"].shape[2]
    valid = True if mask is None else mask.to(torch.bool)
    if per_row(t0):
        rows, slots = _row_slots(t0, L, S)
        kv_cache["mask"][rows, slots] = valid
    else:
        if t0 + L > S:
            raise ValueError(f"KV cache overflow: {t0} + {L} > {S} slots")
        kv_cache["mask"][:, t0:t0 + L] = valid


def llama_forward(params: Params, cfg: LlamaConfig,
                  inputs_embeds: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  kv_cache: Optional[Params] = None,
                  attn_impl: str = "auto",
                  remat: Remat = False,
                  logits_dtype: torch.dtype = torch.float32,
                  return_hidden: bool = False,
                  chunk_attn_mask: Optional[torch.Tensor] = None,
                  mesh=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits [B, L, V], the kv_cache or None).

    Without a cache: causal self-attention over the L tokens (+ the [B, L]
    padding mask), each layer under ``remat`` (:func:`remat_call`). With a
    cache: the L tokens are written at slots ``[len, len + L)`` in place
    (per row when ``len`` is a [B] tensor) and attend to every valid slot
    up to their own; the cache's mask and ``len`` are updated and the same
    dict is returned.

    ``return_hidden``: the final-normed hidden states [B, L, D] instead of
    logits, for ``chunked_ce_loss_and_preds``. The JAX package's
    ``scan_weight_barrier`` is an XLA scheduling fence inside its layer
    scan; eager PyTorch has no such rewrite to fence, so nothing here
    stands for it.

    ``chunk_attn_mask`` ([L, L] bool, cache path only): the ancestor
    matrix of a speculative verification tree. The L tokens attend every
    past slot and chunk slot j iff ``chunk_attn_mask[i, j]`` instead of
    causally (``ops/attention._dense_mask``); the caller gives the tree's
    ``positions`` (depths, not slot order).

    ``mesh``: see the module docstring.
    """
    if chunk_attn_mask is not None and kv_cache is None:
        raise ValueError("chunk_attn_mask requires a kv_cache (tree chunks "
                         "verify against an existing context)")
    positions = default_positions(inputs_embeds, mask, positions, kv_cache)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]

    h = inputs_embeds
    split = decoder_split(params, cfg, mesh)
    per_layer = layer_list(layers, cfg.n_layers, mesh)
    if kv_cache is None:
        h = constrain_batch_sharded(h)
        for p in per_layer:
            h = remat_call(remat, _layer, h, p, cos, sin, mask, cfg,
                           attn_impl, split)
    else:
        t0 = kv_cache["len"]
        mark_slots(kv_cache, mask, inputs_embeds.shape[1])
        for i, p in enumerate(per_layer):
            h = _cached_layer(h, p, cos, sin, kv_cache, i, t0,
                              kv_cache["mask"], cfg, attn_impl,
                              chunk_attn_mask, split)
        kv_cache["len"] = t0 + inputs_embeds.shape[1]

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, kv_cache
    return lm_logits(h, params["lm_head"], mesh).to(logits_dtype), kv_cache


def lm_logits(h: torch.Tensor, lm_head, mesh=None) -> torch.Tensor:
    """``h``'s logits over the whole vocab: vocab-parallel where the
    lm_head is a dense ``tensor`` block (``parallel/tensor.py``), else
    from the gathered (dense or quantized) lm_head."""
    if vocab_split(lm_head, -1, mesh):
        return vocab_logits(h, data_gather(lm_head, mesh), mesh)
    return mm(h, gather(lm_head, mesh))


def embed_tokens(params: Params, input_ids: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of the embedding table, read as the JAX package's gather
    reads them (``parallel.tensor.table_rows``): an id past the table (the
    byte-level tokenizer's pad id is its ``vocab_size``) reads the last
    row, and such slots are masked; a negative id counts from the end
    (-1 the last row), and one below ``-vocab_size`` reads row 0. A
    table whose vocab is split on ``tensor`` is read vocab-parallel, the
    same rows."""
    table = params["embed"]
    if vocab_split(table, 0, mesh):
        return vocab_embed(data_gather(table, mesh), input_ids, mesh)
    table = gather(table, mesh)
    return table[table_rows(input_ids, table.shape[0])]


def chunked_ce_loss_and_preds(h: torch.Tensor, lm_head, labels: torch.Tensor,
                              *, chunk: int = 128, mesh=None):
    """Sequence-chunked shifted CE and greedy preds from the final hidden
    states: the same fp32 log-softmax per position and masked mean as
    ``mm(h, lm_head)`` + :func:`cross_entropy_loss`, but each ``chunk`` of
    positions is checkpointed, so the full fp32 [B, L, vocab] logits and
    their gradient never exist at once (the backward re-runs one chunk's
    lm_head matmul at a time). ``lm_head`` is a matrix (dense or
    quantized) or Phi's biased ``{"kernel", "bias"}``. Returns (loss,
    preds [B, L]); under a ``mesh`` the loss is the global batch's
    (``global_mean``). A dense lm_head whose vocab is split on ``tensor``
    gives each chunk's loss and preds from the rank's vocab block
    (``parallel.tensor.vocab_nll``)."""
    if isinstance(lm_head, dict) and "kernel" in lm_head:
        kernel, bias = gather(lm_head["kernel"], mesh), lm_head["bias"]

        def head(hb):
            return mm(hb, kernel) + bias
    elif vocab_split(lm_head, -1, mesh):
        block = data_gather(lm_head, mesh)
        head = None
    else:
        lm_head = gather(lm_head, mesh)

        def head(hb):
            return mm(hb, lm_head)
    B, L, _ = h.shape
    shifted = torch.cat([labels[:, 1:], torch.full(
        (B, 1), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)],
        dim=1)
    pad = (-L) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        shifted = F.pad(shifted, (0, pad), value=IGNORE_INDEX)

    def one_block(hb, lb):
        if head is None:
            valid = lb != IGNORE_INDEX
            return (*vocab_nll(hb, block, lb, valid, mesh), valid.sum())
        logits = head(hb).float()
        nll, count = _nll_sum(logits, lb)
        return nll, logits.argmax(dim=-1).to(torch.int32), count

    loss_sum = h.new_zeros((), dtype=torch.float32)
    count = 0
    preds = []
    for c in range(0, L + pad, chunk):
        ls, pr, cnt = remat_call("full", one_block, h[:, c:c + chunk],
                                 shifted[:, c:c + chunk])
        loss_sum = loss_sum + ls
        count = count + cnt
        preds.append(pr)
    preds = torch.cat(preds, dim=1)[:, :L]
    return global_mean(loss_sum, count, mesh), preds


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of -log p(target) over the positions whose target is not
    IGNORE_INDEX, their count), from fp32 logits."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (-torch.where(valid, ll, 0.0)).sum(), valid.sum()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """Shifted next-token CE with IGNORE_INDEX masking, in fp32 (the JAX
    package's, and torch ``CrossEntropyLoss(ignore_index=-100)``). Under a
    ``mesh`` the sum and the count are each summed over the data ranks
    before the division (rows hold unequal numbers of labels, so a mean
    of the ranks' means would be wrong)."""
    total, count = _nll_sum(logits[:, :-1].float(), labels[:, 1:])
    return global_mean(total, count, mesh)


class Llama(nn.Module):
    """The decoder holding its (dense, int8 or int4) weights; ``forward``
    is :func:`llama_forward`."""

    def __init__(self, cfg: LlamaConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, inputs_embeds: torch.Tensor, **kw):
        return llama_forward(self.params.tree(), self.cfg, inputs_embeds,
                             **kw)
