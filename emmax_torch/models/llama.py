"""Llama-family decoder (Llama-2), port of ``emmax_tpu/models/llama.py``.

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
rank's blocks (``parallel.shard_params``). Each layer gathers its full
weights where it starts (inside the remat region, so a rematerialized
backward gathers again), the embedding and lm_head where they are read,
and the losses divide global sums by global counts
(``parallel/gather.py``).
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
from emmax_torch.parallel.gather import (gather, gather_tree, global_mean,
                                         layer_blocks)

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


# Llama-2-7B with the Emma-X padded vocab.
LLAMA2_7B = LlamaConfig()


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
                  device="cpu", quantized: bool = False) -> Params:
    """Cache layout: k/v ``[n_layers, B, S, KV, hd]``, the ``[B, S]`` slot
    mask, and ``len``, the host-side write cursor shared by every row
    (serving packs prompts left-padded; the slot-pool engine replaces it
    with a [B] tensor of per-row cursors).

    ``quantized=True`` stores K/V as int8 with fp32 per-(position, head)
    scales ``k_scale``/``v_scale`` [..., 1]; ``dtype`` then names only the
    dtype the cache is read back in."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
    stacked with the index attached, for the kernel to read in place."""
    out = {}
    for key, val in layers.items():
        if isinstance(val, dict) and "q4" in val:
            out[key] = {**val, "layer": i}
        elif isinstance(val, dict):
            out[key] = {k: v[i] for k, v in val.items()}
        else:
            out[key] = val[i]
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


def _mlp(h: torch.Tensor, p: Params, cfg: LlamaConfig) -> torch.Tensor:
    x = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    return h + mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]),
                  p["w_down"])


def _layer(h, p, cos, sin, kv_mask, cfg: LlamaConfig, attn_impl: str,
           mesh=None):
    """One decoder layer (uncached path, causal)."""
    p = gather_tree(p, mesh)
    B, L, _ = h.shape
    x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    q = mm(x, p["wq"]).reshape(B, L, cfg.n_heads, cfg.head_dim)
    k = mm(x, p["wk"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    v = mm(x, p["wv"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    h = h + mm(attn.reshape(B, L, cfg.n_heads * cfg.head_dim), p["wo"])
    return _mlp(h, p, cfg)


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


def _cached_layer(h, p, cos, sin, cache, i: int, t0, slot_mask,
                  cfg: LlamaConfig, attn_impl: str, chunk_mask=None,
                  mesh=None):
    """One decoder layer that writes its K/V into the cache at ``t0`` (host
    int or per-row [B] cursors) and attends over the layer's whole cache
    (the chunk's own slots under ``chunk_mask`` where one is given)."""
    p = gather_tree(p, mesh)
    B, L, _ = h.shape
    x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    k_new = mm(x, p["wk"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    v_new = mm(x, p["wv"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    k_new = apply_rope(k_new, cos, sin)
    if "k_scale" in cache:
        for key, new in (("k", k_new), ("v", v_new)):
            qv, sc = _quantize_kv(new)
            _cache_write(cache, key, i, qv, t0)
            _cache_write(cache, f"{key}_scale", i, sc, t0)
    else:
        _cache_write(cache, "k", i, k_new, t0)
        _cache_write(cache, "v", i, v_new, t0)
    k_c = _cache_read(cache, "k", i, h.dtype)        # [B, S, KV, hd]
    v_c = _cache_read(cache, "v", i, h.dtype)
    q = mm(x, p["wq"]).reshape(B, L, cfg.n_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    # query i (at slot t0 + i) attends to valid slots j <= t0 + i, or
    # under a tree chunk mask to its ancestors' chunk slots
    attn = multi_head_attention(q, k_c, v_c, kv_mask=slot_mask, causal=True,
                                q_offset=t0, impl=attn_impl,
                                chunk_mask=chunk_mask)
    h = h + mm(attn.reshape(B, L, cfg.n_heads * cfg.head_dim), p["wo"])
    return _mlp(h, p, cfg)


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
    B, L, _ = inputs_embeds.shape
    if positions is None:
        if mask is not None:
            positions = torch.clamp(
                torch.cumsum(mask.to(torch.int32), dim=-1) - 1, min=0)
        else:
            positions = torch.arange(L, dtype=torch.int32,
                                     device=inputs_embeds.device).expand(B, L)
        if kv_cache is not None:
            t0 = kv_cache["len"]
            positions = positions + (t0[:, None] if per_row(t0) else t0)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]

    h = inputs_embeds
    per_layer = layer_list(layers, cfg.n_layers, mesh)
    if kv_cache is None:
        h = constrain_batch_sharded(h)
        for p in per_layer:
            h = remat_call(remat, _layer, h, p, cos, sin, mask, cfg,
                           attn_impl, mesh)
    else:
        t0 = kv_cache["len"]
        S = kv_cache["k"].shape[2]
        if per_row(t0):
            rows, slots = _row_slots(t0, L, S)
            kv_cache["mask"][rows, slots] = (
                True if mask is None else mask.to(torch.bool))
        else:
            if t0 + L > S:
                raise ValueError(f"KV cache overflow: {t0} + {L} > {S} "
                                 "slots")
            kv_cache["mask"][:, t0:t0 + L] = (
                True if mask is None else mask.to(torch.bool))
        for i, p in enumerate(per_layer):
            h = _cached_layer(h, p, cos, sin, kv_cache, i, t0,
                              kv_cache["mask"], cfg, attn_impl,
                              chunk_attn_mask, mesh)
        kv_cache["len"] = t0 + L

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, kv_cache
    logits = mm(h, gather(params["lm_head"], mesh)).to(logits_dtype)
    return logits, kv_cache


def embed_tokens(params: Params, input_ids: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of the embedding table. An id past the table (the byte-level
    tokenizer's pad id is its ``vocab_size``) reads the last row, as the
    JAX package's clamped gather does; such slots are masked."""
    table = gather(params["embed"], mesh)
    return table[input_ids.clamp(max=table.shape[0] - 1)]


def chunked_ce_loss_and_preds(h: torch.Tensor, lm_head, labels: torch.Tensor,
                              *, chunk: int = 128, mesh=None):
    """Sequence-chunked shifted CE and greedy preds from the final hidden
    states: the same fp32 log-softmax per position and masked mean as
    ``mm(h, lm_head)`` + :func:`cross_entropy_loss`, but each ``chunk`` of
    positions is checkpointed, so the full fp32 [B, L, vocab] logits and
    their gradient never exist at once (the backward re-runs one chunk's
    lm_head matmul at a time). Returns (loss, preds [B, L]); under a
    ``mesh`` the loss is the global batch's (``global_mean``)."""
    lm_head = gather(lm_head, mesh)
    B, L, _ = h.shape
    shifted = torch.cat([labels[:, 1:], torch.full(
        (B, 1), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)],
        dim=1)
    pad = (-L) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        shifted = F.pad(shifted, (0, pad), value=IGNORE_INDEX)

    def one_block(hb, lb):
        logits = mm(hb, lm_head).float()
        return (*_nll_sum(logits, lb),
                logits.argmax(dim=-1).to(torch.int32))

    loss_sum = h.new_zeros((), dtype=torch.float32)
    count = 0
    preds = []
    for c in range(0, L + pad, chunk):
        ls, cnt, pr = remat_call("full", one_block, h[:, c:c + chunk],
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
