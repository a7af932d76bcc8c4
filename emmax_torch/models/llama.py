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

The uncached path is the training path: each layer may be rematerialized
(``remat``), and the loss heads (``cross_entropy_loss``, the
memory-lean ``chunked_ce_loss_and_preds``) are here as in JAX.
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
from emmax_torch.ops.attention import multi_head_attention
from emmax_torch.ops.norms import rms_norm
from emmax_torch.ops.rope import apply_rope, rope_cos_sin

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
                  device="cpu") -> Params:
    """Cache layout: k/v ``[n_layers, B, S, KV, hd]``, the ``[B, S]`` slot
    mask, and ``len``, the host-side write cursor shared by every row
    (serving packs prompts left-padded)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "mask": torch.zeros((batch, max_len), dtype=torch.bool,
                                device=device),
            "len": 0}


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


def layer_list(layers: Params, n_layers: int) -> List[Params]:
    """Every layer's params. Dense stacked leaves are unbound once
    (``torch.unbind``), so under autograd the backward stacks the layers'
    gradients once; indexing ``w[i]`` per layer would instead add a zero
    tensor the size of the whole stack for every layer."""
    dense = {k: torch.unbind(v) for k, v in layers.items()
             if isinstance(v, torch.Tensor)}
    rest = {k: v for k, v in layers.items() if k not in dense}
    out = []
    for i in range(n_layers):
        p = layer_slice(rest, i)
        p.update({k: v[i] for k, v in dense.items()})
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


def _layer(h, p, cos, sin, kv_mask, cfg: LlamaConfig, attn_impl: str):
    """One decoder layer (uncached path, causal)."""
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


def _cached_layer(h, p, cos, sin, cache, i: int, t0: int, slot_mask,
                  cfg: LlamaConfig, attn_impl: str):
    """One decoder layer that writes its K/V into the cache at ``t0`` and
    attends over the layer's whole cache."""
    B, L, _ = h.shape
    x = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    k_new = mm(x, p["wk"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    v_new = mm(x, p["wv"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
    k_new = apply_rope(k_new, cos, sin)
    k_c, v_c = cache["k"][i], cache["v"][i]          # [B, S, KV, hd] views
    k_c[:, t0:t0 + L] = k_new
    v_c[:, t0:t0 + L] = v_new
    q = mm(x, p["wq"]).reshape(B, L, cfg.n_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    # query i (at slot t0 + i) attends to valid slots j <= t0 + i
    attn = multi_head_attention(q, k_c, v_c, kv_mask=slot_mask, causal=True,
                                q_offset=t0, impl=attn_impl)
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
                  return_hidden: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits [B, L, V], the kv_cache or None).

    Without a cache: causal self-attention over the L tokens (+ the [B, L]
    padding mask), each layer under ``remat`` (:func:`remat_call`). With a
    cache: the L tokens are written at slots ``[len, len + L)`` in place
    and attend to every valid slot up to their own; the cache's mask and
    ``len`` are updated and the same dict is returned.

    ``return_hidden``: the final-normed hidden states [B, L, D] instead of
    logits, for ``chunked_ce_loss_and_preds``. The JAX package's
    ``scan_weight_barrier`` is an XLA scheduling fence inside its layer
    scan; eager PyTorch has no such rewrite to fence, so nothing here
    stands for it.
    """
    B, L, _ = inputs_embeds.shape
    if positions is None:
        if mask is not None:
            positions = torch.clamp(
                torch.cumsum(mask.to(torch.int32), dim=-1) - 1, min=0)
        else:
            positions = torch.arange(L, dtype=torch.int32,
                                     device=inputs_embeds.device).expand(B, L)
        if kv_cache is not None:
            positions = positions + kv_cache["len"]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]

    h = inputs_embeds
    if kv_cache is None:
        for p in layer_list(layers, cfg.n_layers):
            h = remat_call(remat, _layer, h, p, cos, sin, mask, cfg,
                           attn_impl)
    else:
        t0 = kv_cache["len"]
        if t0 + L > kv_cache["k"].shape[2]:
            raise ValueError(f"KV cache overflow: {t0} + {L} > "
                             f"{kv_cache['k'].shape[2]} slots")
        kv_cache["mask"][:, t0:t0 + L] = (
            True if mask is None else mask.to(torch.bool))
        for i in range(cfg.n_layers):
            h = _cached_layer(h, layer_slice(layers, i), cos, sin, kv_cache,
                              i, t0, kv_cache["mask"], cfg, attn_impl)
        kv_cache["len"] = t0 + L

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, kv_cache
    logits = mm(h, params["lm_head"]).to(logits_dtype)
    return logits, kv_cache


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table. An id past the table (the byte-level
    tokenizer's pad id is its ``vocab_size``) reads the last row, as the
    JAX package's clamped gather does; such slots are masked."""
    table = params["embed"]
    return table[input_ids.clamp(max=table.shape[0] - 1)]


def chunked_ce_loss_and_preds(h: torch.Tensor, lm_head, labels: torch.Tensor,
                              *, chunk: int = 128):
    """Sequence-chunked shifted CE and greedy preds from the final hidden
    states: the same fp32 log-softmax per position and masked mean as
    ``mm(h, lm_head)`` + :func:`cross_entropy_loss`, but each ``chunk`` of
    positions is checkpointed, so the full fp32 [B, L, vocab] logits and
    their gradient never exist at once (the backward re-runs one chunk's
    lm_head matmul at a time). Returns (loss, preds [B, L])."""
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
    return loss_sum / torch.clamp(count, min=1), preds


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of -log p(target) over the positions whose target is not
    IGNORE_INDEX, their count), from fp32 logits."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (-torch.where(valid, ll, 0.0)).sum(), valid.sum()


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE with IGNORE_INDEX masking, in fp32 (the JAX
    package's, and torch ``CrossEntropyLoss(ignore_index=-100)``)."""
    total, count = _nll_sum(logits[:, :-1].float(), labels[:, 1:])
    return total / torch.clamp(count, min=1)


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
