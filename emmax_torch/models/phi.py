"""Phi-2 decoder, port of ``emmax_tpu/models/phi.py``.

The architecture differs from Llama's: each layer is one biased LayerNorm
feeding attention and the MLP side by side (a parallel residual, ``h +
attn(x) + mlp(x)``); q, k, v, the output projection and both MLP linears
carry biases; rotary embeddings cover only the first ``rotary_dim =
partial_rotary_factor * head_dim`` channels of each head (rotated in
fp32, the rest passed through); the MLP uses ``gelu_new`` (tanh GELU);
the final LayerNorm is biased and so is the lm_head, a ``{"kernel",
"bias"}`` dict. The parameter layout is the JAX package's: ``[in, out]``
weights stacked ``[L, ...]``.

``phi_forward`` keeps ``llama_forward``'s contract: ``mask`` and
``positions``; the preallocated KV cache (bf16 or int8, a shared cursor
or per-row [B] cursors) updated in place through ``llama``'s cache
helpers; ``remat``, ``logits_dtype``, ``return_hidden`` (for
``chunked_ce_loss_and_preds``, which adds the lm_head's bias) and
``chunk_attn_mask`` (speculative tree verification; it needs a cache).
Quantized weights (``serving/quant.py``) go through ``llama.mm``, int4
through the int4 kernel, and each bias is added after the product, as
the JAX package adds it. ``mesh`` as in ``llama_forward``, but under a
``tensor`` split (``parallel.tensor.decoder_split``) only the attention is
split, as the JAX package's rules place Phi-2: the rank's heads from its
``wq`` / ``wk`` / ``wv`` columns and its slices of ``bq`` / ``bk`` /
``bv`` (its cache holds ``n_kv_heads / t`` heads), ``wo``'s rows summed
over ``tensor``, then ``bo`` once; the MLP (``w1`` / ``w2`` replicated)
and the lm_head run whole on every rank.

Without ``positions`` a cached call's RoPE positions start at the cache's
cursor, as ``llama_forward``'s do; the JAX package's Phi starts them at 0
there (every engine passes ``positions``, so no engine sees it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from emmax_torch.models.convert import _cast, _stack
from emmax_torch.models.llama import (Remat, cache_update, default_positions,
                                      layer_list, mark_slots, mm, remat_call)
from emmax_torch.models.tree import ParamTree
from emmax_torch.ops.attention import multi_head_attention
from emmax_torch.ops.norms import layer_norm
from emmax_torch.ops.rope import apply_partial_rope, rope_cos_sin
from emmax_torch.parallel.constraints import constrain_batch_sharded
from emmax_torch.parallel.gather import gather
from emmax_torch.parallel.tensor import WHOLE, Split, decoder_split

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PhiConfig:
    vocab_size: int = 51200
    dim: int = 2560
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 10240
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.4
    norm_eps: float = 1e-5
    max_seq_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.partial_rotary_factor * self.head_dim)


PHI_2 = PhiConfig()


def init_phi_params(generator: torch.Generator, cfg: PhiConfig,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """Random init with the JAX package's distributions (normal 0.02,
    zero biases, unit norm scales), sampled straight into ``dtype`` on
    ``device``."""
    def normal(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=generator)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    L, D, H, KV, hd, Fh = (cfg.n_layers, cfg.dim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim)
    return {
        "embed": normal(cfg.vocab_size, D),
        "layers": {
            "ln_scale": full(1, L, D), "ln_bias": full(0, L, D),
            "wq": normal(L, D, H * hd), "bq": full(0, L, H * hd),
            "wk": normal(L, D, KV * hd), "bk": full(0, L, KV * hd),
            "wv": normal(L, D, KV * hd), "bv": full(0, L, KV * hd),
            "wo": normal(L, H * hd, D), "bo": full(0, L, D),
            "w1": normal(L, D, Fh), "b1": full(0, L, Fh),
            "w2": normal(L, Fh, D), "b2": full(0, L, D),
        },
        "final_norm": {"scale": full(1, D), "bias": full(0, D)},
        "lm_head": {"kernel": normal(D, cfg.vocab_size),
                    "bias": full(0, cfg.vocab_size)},
    }


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Phi's ``gelu_new``: the tanh approximation of GELU."""
    return F.gelu(x, approximate="tanh")


def _linear(x: torch.Tensor, w, b: torch.Tensor) -> torch.Tensor:
    """``mm(x, w) + b``: the product (dense, int8 or int4) first, then the
    bias."""
    return mm(x, w) + b


def _qkv(x, p, cos, sin, cfg: PhiConfig, split: Split = WHOLE):
    """q [B, L, H, hd] and k, v [B, L, KV, hd] of this rank's heads, q and
    k partially rotated."""
    B, L, _ = x.shape
    H, KV = split.heads(cfg)
    x = split.enter(x)
    q = _linear(x, p["wq"], split.cols(p["bq"])).reshape(B, L, H,
                                                         cfg.head_dim)
    k = _linear(x, p["wk"], split.cols(p["bk"])).reshape(B, L, KV,
                                                         cfg.head_dim)
    v = _linear(x, p["wv"], split.cols(p["bv"])).reshape(B, L, KV,
                                                         cfg.head_dim)
    return (apply_partial_rope(q, cos, sin, cfg.rotary_dim),
            apply_partial_rope(k, cos, sin, cfg.rotary_dim), v)


def _residual(h, x, attn, p, split: Split = WHOLE):
    """The parallel residual: ``h + wo(attn) + mlp(x)``; ``wo``'s partial
    products summed over ``tensor`` before ``bo``, the MLP whole."""
    B, L = h.shape[:2]
    attn = split.reduce(mm(attn.reshape(B, L, -1), p["wo"])) + p["bo"]
    mlp = _linear(gelu_new(_linear(x, p["w1"], p["b1"])), p["w2"], p["b2"])
    return h + attn + mlp


def _layer(h, p, cos, sin, kv_mask, cfg: PhiConfig, attn_impl: str,
           split: Split = WHOLE):
    """One decoder layer (uncached path, causal)."""
    p = split.weights(p)
    x = layer_norm(h, p["ln_scale"], p["ln_bias"], cfg.norm_eps)
    q, k, v = _qkv(x, p, cos, sin, cfg, split)
    attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=True,
                                impl=attn_impl)
    return _residual(h, x, attn, p, split)


def _cached_layer(h, p, cos, sin, cache, i: int, t0, slot_mask,
                  cfg: PhiConfig, attn_impl: str, chunk_mask=None,
                  split: Split = WHOLE):
    """One decoder layer that writes its K/V into the cache at ``t0`` and
    attends over the layer's whole cache (``llama._cached_layer``)."""
    p = split.weights(p)
    x = layer_norm(h, p["ln_scale"], p["ln_bias"], cfg.norm_eps)
    q, k_new, v_new = _qkv(x, p, cos, sin, cfg, split)
    k_c, v_c = cache_update(cache, i, t0, k_new, v_new, h.dtype)
    attn = multi_head_attention(q, k_c, v_c, kv_mask=slot_mask, causal=True,
                                q_offset=t0, impl=attn_impl,
                                chunk_mask=chunk_mask)
    return _residual(h, x, attn, p, split)


def phi_forward(params: Params, cfg: PhiConfig, inputs_embeds: torch.Tensor,
                *, mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[Params] = None, attn_impl: str = "auto",
                remat: Remat = False,
                logits_dtype: torch.dtype = torch.float32,
                return_hidden: bool = False,
                chunk_attn_mask: Optional[torch.Tensor] = None,
                mesh=None) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits [B, L, V], the kv_cache or None), under
    ``llama_forward``'s contract (see the module docstring)."""
    if chunk_attn_mask is not None and kv_cache is None:
        raise ValueError("chunk_attn_mask requires a kv_cache (tree chunks "
                         "verify against an existing context)")
    positions = default_positions(inputs_embeds, mask, positions, kv_cache)
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta)
    split = decoder_split(params, cfg, mesh)
    per_layer = layer_list(params["layers"], cfg.n_layers, mesh)
    h = inputs_embeds
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

    h = layer_norm(h, params["final_norm"]["scale"],
                   params["final_norm"]["bias"], cfg.norm_eps)
    if return_hidden:
        return h, kv_cache
    head = params["lm_head"]
    logits = _linear(h, gather(head["kernel"], mesh), head["bias"])
    return logits.to(logits_dtype), kv_cache


def convert_hf_phi(sd: Mapping[str, Any], cfg: PhiConfig,
                   dtype=torch.float32, device="cpu") -> Params:
    """A Hugging Face ``PhiForCausalLM.state_dict()`` (a mapping of
    tensors) -> the phi param tree, each leaf in ``dtype`` on ``device``."""
    L, pre = cfg.n_layers, "model.layers.{}."

    def stack(name, transpose=False):
        return _stack(sd, pre + name, L, dtype, device, transpose)

    return {
        "embed": _cast(sd["model.embed_tokens.weight"], dtype, device),
        "layers": {
            "ln_scale": stack("input_layernorm.weight"),
            "ln_bias": stack("input_layernorm.bias"),
            "wq": stack("self_attn.q_proj.weight", True),
            "bq": stack("self_attn.q_proj.bias"),
            "wk": stack("self_attn.k_proj.weight", True),
            "bk": stack("self_attn.k_proj.bias"),
            "wv": stack("self_attn.v_proj.weight", True),
            "bv": stack("self_attn.v_proj.bias"),
            "wo": stack("self_attn.dense.weight", True),
            "bo": stack("self_attn.dense.bias"),
            "w1": stack("mlp.fc1.weight", True),
            "b1": stack("mlp.fc1.bias"),
            "w2": stack("mlp.fc2.weight", True),
            "b2": stack("mlp.fc2.bias"),
        },
        "final_norm": {
            "scale": _cast(sd["model.final_layernorm.weight"], dtype, device),
            "bias": _cast(sd["model.final_layernorm.bias"], dtype, device)},
        "lm_head": {"kernel": _cast(sd["lm_head.weight"].T, dtype, device),
                    "bias": _cast(sd["lm_head.bias"], dtype, device)},
    }


class Phi(nn.Module):
    """The Phi decoder holding its (dense, int8 or int4) weights;
    ``forward`` is :func:`phi_forward`."""

    def __init__(self, cfg: PhiConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, inputs_embeds: torch.Tensor, **kw):
        return phi_forward(self.params.tree(), self.cfg, inputs_embeds, **kw)
