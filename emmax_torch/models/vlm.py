"""Prismatic-style VLM: fused vision towers + projector + decoder (the
Llama family or Phi).

Port of ``emmax_tpu/models/vlm.py``: the towers run on their own
normalized images, their features are concatenated on channels and
projected, and the patch embeddings are spliced after each row's BOS
(``fuse_multimodal``) before the decoder runs. ``vlm_forward`` is the
training forward (labels, masked CE, remat, chunked CE);
``text_forward`` the unimodal one. The decoder is picked by the type of
``cfg.llm`` (``llm_apply``): ``LlamaConfig`` for Llama-2 and Mistral,
``PhiConfig`` for Phi-2.

Every forward takes ``mesh=None``: under a ``DeviceMesh`` the params are
this rank's blocks (``parallel.shard_params``), weights are gathered
where they are used, and the loss is the global batch's
(``parallel/gather.py``); None is the single-device path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from emmax_torch.models.llama import (IGNORE_INDEX, LLAMA2_7B, Llama,
                                      LlamaConfig, chunked_ce_loss_and_preds,
                                      cross_entropy_loss, embed_tokens,
                                      init_llama_params, llama_forward)
from emmax_torch.models.phi import Phi, PhiConfig, init_phi_params, phi_forward
from emmax_torch.models.projector import (Projector, init_projector_params,
                                          projector_forward)
from emmax_torch.models.vit import (DINOV2_L_REG4, SIGLIP_SO400M, ViT,
                                    ViTConfig, init_vit_params, vit_forward)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Static architecture description (towers as ordered (name, cfg))."""

    vision: Tuple[Tuple[str, ViTConfig], ...]
    llm: Union[LlamaConfig, PhiConfig]
    arch_specifier: str = "no-align+fused-gelu-mlp"

    @property
    def vision_dim(self) -> int:
        return sum(cfg.dim for _, cfg in self.vision)

    @property
    def num_patches(self) -> int:
        counts = {cfg.num_patches for _, cfg in self.vision}
        if len(counts) != 1:
            raise ValueError(f"towers must agree on patch count: {counts}")
        return counts.pop()


def init_vlm_params(generator: torch.Generator, cfg: VLMConfig,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Params:
    """Random weights with the JAX init's distributions (not its values:
    ``torch.Generator`` and ``jax.random`` draw different numbers)."""
    return {
        "vision": {name: init_vit_params(generator, vcfg, dtype, device)
                   for name, vcfg in cfg.vision},
        "projector": init_projector_params(generator, cfg.arch_specifier,
                                           cfg.vision_dim, cfg.llm.dim,
                                           dtype, device),
        "llm": _decoder(cfg.llm).init(generator, cfg.llm, dtype, device),
    }


class _Decoder(NamedTuple):
    init: Callable
    forward: Callable
    module: type


def _decoder(llm_cfg) -> _Decoder:
    """The decoder that ``llm_cfg`` describes: Phi for a ``PhiConfig``,
    else the Llama family."""
    if isinstance(llm_cfg, PhiConfig):
        return _Decoder(init_phi_params, phi_forward, Phi)
    return _Decoder(init_llama_params, llama_forward, Llama)


def llm_apply(params: Params, llm_cfg, inputs_embeds: torch.Tensor, **kw):
    """Decoder dispatch by config type: ``llama_forward`` for a
    ``LlamaConfig``, ``phi_forward`` for a ``PhiConfig``."""
    return _decoder(llm_cfg).forward(params, llm_cfg, inputs_embeds, **kw)


def encode_tower_features(params: Params, cfg: VLMConfig,
                          pixel_values: Dict[str, torch.Tensor], *,
                          attn_impl: str = "auto",
                          mesh=None) -> torch.Tensor:
    """Every tower on its own normalized image, concatenated on channels:
    the projector's input [B, P, sum of tower widths]."""
    feats = [vit_forward(params["vision"][name], vcfg, pixel_values[name],
                         attn_impl=attn_impl, mesh=mesh)
             for name, vcfg in cfg.vision]
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)


def encode_images(params: Params, cfg: VLMConfig,
                  pixel_values: Dict[str, torch.Tensor], *,
                  attn_impl: str = "auto",
                  stop_tower_gradient: bool = False,
                  mesh=None) -> torch.Tensor:
    """Tower features projected to the LLM width: -> [B, P, llm_dim].

    ``stop_tower_gradient`` stops gradients at the tower outputs, before
    the projector (the align stage: frozen towers, trainable projector).
    The towers then run without autograd, which is the same gradient and
    records no graph for them.

    ``pixel_values={"tower_features": [B, P, C]}`` feeds precomputed tower
    outputs (``encode_tower_features``; ``training/vision_cache.py``)
    straight to the projector: no tower runs, and no gradient flows past
    them."""
    if "tower_features" in pixel_values:
        return projector_forward(params["projector"],
                                 pixel_values["tower_features"].detach(),
                                 mesh)
    if stop_tower_gradient:
        with torch.no_grad():
            fused = encode_tower_features(params, cfg, pixel_values,
                                          attn_impl=attn_impl, mesh=mesh)
    else:
        fused = encode_tower_features(params, cfg, pixel_values,
                                      attn_impl=attn_impl, mesh=mesh)
    return projector_forward(params["projector"], fused, mesh)


def fuse_multimodal(patch_embeds: torch.Tensor, input_embeds: torch.Tensor,
                    mask: torch.Tensor, labels: Optional[torch.Tensor] = None,
                    multimodal_mask: Optional[torch.Tensor] = None):
    """Splice patches after each row's BOS: [pads... | bos | patches | text].

    For a row whose first valid token sits at index ``p``, the fused row
    is text[:p+1] | patches | text[p+1:]. Patch slots are valid and
    labeled IGNORE_INDEX, except in a row that is all padding (it has no
    BOS, and its patch slots must not prefill live cache slots).
    ``multimodal_mask`` ([B] bool) marks rows with an image; a text-only
    row takes the unimodal merge instead: [text | zeros(P)] with the zero
    block masked and labeled IGNORE_INDEX.

    Returns (embeds [B, L+P, D], mask [B, L+P], labels [B, L+P] or None,
    positions [B, L+P]).
    """
    B, P, D = patch_embeds.shape
    L = input_embeds.shape[1]
    F = L + P
    p = mask.to(torch.int32).argmax(dim=-1)                  # first valid
    row_live = mask.any(dim=-1, keepdim=True)                # [B, 1]
    j = torch.arange(F, device=mask.device)[None, :]         # [1, F]
    pe = p[:, None]
    if multimodal_mask is None:
        mm = torch.ones((B, 1), dtype=torch.bool, device=mask.device)
    else:
        mm = multimodal_mask.reshape(B, 1).to(torch.bool)
    is_patch = torch.where(mm, (j > pe) & (j <= pe + P), j >= L)
    src_text = torch.where(mm & (j > pe), j - P, j)
    src = torch.where(is_patch, L + torch.clamp(j - pe - 1, 0, P - 1),
                      src_text)
    source = torch.cat([input_embeds, patch_embeds.to(input_embeds.dtype)],
                       dim=1)
    idx = torch.clamp(src, 0, F - 1)[..., None].expand(B, F, D)
    embeds = torch.gather(source, 1, idx)
    embeds = torch.where((is_patch & ~mm)[..., None],
                         torch.zeros((), dtype=embeds.dtype,
                                     device=embeds.device), embeds)
    text_idx = torch.clamp(src_text, 0, L - 1).expand(B, F)
    fused_mask = torch.where(is_patch, mm & row_live,
                             torch.gather(mask.to(torch.bool), 1, text_idx))
    fused_labels = None
    if labels is not None:
        fused_labels = torch.where(
            is_patch, torch.full((), IGNORE_INDEX, dtype=labels.dtype,
                                 device=labels.device),
            torch.gather(labels, 1, text_idx))
    positions = torch.clamp(
        torch.cumsum(fused_mask.to(torch.int32), dim=-1) - 1, min=0)
    return embeds, fused_mask, fused_labels, positions


def vlm_forward(params: Params, cfg: VLMConfig, input_ids: torch.Tensor,
                pixel_values: Dict[str, torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, *,
                kv_cache: Optional[Params] = None, attn_impl: str = "auto",
                remat=False, stop_vision_gradient: bool = False,
                multimodal_mask: Optional[torch.Tensor] = None,
                ce_chunk: Optional[int] = None, mesh=None):
    """Multimodal forward. Returns (logits, loss or None, kv_cache or None).

    The logits cover the fused sequence [bos | patches | text[1:]].
    ``ce_chunk`` (training, with ``labels``): the loss comes from
    ``chunked_ce_loss_and_preds`` and the first value returned is the
    greedy preds [B, F] int32 instead of logits.
    """
    if mask is None:
        mask = torch.ones(input_ids.shape, dtype=torch.bool,
                          device=input_ids.device)
    patch_embeds = encode_images(params, cfg, pixel_values,
                                 attn_impl=attn_impl,
                                 stop_tower_gradient=stop_vision_gradient,
                                 mesh=mesh)
    input_embeds = embed_tokens(params["llm"], input_ids, mesh)
    embeds, fmask, flabels, positions = fuse_multimodal(
        patch_embeds, input_embeds, mask, labels,
        multimodal_mask=multimodal_mask)
    kw = dict(mask=fmask, positions=positions, kv_cache=kv_cache,
              attn_impl=attn_impl, remat=remat, mesh=mesh)
    if ce_chunk and flabels is not None:
        h, kv_cache = llm_apply(params["llm"], cfg.llm, embeds,
                                return_hidden=True, **kw)
        loss, preds = chunked_ce_loss_and_preds(
            h, params["llm"]["lm_head"], flabels, chunk=ce_chunk, mesh=mesh)
        return preds, loss, kv_cache
    logits, kv_cache = llm_apply(params["llm"], cfg.llm, embeds, **kw)
    loss = (cross_entropy_loss(logits, flabels, mesh)
            if flabels is not None else None)
    return logits, loss, kv_cache


def text_forward(params: Params, cfg: VLMConfig, input_ids: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 labels: Optional[torch.Tensor] = None, *,
                 attn_impl: str = "auto", remat=False, mesh=None):
    """Unimodal (text-only) forward. Returns (logits, loss or None)."""
    embeds = embed_tokens(params["llm"], input_ids, mesh)
    logits, _ = llm_apply(params["llm"], cfg.llm, embeds, mask=mask,
                          attn_impl=attn_impl, remat=remat, mesh=mesh)
    loss = (cross_entropy_loss(logits, labels, mesh)
            if labels is not None else None)
    return logits, loss


# === Reference model shape: the Emma-X flagship ===
def emma_x_vlm_config() -> VLMConfig:
    return VLMConfig(
        vision=(("dino", DINOV2_L_REG4), ("siglip", SIGLIP_SO400M)),
        llm=LLAMA2_7B,
        arch_specifier="no-align+fused-gelu-mlp",
    )


def tiny_vlm_config(vocab_size: int = 512) -> VLMConfig:
    """Small config for tests and smoke runs (same structure, tiny dims)."""
    dino = ViTConfig(img_size=28, patch_size=14, dim=32, depth=3, n_heads=2,
                     hidden_dim=64, class_token=True, num_reg_tokens=4,
                     layerscale=True)
    siglip = ViTConfig(img_size=28, patch_size=14, dim=48, depth=4, n_heads=2,
                       hidden_dim=96, class_token=False, gelu_tanh=True)
    llm = LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, hidden_dim=128, max_seq_len=256)
    return VLMConfig(vision=(("dino", dino), ("siglip", siglip)), llm=llm)


class VLM(nn.Module):
    """The towers, projector and decoder of one VLM, holding the weights."""

    def __init__(self, cfg: VLMConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision = nn.ModuleDict({name: ViT(vcfg, params["vision"][name])
                                     for name, vcfg in cfg.vision})
        self.projector = Projector(params["projector"])
        self.llm = _decoder(cfg.llm).module(cfg.llm, params["llm"])

    def tree(self) -> Params:
        """The weights as the nested dict the functional passes take."""
        return {"vision": {name: tower.params.tree()
                           for name, tower in self.vision.items()},
                "projector": self.projector.params.tree(),
                "llm": self.llm.params.tree()}

    def forward(self, pixel_values: Dict[str, torch.Tensor],
                attn_impl: str = "auto") -> torch.Tensor:
        """Patch embeddings [B, P, llm_dim] (:func:`encode_images`)."""
        return encode_images(self.tree(), self.cfg, pixel_values,
                             attn_impl=attn_impl)
