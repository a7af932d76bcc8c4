"""Weight conversion between checkpoint layouts and the port's parameter
tree, port of ``emmax_tpu/models/convert.py``.

Sources: Hugging Face transformers modules (``LlamaForCausalLM``,
``Dinov2WithRegistersModel``, ``SiglipVisionModel``), the TIMM naming of
the reference Prismatic ``.pt`` checkpoints (the state dict split
``{"model": {"projector", "llm_backbone", "vision_backbone"}}``) and the
published OpenVLA Hugging Face naming (``language_model.*``,
``vision_backbone.featurizer.*`` / ``.fused_featurizer.*``,
``projector.fc{1,2,3}.*``). The tree is the JAX package's: linear kernels
``[in, out]``, layers stacked ``[L, ...]``, a ViT's q, k and v fused into
one ``[D, 3D]`` kernel, ``pos_embed`` ``[1, prefix + N, D]`` (TIMM
``no_embed_class`` checkpoints get a zero class row, which changes
nothing: TIMM adds positions to the patches only).

Each leaf is built straight in the target ``dtype`` (bf16 -> bf16 is
exact, fp32 -> bf16 rounds to nearest even, as ``jnp.asarray`` does) and
placed on ``device``; no float32 copy of a whole tree is made. Only a
position table that needs resizing goes through float32. A Llama
decoder's matmul weights and lm_head can be quantized as they are
converted (``quantize``): each layer is transposed, cast and quantized on
``device``, so no dense stacked leaf is ever built.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch

from emmax_torch.models.llama import LlamaConfig
from emmax_torch.models.vit import ViTConfig

Params = Dict[str, Any]


def _cast(t: torch.Tensor, dtype, device) -> torch.Tensor:
    t = t.detach()
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def quantize_stacked(n: int, layer: Callable[[int], torch.Tensor],
                     quantize: Callable) -> Dict[str, torch.Tensor]:
    """``quantize`` of a stacked ``[n, ...]`` leaf given layer by layer
    (``layer(i)``, contiguous, on the device that quantizes), into stacked
    outputs: a weight's quantization is per layer, so the bytes are those
    of quantizing the whole leaf."""
    out = {}
    for i in range(n):
        for k, v in quantize(layer(i)).items():
            if k not in out:
                out[k] = v.new_empty((n,) + v.shape)
            out[k][i] = v
    return out


def _stack(sd: Mapping[str, Any], fmt: str, n: int, dtype, device,
           transpose: bool = False, quantize: Optional[Callable] = None):
    """``n`` per-layer tensors stacked into one ``[n, ...]`` leaf, written
    layer by layer into the leaf (so only it and one layer are held). A
    layer moves to the leaf's device as it is stored, and is transposed
    and cast there by one copy (a transposed copy is slow on the host).

    With ``quantize`` (a ``serving.quant`` weight quantizer) each layer is
    copied the same way into one contiguous layer buffer on ``device`` and
    quantized there (:func:`quantize_stacked`): the result is the
    quantized leaf's dict, and no dense stacked leaf is built."""
    first = sd[fmt.format(0)]
    shape = first.shape[::-1] if transpose else first.shape
    dt = (dtype if first.is_floating_point() and dtype is not None
          else first.dtype)

    def copy(i, dst):
        t = sd[fmt.format(i)].detach().to(dst.device)
        return dst.copy_(t.T if transpose else t)

    if quantize is not None:
        buf = torch.empty(shape, dtype=dt, device=device)
        return quantize_stacked(n, lambda i: copy(i, buf), quantize)
    out = torch.empty((n, *shape), dtype=dt, device=device)
    for i in range(n):
        copy(i, out[i])
    return out


# --- Llama -------------------------------------------------------------------

def convert_hf_llama(sd: Mapping[str, Any], cfg: LlamaConfig,
                     dtype=torch.float32, device="cpu",
                     quantize: Optional[Callable] = None) -> Params:
    """HF ``LlamaForCausalLM.state_dict()`` -> llama param tree; with
    ``quantize`` its seven matmul weights and the lm_head quantized on
    ``device`` (the module docstring)."""
    L, pre = cfg.n_layers, "model.layers.{}."

    def stack(name, transpose=False):
        # the seven matmul weights are the transposed leaves
        return _stack(sd, pre + name, L, dtype, device, transpose,
                      quantize if transpose else None)

    lm_head = _cast(sd["lm_head.weight"].T, dtype, device)
    return {
        "embed": _cast(sd["model.embed_tokens.weight"], dtype, device),
        "layers": {
            "attn_norm": stack("input_layernorm.weight"),
            "wq": stack("self_attn.q_proj.weight", True),
            "wk": stack("self_attn.k_proj.weight", True),
            "wv": stack("self_attn.v_proj.weight", True),
            "wo": stack("self_attn.o_proj.weight", True),
            "mlp_norm": stack("post_attention_layernorm.weight"),
            "w_gate": stack("mlp.gate_proj.weight", True),
            "w_up": stack("mlp.up_proj.weight", True),
            "w_down": stack("mlp.down_proj.weight", True),
        },
        "final_norm": _cast(sd["model.norm.weight"], dtype, device),
        "lm_head": lm_head if quantize is None else quantize(lm_head),
    }


# --- ViT helpers ---------------------------------------------------------------

def _conv_to_patch_kernel(w: torch.Tensor, dtype, device) -> torch.Tensor:
    """torch conv ``[D, C, ph, pw]`` -> ``[ph*pw*C, D]`` (``vit.patchify``)."""
    d = w.shape[0]
    return _cast(w.permute(2, 3, 1, 0).reshape(-1, d), dtype, device)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel at a = -0.5 (``jax.image``'s "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resize_weights(src: int, dst: int) -> torch.Tensor:
    """``[src, dst]`` float32 weights of ``jax.image.resize(...,
    "bicubic")`` along one axis: half-pixel centres, the kernel widened by
    src / dst when downsampling (``antialias=True``), each output's weights
    normalised to sum 1, outputs sampled outside the input zeroed."""
    inv_scale = 1.0 / (dst / src)
    # float32 tensors, not Python scalars: torch divides by a scalar
    # through its reciprocal
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32)
    sample = ((torch.arange(dst, dtype=torch.float32) + 0.5)
              * torch.tensor(inv_scale, dtype=torch.float32) - 0.5)
    x = (sample[None, :] - torch.arange(src, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_pos_embed(pos: torch.Tensor, src_grid: int, dst_grid: int,
                     has_cls_row: bool) -> torch.Tensor:
    """Bicubic resize of a ``[1, (cls +) src^2, D]`` position table to
    ``dst^2`` rows, as ``jax.image.resize`` does it (two separable
    products in float32). Returns float32 unless the grids match."""
    if src_grid == dst_grid:
        return pos
    cls_row = pos[:, :1].float() if has_cls_row else None
    grid = (pos[:, 1:] if has_cls_row else pos).float()
    d = grid.shape[-1]
    grid = grid.reshape(src_grid, src_grid, d)
    w = resize_weights(src_grid, dst_grid)                 # [src, dst]
    grid = torch.einsum("hwd,hH->Hwd", grid, w)
    grid = torch.einsum("Hwd,wW->HWd", grid, w)
    grid = grid.reshape(1, dst_grid * dst_grid, d)
    return torch.cat([cls_row, grid], dim=1) if has_cls_row else grid


def _fuse_qkv(qw, kw, vw, qb, kb, vb):
    """``[D_out, D_in]`` triples -> kernel ``[D_in, 3 D_out]``, bias
    ``[3 D_out]``."""
    return (torch.cat([qw.T, kw.T, vw.T], dim=-1),
            torch.cat([qb, kb, vb], dim=-1))


def _stack_fused(sd, fmt: str, names, L: int, dtype, device):
    """Per layer q, k, v weights and biases (``fmt`` of the layer index
    and the projection name) fused and stacked: ``wqkv``, ``bqkv``."""
    def one(i, kind):
        return [sd[fmt.format(i, n) + kind].detach() for n in names]

    first = sd[fmt.format(0, names[0]) + "weight"]
    dim, dtype = first.shape[1], dtype or first.dtype
    w = torch.empty((L, dim, 3 * dim), dtype=dtype, device=device)
    b = torch.empty((L, 3 * dim), dtype=dtype, device=device)
    for i in range(L):
        kernel, bias = _fuse_qkv(*one(i, "weight"), *one(i, "bias"))
        w[i], b[i] = kernel.to(dtype), bias.to(dtype)
    return w, b


def _block_leaves(sd, pre: str, L: int, names: Dict[str, str], dtype,
                  device) -> Params:
    """Stacked block leaves; a name ending in ``.T`` is a torch linear
    weight, transposed to ``[in, out]``."""
    out = {}
    for leaf, key in names.items():
        transpose = key.endswith(".T")
        out[leaf] = _stack(sd, pre + key.removesuffix(".T"), L, dtype,
                           device, transpose)
    return out


def _norm(sd, prefix: str, dtype, device) -> Params:
    return {"scale": _cast(sd[prefix + "weight"], dtype, device),
            "bias": _cast(sd[prefix + "bias"], dtype, device)}


def _grid(rows: int) -> int:
    return int(round(rows ** 0.5))


# --- HF DINOv2 (with registers) -------------------------------------------------

def convert_hf_dinov2(sd: Mapping[str, Any], cfg: ViTConfig,
                      dtype=torch.float32, device="cpu") -> Params:
    """HF ``Dinov2WithRegistersModel.state_dict()`` -> vit param tree."""
    L, pre = cfg.depth, "encoder.layer.{}."
    wqkv, bqkv = _stack_fused(sd, pre + "attention.attention.{}.",
                              ("query", "key", "value"), L, dtype, device)
    pos = sd["embeddings.position_embeddings"]
    pos = resize_pos_embed(pos, _grid(pos.shape[1] - 1), cfg.grid,
                           has_cls_row=True)
    blocks = _block_leaves(sd, pre, L, {
        "norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
        "wo": "attention.output.dense.weight.T",
        "bo": "attention.output.dense.bias",
        "ls1": "layer_scale1.lambda1",
        "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
        "w1": "mlp.fc1.weight.T", "b1": "mlp.fc1.bias",
        "w2": "mlp.fc2.weight.T", "b2": "mlp.fc2.bias",
        "ls2": "layer_scale2.lambda1"}, dtype, device)
    return {
        "patch_embed": {
            "kernel": _conv_to_patch_kernel(
                sd["embeddings.patch_embeddings.projection.weight"], dtype,
                device),
            "bias": _cast(sd["embeddings.patch_embeddings.projection.bias"],
                          dtype, device),
        },
        "cls_token": _cast(sd["embeddings.cls_token"], dtype, device),
        "reg_tokens": _cast(sd["embeddings.register_tokens"], dtype, device),
        "pos_embed": _cast(pos, dtype, device),
        "blocks": {**blocks, "wqkv": wqkv, "bqkv": bqkv},
        "final_norm": _norm(sd, "layernorm.", dtype, device),
    }


# --- HF SigLIP vision -------------------------------------------------------------

def convert_hf_siglip(sd: Mapping[str, Any], cfg: ViTConfig,
                      prefix: str = "vision_model.", dtype=torch.float32,
                      device="cpu") -> Params:
    """HF ``SiglipVisionModel.state_dict()`` -> vit param tree."""
    L, pre = cfg.depth, prefix + "encoder.layers.{}."
    wqkv, bqkv = _stack_fused(sd, pre + "self_attn.{}_proj.", ("q", "k", "v"),
                              L, dtype, device)
    pos = sd[prefix + "embeddings.position_embedding.weight"][None]
    pos = resize_pos_embed(pos, _grid(pos.shape[1]), cfg.grid,
                           has_cls_row=False)
    blocks = _block_leaves(sd, pre, L, {
        "norm1_scale": "layer_norm1.weight", "norm1_bias": "layer_norm1.bias",
        "wo": "self_attn.out_proj.weight.T", "bo": "self_attn.out_proj.bias",
        "norm2_scale": "layer_norm2.weight", "norm2_bias": "layer_norm2.bias",
        "w1": "mlp.fc1.weight.T", "b1": "mlp.fc1.bias",
        "w2": "mlp.fc2.weight.T", "b2": "mlp.fc2.bias"}, dtype, device)
    return {
        "patch_embed": {
            "kernel": _conv_to_patch_kernel(
                sd[prefix + "embeddings.patch_embedding.weight"], dtype,
                device),
            "bias": _cast(sd[prefix + "embeddings.patch_embedding.bias"],
                          dtype, device),
        },
        "pos_embed": _cast(pos, dtype, device),
        "blocks": {**blocks, "wqkv": wqkv, "bqkv": bqkv},
        "final_norm": _norm(sd, prefix + "post_layernorm.", dtype, device),
    }


# --- TIMM ViT (the reference Prismatic checkpoints store TIMM modules) ----------

_TIMM_BLOCK = {
    "norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
    "wqkv": "attn.qkv.weight.T", "bqkv": "attn.qkv.bias",
    "wo": "attn.proj.weight.T", "bo": "attn.proj.bias",
    "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
    "w1": "mlp.fc1.weight.T", "b1": "mlp.fc1.bias",
    "w2": "mlp.fc2.weight.T", "b2": "mlp.fc2.bias",
}


def convert_timm_vit(sd: Mapping[str, Any], cfg: ViTConfig,
                     dtype=torch.float32, device="cpu") -> Params:
    """TIMM ``VisionTransformer.state_dict()`` -> vit param tree.

    A ``no_embed_class`` checkpoint (as many position rows as patches)
    gets a zero class row in front. LayerScale is TIMM's ``gamma`` or the
    HF-compatible ``scale_factor``.
    """
    L, pre = cfg.depth, "blocks.{}."
    pos = sd["pos_embed"]
    n_rows = pos.shape[1]
    has_cls_row = cfg.class_token and _grid(n_rows - 1) ** 2 == n_rows - 1
    src_grid = _grid(n_rows - 1) if has_cls_row else _grid(n_rows)
    pos = _cast(resize_pos_embed(pos, src_grid, cfg.grid, has_cls_row),
                dtype, device)
    if cfg.class_token and not has_cls_row:
        pos = torch.cat([torch.zeros((1, 1, pos.shape[-1]), dtype=pos.dtype,
                                     device=device), pos], dim=1)
    names = dict(_TIMM_BLOCK)
    if cfg.layerscale:
        kind = "gamma" if "blocks.0.ls1.gamma" in sd else "scale_factor"
        names["ls1"], names["ls2"] = f"ls1.{kind}", f"ls2.{kind}"
    params: Params = {
        "patch_embed": {
            "kernel": _conv_to_patch_kernel(sd["patch_embed.proj.weight"],
                                            dtype, device),
            "bias": _cast(sd["patch_embed.proj.bias"], dtype, device),
        },
        "pos_embed": pos,
        "blocks": _block_leaves(sd, pre, L, names, dtype, device),
        "final_norm": _norm(sd, "norm.", dtype, device),
    }
    if cfg.class_token:
        params["cls_token"] = _cast(sd["cls_token"], dtype, device)
    if cfg.num_reg_tokens:
        params["reg_tokens"] = _cast(sd["reg_token"], dtype, device)
    # CLIP towers' LayerNorm before the blocks
    if cfg.pre_norm:
        params["pre_norm"] = _norm(sd, "norm_pre.", dtype, device)
    return params


# --- Projector -----------------------------------------------------------------------

def convert_projector(sd: Mapping[str, Any], prefix: str = "projector.",
                      dtype=torch.float32, device="cpu") -> Params:
    """The reference ``nn.Sequential`` projector (linears at 0, 2, 4 for
    the fused GELU MLP; the 2- and 1-linear variants too)."""
    idxs = sorted({int(k.split(".")[-2]) for k in sd
                   if k.startswith(prefix) and k.endswith(".weight")})
    return {"layers": [
        {"kernel": _cast(sd[f"{prefix}{i}.weight"].T, dtype, device),
         "bias": _cast(sd[f"{prefix}{i}.bias"], dtype, device)}
        for i in idxs]}


# --- export ------------------------------------------------------------------------------

def _check_dense(params) -> None:
    llm = params["llm"]
    if isinstance(llm["lm_head"], dict) or any(
            isinstance(v, dict) for v in llm["layers"].values()):
        raise ValueError("cannot export a quantized tree; export the dense "
                         "weights")


def params_to_prismatic_sd(params, cfg, dtype=None) -> dict:
    """The param tree -> reference-layout state dicts ``{"projector",
    "llm_backbone", "vision_backbone"}`` (the inverse of
    ``load.convert_prismatic_pt``): contiguous CPU tensors, in ``dtype``
    or each leaf's own."""
    _check_dense(params)

    def t(x):
        """A CPU tensor that owns its storage (a row of a stacked leaf
        would otherwise save the whole leaf with it)."""
        y = _cast(x, dtype, "cpu")
        if y.untyped_storage().nbytes() != y.numel() * y.element_size():
            y = y.clone()
        return y

    def rows(x):
        """A stacked leaf on the host once, then one row per layer."""
        return x.detach().to("cpu")

    llm = params["llm"]
    llm_sd = {"llm.model.embed_tokens.weight": t(llm["embed"]),
              "llm.model.norm.weight": t(llm["final_norm"]),
              "llm.lm_head.weight": t(llm["lm_head"].T)}
    norms = {"attn_norm": "input_layernorm.weight",
             "mlp_norm": "post_attention_layernorm.weight"}
    mats = {"wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
            "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
            "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
            "w_down": "mlp.down_proj.weight"}
    for group, transpose in ((norms, False), (mats, True)):
        for k, hf in group.items():
            stacked = rows(llm["layers"][k])
            for i in range(stacked.shape[0]):
                llm_sd[f"llm.model.layers.{i}.{hf}"] = t(
                    stacked[i].T if transpose else stacked[i])
            del stacked

    vis_sd = {}
    for name, vcfg in cfg.vision:
        pre = f"{name}_featurizer."
        p = params["vision"][name]
        pk = p["patch_embed"]["kernel"]
        vis_sd[pre + "patch_embed.proj.weight"] = t(
            pk.reshape(vcfg.patch_size, vcfg.patch_size, 3, vcfg.dim)
            .permute(3, 2, 0, 1))
        vis_sd[pre + "patch_embed.proj.bias"] = t(p["patch_embed"]["bias"])
        vis_sd[pre + "pos_embed"] = t(p["pos_embed"])
        if vcfg.class_token:
            vis_sd[pre + "cls_token"] = t(p["cls_token"])
        if vcfg.num_reg_tokens:
            vis_sd[pre + "reg_token"] = t(p["reg_tokens"])
        keys = dict(_TIMM_BLOCK)
        if vcfg.layerscale:
            keys["ls1"], keys["ls2"] = "ls1.gamma", "ls2.gamma"
        blocks = {leaf: rows(p["blocks"][leaf]) for leaf in keys}
        for i in range(vcfg.depth):
            for leaf, key in keys.items():
                x = blocks[leaf][i]
                vis_sd[f"{pre}blocks.{i}.{key.removesuffix('.T')}"] = t(
                    x.T if key.endswith(".T") else x)
        del blocks
        vis_sd[pre + "norm.weight"] = t(p["final_norm"]["scale"])
        vis_sd[pre + "norm.bias"] = t(p["final_norm"]["bias"])

    proj_sd = {}
    for li, layer in enumerate(params["projector"]["layers"]):
        proj_sd[f"projector.{2 * li}.weight"] = t(layer["kernel"].T)
        proj_sd[f"projector.{2 * li}.bias"] = t(layer["bias"])
    return {"projector": proj_sd, "llm_backbone": llm_sd,
            "vision_backbone": vis_sd}


# --- the published OpenVLA Hugging Face naming ------------------------------------------

_HF_FC = {0: "fc1", 2: "fc2", 4: "fc3"}


def params_to_hf_sd(params, cfg, dtype=None) -> dict:
    """The param tree -> one flat state dict in the OpenVLA
    ``modeling_prismatic`` naming (``language_model.*``,
    ``vision_backbone.featurizer.*`` / ``.fused_featurizer.*`` with
    LayerScale ``scale_factor``, ``projector.fc{1,2,3}.*``)."""
    parts = params_to_prismatic_sd(params, cfg, dtype)
    sd = {}
    for k, v in parts.pop("llm_backbone").items():
        sd["language_model." + k[len("llm."):]] = v
    names = [name for name, _ in cfg.vision]
    vis_prefix = {names[0]: "vision_backbone.featurizer."}
    if len(names) > 1:
        vis_prefix[names[1]] = "vision_backbone.fused_featurizer."
    for k, v in parts.pop("vision_backbone").items():
        name, rest = k.split("_featurizer.", 1)
        for ls in ("ls1", "ls2"):
            rest = rest.replace(f"{ls}.gamma", f"{ls}.scale_factor")
        sd[vis_prefix[name] + rest] = v
    for k, v in parts.pop("projector").items():
        _, idx, leaf = k.split(".")
        sd[f"projector.{_HF_FC[int(idx)]}.{leaf}"] = v
    return sd


def convert_hf_openvla_sd(sd: Mapping[str, Any], cfg, dtype=torch.float32,
                          device="cpu",
                          quantize: Optional[Callable] = None) -> Params:
    """Flat OpenVLA-naming state dict -> param tree (the inverse of
    :func:`params_to_hf_sd`); ``quantize`` as in :func:`convert_hf_llama`."""
    names = [name for name, _ in cfg.vision]
    vis_prefix = {"vision_backbone.featurizer.": names[0]}
    if len(names) > 1:
        vis_prefix["vision_backbone.fused_featurizer."] = names[1]
    vision = {}
    for prefix, name in vis_prefix.items():
        sub = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
        vision[name] = convert_timm_vit(sub, dict(cfg.vision)[name], dtype,
                                        device)
    llm_sub = {k[len("language_model."):]: v for k, v in sd.items()
               if k.startswith("language_model.")}
    fc_to_idx = {v: k for k, v in _HF_FC.items()}
    proj_sd = {}
    for k, v in sd.items():
        if k.startswith("projector."):
            _, fc, leaf = k.split(".")
            proj_sd[f"projector.{fc_to_idx[fc]}.{leaf}"] = v
    return {"vision": vision,
            "projector": convert_projector(proj_sd, "projector.", dtype,
                                           device),
            "llm": convert_hf_llama(llm_sub, cfg.llm, dtype, device,
                                    quantize)}
