"""Model loading and saving, port of ``emmax_tpu/models/load.py``.

``load(model_id_or_path)`` builds a VLM and ``load_vla(path)`` a VLA
policy from:

1. a registered model id: random weights drawn on the device from a
   ``torch.Generator`` seeded with ``seed``;
2. a directory with ``config.json``, holding in this order of preference
   - the port's own run directory: ``checkpoints/step-.../state.pt``
     (written by ``emmax_torch.train`` or :func:`save_pretrained`); only
     its ``params`` are read, through a map of the file, so the optimizer
     moments are never touched;
   - a reference Prismatic ``checkpoints/*.pt``: ``{"model":
     {"projector", "llm_backbone", "vision_backbone"}}``;
   - Hugging Face safetensors shards in the published OpenVLA naming
     (``convert_weights --mode export_hf`` writes them; the reference's
     ``convert_openvla_weights_to_hf.py`` too);
   and ``dataset_statistics.json`` or ``norm_stats`` in ``config.json``
   for un-normalizing actions.

A checkpoint's tensors are read through a map of its files and each
leaf is converted straight onto the device, so the host holds no second
copy of the tree. ``quantize="int8"|"int4"`` quantizes the decoder's
matmul weights and the lm_head. From a checkpoint the tree is converted
on the host, and each stacked leaf moves to the device one layer at a
time and is quantized there, so the device never holds a dense stacked
leaf beside the quantized tree (the JAX package quantizes on the host;
the bytes are the same).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from emmax_torch.models.convert import (convert_hf_llama,
                                        convert_hf_openvla_sd,
                                        convert_projector, convert_timm_vit)
from emmax_torch.models.materialize import (get_image_transforms,
                                            get_llm_config, get_vision_config)
from emmax_torch.models.registry import MODEL_REGISTRY
from emmax_torch.models.safetensors_io import load_dir
from emmax_torch.models.vlm import VLMConfig, init_vlm_params, tiny_vlm_config
from emmax_torch.ops.image import ImageTransformConfig
from emmax_torch.serving.engine import resolve_device
from emmax_torch.serving.quant import (QUANT_KEYS, quantize_vlm_params,
                                       weight_quantizer)
from emmax_torch.training.checkpointing import STATE_FILE, CheckpointManager
from emmax_torch.vla.tokenizer import load_tokenizer


# --- config plumbing ---------------------------------------------------------

def _model_cfg_from_json(blob: dict):
    """(vision id, llm id, arch, resize) from a config.json: the pretrain
    shape ``{"model": {...}}``, the trainer's ``{"vla": {"base_vlm": id}}``
    or the flat Hugging Face export blob."""
    if "model" in blob:
        m = blob["model"]
        return (m["vision_backbone_id"], m["llm_backbone_id"],
                m["arch_specifier"],
                m.get("image_resize_strategy", "resize-naive"))
    if "vla" in blob:
        from emmax_torch.conf.models import ModelConfig

        mc = ModelConfig.get_choice_class(str(blob["vla"]["base_vlm"]))()
        return (mc.vision_backbone_id, mc.llm_backbone_id, mc.arch_specifier,
                mc.image_resize_strategy)
    return (blob["vision_backbone_id"], blob["llm_backbone_id"],
            blob["arch_specifier"],
            blob.get("image_resize_strategy", "resize-naive"))


def build_vlm(vision_backbone_id: str, llm_backbone_id: str,
              arch_specifier: str):
    """(VLMConfig, llm family) for a backbone pair ("tiny" = test scale)."""
    if vision_backbone_id == "tiny" or llm_backbone_id == "tiny":
        return tiny_vlm_config(), "llama2"
    llm, family = get_llm_config(llm_backbone_id)
    return VLMConfig(vision=get_vision_config(vision_backbone_id), llm=llm,
                     arch_specifier=arch_specifier), family


def _transforms(cfg: VLMConfig, vision_backbone_id: str, resize: str):
    if vision_backbone_id == "tiny":
        return {n: ImageTransformConfig(size=v.img_size,
                                        resize_strategy=resize)
                for n, v in cfg.vision}
    return get_image_transforms(vision_backbone_id, resize)


# --- the port's run directories ---------------------------------------------

def save_pretrained(run_dir, cfg_blob: dict, params, step: int = 0,
                    dataset_statistics: Optional[dict] = None) -> Path:
    """A run directory holding ``params``: ``config.json`` (any shape
    :func:`_model_cfg_from_json` reads), ``dataset_statistics.json`` and
    ``checkpoints/step-XXXXXX/state.pt``. Returns the checkpoint dir."""
    from emmax_torch.training.checkpointing import write_sidecars

    run_dir = Path(run_dir)
    write_sidecars(run_dir, cfg_blob, dataset_statistics)
    ckpt_dir = (run_dir / "checkpoints" / f"step-{step:06d}").absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"step": step, "params": params}, ckpt_dir / STATE_FILE)
    return ckpt_dir


def _latest_checkpoint(run_dir: Path) -> Optional[Path]:
    if not (Path(run_dir) / "checkpoints").is_dir():
        return None
    return CheckpointManager(run_dir).latest()


def load_run_params(ckpt_dir) -> dict:
    """The ``params`` of a run checkpoint, as CPU tensors backed by a map
    of ``state.pt`` (the optimizer state beside them is never read)."""
    blob = torch.load(Path(ckpt_dir) / STATE_FILE, map_location="cpu",
                      weights_only=True, mmap=True)
    return blob["params"]


# --- reference .pt -----------------------------------------------------------

def convert_prismatic_pt(pt_path, cfg: VLMConfig, dtype=torch.float32,
                         device="cpu"):
    """A reference Prismatic / OpenVLA ``.pt`` -> param tree, each leaf in
    ``dtype`` on ``device``. The file is mapped, not read whole."""
    blob = torch.load(pt_path, map_location="cpu", weights_only=True,
                      mmap=True)
    model_sd = blob["model"] if "model" in blob else blob
    vision_sd = model_sd["vision_backbone"]
    vision = {}
    for name, vcfg in cfg.vision:
        prefix = f"{name}_featurizer."
        sub = {k[len(prefix):]: v for k, v in vision_sd.items()
               if k.startswith(prefix)}
        if not sub and len(cfg.vision) == 1:
            sub = {k.split("featurizer.", 1)[-1]: v
                   for k, v in vision_sd.items()}
        vision[name] = convert_timm_vit(sub, vcfg, dtype, device)
    llm_sub = {k[len("llm."):]: v for k, v in model_sd["llm_backbone"].items()
               if k.startswith("llm.")}
    return {"vision": vision,
            "projector": convert_projector(model_sd["projector"],
                                           "projector.", dtype, device),
            "llm": convert_hf_llama(llm_sub, cfg.llm, dtype, device)}


# --- placing a host tree ---------------------------------------------------------

def _cast_tree(tree, dtype, device="cpu"):
    """Each leaf on ``device``, the floating ones in ``dtype``, leaf by
    leaf."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype, device) for v in tree]
    return tree.to(device, dtype if tree.is_floating_point() else None)


def _quantize_layers(w: torch.Tensor, device, qfn) -> dict:
    """``qfn`` of a host ``[L, D, F]`` leaf, computed on ``device`` one
    layer at a time into stacked outputs (a weight's quantization is per
    layer, so the bytes are those of the whole leaf's)."""
    out = {}
    for i in range(w.shape[0]):
        for k, v in qfn(w[i].to(device)).items():
            if k not in out:
                out[k] = v.new_empty((w.shape[0],) + v.shape)
            out[k][i] = v
    return out


def place_params(host: dict, device, quantize: str) -> dict:
    """A CPU tree -> the same tree on ``device``, leaf by leaf, each
    decoder matmul weight and the lm_head quantized (``quantize`` "int8"
    or "int4") on ``device`` by the ``serving/quant.py`` quantizers, one
    layer of a stacked leaf moved at a time."""
    def move(tree):
        return _cast_tree(tree, None, device)

    qfn = weight_quantizer(4 if quantize == "int4" else 8)
    llm = dict(host["llm"])
    layers = dict(llm.pop("layers"))
    for key in QUANT_KEYS:
        if key in layers:
            layers[key] = _quantize_layers(layers.pop(key), device, qfn)
    lm_head = qfn(llm.pop("lm_head").to(device))
    return {"vision": move(host["vision"]),
            "projector": move(host["projector"]),
            "llm": {**move(llm), "layers": move(layers), "lm_head": lm_head}}


# --- public API ----------------------------------------------------------------------

def load_checkpoint_params(path, cfg: VLMConfig, dtype=torch.bfloat16,
                           init_if_missing: bool = False, seed: int = 0,
                           device="cpu"):
    """The param tree of a checkpoint directory, in ``dtype`` on
    ``device``: the port's run dir, else ``checkpoints/*.pt``, else
    safetensors. ``init_if_missing`` draws the weights on the CPU from
    ``seed`` (the same values whatever ``device``)."""
    path = Path(path)
    ckpt = _latest_checkpoint(path)
    if ckpt is not None:
        return _cast_tree(load_run_params(ckpt), dtype, device)
    pts = sorted(path.glob("checkpoints/*.pt"))
    if pts:
        return convert_prismatic_pt(pts[-1], cfg, dtype, device)
    if any(path.glob("*.safetensors")):
        return convert_hf_openvla_sd(load_dir(path), cfg, dtype, device)
    if init_if_missing:
        generator = torch.Generator("cpu")
        generator.manual_seed(seed)
        return _cast_tree(init_vlm_params(generator, cfg, dtype, "cpu"),
                          dtype, device)
    raise FileNotFoundError(f"no checkpoint under {path} (run dir, "
                            "checkpoints/*.pt or *.safetensors)")


def load(model_id_or_path, dtype: torch.dtype = torch.bfloat16,
         tokenizer_path: Optional[str] = None,
         quantize: Optional[str] = None, device="cuda", seed: int = 0,
         init_if_missing: bool = False, quantize_int8: bool = False):
    """Load a VLM. Returns (cfg, params, tokenizer, transforms, family).

    ``model_id_or_path``: a registered id (random weights drawn on
    ``device`` from ``seed``) or a checkpoint directory (see the module
    docstring). ``quantize``: None, "int8" (per-channel) or "int4"
    (nibble-packed group-128, read by the int4 kernel).
    ``quantize_int8=True`` is the back-compat spelling of
    ``quantize="int8"``; an explicit ``quantize`` wins.
    """
    if quantize_int8:
        quantize = quantize or "int8"
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"quantize={quantize!r}: expected 'int8' or 'int4'")
    device = resolve_device(device)
    path = Path(str(model_id_or_path))
    if path.is_dir():
        blob = json.loads((path / "config.json").read_text())
        vid, lid, arch, resize = _model_cfg_from_json(blob)
        cfg, family = build_vlm(vid, lid, arch)
        tc_vocab = blob.get("text_config", {}).get("vocab_size")
        if vid == "tiny" and tc_vocab and tc_vocab != cfg.llm.vocab_size:
            cfg = tiny_vlm_config(vocab_size=tc_vocab)
        if quantize is None:
            params = load_checkpoint_params(path, cfg, dtype,
                                            init_if_missing, seed, device)
        else:
            params = place_params(load_checkpoint_params(
                path, cfg, dtype, init_if_missing, seed), device, quantize)
    else:
        if str(model_id_or_path) not in MODEL_REGISTRY:
            raise KeyError(f"{model_id_or_path!r} is neither a directory "
                           f"nor a known model id; known: "
                           f"{sorted(MODEL_REGISTRY)}")
        entry = MODEL_REGISTRY[str(model_id_or_path)]
        vid, resize = (entry["vision_backbone_id"],
                       entry["image_resize_strategy"])
        cfg, family = build_vlm(vid, entry["llm_backbone_id"],
                                entry["arch_specifier"])
        generator = torch.Generator(device)
        generator.manual_seed(seed)
        params = init_vlm_params(generator, cfg, dtype, device)
        if quantize is not None:
            params = quantize_vlm_params(params,
                                         bits=4 if quantize == "int4" else 8)
    transforms = _transforms(cfg, vid, resize)
    return cfg, params, load_tokenizer(tokenizer_path), transforms, family


def read_stats(path):
    """(norm_stats, proprio_stats) of a checkpoint directory:
    ``norm_stats`` embedded in config.json (Hugging Face exports), then
    ``dataset_statistics.json`` (a dataset-keyed dict, or one proprio
    entry with ``Q1`` / ``Q99``), which wins where both exist."""
    norm_stats, proprio_stats = {}, None
    p = Path(str(path))
    if not p.is_dir():
        return norm_stats, proprio_stats
    if (p / "config.json").exists():
        cfg_blob = json.loads((p / "config.json").read_text())
        if isinstance(cfg_blob.get("norm_stats"), dict):
            norm_stats = cfg_blob["norm_stats"]
            for entry in norm_stats.values():
                if isinstance(entry, dict) and "Q1" in entry:
                    proprio_stats = entry
    stats_file = p / "dataset_statistics.json"
    if stats_file.exists():
        blob = json.loads(stats_file.read_text())
        if "Q1" in blob or "Q99" in blob:
            proprio_stats = blob
        else:
            norm_stats = blob
            for entry in blob.values():
                if isinstance(entry, dict) and "Q1" in entry:
                    proprio_stats = entry
    return norm_stats, proprio_stats


def load_vla(model_id_or_path, dtype: torch.dtype = torch.bfloat16,
             tokenizer_path: Optional[str] = None, attn_impl: str = "auto",
             quantize: Optional[str] = None, device="cuda", seed: int = 0,
             norm_stats: Optional[dict] = None,
             proprio_stats: Optional[dict] = None,
             speculative: bool = False, init_if_missing: bool = False,
             quantize_int8: bool = False):
    """Load a VLA policy -> ``EmmaXVLA`` (see :func:`load`). A checkpoint
    directory's statistics come from its sidecars unless ``norm_stats`` /
    ``proprio_stats`` are given; ``speculative`` serves it on the
    closed-loop ``SpeculativeEngine``."""
    from emmax_torch.models.vla import EmmaXVLA

    cfg, params, tokenizer, transforms, family = load(
        model_id_or_path, dtype=dtype, tokenizer_path=tokenizer_path,
        quantize=quantize, device=device, seed=seed,
        init_if_missing=init_if_missing, quantize_int8=quantize_int8)
    file_norm, file_proprio = read_stats(model_id_or_path)
    return EmmaXVLA(cfg, params, tokenizer, transforms,
                    norm_stats=norm_stats if norm_stats is not None
                    else file_norm,
                    proprio_stats=proprio_stats if proprio_stats is not None
                    else file_proprio,
                    llm_family=family, attn_impl=attn_impl,
                    speculative=speculative, device=device)
