"""Weight conversion CLI: reference checkpoints <-> the port's run dirs.

Port of ``vla-scripts/extern/convert_weights.py``:

- ``--mode import_pt``: a reference Prismatic / OpenVLA ``.pt`` -> a run
  dir (``models.load.save_pretrained``);
- ``--mode import_hf``: a Hugging Face dir (OpenVLA safetensors naming,
  sharded or not) -> a run dir;
- ``--mode export_pt``: a run dir -> a reference-layout ``.pt``;
- ``--mode export_hf``: a run dir -> the Hub surface the JAX exporter
  writes: ``model.safetensors`` (or shards of at most 5 GB with
  ``model.safetensors.index.json``) in the OpenVLA naming; ``config.json``
  as ``EmmaXVLAConfig(...).save_pretrained`` writes it, with ``auto_map``
  and ``norm_stats`` (a flat blob for the tiny or an unregistered
  backbone, as in JAX); ``preprocessor_config.json``; the self-contained
  ``modeling_emmax.py`` (``extern/standalone.py``) with
  ``configuration_emmax.py`` and ``processing_emmax.py`` beside it; and a
  copy of ``csrc/``, from which the bundle builds its kernels on the card.
  None of it needs ``transformers``. ``emmax_tpu.models.load`` and
  ``emmax_torch.models.load`` both read the directory.

    python -m emmax_torch.convert_weights --mode import_pt \\
        --src checkpoints/step-....pt --dst runs/imported \\
        --base_vlm prism-dinosiglip-224px+7b
    python -m emmax_torch.convert_weights --mode export_hf \\
        --src runs/<run> --dst export/ --dataset_statistics stats.json
"""

from __future__ import annotations

import json
import logging
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from emmax_torch.conf import parse_config

log = logging.getLogger("emmax_torch.convert_weights")


@dataclass
class ConvertConfig:
    mode: str = "import_pt"    # import_pt | export_pt | import_hf | export_hf
    export_dtype: str = "bfloat16"  # export_hf tensor dtype
    src: Path = Path("checkpoint.pt")
    dst: Path = Path("runs/imported")
    base_vlm: str = "prism-dinosiglip-224px+7b"
    dataset_statistics: Optional[Path] = None


def vlm_ids(base_vlm: str) -> dict:
    """The backbone ids of a VLM id ("tiny": the test scale)."""
    if base_vlm == "tiny":
        return {"vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
                "arch_specifier": "fused-gelu-mlp",
                "image_resize_strategy": "resize-naive"}
    from emmax_torch.conf.models import ModelConfig

    mc = ModelConfig.get_choice_class(base_vlm)()
    return {"vision_backbone_id": mc.vision_backbone_id,
            "llm_backbone_id": mc.llm_backbone_id,
            "arch_specifier": mc.arch_specifier,
            "image_resize_strategy": mc.image_resize_strategy}


def _vlm_cfg(base_vlm: str):
    from emmax_torch.models.load import build_vlm

    ids = vlm_ids(base_vlm)
    cfg, _ = build_vlm(ids["vision_backbone_id"], ids["llm_backbone_id"],
                       ids["arch_specifier"])
    return cfg, ids


def _stats(cfg: ConvertConfig) -> Optional[dict]:
    if cfg.dataset_statistics is None:
        return None
    return json.loads(Path(cfg.dataset_statistics).read_text())


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} (e.g. bfloat16, float16, "
                         "float32)")
    return dt


def save_reference_pt(params, vlm_cfg, out, dtype=None) -> Path:
    """``params`` -> ``torch.save({"model": {"projector", "llm_backbone",
    "vision_backbone"}})`` at ``out``, in ``dtype`` or each leaf's own."""
    from emmax_torch.models.convert import params_to_prismatic_sd

    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": params_to_prismatic_sd(params, vlm_cfg, dtype)},
               out)
    return out


def write_hf_config(out, vlm_cfg, ids: dict, norm_stats=None,
                    dtype=torch.bfloat16) -> Path:
    """``config.json``: ``EmmaXVLAConfig``'s ``save_pretrained`` layout
    with ``auto_map``, or for a backbone the Hub config does not know (the
    tiny one) the flat blob that both loaders read."""
    from emmax_torch.extern.hf_config import AUTO_MAP, write_config_json

    dtype_name = str(dtype).removeprefix("torch.")
    text_config = {"vocab_size": vlm_cfg.llm.vocab_size, "pad_token_id": 32000}
    try:
        return write_config_json(
            out, vision_backbone_id=ids["vision_backbone_id"],
            llm_backbone_id=ids["llm_backbone_id"],
            arch_specifier=ids["arch_specifier"],
            image_resize_strategy=ids["image_resize_strategy"],
            text_config=text_config, norm_stats=norm_stats,
            torch_dtype=dtype_name, auto_map=AUTO_MAP)
    except ValueError:
        blob = {"model_type": "emmax-openvla", **ids,
                "torch_dtype": dtype_name, "auto_map": AUTO_MAP,
                "text_config": text_config}
        if norm_stats is not None:
            blob["norm_stats"] = norm_stats
        path = Path(out) / "config.json"
        path.write_text(json.dumps(blob, indent=2))
        return path


REMOTE_CODE_STUB = '''\
"""Remote-code entry for `{auto}`: re-exports from the self-contained
`modeling_emmax.py` bundled in this directory (no package install needed)."""

try:  # HF dynamic-module loading imports these as a package
    from .modeling_emmax import {name}  # noqa: F401
except ImportError:  # plain sys.path import from the export dir
    from modeling_emmax import {name}  # noqa: F401
'''


def write_hub_files(out, vlm_cfg, ids: dict) -> None:
    """``preprocessor_config.json``, ``modeling_emmax.py`` (the bundle),
    ``configuration_emmax.py``, ``processing_emmax.py`` and ``csrc/``."""
    import shutil

    from emmax_torch.extern.hf_processor import (EmmaXImagePipeline,
                                                 EmmaXProcessor)
    from emmax_torch.extern.standalone import PKG_ROOT, build_standalone_source
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    out = Path(out)
    try:
        images = EmmaXImagePipeline.for_backbone(
            ids["vision_backbone_id"], ids["image_resize_strategy"])
    except KeyError:   # the tiny towers: sizes from the VLM config
        images = EmmaXImagePipeline(
            tower_names=[n for n, _ in vlm_cfg.vision],
            input_sizes=[v.img_size for _, v in vlm_cfg.vision],
            image_resize_strategy=ids["image_resize_strategy"])
    EmmaXProcessor(images, ByteLevelTokenizer()).save_pretrained(out)
    (out / "modeling_emmax.py").write_text(build_standalone_source())
    for fname, (auto, name) in {
            "configuration_emmax.py": ("AutoConfig", "EmmaXVLAConfig"),
            "processing_emmax.py": ("AutoProcessor", "EmmaXProcessor")}.items():
        (out / fname).write_text(REMOTE_CODE_STUB.format(auto=auto,
                                                         name=name))
    shutil.copytree(PKG_ROOT / "csrc", out / "csrc", dirs_exist_ok=True)


def save_hf(params, vlm_cfg, ids: dict, out, norm_stats=None,
            dtype=torch.bfloat16, max_shard_bytes: float = 5e9) -> list:
    """``params`` -> a Hugging Face dir in the OpenVLA naming: safetensors
    shards (with the index when there are several), ``config.json``
    (:func:`write_hf_config`), and the processor and remote-code files
    (:func:`write_hub_files`). Returns the shard paths."""
    from emmax_torch.models.convert import params_to_hf_sd
    from emmax_torch.models.safetensors_io import save_dir

    out = Path(out)
    sd = params_to_hf_sd(params, vlm_cfg, dtype)
    shards = save_dir(sd, out, max_shard_bytes)
    write_hf_config(out, vlm_cfg, ids, norm_stats, dtype)
    write_hub_files(out, vlm_cfg, ids)
    return shards


def _run_params(src: Path):
    from emmax_torch.models.load import _latest_checkpoint, load_run_params

    ckpt = _latest_checkpoint(Path(src))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoints under {src}")
    return load_run_params(ckpt)


def _import(cfg: ConvertConfig, params, ids) -> None:
    from emmax_torch.models.load import save_pretrained

    out = save_pretrained(cfg.dst, {**ids, "source_checkpoint": str(cfg.src)},
                          params, dataset_statistics=_stats(cfg))
    log.info("imported %s -> %s", cfg.src, out)


def import_pt(cfg: ConvertConfig) -> None:
    from emmax_torch.models.load import convert_prismatic_pt

    vlm_cfg, ids = _vlm_cfg(cfg.base_vlm)
    _import(cfg, convert_prismatic_pt(cfg.src, vlm_cfg, torch.bfloat16), ids)


def import_hf(cfg: ConvertConfig) -> None:
    from emmax_torch.models.convert import convert_hf_openvla_sd
    from emmax_torch.models.safetensors_io import load_dir

    vlm_cfg, ids = _vlm_cfg(cfg.base_vlm)
    _import(cfg, convert_hf_openvla_sd(load_dir(cfg.src), vlm_cfg,
                                       torch.bfloat16), ids)


def export_pt(cfg: ConvertConfig) -> None:
    vlm_cfg, _ = _vlm_cfg(cfg.base_vlm)
    out = save_reference_pt(_run_params(cfg.src), vlm_cfg, cfg.dst)
    log.info("exported %s -> %s", cfg.src, out)


def export_hf(cfg: ConvertConfig) -> None:
    vlm_cfg, ids = _vlm_cfg(cfg.base_vlm)
    shards = save_hf(_run_params(cfg.src), vlm_cfg, ids, cfg.dst,
                     norm_stats=_stats(cfg), dtype=_dtype(cfg.export_dtype))
    log.info("exported %s -> %s (%d shard(s), %s)", cfg.src, cfg.dst,
             len(shards), cfg.export_dtype)


MODES = {"import_pt": import_pt, "import_hf": import_hf,
         "export_pt": export_pt, "export_hf": export_hf}


def main(argv) -> None:
    cfg = parse_config(ConvertConfig, argv)
    if cfg.mode not in MODES:
        raise SystemExit(f"unknown --mode {cfg.mode!r} (choose from "
                         f"{sorted(MODES)})")
    MODES[cfg.mode](cfg)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main(sys.argv[1:])
