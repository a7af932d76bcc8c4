"""Prismatic VLM pretraining (align -> finetune) in PyTorch: the port of
``scripts/pretrain.py``.

The same config surface (``--model.type <id>`` / ``--dataset.type <id>``
plus dotted overrides), stage hyperparameters from the ``ModelConfig``
registry (``{stage}_learning_rate``, ... ``{stage}_train_strategy``), run
directory (``config.json`` beside checkpoints named
``step-XXXXXX-epoch-XX-loss=X.XXXX``, every 2500 steps and at each
epoch's end) and stage semantics: ``align`` trains the projector on
LLaVA's caption set, ``finetune`` the projector and the LLM on an
instruct mix, both through split-modality batches of mixed text-only and
multimodal rows (``SplitModalityLoader`` -> ``collate_lm`` ->
``run_training``). It runs on the card unless ``--device cpu`` is given,
and raises without one. Weights are random from ``--seed`` or come from
``--pretrained_checkpoint``: a run directory of this port (the align
stage's output feeding the finetune stage) or a reference Prismatic
``.pt`` (JAX orbax directories are not read).

``--cache_vision true`` (align only): the frozen towers' features are
computed once per image and served from a host store afterwards
(``training/vision_cache.py``); the store holds at most
``VISION_CACHE_HOST_BYTES`` of features, and once the first epoch has
encoded every sample and dropped none, the loader lets go of the towers.

Under ``python -m torch.distributed.run --nproc_per_node N`` each process
drives one card on the mesh of ``{stage}_train_strategy``; each data rank
reads its own batches and rank 0 writes the run directory.

    python -m emmax_torch.pretrain --model.type prism-dinosiglip-224px+7b \\
        --stage align --dataset.dataset_root_dir data/prismatic-vlms
    python -m emmax_torch.pretrain --smoke_test true --device cpu \\
        --stage align --run_root_dir /tmp/pt
    python -m emmax_torch.pretrain --smoke_test true --device cpu \\
        --stage finetune --run_root_dir /tmp/pt \\
        --pretrained_checkpoint /tmp/pt/prism-dinosiglip-224px+7b+stage-align+x7
"""

from __future__ import annotations

import logging
import os
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from emmax_torch.conf import (DatasetConfig, ModelConfig, config_to_dict,
                              parse_config)
from emmax_torch.overwatch import initialize_overwatch

log = initialize_overwatch("emmax_torch.pretrain")

# the host bytes the align stage's feature store may hold: a third of a
# 96 GiB host (a DINOv2 + SigLIP entry is 256 x 2176 bf16 values, 1.1 MB)
VISION_CACHE_HOST_BYTES = 32 << 30


@dataclass
class PretrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    stage: str = "finetune"                 # align | finetune
    run_root_dir: Path = Path("runs")
    run_id: Optional[str] = None
    pretrained_checkpoint: Optional[Path] = None  # e.g. the align run dir
    seed: int = 7
    tokenizer_path: Optional[str] = None
    attn_impl: str = "auto"
    max_steps: Optional[int] = None
    smoke_test: bool = False
    trackers: str = "jsonl"
    # align only: cache the frozen towers' features across epochs
    cache_vision: bool = False
    device: str = "cuda"


@dataclass
class Pretraining:
    """A built stage, ready for :func:`run`."""

    cfg: PretrainConfig
    vlm_cfg: Any
    run_dir: Path
    device: Any
    mesh: Any
    transforms: Dict
    loader: Any            # the SplitModalityLoader (cached: wrapped)
    state: Any
    train_step: Callable
    metrics: Any
    ckpt: Any
    loop_cfg: Any
    lr_fn: Callable
    cache: Any = None      # the CachedVisionLoader, with --cache_vision
    data_dir: Optional[tempfile.TemporaryDirectory] = None   # smoke data


class _ReleaseAfterFirstEpoch:
    """The cached loader; once epoch 0 has been read through, its towers
    are released if that epoch encoded every sample (one data rank reads
    every example each epoch) and the store dropped none: later epochs
    are all hits."""

    def __init__(self, cache, every_sample: bool) -> None:
        self.cache = cache
        self.every_sample = every_sample

    def epoch(self, epoch: int = 0):
        yield from self.cache.epoch(epoch)
        if epoch == 0 and self.every_sample and self.cache.evicted == 0:
            self.cache.release_towers()
            log.info("vision cache: every sample encoded; towers released")

    def __len__(self) -> int:
        return len(self.cache)


def _initial_params(cfg: PretrainConfig, vlm_cfg, device):
    """fp32 masters: ``--pretrained_checkpoint`` (a port run dir or a
    reference ``.pt``), else random from ``--seed``."""
    import torch

    ckpt = cfg.pretrained_checkpoint
    if ckpt is not None:
        from emmax_torch.models.load import (convert_prismatic_pt,
                                             load_checkpoint_params)

        log.info(f"starting from {ckpt}")
        if Path(ckpt).is_file():
            return convert_prismatic_pt(ckpt, vlm_cfg, torch.float32, device)
        return load_checkpoint_params(ckpt, vlm_cfg, torch.float32,
                                      device=device)
    from emmax_torch.models.vlm import init_vlm_params

    generator = torch.Generator(device)
    generator.manual_seed(cfg.seed)
    return init_vlm_params(generator, vlm_cfg, torch.float32, device)


def build(cfg: PretrainConfig, *, image_loader=None,
          vlm_cfg=None) -> Pretraining:
    """Everything the stage needs, from ``cfg``. ``image_loader(root,
    rel)`` replaces the datasets' OpenCV decoder, and ``vlm_cfg`` the
    model's config (a cut of its depth), for callers that drive the
    stage in-process."""
    import torch

    from emmax_torch.data.collators import SplitModalityLoader, collate_lm
    from emmax_torch.data.pretrain import (AlignDataset, FinetuneDataset,
                                           _load_image,
                                           make_synthetic_chat_json)
    from emmax_torch.models.load import build_vlm
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.ops.image import ImageTransformConfig
    from emmax_torch.parallel import (initialize_distributed, make_mesh,
                                      shard_params)
    from emmax_torch.parallel.mesh import strategy_to_mesh_shape
    from emmax_torch.parallel.sharding import (data_extent, data_index,
                                               mesh_device)
    from emmax_torch.serving.engine import resolve_device
    from emmax_torch.training.checkpointing import (CheckpointManager,
                                                    write_sidecars)
    from emmax_torch.training.loop import LoopConfig
    from emmax_torch.training.metrics import Metrics, build_trackers
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer, load_tokenizer

    m = cfg.model
    if cfg.stage not in ("align", "finetune"):
        raise ValueError(f"--stage {cfg.stage!r}: expected align or finetune")
    lr = getattr(m, f"{cfg.stage}_learning_rate")
    wd = getattr(m, f"{cfg.stage}_weight_decay")
    mgn = getattr(m, f"{cfg.stage}_max_grad_norm")
    sched = getattr(m, f"{cfg.stage}_lr_scheduler_type")
    warmup = getattr(m, f"{cfg.stage}_warmup_ratio")
    epochs = getattr(m, f"{cfg.stage}_epochs")
    gbs = getattr(m, f"{cfg.stage}_global_batch_size")
    strategy = getattr(m, f"{cfg.stage}_train_strategy")

    device = resolve_device(cfg.device)
    initialize_distributed(device_type=device.type)
    mesh = None
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
        shape = strategy_to_mesh_shape(strategy, world, hosts)
        mesh = make_mesh(shape, device_type=device.type)
        device = mesh_device(mesh)
        log.info(f"mesh {dict(zip(mesh.mesh_dim_names, shape))}")
    writer = mesh is None or mesh.get_rank() == 0

    run_id = cfg.run_id or f"{m.model_id}+stage-{cfg.stage}+x{cfg.seed}"
    run_dir = Path(cfg.run_root_dir) / run_id
    data_dir = None
    blob = {"model": config_to_dict(m), "stage": cfg.stage, "run_id": run_id}
    if cfg.smoke_test:
        vlm_cfg = tiny_vlm_config(vocab_size=512)
        tokenizer = ByteLevelTokenizer(vocab_size=512)
        transforms = {name: ImageTransformConfig(size=v.img_size)
                      for name, v in vlm_cfg.vision}
        data_dir = tempfile.TemporaryDirectory(prefix="emmax_pretrain_")
        ann, imgs = (Path(data_dir.name) / "chat.json",
                     Path(data_dir.name) / "img")
        make_synthetic_chat_json(ann, 16, image_dir=imgs)
        gbs, epochs = 8, 1
        # the checkpoints hold the tiny model: say so where models.load
        # reads the run dir's config
        blob["model"] = {"vision_backbone_id": "tiny",
                         "llm_backbone_id": "tiny",
                         "arch_specifier": vlm_cfg.arch_specifier,
                         "image_resize_strategy": "resize-naive"}
    else:
        if vlm_cfg is None:
            vlm_cfg, _ = build_vlm(m.vision_backbone_id, m.llm_backbone_id,
                                   m.arch_specifier)
        transforms = get_image_transforms(m.vision_backbone_id,
                                          m.image_resize_strategy)
        tokenizer = load_tokenizer(cfg.tokenizer_path)
        components = (cfg.dataset.align_stage_components
                      if cfg.stage == "align"
                      else cfg.dataset.finetune_stage_components)
        ann = Path(cfg.dataset.dataset_root_dir) / components[0]
        imgs = Path(cfg.dataset.dataset_root_dir) / components[1]

    image_loader = image_loader or _load_image
    dataset = (AlignDataset(ann, imgs, tokenizer, image_loader=image_loader)
               if cfg.stage == "align" else
               FinetuneDataset(ann, imgs, tokenizer,
                               image_loader=image_loader))
    n_data = data_extent(mesh) if mesh is not None else 1
    loader = SplitModalityLoader(
        dataset, max(gbs // n_data, 1),
        lambda s: collate_lm(s, tokenizer.pad_id), seed=cfg.seed,
        num_shards=n_data,
        shard_index=data_index(mesh) if mesh is not None else 0)

    params = _initial_params(cfg, vlm_cfg, device)
    total_steps = cfg.max_steps or epochs * max(len(loader), 1)
    tx, schedule = make_optimizer(params, learning_rate=lr, weight_decay=wd,
                                  max_grad_norm=mgn, lr_scheduler_type=sched,
                                  warmup_ratio=warmup,
                                  total_steps=total_steps, stage=cfg.stage)
    if mesh is not None:
        params = shard_params(params, mesh)
    state = create_train_state(params, tx)
    ckpt = CheckpointManager(run_dir, mesh=mesh)
    if writer:
        write_sidecars(run_dir, blob)

    compute_dtype = torch.float32 if cfg.smoke_test else (
        torch.bfloat16 if m.enable_mixed_precision_training
        else torch.float32)
    step_fn = make_train_step(
        vlm_cfg, tx, mesh=mesh, attn_impl=cfg.attn_impl,
        remat=m.enable_gradient_checkpointing, compute_dtype=compute_dtype,
        transforms=transforms, stop_vision_gradient=(cfg.stage == "align"),
        freeze_mask=trainable_mask(state.params, cfg.stage))

    cache = None
    if cfg.cache_vision and cfg.stage == "align":
        from emmax_torch.training.vision_cache import CachedVisionLoader

        entry_bytes = (vlm_cfg.num_patches * vlm_cfg.vision_dim
                       * torch.empty((), dtype=compute_dtype).element_size())
        cache = CachedVisionLoader(
            loader, state.params, vlm_cfg, transforms,
            attn_impl=cfg.attn_impl, compute_dtype=compute_dtype,
            capacity=max(VISION_CACHE_HOST_BYTES // entry_bytes, 1),
            device=device, mesh=mesh)
        loader = _ReleaseAfterFirstEpoch(cache, every_sample=n_data == 1)

    metrics = Metrics(build_trackers(
        cfg.trackers.split(",") if writer else [], run_id, run_dir))
    return Pretraining(
        cfg=cfg, vlm_cfg=vlm_cfg, run_dir=run_dir, device=device, mesh=mesh,
        transforms=transforms, loader=loader, state=state,
        train_step=step_fn, metrics=metrics, ckpt=ckpt,
        loop_cfg=LoopConfig(epochs=epochs, max_steps=cfg.max_steps,
                            save_every=2500),
        lr_fn=schedule, cache=cache, data_dir=data_dir)


def run(p: Pretraining):
    """Train the built stage to its end; returns the final state."""
    from emmax_torch.training.loop import run_training

    try:
        state = run_training(
            vlm_cfg=p.vlm_cfg, state=p.state, train_step=p.train_step,
            loader=p.loader, metrics=p.metrics, loop_cfg=p.loop_cfg,
            device=p.device, mesh=p.mesh, ckpt_manager=p.ckpt,
            lr_fn=p.lr_fn)
        p.metrics.finalize()
    finally:
        if p.data_dir is not None:
            p.data_dir.cleanup()
    log.info(f"{p.cfg.stage} stage done at step {state.step}; run dir "
             f"{p.run_dir}")
    return state


def main(cfg: PretrainConfig):
    return run(build(cfg))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main(parse_config(PretrainConfig, sys.argv[1:],
                      choice_fields={"model": ModelConfig,
                                     "dataset": DatasetConfig}))
