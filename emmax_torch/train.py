"""Emma-X VLA fine-tuning on one GPU (PyTorch): the port of
``vla-scripts/train.py``.

The same config surface (``--vla.type <id>`` plus dotted overrides), run
directory (``config.json`` and ``dataset_statistics.json`` sidecars,
checkpoints named ``step-XXXXXX-epoch-XX-loss=X.XXXX``) and training
semantics (GCOT dataset with its data mix, instruction masking, Solver
eval every ``eval_interval`` steps, checkpoints every ``save_interval``).
It runs on the card unless ``--device cpu`` is given, and raises without
one. Weights are random from ``--seed``, or, with
``--pretrained_checkpoint``, a reference Prismatic ``.pt`` converted into
fp32 masters (when not resuming).

    python -m emmax_torch.train \\
        --vla.type prism-dinosiglip-224px+mx-moveonly-moveguided-single-policy \\
        --data_root_dir data/gcot --frames_dir data/frames --run_root_dir runs
    python -m emmax_torch.train --smoke_test true --device cpu \\
        --vla.max_steps 2 --run_root_dir /tmp/smoke
"""

from __future__ import annotations

import json
import logging
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from emmax_torch.conf import VLAConfig, config_to_dict, parse_config

log = logging.getLogger("emmax_torch.train")


@dataclass
class TrainConfig:
    vla: VLAConfig = field(default_factory=VLAConfig)

    data_root_dir: Path = Path("data/gcot")            # GCOT JSON dir
    file_name: str = "second_version.json"
    run_root_dir: Path = Path("runs")
    rlds_data_dir: Optional[Path] = None               # not ported yet
    frames_dir: Optional[Path] = None                  # pre-extracted frames

    pretrained_checkpoint: Optional[Path] = None       # reference .pt
    is_resume: bool = False
    auto_resume: bool = True                           # pick up run-dir ckpts
    resume_step: Optional[int] = None
    resume_epoch: Optional[int] = None

    run_id_note: Optional[str] = None
    save_interval: int = 1000
    eval_interval: int = 200
    seed: int = 7

    tokenizer_path: Optional[str] = None
    attn_impl: str = "auto"            # auto | cuda | cuda_fused | torch
    mask_inst: bool = True
    smoke_test: bool = False                           # tiny model, synthetic data
    trackers: str = "jsonl"
    device: str = "cuda"


def initial_params(cfg: TrainConfig, vlm_cfg, device):
    """The fp32 master params a run starts from: the reference ``.pt`` at
    ``--pretrained_checkpoint`` converted with the stage's VLM config
    (unless resuming, which restores its own), else random from
    ``--seed``."""
    import torch

    if cfg.pretrained_checkpoint is not None and not cfg.is_resume:
        from emmax_torch.models.load import convert_prismatic_pt

        log.info("starting from %s", cfg.pretrained_checkpoint)
        return convert_prismatic_pt(cfg.pretrained_checkpoint, vlm_cfg,
                                    torch.float32, device)
    from emmax_torch.models.vlm import init_vlm_params

    generator = torch.Generator(device)
    generator.manual_seed(cfg.seed)
    return init_vlm_params(generator, vlm_cfg, torch.float32, device)


def main(cfg: TrainConfig):
    import torch

    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.gcot import (DirectoryFrameSource, GCOTDataset,
                                       SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.prefetch import PrefetchingLoader
    from emmax_torch.models.load import build_vlm
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.registry import MODEL_REGISTRY
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.ops.image import ImageTransformConfig
    from emmax_torch.serving.engine import resolve_device
    from emmax_torch.training.checkpointing import (CheckpointManager,
                                                    write_sidecars)
    from emmax_torch.training.loop import (LoopConfig, make_eval_fn,
                                           run_discrete_vla_training)
    from emmax_torch.training.metrics import (VLADiscreteMetrics,
                                              build_trackers)
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.solver import Solver
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer, load_tokenizer

    device = resolve_device(cfg.device)
    vla = cfg.vla
    run_id = f"{vla.vla_id}+n1+b{vla.global_batch_size}+x{cfg.seed}"
    if cfg.run_id_note:
        run_id += f"--{cfg.run_id_note}"
    run_dir = Path(cfg.run_root_dir) / run_id
    run_dir.mkdir(parents=True, exist_ok=True)

    # --- model + tokenizer ---
    if cfg.smoke_test:
        # >= 516 so the 256 action bins fit above the byte region
        tokenizer = ByteLevelTokenizer(vocab_size=1024)
        vlm_cfg = tiny_vlm_config(vocab_size=tokenizer.padded_vocab_size)
        transforms = {name: ImageTransformConfig(size=v.img_size)
                      for name, v in vlm_cfg.vision}
    else:
        base = str(vla.base_vlm)
        if base not in MODEL_REGISTRY:
            raise KeyError(f"base VLM {base!r} is not ported; known: "
                           f"{sorted(MODEL_REGISTRY)}")
        entry = MODEL_REGISTRY[base]
        vlm_cfg, _ = build_vlm(entry["vision_backbone_id"],
                               entry["llm_backbone_id"],
                               entry["arch_specifier"])
        transforms = get_image_transforms(entry["vision_backbone_id"],
                                          entry["image_resize_strategy"])
        tokenizer = load_tokenizer(cfg.tokenizer_path)
    action_tokenizer = ActionTokenizer(tokenizer)

    stats_path = Path(cfg.data_root_dir) / "dataset_statistics.json"
    dataset_statistics = (json.loads(stats_path.read_text())
                          if stats_path.exists() else None)

    # --- data ---
    if cfg.smoke_test:
        items = make_dummy_gcot_items(64)
        frame_source = SyntheticFrameSource(64)
    else:
        with open(Path(cfg.data_root_dir) / cfg.file_name) as f:
            items = json.load(f)
        if cfg.frames_dir is not None:
            frame_source = DirectoryFrameSource(cfg.frames_dir)
        elif cfg.rlds_data_dir is not None:
            raise ValueError("--rlds_data_dir: the RLDS frame source is not "
                             "ported yet; pass --frames_dir")
        else:
            raise ValueError("need --frames_dir")
    dataset = GCOTDataset(items, action_tokenizer, tokenizer, frame_source,
                          data_mix=vla.data_mix, mask_inst=cfg.mask_inst)
    loader = BatchLoader(
        dataset, max(vla.global_batch_size, 1),
        lambda s: collate_train(s, tokenizer.pad_id,
                                max_length=vlm_cfg.llm.max_seq_len),
        seed=cfg.seed)

    # --- params + optimizer ---
    params = initial_params(cfg, vlm_cfg, device)
    stage = stage_from_flags(vla.freeze_vision_backbone,
                             vla.freeze_llm_backbone,
                             vla.unfreeze_last_llm_layer)
    steps_per_epoch = max(len(loader), 1)
    total_steps = vla.max_steps or vla.epochs * steps_per_epoch
    tx, schedule = make_optimizer(
        params, learning_rate=vla.learning_rate,
        weight_decay=vla.weight_decay, max_grad_norm=vla.max_grad_norm,
        lr_scheduler_type=vla.lr_scheduler_type, total_steps=total_steps,
        warmup_ratio=vla.warmup_ratio, stage=stage)
    state = create_train_state(params, tx)

    ckpt = CheckpointManager(run_dir)
    start_step, start_epoch = 0, 0
    if cfg.auto_resume and not cfg.is_resume and ckpt.latest() is not None:
        log.info("auto-resuming from %s (disable with --auto_resume false)",
                 ckpt.latest().name)
        cfg.is_resume = True
    if cfg.is_resume:
        state = ckpt.restore(device=device)
        start_step = state.step
        start_epoch = start_step // steps_per_epoch
        if cfg.resume_step is not None and cfg.resume_step != start_step:
            raise ValueError(f"resume_step={cfg.resume_step} != checkpoint "
                             f"step {start_step}")

    blob = {"vla": config_to_dict(vla), "run_id": run_id, "seed": cfg.seed}
    if cfg.smoke_test:
        # the tiny model, not vla.base_vlm, is what the checkpoints hold:
        # say so where models.load reads it first
        blob["model"] = {"vision_backbone_id": "tiny",
                         "llm_backbone_id": "tiny",
                         "arch_specifier": vlm_cfg.arch_specifier,
                         "image_resize_strategy": "resize-naive"}
        blob["text_config"] = {"vocab_size": vlm_cfg.llm.vocab_size}
    write_sidecars(run_dir, blob, dataset_statistics)

    # --- train ---
    compute_dtype = (torch.bfloat16 if vla.enable_mixed_precision_training
                     and not cfg.smoke_test else torch.float32)
    step_fn = make_train_step(
        vlm_cfg, tx, attn_impl=cfg.attn_impl,
        remat=(False if (not vla.enable_gradient_checkpointing
                         or vla.remat_policy == "none")
               else "dots" if vla.remat_policy == "dots" else True),
        compute_dtype=compute_dtype, transforms=transforms,
        stop_vision_gradient=vla.freeze_vision_backbone,
        freeze_mask=trainable_mask(state.params, stage),
        action_vocab_size=tokenizer.vocab_size)
    metrics = VLADiscreteMetrics(build_trackers(
        cfg.trackers.split(","), run_id, run_dir,
        hparams=config_to_dict(vla)))
    for t in metrics.trackers:
        t.write_hyperparameters(config_to_dict(vla))
    eval_fn = make_eval_fn(vlm_cfg, transforms=transforms,
                           attn_impl=cfg.attn_impl,
                           compute_dtype=compute_dtype)
    state = run_discrete_vla_training(
        vlm_cfg=vlm_cfg, state=state, train_step=step_fn,
        loader=PrefetchingLoader(loader, device), metrics=metrics,
        loop_cfg=LoopConfig(epochs=vla.epochs, max_steps=vla.max_steps,
                            eval_every=cfg.eval_interval,
                            save_every=cfg.save_interval),
        device=device, tokenizer=tokenizer, solver=Solver(action_tokenizer),
        eval_fn=eval_fn, ckpt_manager=ckpt, lr_fn=schedule,
        start_step=start_step, start_epoch=start_epoch)
    metrics.finalize()
    log.info("done; final step %d; run dir %s", state.step, run_dir)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main(parse_config(TrainConfig, sys.argv[1:],
                      choice_fields={"vla": VLAConfig}))
