"""The discrete VLA training loop, port of the part of
``emmax_tpu/training/loop.py`` that Emma-X fine-tuning runs
(``run_discrete_vla_training``): an epoch loop over the GCOT batches with

- the train step,
- teacher-forced Solver evaluation every ``eval_every`` steps,
- checkpoints every ``save_every`` steps, at ``max_steps`` and at each
  epoch's end (with the optimizer state),
- metrics committed per step and pushed to the trackers.

Under a mesh every rank runs the loop on its own rows
(``parallel.shard_batch``); the step's metrics are the global batch's,
the Solver evaluates each rank's rows, and rank 0 logs and writes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from emmax_torch.data.prefetch import to_device
from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.models.vlm import VLMConfig, vlm_forward
from emmax_torch.overwatch import initialize_overwatch
from emmax_torch.parallel.sharding import shard_batch
from emmax_torch.training.metrics import VLADiscreteMetrics
from emmax_torch.training.train_step import cast_params

log = initialize_overwatch(__name__)


@dataclasses.dataclass
class LoopConfig:
    epochs: int = 1
    max_steps: Optional[int] = None
    eval_every: int = 200
    save_every: int = 1000
    log_every: int = 10


def make_eval_fn(cfg: VLMConfig, *, transforms=None, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """Teacher-forced greedy predictions [B, F] for a batch (this rank's
    rows under a ``mesh``)."""

    @torch.no_grad()
    def eval_fn(params, batch):
        cparams = cast_params(params, compute_dtype)
        if "pixel_values" in batch:
            pv = batch["pixel_values"]
        else:
            from emmax_torch.ops.image import preprocess_for_towers

            pv = {k: v.to(compute_dtype) for k, v in
                  preprocess_for_towers(batch["images"], transforms).items()}
        logits, _, _ = vlm_forward(cparams, cfg, batch["input_ids"], pv,
                                   mask=batch["attention_mask"],
                                   attn_impl=attn_impl, mesh=mesh)
        return logits.float().argmax(dim=-1)

    return eval_fn


def teacher_forced_texts(preds: np.ndarray, labels: np.ndarray,
                         num_patches: int, tokenizer):
    """(ground truth, prediction) texts at the supervised positions.

    ``preds`` covers the fused sequence [bos | patches | text[1:]];
    ``labels`` is the unfused [B, L] array. Fused position ``t`` predicts
    position ``t + 1``; a supervised position 0 has no predictor and is
    dropped.
    """
    gt_texts, pred_texts = [], []
    for b in range(labels.shape[0]):
        fused_labels = np.concatenate(
            [labels[b, :1], np.full(num_patches, IGNORE_INDEX), labels[b, 1:]])
        idx = np.nonzero(fused_labels != IGNORE_INDEX)[0]
        idx = idx[idx > 0]
        gt_texts.append(tokenizer.decode(fused_labels[idx].tolist()))
        pred_texts.append(tokenizer.decode(preds[b, idx - 1].tolist()))
    return gt_texts, pred_texts


def run_discrete_vla_training(*, vlm_cfg: VLMConfig, state,
                              train_step: Callable, loader,
                              metrics: VLADiscreteMetrics,
                              loop_cfg: LoopConfig, device="cpu",
                              mesh=None, tokenizer=None, solver=None,
                              eval_fn: Optional[Callable] = None,
                              ckpt_manager=None,
                              lr_fn: Optional[Callable[[int], float]] = None,
                              start_step: int = 0, start_epoch: int = 0):
    """Returns the final state. ``loader.epoch(e)`` yields collated
    batches (numpy, or tensors already on ``device``); under a ``mesh``,
    this rank's rows, placed with ``shard_batch``."""
    step = start_step
    final_loss = float("nan")
    for epoch in range(start_epoch, loop_cfg.epochs):
        for batch in loader.epoch(epoch):
            batch = {k: v for k, v in batch.items()
                     if k != "multimodal_indices"}      # host-side only
            labels = batch["labels"]
            device_batch = (to_device(batch, device) if mesh is None
                            else shard_batch(batch, mesh))
            state, m = train_step(state, device_batch)
            step += 1
            names = sorted(m)
            vals = torch.stack([m[k].float() for k in names]).cpu().tolist()
            m = dict(zip(names, vals))                  # one device fetch
            final_loss = m["loss"]
            metrics.commit(loss=final_loss,
                           action_accuracy=m.get("action_accuracy", 0.0),
                           action_l1=m.get("action_l1", 0.0),
                           grad_norm=m.get("grad_norm", 0.0))

            lr = float(lr_fn(step)) if lr_fn is not None else 0.0
            if step % loop_cfg.log_every == 0:
                metrics.push(lr)
                log.info(metrics.status(epoch, lr))
            else:
                metrics.global_step += 1

            if (solver is not None and eval_fn is not None
                    and step % loop_cfg.eval_every == 0
                    and not isinstance(labels, (list, tuple))):
                host_labels = (labels.cpu().numpy()
                               if isinstance(labels, torch.Tensor)
                               else np.asarray(labels))
                preds = eval_fn(state.params, device_batch).cpu().numpy()
                gts, prs = teacher_forced_texts(
                    preds, host_labels, vlm_cfg.num_patches, tokenizer)
                _, a_acc, l1, rel_l1, _, _ = solver.evaluate_batch(gts, prs)
                metrics.commit(solver_action_accuracy=float(np.mean(a_acc)),
                               solver_l1=float(np.mean(l1)),
                               solver_relative_l1=float(np.mean(rel_l1)))
                log.info(f"[solver eval @ {step}] acc={np.mean(a_acc):.3f} "
                         f"L1={np.mean(l1):.4f}")

            if ckpt_manager is not None and step % loop_cfg.save_every == 0:
                ckpt_manager.save(state, step=step, epoch=epoch,
                                  loss=final_loss)
            if loop_cfg.max_steps is not None and step >= loop_cfg.max_steps:
                if ckpt_manager is not None:
                    ckpt_manager.save(state, step=step, epoch=epoch,
                                      loss=final_loss)
                return state
        if ckpt_manager is not None:
            ckpt_manager.save(state, step=step, epoch=epoch, loss=final_loss)
    return state
