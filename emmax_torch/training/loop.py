"""Training loops, port of ``emmax_tpu/training/loop.py``.

``run_discrete_vla_training`` (Emma-X fine-tuning) is an epoch loop over
the GCOT batches with

- the train step,
- teacher-forced Solver evaluation every ``eval_every`` steps,
- checkpoints every ``save_every`` steps, at ``max_steps`` and at each
  epoch's end (with the optimizer state),
- metrics committed per step and pushed to the trackers.

``run_vla_training`` is OpenVLA's RLDS loop: no epochs, a stream of
batches consumed for ``max_steps`` steps, with the same Solver eval and
checkpoint cadence.

``run_training`` is the VLM pretraining stages' loop (align / finetune):
split-modality batches with mixed text-only and multimodal rows, the
same checkpoints and metrics, no Solver. ``run_validation`` writes the
teacher-forced Solver scores of a validation loader to
``validation_results/epoch_{n}_{rank}.json``.

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


def _fetch(metrics) -> dict:
    """The step's 0-d device metrics as floats, in one device fetch."""
    names = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def _place(batch, device, mesh):
    """A host batch on ``device`` (under a ``mesh``, this rank's rows on
    its device); ``multimodal_indices`` stays on the host."""
    batch = {k: v for k, v in batch.items() if k != "multimodal_indices"}
    return to_device(batch, device) if mesh is None else shard_batch(batch,
                                                                     mesh)


def _vla_step(state, batch, step: int, epoch: int, *, vlm_cfg, train_step,
              metrics, loop_cfg: LoopConfig, device, mesh, tokenizer,
              solver, eval_fn, ckpt_manager, lr_fn):
    """One step of the VLA loops: the train step on the placed batch, the
    metrics, the Solver eval every ``eval_every`` steps and the checkpoint
    every ``save_every``. Returns (state, step, loss)."""
    labels = batch["labels"]
    device_batch = _place(batch, device, mesh)
    state, m = train_step(state, device_batch)
    step += 1
    m = _fetch(m)
    loss = m["loss"]
    metrics.commit(loss=loss, action_accuracy=m.get("action_accuracy", 0.0),
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
        ckpt_manager.save(state, step=step, epoch=epoch, loss=loss)
    return state, step, loss


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
    kw = dict(vlm_cfg=vlm_cfg, train_step=train_step, metrics=metrics,
              loop_cfg=loop_cfg, device=device, mesh=mesh,
              tokenizer=tokenizer, solver=solver, eval_fn=eval_fn,
              ckpt_manager=ckpt_manager, lr_fn=lr_fn)
    for epoch in range(start_epoch, loop_cfg.epochs):
        for batch in loader.epoch(epoch):
            state, step, final_loss = _vla_step(state, batch, step, epoch,
                                                **kw)
            if loop_cfg.max_steps is not None and step >= loop_cfg.max_steps:
                if ckpt_manager is not None:
                    ckpt_manager.save(state, step=step, epoch=epoch,
                                      loss=final_loss)
                return state
        if ckpt_manager is not None:
            ckpt_manager.save(state, step=step, epoch=epoch, loss=final_loss)
    return state


def run_vla_training(*, vlm_cfg: VLMConfig, state, train_step: Callable,
                     batch_iter, metrics, max_steps: int,
                     loop_cfg: Optional[LoopConfig] = None, device="cpu",
                     mesh=None, tokenizer=None, solver=None,
                     eval_fn: Optional[Callable] = None, ckpt_manager=None,
                     lr_fn: Optional[Callable[[int], float]] = None,
                     start_step: int = 0):
    """The RLDS stream loop: ``batch_iter`` yields collated batches
    (numpy, or tensors on ``device``, e.g. ``PrefetchingLoader(
    StreamingBatcher(...), device).epoch(0)``) forever; the loop steps
    until ``max_steps`` and saves a last checkpoint. Returns the final
    state."""
    loop_cfg = loop_cfg or LoopConfig()
    step = start_step
    final_loss = float("nan")
    for batch in batch_iter:
        state, step, final_loss = _vla_step(
            state, batch, step, 0, vlm_cfg=vlm_cfg, train_step=train_step,
            metrics=metrics, loop_cfg=loop_cfg, device=device, mesh=mesh,
            tokenizer=tokenizer, solver=solver, eval_fn=eval_fn,
            ckpt_manager=ckpt_manager, lr_fn=lr_fn)
        if step >= max_steps:
            break
    if ckpt_manager is not None:
        ckpt_manager.save(state, step=step, epoch=0, loss=final_loss)
    return state


def run_validation(*, vlm_cfg: VLMConfig, params, eval_fn, loader,
                   tokenizer, solver, run_dir, epoch: int = 0,
                   device="cpu", mesh=None) -> dict:
    """A validation pass: teacher-forced predictions of every batch with
    array labels, scored by the Solver, written with the (ground truth,
    prediction) records to ``run_dir/validation_results/
    epoch_{epoch}_{rank}.json`` (the rank of ``torch.distributed``, else
    0). Returns the summary."""
    import json
    from pathlib import Path

    records = []
    accs, l1s = [], []
    for batch in loader.epoch(epoch):
        labels = batch["labels"]
        if isinstance(labels, (list, tuple)):
            continue
        host_labels = (labels.cpu().numpy() if isinstance(labels,
                                                          torch.Tensor)
                       else np.asarray(labels))
        preds = eval_fn(params, _place(batch, device, mesh)).cpu().numpy()
        gts, prs = teacher_forced_texts(preds, host_labels,
                                        vlm_cfg.num_patches, tokenizer)
        _, a_acc, l1, _, _, _ = solver.evaluate_batch(gts, prs)
        accs.extend(a_acc)
        l1s.extend(l1)
        records.extend({"ground_truth": g, "prediction": p}
                       for g, p in zip(gts, prs))
    out_dir = Path(run_dir) / "validation_results"
    out_dir.mkdir(parents=True, exist_ok=True)
    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)
    summary = {"epoch": epoch, "action_accuracy": float(np.mean(accs or [0])),
               "l1": float(np.mean(l1s or [0])), "n": len(records)}
    with open(out_dir / f"epoch_{epoch}_{rank}.json", "w") as f:
        json.dump({"summary": summary, "records": records}, f, indent=2)
    log.info(f"[validation] {summary}")
    return summary


def run_training(*, vlm_cfg: VLMConfig, state, train_step: Callable,
                 loader, metrics, loop_cfg: LoopConfig, device="cpu",
                 mesh=None, ckpt_manager=None, lr_fn=None,
                 start_step: int = 0, start_epoch: int = 0):
    """The VLM align / finetune stage loop. ``loader.epoch(e)`` yields
    ``collate_lm`` batches (a ``SplitModalityLoader``, or a
    ``CachedVisionLoader`` around one): each batch's ``multimodal_mask``
    goes to the device with it (text-only rows take the unimodal merge in
    the step) and its ``multimodal_indices`` stays on the host. Logs the
    examples seen of each modality (this rank's rows) at the end. Returns
    the final state."""
    mm_seen = text_seen = 0
    step = start_step
    final_loss = float("nan")

    def seen() -> None:
        log.info(f"[run_training] examples seen: {mm_seen} multimodal / "
                 f"{text_seen} text-only")

    for epoch in range(start_epoch, loop_cfg.epochs):
        for batch in loader.epoch(epoch):
            if "multimodal_mask" in batch:
                mm = np.asarray(batch["multimodal_mask"])
                mm_seen += int(mm.sum())
                text_seen += int((~mm).sum())
            state, m = train_step(state, _place(batch, device, mesh))
            step += 1
            m = _fetch(m)
            final_loss = m["loss"]
            metrics.commit(loss=final_loss,
                           grad_norm=m.get("grad_norm", 0.0))
            lr = float(lr_fn(step)) if lr_fn is not None else 0.0
            if step % loop_cfg.log_every == 0:
                metrics.push(lr)
                log.info(metrics.status(epoch, lr))
            else:
                metrics.global_step += 1
            if ckpt_manager is not None and step % loop_cfg.save_every == 0:
                ckpt_manager.save(state, step=step, epoch=epoch,
                                  loss=final_loss)
            if loop_cfg.max_steps is not None and step >= loop_cfg.max_steps:
                if ckpt_manager is not None:
                    ckpt_manager.save(state, step=step, epoch=epoch,
                                      loss=final_loss)
                seen()
                return state
        if ckpt_manager is not None:
            ckpt_manager.save(state, step=step, epoch=epoch, loss=final_loss)
    seen()
    return state
