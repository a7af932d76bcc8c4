"""The VLA train step.

Port of ``emmax_tpu/training/train_step.py``: forward (fp32 master
params, computed in ``compute_dtype``), masked CE, backward, clip, AdamW,
and the in-loop action-token metrics the reference derives from logits
(accuracy, and L1 between the continuous decodes of predicted and target
action tokens).

Leaves that the freeze mask leaves entirely frozen are not
differentiated (``requires_grad=False``): no gradient the size of a frozen
7B backbone is ever built. Their cast to ``compute_dtype`` happens without
autograd, once per step; a trainable leaf's cast is recorded, so its
gradient reaches the fp32 master in fp32.

``mesh`` (the JAX package's ``jit_train_step(mesh=)``): the state holds
each rank's blocks (``parallel.shard_params``) and the batch each rank's
rows (``parallel.shard_batch``). The forward gathers weights at use, the
loss and metrics are the global batch's, and after the backward each
gradient is summed over the data axes its leaf is not split on, so the
step equals the single-device step on the global batch
(``parallel/gather.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.models.tree import leaves_with_path, map_with_path, tree_map
from emmax_torch.models.vlm import VLMConfig, vlm_forward
from emmax_torch.parallel.gather import global_mean, reduce_gradients
from emmax_torch.parallel.sharding import spec_of, with_spec
from emmax_torch.training.train_state import (Optimizer, TrainState,
                                              global_norm, is_frozen)


def action_token_metrics(logits: torch.Tensor, labels: torch.Tensor, *,
                         vocab_size: int, n_bins: int = 256, mesh=None):
    """Accuracy and L1 over action-token label positions. ``logits``
    cover the fused sequence; ``labels`` are fused to match. Under a
    ``mesh``, over the global batch."""
    preds = logits[:, :-1].float().argmax(dim=-1)
    return action_token_metrics_from_preds(preds, labels,
                                           vocab_size=vocab_size,
                                           n_bins=n_bins, mesh=mesh)


def action_token_metrics_from_preds(preds: torch.Tensor,
                                    labels: torch.Tensor, *,
                                    vocab_size: int, n_bins: int = 256,
                                    mesh=None):
    """The same metrics from greedy preds [B, L-1] (positions 0..L-2), for
    the chunked CE path, which never holds the logits."""
    targets = labels[:, 1:]
    begin = vocab_size - (n_bins + 1)
    action_mask = (targets > begin) & (targets != IGNORE_INDEX)
    correct = (preds == targets) & action_mask
    count = action_mask.sum()
    acc = global_mean(correct.sum(), count, mesh)
    bins = torch.linspace(-1.0, 1.0, n_bins, device=preds.device)
    centers = (bins[:-1] + bins[1:]) / 2.0

    def to_cont(ids):
        return centers[torch.clamp(vocab_size - ids - 1, 0, n_bins - 2)]

    l1 = torch.where(action_mask,
                     (to_cont(preds) - to_cont(targets)).abs(), 0.0)
    return acc, global_mean(l1.sum(), count, mesh)


def cast_params(params, dtype: torch.dtype):
    """Every floating leaf in ``dtype``; a placed block keeps its spec."""
    def cast(a):
        if not a.is_floating_point():
            return a
        return with_spec(a.to(dtype), spec_of(a))

    return tree_map(cast, params)


def make_grad_fn(cfg: VLMConfig, *, attn_impl: str = "auto", remat=True,
                 stop_vision_gradient: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 transforms: Optional[Dict] = None,
                 action_vocab_size: Optional[int] = None,
                 freeze_mask=None, ce_chunk: Optional[int] = None,
                 mesh=None):
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the loss, the
    action metrics and the gradient tree (a zero scalar for each frozen
    leaf) of one batch; arguments as for :func:`make_train_step`. Under a
    ``mesh`` the gradients are this rank's share, before
    ``reduce_gradients``."""
    vocab = action_vocab_size or cfg.llm.vocab_size

    def pixel_values(batch):
        if "pixel_values" in batch:
            return batch["pixel_values"]
        from emmax_torch.ops.image import preprocess_for_towers

        pv = preprocess_for_towers(batch["images"], transforms)
        return {k: v.to(compute_dtype) for k, v in pv.items()}

    def loss_fn(params, batch):
        cparams = cast_params(params, compute_dtype)
        logits, loss, _ = vlm_forward(
            cparams, cfg, batch["input_ids"], pixel_values(batch),
            mask=batch["attention_mask"], labels=batch["labels"],
            attn_impl=attn_impl, remat=remat,
            stop_vision_gradient=stop_vision_gradient,
            multimodal_mask=batch.get("multimodal_mask"), ce_chunk=ce_chunk,
            mesh=mesh)
        labels = batch["labels"]
        P = logits.shape[1] - labels.shape[1]
        fused_labels = torch.cat(
            [labels[:, :1], torch.full((labels.shape[0], P), IGNORE_INDEX,
                                       dtype=labels.dtype,
                                       device=labels.device),
             labels[:, 1:]], dim=1)
        if ce_chunk:   # `logits` holds the greedy preds [B, F]
            acc, l1 = action_token_metrics_from_preds(
                logits[:, :-1], fused_labels, vocab_size=vocab, mesh=mesh)
        else:
            acc, l1 = action_token_metrics(logits, fused_labels,
                                           vocab_size=vocab, mesh=mesh)
        return loss, {"action_accuracy": acc, "action_l1": l1}

    frozen = None
    if freeze_mask is not None:
        frozen = [is_frozen(m) for _, m in leaves_with_path(freeze_mask)]

    def grad_fn(params, batch):
        leaves = [p for _, p in leaves_with_path(params)]
        train = [p.is_floating_point() and not (frozen and frozen[i])
                 for i, p in enumerate(leaves)]
        for p, t in zip(leaves, train):
            p.requires_grad_(t)
        try:
            loss, aux = loss_fn(params, batch)
            wanted = [p for p, t in zip(leaves, train) if t]
            # a trainable leaf the forward never reads (a tower's final
            # norm) gets zeros, as JAX's grad gives
            got = iter(torch.autograd.grad(loss, wanted, allow_unused=True,
                                           materialize_grads=True))
        finally:
            for p in leaves:
                p.requires_grad_(False)
        flat = [next(got) if t else torch.zeros((), dtype=p.dtype,
                                                device=p.device)
                for p, t in zip(leaves, train)]
        grads = map_with_path(lambda path, _: flat.pop(0), params)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    return grad_fn


def make_train_step(cfg: VLMConfig, tx: Optimizer, *,
                    grad_accum_steps: int = 1, mesh=None, **kw):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the params
    and optimizer state are updated in place.

    ``kw`` (see :func:`make_grad_fn`): ``attn_impl``, ``remat``,
    ``stop_vision_gradient``, ``compute_dtype`` (fp32 master params are
    cast to it for the forward), ``transforms``, ``action_vocab_size``,
    ``freeze_mask`` (the ``trainable_mask(params, stage)`` tree; its
    all-zero leaves are not differentiated) and ``ce_chunk``.

    ``batch``: {"input_ids", "attention_mask", "labels"} tensors on the
    params' device plus either ``"pixel_values": {tower: [B, H, W, 3]}``
    (normalized) or, with ``transforms`` (tower -> ImageTransformConfig),
    uint8 ``"images": [B, H, W, 3]``, resized and normalized on the device.
    With ``grad_accum_steps > 1`` the batch's leading dim is
    ``accum * micro`` and the micro-batches' gradients are averaged (under
    a ``mesh``, micro-batch ``i`` is the ``i``-th block of each rank's
    rows; the JAX package takes the ``i``-th block of the global rows,
    which gives the same step when the rows hold equal numbers of
    labels).
    ``mesh``: see the module docstring.
    ``metrics`` holds 0-d tensors on the device: loss, grad_norm (of the
    unmasked gradients), action_accuracy, action_l1.
    """
    grad_fn = make_grad_fn(cfg, mesh=mesh, **kw)

    def train_step(state: TrainState, batch):
        if grad_accum_steps == 1:
            loss, aux, grads = grad_fn(state.params, batch)
        else:
            n = grad_accum_steps
            micro = [_micro_batch(batch, i, n) for i in range(n)]
            loss, aux, grads = grad_fn(state.params, micro[0])
            for mb in micro[1:]:
                l_i, a_i, g_i = grad_fn(state.params, mb)
                loss = loss + l_i
                aux = {k: aux[k] + a_i[k] for k in aux}
                grads = tree_map(torch.add, grads, g_i)
            grads = tree_map(lambda g: g * (1.0 / n), grads)
            loss = loss * (1.0 / n)
            aux = {k: v * (1.0 / n) for k, v in aux.items()}
        flat = [g for _, g in leaves_with_path(grads)]
        specs = [spec_of(p) for _, p in leaves_with_path(state.params)]
        reduce_gradients(flat, specs, mesh)
        gnorm = global_norm(flat, mesh, specs)
        tx.update(state.params, grads, state.opt_state, mesh)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state), metrics

    return train_step


def _micro_batch(batch, i: int, n: int):
    """Micro-batch ``i`` of ``n``: rows ``[i * B/n, (i + 1) * B/n)`` of
    every tensor (JAX reshapes ``[B] -> [n, B/n]`` and scans)."""
    def take(a):
        if isinstance(a, dict):
            return {k: take(v) for k, v in a.items()}
        m = a.shape[0] // n
        return a[i * m:(i + 1) * m]

    return {k: take(v) for k, v in batch.items()}
