"""Train state: params, optimizer, schedules and freeze-stage masks.

Port of ``emmax_tpu/training/train_state.py``. Freezing is a per-leaf 0/1
gradient mask, which also covers the "last LLM layer only" stages by
masking along the stacked layer axis. The optimizer reproduces the JAX
package's optax chain, ``mask -> clip_by_global_norm -> AdamW on the
trainable leaves (set_to_zero on the others) -> mask``, with optax's
arithmetic rather than ``torch.optim``'s:

- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (no ``+1e-6``);
- update ``k`` (from 0) uses ``schedule(k)``; Adam's bias correction uses
  ``k + 1``; eps 1e-8 outside the square root;
- weight decay applies to the ``_decay_mask`` leaves only, and the
  trailing mask keeps frozen layers of a partly trainable stacked leaf
  both unchanged and undecayed.

Unlike optax the update is applied in place (params and moments), so a
7B fp32 master tree is never copied.

Under a mesh (``parallel``) the params, gradients and moments are each
rank's blocks: AdamW and the masks act on the blocks as they are, and the
global norm counts every element of the global tree once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Union

import torch

from emmax_torch.models.tree import leaves_with_path, map_with_path
from emmax_torch.parallel.gather import sum_of_squares
from emmax_torch.parallel.sharding import spec_of, with_spec

Params = Any
Mask = Union[float, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Dict[str, Any]


# --- freeze stages -----------------------------------------------------------

def trainable_mask(params: Params, stage: str) -> Params:
    """Per-leaf broadcastable mask, 1.0 where trainable: a float for a
    uniform leaf, a ``[L, 1, ...]`` column for a stacked LLM leaf of the
    last-layer stages (so no params-sized mask tree is ever built).

    Stages: align / finetune / vla-train / full-finetune / vla-full-train /
    last-layer-finetune / vla-last-layer-train / vla-sandwich-train.
    """
    def leaf_mask(p: str, leaf) -> Mask:
        vision = p.startswith("vision")
        projector = p.startswith("projector")
        llm = p.startswith("llm")
        is_llm_layers = p.startswith("llm/layers")
        is_llm_embed = p in ("llm/embed", "llm/lm_head")

        def last_layer_only() -> Mask:
            # embed + lm_head + the final layer of the stacked axis
            if is_llm_embed:
                return 1.0
            if is_llm_layers:
                m = torch.zeros((leaf.shape[0],) + (1,) * (leaf.dim() - 1),
                                dtype=torch.float32, device=leaf.device)
                m[-1] = 1.0
                return m
            return 0.0

        if stage == "align":
            on = projector
        elif stage in ("finetune", "vla-train"):
            on = projector or llm
        elif stage in ("full-finetune", "vla-full-train"):
            on = True
        elif stage in ("last-layer-finetune", "vla-last-layer-train"):
            return last_layer_only() if llm else 0.0
        elif stage == "vla-sandwich-train":
            if llm:
                return last_layer_only()
            on = vision or projector
        else:
            raise ValueError(f"unsupported stage {stage!r}")
        return 1.0 if on else 0.0

    return map_with_path(leaf_mask, params)


def is_frozen(m: Mask) -> bool:
    """A leaf whose mask is zero everywhere: never differentiated."""
    return not bool(torch.as_tensor(m).any())


def stage_from_flags(freeze_vision: bool, freeze_llm: bool,
                     unfreeze_last_llm_layer: bool) -> str:
    """The reference's flag -> stage mapping."""
    if not freeze_vision and not freeze_llm:
        return "vla-full-train"
    if freeze_vision and not freeze_llm:
        return "vla-train"
    if freeze_vision and freeze_llm and unfreeze_last_llm_layer:
        return "vla-last-layer-train"
    if not freeze_vision and freeze_llm and unfreeze_last_llm_layer:
        return "vla-sandwich-train"
    raise ValueError("invalid freeze combination "
                     f"({freeze_vision=}, {freeze_llm=}, "
                     f"{unfreeze_last_llm_layer=})")


# --- schedules / optimizer ---------------------------------------------------

def make_schedule(kind: str, learning_rate: float, total_steps: int,
                  warmup_ratio: float = 0.03) -> Callable[[int], float]:
    """"constant" | "linear-warmup+cosine-decay" (optax's
    ``warmup_cosine_decay_schedule`` from 0 to ``learning_rate`` and down
    to 0)."""
    if kind == "constant":
        return lambda step: learning_rate
    if kind == "linear-warmup+cosine-decay":
        warmup = max(int(total_steps * warmup_ratio), 1)
        decay = max(total_steps, warmup + 1) - warmup

        def schedule(step: int) -> float:
            if step < warmup:
                return learning_rate * min(max(step, 0), warmup) / warmup
            t = min(step - warmup, decay)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))

        return schedule
    raise ValueError(f"unknown lr schedule {kind!r}")


def _decay_mask(params: Params) -> Params:
    """AdamW weight decay on matmul weights only: biases, norms,
    layerscale, tokens and position embeddings are excluded."""
    def m(path: str, leaf) -> bool:
        no_decay = any(t in path for t in
                       ("norm", "bias", "ls1", "ls2", "cls_token",
                        "reg_tokens", "pos_embed"))
        return not no_decay and getattr(leaf, "ndim", 0) >= 2

    return map_with_path(m, params)


def _scaled(g: torch.Tensor, m: Mask) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return g * m.to(g.dtype)
    return g if m == 1.0 else g * m


class Optimizer:
    """The JAX package's optimizer chain, applied in place.

    ``update(params, grads, opt_state)`` takes the gradient tree (a zero
    scalar for an entirely frozen leaf) and updates ``params`` and
    ``opt_state`` where they lie; ``opt_state["count"]`` is the number of
    updates made so far.
    """

    def __init__(self, mask: Params, decay: Params,
                 schedule: Callable[[int], float], *, weight_decay: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.mask = [m for _, m in leaves_with_path(mask)]
        self.decay = [d for _, d in leaves_with_path(decay)]
        self.train = [not is_frozen(m) for m in self.mask]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> Dict[str, Any]:
        leaves = [p for _, p in leaves_with_path(params)]
        def zeros(p, t):   # a moment is placed as its param is
            return with_spec(torch.zeros_like(p), spec_of(p)) if t else None

        mu = [zeros(p, t) for p, t in zip(leaves, self.train)]
        nu = [zeros(p, t) for p, t in zip(leaves, self.train)]
        return {"count": 0, "mu": mu, "nu": nu}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               opt_state: Dict[str, Any], mesh=None) -> None:
        """``mesh``: params, grads and moments are this rank's blocks (the
        clip then reads the global norm, the same on every rank)."""
        leaves = [p for _, p in leaves_with_path(params)]
        gs = [_scaled(g, m) for (_, g), m in zip(leaves_with_path(grads),
                                                 self.mask)]
        norm = global_norm(gs, mesh, [spec_of(p) for p in leaves])
        keep = norm < self.max_grad_norm   # on the device: no host sync
        k = opt_state["count"]
        lr = self.schedule(k)
        c1 = 1 - self.b1 ** (k + 1)
        c2 = 1 - self.b2 ** (k + 1)
        for i, (p, g) in enumerate(zip(leaves, gs)):
            if not self.train[i]:
                continue
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            mu, nu = opt_state["mu"][i], opt_state["nu"][i]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / c1) / ((nu / c2).sqrt() + self.eps)
            if self.decay[i] and self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(_scaled(u * -lr, self.mask[i]))
        opt_state["count"] = k + 1


def global_norm(leaves, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32. Under a
    ``mesh`` the leaves are blocks placed by ``specs`` and each element of
    the global tree counts once (``parallel.gather.sum_of_squares``)."""
    leaves = list(leaves)
    if specs is None:
        specs = [None] * len(leaves)
    return sum_of_squares(leaves, specs, mesh).sqrt()


def make_optimizer(params: Params, *, learning_rate: float,
                   weight_decay: float, max_grad_norm: float,
                   lr_scheduler_type: str, total_steps: int,
                   warmup_ratio: float = 0.03,
                   stage: str = "vla-full-train"):
    """Returns (optimizer, schedule)."""
    schedule = make_schedule(lr_scheduler_type, learning_rate, total_steps,
                             warmup_ratio)
    tx = Optimizer(trainable_mask(params, stage), _decay_mask(params),
                   schedule, weight_decay=weight_decay,
                   max_grad_norm=max_grad_norm)
    return tx, schedule


def create_train_state(params: Params, tx: Optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=tx.init(params))
