"""Cross-epoch vision-feature cache for frozen-tower stages, port of
``emmax_tpu/training/vision_cache.py``.

In the align stage the towers are frozen, so each image's tower output
is a constant; yet each epoch would run DINOv2-L and SigLIP over every
image again. ``CachedVisionLoader`` wraps a pretraining loader and
replaces each batch's uint8 ``images`` with the pre-projector tower
features (``pixel_values={"tower_features": [B, P, C]}``, which
``vlm_forward`` feeds straight to the projector), kept on the host under
a content hash of each image. The projector still trains.

Where the JAX package's loader differs, this one:

- encodes as the train step does: the same preprocessing, the tower
  weights cast to the step's compute dtype, the same ``attn_impl``; so a
  cached batch gives the projector the features an uncached one would;
- reads the train state's own tower tensors (torch does not donate
  buffers, and the align stage never updates the towers) instead of
  holding a private copy on the device; ``release_towers()`` drops the
  reference;
- bounds its store at ``capacity`` entries, dropping the oldest first.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from emmax_torch.models.vlm import VLMConfig, encode_tower_features
from emmax_torch.ops.image import preprocess_for_towers
from emmax_torch.overwatch import initialize_overwatch
from emmax_torch.training.train_step import cast_params

log = initialize_overwatch(__name__)


class CachedVisionLoader:
    """Wrap a loader whose batches carry uint8 ``images`` [B, H, W, 3].

    ``params``: the train state's param tree, whose ``"vision"`` leaves
    the loader reads (not copied). ``transforms``, ``attn_impl`` and
    ``compute_dtype``: the train step's. ``device``: where the towers
    run (the params' device); ``mesh``: the step's, under which the
    params are this rank's blocks.

    Each wrapped batch keeps every other key (labels, masks,
    ``multimodal_mask``), drops ``images`` and gains
    ``pixel_values={"tower_features": ...}`` on the host. A batch with any
    image not in the store is encoded whole, in one batched tower
    forward (``encodes`` counts them); the zero frames of text-only rows
    cache like any other content and are ignored by the unimodal merge.
    """

    def __init__(self, loader, params, cfg: VLMConfig, transforms: Dict, *,
                 attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 capacity: Optional[int] = None, device="cpu",
                 mesh=None) -> None:
        self.loader = loader
        self.cfg = cfg
        self.transforms = transforms
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        self.capacity = capacity
        self.device = device
        self.mesh = mesh
        self.vision = params["vision"]
        self._store: Dict[bytes, torch.Tensor] = {}
        self.encodes = 0
        self.evicted = 0

    def release_towers(self) -> None:
        """Drop the reference to the towers: every later batch must be a
        cache hit (call once every sample has been encoded)."""
        self.vision = None

    @staticmethod
    def key(row: np.ndarray) -> bytes:
        return hashlib.blake2b(row.tobytes(), digest_size=16).digest()

    @property
    def nbytes(self) -> int:
        """Host bytes held by the store."""
        return sum(t.nbytes for t in self._store.values())

    @torch.no_grad()
    def encode(self, images: np.ndarray) -> torch.Tensor:
        """The towers' features [B, P, C] of uint8 ``images`` on the host,
        computed as the train step computes them."""
        if self.vision is None:
            raise RuntimeError(
                "CachedVisionLoader: cache miss after release_towers(); "
                "release only once every sample has been encoded")
        pixels = torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)
        pv = {k: v.to(self.compute_dtype) for k, v in
              preprocess_for_towers(pixels, self.transforms).items()}
        vision = cast_params(self.vision, self.compute_dtype)
        feats = encode_tower_features({"vision": vision}, self.cfg, pv,
                                      attn_impl=self.attn_impl,
                                      mesh=self.mesh)
        self.encodes += 1
        return feats.cpu()

    def _features(self, images: np.ndarray) -> torch.Tensor:
        keys = [self.key(r) for r in images]
        missing = [i for i, k in enumerate(keys) if k not in self._store]
        if not missing:
            return torch.stack([self._store[k] for k in keys])
        # one batched encode even on a partial miss: the batch's shape
        # stays that of every other batch
        feats = self.encode(images)
        for i in missing:
            self._store[keys[i]] = feats[i].clone()
        if self.capacity is not None and len(self._store) > self.capacity:
            log.warning(f"CachedVisionLoader over capacity "
                        f"({len(self._store)} > {self.capacity}); dropping "
                        f"the oldest entries")
            while len(self._store) > self.capacity:
                self._store.pop(next(iter(self._store)))
                self.evicted += 1
        return feats

    def epoch(self, epoch: int = 0):
        for batch in self.loader.epoch(epoch):
            feats = self._features(np.asarray(batch["images"]))
            out = {k: v for k, v in batch.items() if k != "images"}
            out["pixel_values"] = {"tower_features": feats}
            yield out

    def __len__(self) -> int:
        return len(self.loader)
