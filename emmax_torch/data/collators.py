"""Batch collators and loaders, port of ``emmax_tpu/data/collators.py``.

- ``collate_train``: right-pads input_ids / labels (PAD / IGNORE_INDEX)
  and stacks the uint8 images;
- ``collate_val``: left-pads for generation and keeps the string labels;
- ``collate_lm``: mixed multimodal / text-only batches of the pretraining
  stages, with ``multimodal_indices`` and ``multimodal_mask``.

Sequence lengths are bucketed to multiples of ``pad_multiple``. Outputs
are numpy; the loop or ``PrefetchingLoader`` moves them to the device.
``BatchLoader`` and ``SplitModalityLoader`` draw from the same seeded
numpy generators as the JAX package, so both see the same batches in the
same order.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.util.batching import split_modality_batches


def _bucket_len(n: int, multiple: int, max_len: int) -> int:
    return min(((n + multiple - 1) // multiple) * multiple, max_len)


def collate_train(samples: Sequence[Dict], pad_id: int,
                  max_length: int = 2048, pad_multiple: int = 64) -> Dict:
    L = _bucket_len(max(len(s["input_ids"]) for s in samples), pad_multiple,
                    max_length)
    B = len(samples)
    input_ids = np.full((B, L), pad_id, np.int32)
    labels = np.full((B, L), IGNORE_INDEX, np.int32)
    mask = np.zeros((B, L), bool)
    images = np.stack([s["image"] for s in samples])
    for i, s in enumerate(samples):
        ids = list(s["input_ids"])[:L]
        lbl = list(s["labels"])[:L]
        input_ids[i, :len(ids)] = ids
        labels[i, :len(lbl)] = lbl
        mask[i, :len(ids)] = True
    return {"input_ids": input_ids, "attention_mask": mask, "labels": labels,
            "images": images}


def collate_val(samples: Sequence[Dict], pad_id: int,
                max_length: int = 2048, pad_multiple: int = 64) -> Dict:
    L = _bucket_len(max(len(s["input_ids"]) for s in samples), pad_multiple,
                    max_length)
    B = len(samples)
    input_ids = np.full((B, L), pad_id, np.int32)
    mask = np.zeros((B, L), bool)
    images = np.stack([s["image"] for s in samples])
    for i, s in enumerate(samples):
        ids = list(s["input_ids"])[:L]
        input_ids[i, L - len(ids):] = ids       # left pad
        mask[i, L - len(ids):] = True
    return {"input_ids": input_ids, "attention_mask": mask,
            "labels": [s["labels"] for s in samples], "images": images}


def collate_lm(samples: Sequence[Dict], pad_id: int,
               default_image_shape=(224, 224, 3), max_length: int = 2048,
               pad_multiple: int = 64) -> Dict:
    """Mixed multimodal / text-only batches: a row without an image gets
    zero pixels shaped like the batch's first real image (so the images
    stack), and is left out of ``multimodal_indices`` (int64) and marked
    False in ``multimodal_mask`` (bool, the step's static-shape form of
    the same list: text-only rows take the unimodal merge)."""
    for s in samples:
        if s.get("image") is not None:
            default_image_shape = s["image"].shape
            break
    base = collate_train(
        [{**s, "image": s.get("image") if s.get("image") is not None
          else np.zeros(default_image_shape, np.uint8)} for s in samples],
        pad_id, max_length, pad_multiple)
    base["multimodal_indices"] = np.asarray(
        [i for i, s in enumerate(samples) if s.get("image") is not None],
        np.int64)
    base["multimodal_mask"] = np.asarray(
        [s.get("image") is not None for s in samples], bool)
    return base


class SplitModalityLoader:
    """Batch iterator with LLaVA's split-modality batching
    (``util.batching.split_modality_batches``): each batch is of one
    modality and length-sorted. A dataset gives its ``modality_lengths()``
    without reading images; ``collate_fn`` is ``collate_lm`` (its
    ``multimodal_mask`` covers a batch of either kind)."""

    def __init__(self, dataset, batch_size: int, collate_fn=None, *,
                 seed: int = 7, num_shards: int = 1,
                 shard_index: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_fn
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        mods = dataset.modality_lengths()
        self.is_multimodal = [m for m, _ in mods]
        self.lengths = [n for _, n in mods]

    def batches(self, epoch: int = 0):
        """This shard's index lists for ``epoch``."""
        return split_modality_batches(
            self.lengths, self.is_multimodal, self.batch_size,
            seed=self.seed, epoch=epoch, num_shards=self.num_shards,
            shard_index=self.shard_index)

    def epoch(self, epoch: int = 0):
        for idxs in self.batches(epoch):
            yield self.collate([self.dataset[int(j)] for j in idxs])

    def __len__(self) -> int:
        return len(self.batches(0))


class BatchLoader:
    """Shuffling batch iterator over a map-style dataset, with per-host
    sharding (``shard_index::num_shards``)."""

    def __init__(self, dataset, batch_size: int, collate_fn, *,
                 shuffle: bool = True, seed: int = 7, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index

    def epoch(self, epoch: int = 0):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        order = order[self.shard_index::self.num_shards]
        step = self.batch_size
        end = (len(order) // step) * step if self.drop_last else len(order)
        for i in range(0, end, step):
            idxs = order[i:i + step]
            if not self.drop_last and len(idxs) < step:
                idxs = np.concatenate([idxs, order[:step - len(idxs)]])
            yield self.collate([self.dataset[int(j)] for j in idxs])

    def __len__(self) -> int:
        return len(self.dataset) // self.num_shards // self.batch_size
