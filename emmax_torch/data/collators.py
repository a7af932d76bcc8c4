"""Batch collators and the shuffling batch loader, port of the part of
``emmax_tpu/data/collators.py`` that GCOT training uses.

- ``collate_train``: right-pads input_ids / labels (PAD / IGNORE_INDEX)
  and stacks the uint8 images;
- ``collate_val``: left-pads for generation and keeps the string labels.

Sequence lengths are bucketed to multiples of ``pad_multiple``. Outputs
are numpy; the loop or ``PrefetchingLoader`` moves them to the device.
``BatchLoader`` shuffles with the same seeded numpy generator as the JAX
package, so both see the same batches in the same order.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from emmax_torch.models.llama import IGNORE_INDEX


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
