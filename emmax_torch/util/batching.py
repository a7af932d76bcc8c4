"""Modality-and-length-grouped batch sampling, the port's own copy of
``emmax_tpu/util/batching.py`` (numpy only, so both packages give the same
index lists for every seed, epoch and shard).

LLaVA-style pretraining batches group examples by modality (multimodal
vs text-only) and sort each batch by sequence length, so padding waste is
small: a host-side index sampler with per-shard slicing.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def split_modality_batches(
    lengths: Sequence[int],
    is_multimodal: Sequence[bool],
    batch_size: int,
    *,
    seed: int = 7,
    epoch: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
) -> List[List[int]]:
    """Returns this shard's batches of dataset indices.

    Within each modality group the examples are shuffled and chunked into
    batch-size buckets, each bucket sorted by length (descending); then the
    buckets of both groups are interleaved in random order and dealt to
    the shards in turn.
    """
    rng = np.random.default_rng([seed, epoch])
    lengths = np.asarray(lengths)
    is_mm = np.asarray(is_multimodal, bool)

    buckets: List[np.ndarray] = []
    for group_mask in (is_mm, ~is_mm):
        idxs = np.nonzero(group_mask)[0]
        if len(idxs) == 0:
            continue
        rng.shuffle(idxs)
        # pad the trailing partial bucket by stealing from the front, so
        # every example trains each epoch
        if len(idxs) % batch_size:
            n_missing = batch_size - len(idxs) % batch_size
            idxs = np.concatenate([idxs, idxs[:n_missing]])
        for start in range(0, len(idxs), batch_size):
            bucket = idxs[start:start + batch_size]
            bucket = bucket[np.argsort(-lengths[bucket])]
            buckets.append(bucket)
    order = rng.permutation(len(buckets))
    shard_buckets = [buckets[i] for i in order][shard_index::num_shards]
    return [b.tolist() for b in shard_buckets]
