"""Action/proprio normalization and dataset statistics (numpy), port of
``emmax_tpu/data/normalization.py``.

NormalizationType (NORMAL / BOUNDS / BOUNDS_Q99), trajectory
normalization with per-dim masks and degenerate-dim zeroing, statistics
(mean/std/max/min/q01/q99) with a hash-keyed disk cache, and the gripper
primitives. ``cached_statistics`` keys its file as the JAX package does
(``dataset_statistics_<sha256[:16]>.json`` of the ``|``-joined key parts),
so a cache, or a run's ``dataset_statistics.json``, written by either
package is read by the other.
"""

from __future__ import annotations

import hashlib
import json
from enum import Enum
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np


class NormalizationType(str, Enum):
    NORMAL = "normal"
    BOUNDS = "bounds"
    BOUNDS_Q99 = "bounds_q99"


def normalize_array(x: np.ndarray, stats: Dict, norm_type: NormalizationType
                    ) -> np.ndarray:
    """Normalize [..., D] with per-dim mask; degenerate dims (min==max) → 0."""
    x = np.asarray(x, np.float64)
    mask = np.asarray(stats.get("mask", np.ones_like(stats["min"], bool)), bool)
    if norm_type == NormalizationType.NORMAL:
        out = np.where(mask, (x - stats["mean"]) / (np.asarray(stats["std"]) + 1e-8), x)
        return out
    if norm_type == NormalizationType.BOUNDS:
        low, high = np.asarray(stats["min"]), np.asarray(stats["max"])
    elif norm_type == NormalizationType.BOUNDS_Q99:
        low, high = np.asarray(stats["q01"]), np.asarray(stats["q99"])
    else:
        raise ValueError(norm_type)
    out = np.where(mask, np.clip(2 * (x - low) / (high - low + 1e-8) - 1, -1, 1), x)
    zeros = np.asarray(stats["min"]) == np.asarray(stats["max"])
    return np.where(zeros, 0.0, out)


def compute_statistics(arrays: Iterable[np.ndarray]) -> Dict:
    """Aggregate per-dim stats over all transitions of all trajectories
    (reference ``get_dataset_statistics``, data_utils.py:185-271)."""
    stacked = np.concatenate([np.asarray(a, np.float64).reshape(-1, np.asarray(a).shape[-1])
                              for a in arrays], axis=0)
    return {
        "mean": stacked.mean(0).tolist(),
        "std": stacked.std(0).tolist(),
        "max": stacked.max(0).tolist(),
        "min": stacked.min(0).tolist(),
        "q01": np.quantile(stacked, 0.01, axis=0).tolist(),
        "q99": np.quantile(stacked, 0.99, axis=0).tolist(),
        "num_transitions": int(stacked.shape[0]),
    }


def cached_statistics(cache_dir, key_parts: Iterable[str], compute_fn):
    """Disk-cached statistics keyed by a hash of the identifying strings
    (reference caches by unique_hash under ~/.cache, data_utils.py:240-271)."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256("|".join(key_parts).encode()).hexdigest()[:16]
    path = cache_dir / f"dataset_statistics_{h}.json"
    if path.exists():
        return json.loads(path.read_text())
    stats = compute_fn()
    path.write_text(json.dumps(stats, indent=2))
    return stats


def save_dataset_statistics(run_dir, stats_by_dataset: Dict) -> Path:
    """Write the inference-time sidecar (reference data_utils.py:274-297)."""
    out = Path(run_dir) / "dataset_statistics.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(stats_by_dataset, f, indent=2)
    return out


# --- gripper-action primitives (data_utils.py:107-182) ----------------------

def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous [0,1] gripper → binary, relabeling in-transition values by
    the state eventually reached (reverse scan)."""
    actions = np.asarray(actions, np.float64)
    new = np.empty_like(actions)
    carry = actions[-1]
    for i in reversed(range(len(actions))):
        a = actions[i]
        if a > 0.95:
            carry = 1.0
        elif a < 0.05:
            carry = 0.0
        new[i] = carry
    return new


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - np.asarray(actions)


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative (+1 open / -1 close / 0 no-op) → absolute [0, 1]."""
    actions = np.asarray(actions, np.float64)
    opening = actions < -0.1
    closing = actions > 0.1
    out = np.empty_like(actions)
    # carry the last commanded state through no-ops; back-fill leading
    # no-ops with the INVERSE of the first command (a close command implies
    # the gripper was open before it — reference data_utils.py:155-157);
    # default open (1) when the trajectory has no command at all
    state = 1.0
    for a in actions:
        if a < -0.1:   # first command opens → gripper was closed before
            state = 0.0
            break
        if a > 0.1:    # first command closes → gripper was open before
            state = 1.0
            break
    for i, a in enumerate(actions):
        if opening[i]:
            state = 1.0
        elif closing[i]:
            state = 0.0
        out[i] = state
    return out


def allocate_threads(n: Optional[int], weights: np.ndarray) -> np.ndarray:
    """Proportionally allocate ``n`` threads across datasets by weight
    (reference data_utils.py:300-330); every dataset gets ≥1."""
    weights = np.asarray(weights, np.float64)
    if n is None:
        return np.array([-1] * len(weights))
    assert n >= len(weights), "need at least one thread per dataset"
    weights = weights / weights.sum()
    alloc = np.zeros(len(weights), int)
    while weights.sum() > 0 and (mask := (weights * n < 1) & (weights > 0)).any():
        alloc[mask] = 1
        n -= int(mask.sum())
        weights[mask] = 0
        if weights.sum() > 0:
            weights = weights / weights.sum()
    if weights.sum() > 0:
        extra = np.floor(weights * n).astype(int)
        alloc[weights > 0] += extra[weights > 0]
        n -= int(extra.sum())
        # distribute remainder to largest fractional parts
        frac = weights * (n + extra.sum()) - extra
        for idx in np.argsort(-frac)[:n]:
            alloc[idx] += 1
    return alloc
