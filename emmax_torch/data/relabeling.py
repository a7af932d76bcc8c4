"""Trajectory-level relabeling on numpy trajectories: pad masks, goal
relabeling, task augmentation. Port of ``emmax_tpu/data/relabeling.py``.

A trajectory is a nested dict of arrays with a leading time axis (strings
as object arrays of ``bytes``; a scalar ``bytes`` is one value for the whole
trajectory). Each random function takes a ``rand`` callable (shape ->
float32 array in [0, 1)), so tests drive this and the JAX package with the
same draws; the pipeline passes one built on its own seeded generator.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

Rand = Callable[[tuple], np.ndarray]


def tree_merge(*trees: Dict) -> Dict:
    """Recursive dict merge, later trees win."""
    merged: Dict = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict):
                merged[k] = tree_merge(merged.get(k, {}), v)
            else:
                merged[k] = v
    return merged


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def is_string(x) -> bool:
    return isinstance(x, bytes) or (isinstance(x, np.ndarray)
                                    and x.dtype == object)


def string_lengths(x) -> np.ndarray:
    if isinstance(x, bytes):
        return np.asarray(len(x))
    return np.vectorize(len, otypes=[np.int64])(x) if x.size else (
        np.zeros(x.shape, np.int64))


def to_padding(x):
    """Padding of a value: zeros for numbers, empty strings for strings."""
    if is_string(x):
        return np.full(np.shape(x), b"", dtype=object)
    return np.zeros_like(x)


def add_pad_mask_dict(traj: Dict) -> Dict:
    """Mark which observation / task entries are padding (empty strings)."""
    traj_len = len(traj["action"])
    for key in ("observation", "task"):
        pad_mask_dict = {}
        for subkey, value in traj[key].items():
            if is_string(value):
                pad_mask_dict[subkey] = string_lengths(value) != 0
            else:
                pad_mask_dict[subkey] = np.ones(traj_len, bool)
        traj[key]["pad_mask_dict"] = pad_mask_dict
    return traj


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def uniform_goal_relabel(traj: Dict, rand: Rand) -> Dict:
    """Each transition's goal is a uniformly drawn future observation: the
    index for step i from [i + 1, traj_len), clamped to traj_len - 1,
    merged into ``traj["task"]``."""
    traj_len = len(next(_leaves(traj["observation"])))
    u = np.asarray(rand((traj_len,)), np.float32)
    low = (np.arange(traj_len, dtype=np.int32) + 1).astype(np.float32)
    high = np.float32(traj_len)
    goal_idxs = (u * (high - low) + low).astype(np.int32)
    goal_idxs = np.minimum(goal_idxs, traj_len - 1)
    goal = tree_map(lambda x: x[goal_idxs], traj["observation"])
    traj["task"] = tree_merge(traj.get("task", {}), goal)
    return traj


GOAL_RELABELING_STRATEGIES = {"uniform": uniform_goal_relabel}


def delete_task_conditioning(traj: Dict, keep_image_prob: float,
                             rand: Rand) -> Dict:
    """Per transition, keep either the goal images or the language
    instruction (no-op unless both are there); a transition whose language
    is padding keeps the images. Dropped keys become padding with their
    pad mask cleared; where images are dropped the goal timestep becomes
    the last step."""
    task = traj["task"]
    if "language_instruction" not in task:
        return traj
    image_keys = {k for k in task
                  if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj
    traj_len = len(traj["action"])
    keep_images = np.asarray(rand((traj_len,)), np.float32) < keep_image_prob
    keep_images |= ~np.asarray(task["pad_mask_dict"]["language_instruction"])
    for key in image_keys | {"language_instruction"}:
        keep = keep_images if key in image_keys else ~keep_images
        value = task[key]
        if is_string(value):
            value = np.broadcast_to(np.asarray(value, dtype=object),
                                    keep.shape) if np.ndim(value) == 0 \
                else value
            kept = np.empty(keep.shape + np.shape(value)[1:], dtype=object)
            cond = keep.reshape(keep.shape + (1,) * (kept.ndim - 1))
            kept[...] = np.where(cond, value, b"")
            task[key] = kept
        else:
            cond = keep.reshape(keep.shape + (1,) * (np.ndim(value) - 1))
            task[key] = np.where(cond, value, to_padding(value))
        mask = np.asarray(task["pad_mask_dict"][key])
        task["pad_mask_dict"][key] = np.where(
            keep.reshape(keep.shape + (1,) * max(mask.ndim - 1, 0)), mask,
            np.zeros_like(mask))
    if "timestep" in task:
        task["timestep"] = np.where(keep_images, task["timestep"],
                                    traj_len - 1).astype(
                                        np.asarray(task["timestep"]).dtype)
    return traj


TASK_AUGMENT_STRATEGIES = {"delete_task_conditioning": delete_task_conditioning}
