"""The RLDS trajectory pipeline without TensorFlow, port of
``emmax_tpu/data/rlds.py``.

Episodes are read from the same self-describing TFRecord layout the JAX
package writes and reads (one ``tf.train.Example`` per episode, see
``write_episodes`` / ``EPISODE_KEYS``) through the port's own reader
(``data/tfrecord.py``), and images are decoded by the port's codec
(``data/codec.py``) with libjpeg's IFAST DCT, which is what
``tf.io.decode_image`` uses. ``tf.data`` becomes ``Dataset``: a lazy,
re-iterable sequence with the few operators the pipeline needs, over
trajectories that are nested dicts of numpy arrays (strings as object
arrays of ``bytes``). The semantics and their order are the JAX
package's:

- per-dataset standardization (``STANDARDIZE_FNS``, else the OXE registry
  of ``data/oxe.py``), then ``timestep`` and ``dataset_name``;
- statistics over all splits, disk-cached under the JAX package's key, and
  BOUNDS_Q99 normalization;
- trajectory transforms: filters, pad masks, goal relabeling, task
  augmentation, window / future-window chunking with the goal clamp,
  subsampling;
- frame transforms: decode, lanczos3 antialiased resize (round and clip
  before the uint8 cast), then augmentation with per-frame keys;
- weighted interleave with a shuffle buffer, on the port's seeded RNG.

Where the JAX package draws from TF's random ops (goal relabeling, task
augmentation, subsampling, shuffles, augmentation) the port draws from
``numpy.random`` generators seeded from the pipeline's arguments, so a
stream is reproducible run to run but not equal to TF's.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np

from emmax_torch.data import codec, tfrecord
from emmax_torch.data.normalization import (NormalizationType,
                                            binarize_gripper_actions,
                                            cached_statistics,
                                            compute_statistics)
from emmax_torch.data.relabeling import tree_map


class Dataset:
    """A lazy sequence that can be iterated more than once:
    ``make()`` returns a fresh iterator each time."""

    def __init__(self, make: Callable[[], Iterator]) -> None:
        self._make = make

    def __iter__(self) -> Iterator:
        return self._make()

    def map(self, fn: Callable, num_parallel_calls: int = 1) -> "Dataset":
        if num_parallel_calls > 1:
            return Dataset(lambda: _parallel_map(fn, iter(self),
                                                 num_parallel_calls))
        return Dataset(lambda: map(fn, iter(self)))

    def filter(self, pred: Callable) -> "Dataset":
        return Dataset(lambda: filter(pred, iter(self)))

    def flat_map(self, fn: Callable) -> "Dataset":
        return Dataset(lambda: (y for x in self for y in fn(x)))

    def shard(self, num_shards: int, index: int) -> "Dataset":
        return Dataset(lambda: (x for i, x in enumerate(self)
                                if i % num_shards == index))

    def enumerate(self) -> "Dataset":
        return Dataset(lambda: enumerate(self))

    def repeat(self) -> "Dataset":
        def forever():
            while True:
                empty = True
                for x in self:
                    empty = False
                    yield x
                if empty:
                    raise ValueError("repeat() of an empty dataset")
        return Dataset(forever)


def _parallel_map(fn: Callable, items: Iterator, workers: int) -> Iterator:
    """``map(fn, items)`` in order on ``workers`` threads, at most
    ``2 * workers`` items ahead (the codec and torch release the GIL)."""
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        pending: collections.deque = collections.deque()
        for x in items:
            pending.append(pool.submit(fn, x))
            if len(pending) >= 2 * workers:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


# === storage format ==========================================================
# one Example per episode; images stored as encoded JPEG/PNG bytes per step
EPISODE_KEYS = ("steps/image_primary", "steps/proprio", "steps/action",
                "language_instruction", "file_path", "episode_id")


def write_episodes(path, episodes: Sequence[Dict]) -> None:
    """episodes: dicts with image_bytes (list[bytes]), proprio [T, Dp],
    action [T, Da], language (str), file_path (str), episode_id (int)."""
    with tfrecord.TFRecordWriter(path) as w:
        for ep in episodes:
            proprio = np.asarray(ep["proprio"], np.float32)
            action = np.asarray(ep["action"], np.float32)
            w.write(tfrecord.serialize_example({
                "steps/image_primary": [bytes(b) for b in ep["image_bytes"]],
                "steps/proprio": proprio.reshape(-1),
                "steps/action": action.reshape(-1),
                "language_instruction": [ep["language"].encode()],
                "file_path": [str(ep["file_path"]).encode()],
                "episode_id": np.asarray([int(ep["episode_id"])], np.int64),
                "num_steps": np.asarray([len(ep["image_bytes"])], np.int64),
                "proprio_dim": np.asarray([proprio.shape[-1]], np.int64),
                "action_dim": np.asarray([action.shape[-1]], np.int64),
            }))


def parse_episode(payload: bytes) -> Dict:
    """One serialized episode as a trajectory dict."""
    ex = tfrecord.parse_example(payload)
    T = int(ex["num_steps"][0])
    images = np.empty(T, dtype=object)
    images[:] = ex["steps/image_primary"]
    return {
        "observation": {
            "image_primary": images,
            "proprio": ex["steps/proprio"].reshape(T, int(ex["proprio_dim"][0])),
        },
        "action": ex["steps/action"].reshape(T, int(ex["action_dim"][0])),
        "task": {"language_instruction": ex["language_instruction"][0]},
        "file_path": np.full(T, ex["file_path"][0], dtype=object),
        "episode_id": np.full(T, int(ex["episode_id"][0]), np.int32),
    }


def read_episodes(files: Sequence[Path]) -> Dataset:
    return Dataset(lambda: (parse_episode(r) for f in files
                            for r in tfrecord.read_records(f)))


# === per-dataset standardization =============================================

def _slice_time(traj: Dict, sl: slice, keep=("task",)) -> Dict:
    return {k: (v if k in keep else tree_map(lambda x: x[sl], v))
            for k, v in traj.items()}


def bridge_orig_standardize(traj: Dict) -> Dict:
    """Drop the all-zero first step, binarize the gripper, relabel the
    movement to reached-state deltas dropping the last (action-less) step,
    split EEF / gripper state."""
    traj = _slice_time(traj, slice(1, None))
    a = traj["action"]
    grip = binarize_gripper_actions(a[:, -1]).astype(np.float32)
    traj["action"] = np.concatenate([a[:, :6], grip[:, None]], axis=1)
    proprio = traj["observation"]["proprio"]
    move = proprio[1:, :6] - proprio[:-1, :6]
    grip = traj["action"][:-1, -1:]
    traj = _slice_time(traj, slice(None, -1))
    traj["action"] = np.concatenate([move, grip], axis=1)
    traj["observation"]["EEF_state"] = traj["observation"]["proprio"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["proprio"][:, -1:]
    return traj


def _rel2abs_gripper(actions: np.ndarray) -> np.ndarray:
    """Relative open (-) / close (+) commands to an absolute [0, 1] state:
    the last command carried through no-ops, leading no-ops back-filled
    with the inverse of the first command, open when there is none."""
    delta = ((actions < -0.1).astype(np.float32)
             - (actions > 0.1).astype(np.float32))
    nonzero = np.flatnonzero(delta != 0)
    carry = np.float32(-delta[nonzero[0]] if nonzero.size else 1.0)
    out = np.empty_like(delta)
    for i, d in enumerate(delta):
        if d != 0:
            carry = d
        out[i] = carry
    return np.where(out > 0, 1.0, 0.0).astype(np.float32)


def rt1_style_standardize(traj: Dict) -> Dict:
    """xyz + rpy pass through; the relative gripper command becomes an
    absolute open (1) / close (0) state."""
    grip = _rel2abs_gripper(traj["action"][:, -1])
    traj["action"] = np.concatenate([traj["action"][:, :6], grip[:, None]],
                                    axis=1)
    traj["observation"]["EEF_state"] = traj["observation"]["proprio"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["proprio"][:, -1:]
    return traj


def taco_play_style_standardize(traj: Dict) -> Dict:
    """Gripper clipped to [0, 1]; EEF / gripper state split."""
    traj["action"] = np.concatenate(
        [traj["action"][:, :6], np.clip(traj["action"][:, -1:], 0.0, 1.0)],
        axis=1)
    traj["observation"]["EEF_state"] = traj["observation"]["proprio"][:, :6]
    traj["observation"]["gripper_state"] = traj["observation"]["proprio"][:, -1:]
    return traj


STANDARDIZE_FNS: Dict[str, Callable] = {
    "bridge_orig": bridge_orig_standardize,
    "bridge": bridge_orig_standardize,
    "rt_1": rt1_style_standardize,
    "kuka": rt1_style_standardize,
    "taco_play": taco_play_style_standardize,
}

# xyz + rpy normalized, the gripper passed through
ACTION_PROPRIO_NORMALIZATION_MASK = [True] * 6 + [False]

NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_orig", 1.0)],
    "bridge_orig": [("bridge_orig", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("rt_1", 1.0)],
}


# === dataset construction ====================================================

def _normalize(x: np.ndarray, st: Dict, norm_type) -> np.ndarray:
    mask = np.asarray(st.get("mask", [True] * len(st["min"])), bool)
    q99 = norm_type == NormalizationType.BOUNDS_Q99
    low = np.asarray(st["q01" if q99 else "min"], np.float32)
    high = np.asarray(st["q99" if q99 else "max"], np.float32)
    x = np.asarray(x, np.float32)
    out = np.where(mask, np.clip(np.float32(2.0) * (x - low)
                                 / (high - low + np.float32(1e-8))
                                 - np.float32(1.0), -1.0, 1.0), x)
    zeros = np.asarray(st["min"]) == np.asarray(st["max"])
    return np.where(zeros, np.float32(0.0), out).astype(np.float32)


def make_dataset_from_rlds(
    data_dir,
    name: str = "bridge_orig",
    split: str = "train",
    *,
    standardize_fn: Optional[Callable] = None,
    normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
    norm_mask: Optional[Sequence[bool]] = ACTION_PROPRIO_NORMALIZATION_MASK,
    cache_dir: Optional[str] = None,
    dataset_statistics: Optional[Dict] = None,
    keep_metadata: bool = True,
):
    """(trajectory Dataset, statistics): parse, standardize, statistics
    (computed over all splits, or cached), normalize."""
    files = sorted(Path(data_dir).glob(f"{name}-{split}*.tfrecord*"))
    if not files:
        raise FileNotFoundError(f"no {name}-{split} tfrecords in {data_dir}")
    if standardize_fn is None:
        standardize_fn = STANDARDIZE_FNS.get(name)
    if standardize_fn is None:
        from emmax_torch.data.oxe import OXE_STANDARDIZATION_TRANSFORMS

        standardize_fn = OXE_STANDARDIZATION_TRANSFORMS.get(name)

    def standardized(paths) -> Dataset:
        ds = read_episodes(paths)
        return ds.map(standardize_fn) if standardize_fn is not None else ds

    def post(traj):
        T = len(traj["action"])
        traj["observation"]["timestep"] = np.arange(T, dtype=np.int32)
        traj["dataset_name"] = np.full(T, name.encode(), dtype=object)
        return traj

    ds = standardized(files).map(post)

    if dataset_statistics is None:
        def compute():
            all_files = sorted(Path(data_dir).glob(f"{name}-*.tfrecord*"))
            actions, proprios = [], []
            for traj in standardized(all_files):
                actions.append(traj["action"])
                proprios.append(traj["observation"]["proprio"])
            stats = {"action": compute_statistics(actions),
                     "proprio": compute_statistics(proprios),
                     "num_trajectories": len(actions)}
            if norm_mask is not None:
                stats["action"]["mask"] = list(norm_mask)
            return stats

        if cache_dir is not None:
            dataset_statistics = cached_statistics(
                cache_dir, [str(data_dir), name, "all"], compute)
        else:
            dataset_statistics = compute()

    a_stats = dataset_statistics["action"]
    p_stats = dataset_statistics["proprio"]

    def normalize(traj):
        traj["action"] = _normalize(traj["action"], a_stats,
                                    normalization_type)
        traj["observation"]["proprio"] = _normalize(
            traj["observation"]["proprio"], p_stats, normalization_type)
        return traj

    if normalization_type is not None:
        ds = ds.map(normalize)
    if not keep_metadata:
        def drop_meta(traj):
            traj = dict(traj)
            traj.pop("file_path", None)
            traj.pop("episode_id", None)
            return traj
        ds = ds.map(drop_meta)
    return ds, dataset_statistics


def chunk_trajectory(traj: Dict, window_size: int,
                     future_action_window_size: int) -> Dict:
    """History windows of the observation and action chunks of
    ``window + future`` steps, clamped at 0 and at the goal timestep, with
    the actions past the goal zeroed."""
    T = len(traj["action"])
    w, f = window_size, future_action_window_size
    offsets = np.arange(T)[:, None] + np.arange(-w + 1, 1)[None, :]
    hist = np.maximum(offsets, 0)
    act = np.arange(T)[:, None] + np.arange(-w + 1, f + 1)[None, :]
    task = traj.get("task", {})
    goal_ts = (np.asarray(task["timestep"]) if "timestep" in task
               else np.full(T, T - 1))
    clamped = np.minimum(np.maximum(act, 0), goal_ts[:, None])
    out = dict(traj)
    out["observation"] = tree_map(lambda x: x[hist], traj["observation"])
    action = traj["action"][clamped]
    out["observation"]["pad_mask"] = offsets >= 0
    past_goal = act > goal_ts[:, None]
    out["action"] = np.where(past_goal[:, :, None], np.zeros_like(action),
                             action)
    return out


def apply_trajectory_transforms(ds: Dataset, *, train: bool = True,
                                window_size: int = 1,
                                future_action_window_size: int = 0,
                                skip_unlabeled: bool = False,
                                max_action: Optional[float] = None,
                                max_proprio: Optional[float] = None,
                                goal_relabeling_strategy: Optional[str] = None,
                                goal_relabeling_kwargs: Optional[Dict] = None,
                                task_augment_strategy: Optional[str] = None,
                                task_augment_kwargs: Optional[Dict] = None,
                                subsample_length: Optional[int] = None,
                                seed: int = 0) -> Dataset:
    """Filters, pad-mask dict, goal relabeling, task augmentation (train
    only), chunking, subsampling (train only), in the JAX package's order.
    The random transforms draw from generators keyed by ``seed`` and the
    trajectory's position in the stream."""
    from emmax_torch.data.relabeling import (GOAL_RELABELING_STRATEGIES,
                                             TASK_AUGMENT_STRATEGIES,
                                             add_pad_mask_dict)

    if skip_unlabeled:
        ds = ds.filter(lambda t: len(t["task"]["language_instruction"]) > 0)
    if max_action is not None:
        ds = ds.filter(lambda t: bool(np.all(np.abs(t["action"])
                                             <= max_action)))
    if max_proprio is not None:
        ds = ds.filter(lambda t: bool(np.all(
            np.abs(t["observation"]["proprio"]) <= max_proprio)))
    ds = ds.map(add_pad_mask_dict)

    def keyed(stage: int, fn: Callable) -> Callable:
        def run(item):
            i, traj = item
            rng = np.random.default_rng([seed, stage, i])
            return fn(traj, lambda shape: rng.random(shape, np.float32))
        return run

    if goal_relabeling_strategy is not None:
        fn = GOAL_RELABELING_STRATEGIES[goal_relabeling_strategy]
        kw = goal_relabeling_kwargs or {}
        ds = ds.enumerate().map(keyed(0, lambda t, r: fn(t, rand=r, **kw)))
    if train and task_augment_strategy is not None:
        fn2 = TASK_AUGMENT_STRATEGIES[task_augment_strategy]
        kw2 = task_augment_kwargs or {}
        ds = ds.enumerate().map(keyed(1, lambda t, r: fn2(t, rand=r, **kw2)))

    ds = ds.map(lambda t: chunk_trajectory(t, window_size,
                                           future_action_window_size))

    if train and subsample_length is not None:
        def subsample(item):
            i, traj = item
            T = len(traj["action"])
            if T <= subsample_length:
                return traj
            idx = np.random.default_rng([seed, 2, i]).permutation(
                T)[:subsample_length]
            return tree_map(lambda x: x[idx] if np.ndim(x) > 0 else x, traj)

        ds = ds.enumerate().map(subsample)
    return ds


def _frames(traj: Dict) -> Iterator[Dict]:
    T = len(traj["action"])
    traj = dict(traj)
    traj["task"] = tree_map(
        lambda x: (np.full(T, x, dtype=object) if isinstance(x, bytes)
                   else np.full(T, x) if np.ndim(x) == 0 else x),
        traj["task"])
    for i in range(T):
        yield tree_map(lambda x: x[i], traj)


def flatten_trajectories(ds: Dataset) -> Dataset:
    """Trajectories -> frames (per-episode task scalars repeated)."""
    return ds.flat_map(_frames)


def resize_lanczos3(images: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 ``[..., H, W, 3]`` -> uint8 ``[..., h, w, 3]``: lanczos3 with
    antialiasing (``tf.image.resize(method="lanczos3", antialias=True)``)
    as two weight matrices, rounded half to even and clipped before the
    cast."""
    import torch

    from emmax_torch.ops.image import resize_weights

    img = torch.from_numpy(np.ascontiguousarray(images)).to(torch.float32)
    H, W = img.shape[-3], img.shape[-2]
    h, w = size
    if (H, W) != (h, w):
        cpu = torch.device("cpu")
        img = torch.einsum("...hwc,hy->...ywc", img,
                           resize_weights(H, h, cpu, kernel="lanczos3"))
        img = torch.einsum("...hwc,wx->...hxc", img,
                           resize_weights(W, w, cpu, kernel="lanczos3"))
    return img.round().clamp(0.0, 255.0).to(torch.uint8).numpy()


def apply_frame_transforms(ds: Dataset, *,
                           resize: Optional[Tuple[int, int]] = None,
                           train: bool = False,
                           image_augment_kwargs: Optional[Dict] = None,
                           num_parallel_calls: int = 16,
                           augment_seed: int = 0) -> Dataset:
    """Decode (IFAST, as ``tf.io.decode_image``) and resize, then (train
    only) augment every ``image_*`` key keyed by the frame's index in the
    stream, ``augment_seed`` and the image's index. ``image_augment_kwargs``
    is one kwargs dict (with ``augment_order``) for every image, or a
    ``{name: kwargs}`` mapping keyed like ``image_{name}``; images whose
    pad mask is False are left as they are."""

    def decode(frame):
        img = frame["observation"]["image_primary"]
        if isinstance(img, np.ndarray) and img.ndim == 1:
            imgs = np.stack([codec.decode_image(b) for b in img])
        else:
            imgs = codec.decode_image(img)
        if resize is not None:
            imgs = resize_lanczos3(imgs, resize)
        frame["observation"]["image_primary"] = imgs
        return frame

    workers = max(1, min(num_parallel_calls, len(os.sched_getaffinity(0))))
    ds = ds.map(decode, num_parallel_calls=workers)

    if train and image_augment_kwargs:
        import torch

        from emmax_torch.data.augment import augment_image

        def augment_frame(item):
            idx, frame = item
            obs = frame["observation"]
            names = sorted(k[6:] for k in obs if k.startswith("image_"))
            per_name = ({n: image_augment_kwargs for n in names}
                        if "augment_order" in image_augment_kwargs
                        else image_augment_kwargs)
            for i, name in enumerate(names):
                if name not in per_name:
                    continue
                mask = obs.get("pad_mask_dict", {}).get(f"image_{name}")
                if mask is not None and not np.all(mask):
                    continue
                img = torch.from_numpy(obs[f"image_{name}"])
                key = (idx % (2 ** 31 - 1), augment_seed, i)
                if img.dim() == 4:
                    out = torch.stack([augment_image(x, key, **per_name[name])
                                       for x in img])
                else:
                    out = augment_image(img, key, **per_name[name])
                obs[f"image_{name}"] = out.numpy()
            return frame

        ds = ds.enumerate().map(augment_frame, num_parallel_calls=workers)
    return ds


def make_interleaved_dataset(datasets: Sequence[Dataset],
                             weights: Sequence[float], *,
                             shuffle_buffer_size: int = 1000,
                             seed: int = 7) -> Dataset:
    """Each element from dataset i with probability weights[i] (each
    repeated forever), through a shuffle buffer."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def stream():
        rng = np.random.default_rng(seed)
        its = [iter(d.repeat()) for d in datasets]
        buf: List = []
        while True:
            i = int(rng.choice(len(its), p=w)) if len(its) > 1 else 0
            buf.append(next(its[i]))
            if len(buf) >= shuffle_buffer_size:
                j = int(rng.integers(len(buf)))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield buf.pop()

    return Dataset(stream)


def make_single_dataset(data_dir, name: str = "bridge_orig",
                        split: str = "train", *, window_size: int = 1,
                        future_action_window_size: int = 0,
                        resize: Optional[Tuple[int, int]] = None,
                        cache_dir=None):
    """The single-dataset frame pipeline: (frames, statistics)."""
    ds, stats = make_dataset_from_rlds(data_dir, name, split,
                                       cache_dir=cache_dir)
    ds = apply_trajectory_transforms(
        ds, window_size=window_size,
        future_action_window_size=future_action_window_size)
    ds = flatten_trajectories(ds)
    ds = apply_frame_transforms(ds, resize=resize)
    return ds, stats


def load_bridgev2_dataset(data_dir, split: str = "train", *, cache_dir=None):
    """Trajectory-level bridge data with the ``file_path`` / ``episode_id``
    join keys of the GCOT records."""
    return make_dataset_from_rlds(data_dir, "bridge_orig", split,
                                  cache_dir=cache_dir, keep_metadata=True)


def trajectory_key(traj: Dict) -> str:
    """``file_path|episode_id``, the key GCOT records name a frame by."""
    fp = traj["file_path"][0]
    fp = fp.decode("utf-8") if isinstance(fp, bytes) else str(fp)
    return fp + "|" + str(int(traj["episode_id"][0]))


class RLDSFrameSource:
    """A ``FrameSource`` over the trajectory-level bridge data: an index
    ``file_path|episode_id -> encoded frames`` built once (the encoded
    bytes only), frames decoded with IFAST on request."""

    def __init__(self, data_dir, splits: Iterable[str] = ("train", "val"),
                 cache_dir=None) -> None:
        self.index: Dict[str, np.ndarray] = {}
        for split in splits:
            try:
                ds, _ = load_bridgev2_dataset(data_dir, split,
                                              cache_dir=cache_dir)
            except FileNotFoundError:
                continue
            for traj in ds:
                self.index[trajectory_key(traj)] = \
                    traj["observation"]["image_primary"]

    def get_frame(self, key: str, index: int) -> np.ndarray:
        return codec.decode_image(self.index[key][index], "ifast")
