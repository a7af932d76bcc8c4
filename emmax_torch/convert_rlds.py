"""One-time TFDS / RLDS -> shard conversion, port of
``scripts/convert_rlds.py``.

The port's data path reads the one-Example-per-episode TFRecord layout of
``emmax_torch.data.rlds`` (``write_episodes``). A real RLDS corpus (the
124 GB ``bridge_orig``, say) is converted once, wherever
``tensorflow_datasets`` is installed (it is imported only by
``iter_tfds_episodes``):

    python -m emmax_torch.convert_rlds --name bridge_orig \\
        --data_dir /path/to/tensorflow_datasets --out_dir /data/efs1 \\
        --splits train,val

It writes ``{out_dir}/{name}-{split}-{shard:05d}.tfrecord`` (the glob
``make_dataset_from_rlds`` reads) and ``dataset_statistics.json`` over the
standardized trajectories. Frames already encoded pass through; arrays are
JPEG-encoded (quality 95) by the port's own codec (``data/codec.py``).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from emmax_torch.data.rlds import make_dataset_from_rlds, write_episodes
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


def _encode_image(img) -> bytes:
    """uint8 HWC array -> JPEG bytes; encoded bytes pass through."""
    if isinstance(img, (bytes, np.bytes_)):
        return bytes(img)
    from emmax_torch.data.codec import encode_jpeg

    return encode_jpeg(np.asarray(img, np.uint8), 95)


def _stack_proprio(obs: Dict[str, np.ndarray],
                   state_keys: Sequence[Optional[str]],
                   traj_len: int) -> np.ndarray:
    """Concatenate 1-D state keys; one zero column per ``None`` entry
    (reference ``dataset.py:160-175``)."""
    cols: List[np.ndarray] = []
    for key in state_keys:
        if key is None:
            cols.append(np.zeros((traj_len, 1), np.float32))
        else:
            col = np.asarray(obs[key], np.float32)
            cols.append(col[:, None] if col.ndim == 1 else col)
    if not cols:
        return np.zeros((traj_len, 1), np.float32)
    return np.concatenate(cols, axis=1)


def convert_episodes(raw_episodes: Iterable[Dict], *,
                     image_key: str = "image_0",
                     state_keys: Sequence[Optional[str]] = ("state",),
                     language_key: str = "language_instruction",
                     start_episode_id: int = 0) -> Iterator[Dict]:
    """Raw RLDS episode dicts -> ``write_episodes``' episode dicts.

    ``raw_episodes``: iterables of
    ``{"steps": {"observation": {...}, "action": [T, Da],
                 <language_key>: [T] bytes/str},
       "episode_metadata": {"file_path": ..., "episode_id": ...}}``
    with numpy leaves (the shape ``tfds.as_numpy`` produces after stacking
    the steps sub-dataset).
    """
    for fallback_id, raw in enumerate(raw_episodes, start=start_episode_id):
        steps = raw["steps"]
        obs = steps["observation"]
        action = np.asarray(steps["action"], np.float32)
        T = action.shape[0]
        images = obs[image_key]
        lang_arr = steps.get(language_key)
        if lang_arr is None:
            lang_arr = obs.get(language_key, [b""])
        lang = lang_arr[0] if not isinstance(lang_arr, (str, bytes)) else lang_arr
        if isinstance(lang, bytes):
            lang = lang.decode("utf-8")
        meta = raw.get("episode_metadata", {})
        file_path = meta.get("file_path", b"")
        if isinstance(file_path, (bytes, np.bytes_)):
            file_path = file_path.decode("utf-8")
        if isinstance(file_path, np.ndarray):
            file_path = file_path.reshape(-1)[0].decode("utf-8")
        episode_id = int(np.reshape(meta.get("episode_id", fallback_id), -1)[0])
        yield {
            "image_bytes": [_encode_image(images[t]) for t in range(T)],
            "proprio": _stack_proprio(obs, state_keys, T),
            "action": action,
            "language": str(lang),
            "file_path": str(file_path),
            "episode_id": episode_id,
        }


def iter_tfds_episodes(name: str, data_dir: str, split: str) -> Iterator[Dict]:
    """The episodes of a TFDS builder directory, each nested ``steps``
    sub-dataset stacked into numpy arrays (``tensorflow_datasets`` is
    imported here, on first use)."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:
        raise ImportError(
            "tensorflow_datasets is required to read the source corpus; run "
            "the conversion where TFDS is installed, then ship the shards"
        ) from e
    builder = tfds.builder(name, data_dir=data_dir)
    ds = builder.as_dataset(split=split, shuffle_files=False)
    for raw in ds:
        # materialize the nested steps sub-dataset into stacked numpy arrays
        stacked: Dict = {}
        for step in raw["steps"]:
            for key, val in step.items():
                if isinstance(val, dict):
                    stacked.setdefault(key, {})
                    for k2, v2 in val.items():
                        stacked[key].setdefault(k2, []).append(v2.numpy())
                else:
                    stacked.setdefault(key, []).append(val.numpy())

        def finalize(v):
            if isinstance(v, dict):
                return {k: finalize(x) for k, x in v.items()}
            first = v[0]
            if isinstance(first, (bytes, np.bytes_)):
                return list(v)
            return np.stack(v)

        episode = {"steps": finalize(stacked)}
        if "episode_metadata" in raw:
            episode["episode_metadata"] = {
                k: v.numpy() for k, v in raw["episode_metadata"].items()}
        yield episode


def write_shards(episodes: Iterable[Dict], out_dir, name: str, split: str,
                 shard_size: int = 256) -> int:
    """Episode dicts into ``{name}-{split}-{i:05d}.tfrecord`` shards of
    ``shard_size``; returns the episode count."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shard: List[Dict] = []
    shard_idx = 0
    total = 0

    def flush():
        nonlocal shard, shard_idx
        if shard:
            write_episodes(
                out_dir / f"{name}-{split}-{shard_idx:05d}.tfrecord", shard)
            shard_idx += 1
            shard = []

    for ep in episodes:
        shard.append(ep)
        total += 1
        if len(shard) >= shard_size:
            flush()
    flush()
    return total


def convert(name: str, data_dir: str, out_dir, *,
            splits: Sequence[str] = ("train", "val"), shard_size: int = 256,
            image_key: Optional[str] = None,
            state_keys: Optional[Sequence[Optional[str]]] = None,
            language_key: str = "language_instruction") -> Dict:
    """TFDS builder -> shards + ``dataset_statistics.json``; returns the
    episode count of each split."""
    if image_key is None or state_keys is None:
        # pull the per-dataset schema from the OXE registry when known
        from emmax_torch.data.oxe import OXE_DATASET_CONFIGS

        cfg = OXE_DATASET_CONFIGS.get(name, {})
        if image_key is None:
            image_key = cfg.get("image_obs_keys", {}).get("primary", "image_0")
        if state_keys is None:
            state_keys = cfg.get("state_obs_keys", ["state"])
    counts = {}
    for split in splits:
        eps = convert_episodes(
            iter_tfds_episodes(name, data_dir, split), image_key=image_key,
            state_keys=state_keys, language_key=language_key)
        counts[split] = write_shards(eps, out_dir, name, split,
                                     shard_size=shard_size)
        overwatch.info(f"{name}/{split}: wrote {counts[split]} episodes")
    # statistics over the standardized train trajectories, beside the shards
    _, stats = make_dataset_from_rlds(out_dir, name, "train")
    stats_path = Path(out_dir) / "dataset_statistics.json"
    with open(stats_path, "w") as f:
        json.dump(stats, f, indent=2)
    overwatch.info(f"statistics -> {stats_path}")
    return counts


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--name", default="bridge_orig")
    parser.add_argument("--data_dir", required=True,
                        help="TFDS root containing the builder directory")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--splits", default="train,val")
    parser.add_argument("--shard_size", type=int, default=256)
    parser.add_argument("--image_key", default=None)
    parser.add_argument("--language_key", default="language_instruction")
    args = parser.parse_args(argv)
    return convert(args.name, args.data_dir, args.out_dir,
                   splits=args.splits.split(","), shard_size=args.shard_size,
                   image_key=args.image_key, language_key=args.language_key)


if __name__ == "__main__":
    main()
