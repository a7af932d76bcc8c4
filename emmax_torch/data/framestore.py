"""The frame store, port of ``emmax_tpu/data/framestore.py``: trajectories
of JPEG frames packed into one memory-mapped shard ("EFS1"), indexed by
``file_path|episode_id`` keys, decoded one at a time or a batch at a time
on the codec's threads.

The format is the JAX package's, byte for byte (little endian):

    magic u32 = 0x31534645 ("EFS1") | num_trajs u64
    per trajectory: key_len u32 | key | num_frames u32
                    per frame: offset u64 | size u64 | width u32 | height u32
    frame payloads (JPEG) at their offsets

so a store written by either package opens in the other. Frames decode
with libjpeg's ISLOW DCT, as the JAX package's native store decodes them
(``data/codec.py``); the RLDS paths decode with IFAST.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from emmax_torch.data import codec

_MAGIC = 0x31534645  # "EFS1"
_FRAME = np.dtype([("offset", "<u8"), ("size", "<u8"), ("width", "<u4"),
                   ("height", "<u4")])
DCT = "islow"


class FrameStoreWriter:
    """Pack trajectories of JPEG frames into an EFS1 shard."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        self._trajs: List[Tuple[str, List[Tuple[bytes, int, int]]]] = []

    def add_trajectory(self, key: str, jpeg_frames: Sequence[bytes]) -> None:
        frames = []
        for blob in jpeg_frames:
            w, h = codec.jpeg_size(blob)
            frames.append((bytes(blob), w, h))
        self._trajs.append((key, frames))

    def add_trajectory_arrays(self, key: str, images: Sequence[np.ndarray],
                              quality: int = 95) -> None:
        """uint8 RGB frames, encoded with the port's JPEG encoder."""
        self.add_trajectory(key, [codec.encode_jpeg(img, quality)
                                  for img in images])

    def finalize(self) -> Path:
        header = bytearray(struct.pack("<IQ", _MAGIC, len(self._trajs)))
        offset = len(header) + sum(4 + len(k.encode()) + 4 + 24 * len(f)
                                   for k, f in self._trajs)
        for key, frames in self._trajs:
            kb = key.encode()
            header += struct.pack("<I", len(kb)) + kb
            header += struct.pack("<I", len(frames))
            for blob, w, h in frames:
                header += struct.pack("<QQII", offset, len(blob), w, h)
                offset += len(blob)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            f.write(header)
            for _, frames in self._trajs:
                for blob, _, _ in frames:
                    f.write(blob)
        return self.path


class FrameStore:
    """A ``FrameSource`` over an EFS1 shard."""

    def __init__(self, path) -> None:
        with open(path, "rb") as f:
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._data = np.frombuffer(self._map, np.uint8)
        magic, n = struct.unpack_from("<IQ", self._map, 0)
        if magic != _MAGIC:
            raise ValueError(f"{path} is not an EFS1 frame store")
        pos = 12
        self._keys: List[str] = []
        self._frames: List[np.ndarray] = []
        self._index: Dict[str, int] = {}
        for t in range(n):
            (klen,) = struct.unpack_from("<I", self._map, pos)
            key = bytes(self._map[pos + 4:pos + 4 + klen]).decode()
            (nf,) = struct.unpack_from("<I", self._map, pos + 4 + klen)
            pos += 8 + klen
            self._frames.append(np.frombuffer(self._map, _FRAME, nf, pos))
            pos += 24 * nf
            self._keys.append(key)
            self._index[key] = t

    @property
    def num_trajectories(self) -> int:
        return len(self._keys)

    def keys(self) -> List[str]:
        return list(self._keys)

    def _traj(self, key: str) -> np.ndarray:
        if key not in self._index:
            raise KeyError(key)
        return self._frames[self._index[key]]

    def traj_info(self, key: str) -> Tuple[int, int, int]:
        """(num_frames, width, height)."""
        fr = self._traj(key)
        if not len(fr):
            return 0, 0, 0
        return len(fr), int(fr[0]["width"]), int(fr[0]["height"])

    def _blob(self, key: str, index: int) -> np.ndarray:
        fr = self._traj(key)
        if not 0 <= index < len(fr):
            raise IndexError(f"{key}[{index}]: {len(fr)} frames")
        o, s = int(fr[index]["offset"]), int(fr[index]["size"])
        return self._data[o:o + s]

    def get_frame(self, key: str, index: int) -> np.ndarray:
        return codec.decode_jpeg(self._blob(key, index), DCT)

    def get_batch(self, keys: Sequence[str], indices: Sequence[int]
                  ) -> np.ndarray:
        """A batch of frames of one size, ``[N, H, W, 3]``, decoded in
        parallel."""
        if len(keys) != len(indices):
            raise ValueError("keys and indices differ in length")
        return codec.decode_jpeg_batch(
            [self._blob(k, int(i)) for k, i in zip(keys, indices)], DCT)


def pack_rlds_to_framestore(data_dir, out_path, splits=("train", "val")
                            ) -> Path:
    """Bridge TFRecords -> one EFS1 shard (the encoded frames as they are)."""
    from emmax_torch.data.rlds import load_bridgev2_dataset, trajectory_key

    writer = FrameStoreWriter(out_path)
    for split in splits:
        try:
            ds, _ = load_bridgev2_dataset(data_dir, split)
        except FileNotFoundError:
            continue
        for traj in ds:
            writer.add_trajectory(trajectory_key(traj),
                                  list(traj["observation"]["image_primary"]))
    return writer.finalize()
