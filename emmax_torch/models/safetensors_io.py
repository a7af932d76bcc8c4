"""The safetensors file format, read and written without the
``safetensors`` package.

A file is an 8-byte little-endian header length ``n``, a JSON header of
``n`` bytes (``{name: {"dtype", "shape", "data_offsets": [begin, end]}}``
plus an optional ``"__metadata__"`` of strings, padded with spaces to a
multiple of 8) and the tensors' raw little-endian bytes, offsets counted
from the end of the header.

``load_file`` maps the file copy-on-write and builds each tensor with
``torch.frombuffer`` on the map: no byte is read until a tensor is used,
and a tensor moved to another device or dtype leaves no host copy behind.
``load_dir`` reads every shard of a directory (a Hugging Face export) and
checks them against ``model.safetensors.index.json`` where there is one;
``save_dir`` writes such shards and their index.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

DTYPES: Dict[str, torch.dtype] = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def read_header(path) -> tuple:
    """(header dict without ``__metadata__``, metadata, data offset)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, metadata, 8 + n


def load_file(path, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of one file, on ``device``. On the CPU the tensors are
    views of a private map of the file (writes stay in this process)."""
    header, _, base = read_header(path)
    size = Path(path).stat().st_size
    with open(path, "rb") as f:
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > base else b"")
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}; known: {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} has offsets "
                             f"{begin}..{end} for {numel} x {itemsize} "
                             "bytes, or runs past the end of the file")
        if numel == 0:
            t = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:
            # frombuffer needs an aligned start: copy this one tensor
            t = torch.frombuffer(bytearray(buf[base + begin:base + end]),
                                 dtype=dtype).reshape(shape)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=numel,
                                 offset=base + begin).reshape(shape)
        out[name] = t if torch.device(device).type == "cpu" else t.to(device)
    return out


def _pad8(blob: bytes) -> bytes:
    return blob + b" " * (-len(blob) % 8)


def save_file(sd: Mapping[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``sd`` to ``path``; returns the bytes of tensor data. Tensors
    are laid out by element size (largest first), then name, so each
    starts aligned to its element size."""
    items = sorted(sd.items(), key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             "safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = _pad8(json.dumps(header, separators=(",", ":")).encode())
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1)
                        .view(torch.uint8).numpy())
    return offset


def save_dir(sd: Mapping[str, torch.Tensor], out_dir,
             max_shard_bytes: float = 5e9,
             metadata: Optional[Dict[str, str]] = None) -> list:
    """Write ``sd`` as Hugging Face shards: ``model.safetensors`` when it
    fits one shard, else ``model-0000i-of-0000n.safetensors`` (each at most
    ``max_shard_bytes`` unless one tensor is larger) and the index. Returns
    the shard paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shards, cur, cur_bytes = [], {}, 0
    for name, t in sd.items():
        n = t.numel() * t.element_size()
        if cur and cur_bytes + n > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[name] = t
        cur_bytes += n
    shards.append(cur)
    meta = {"format": "pt", **(metadata or {})}
    if len(shards) == 1:
        path = out_dir / "model.safetensors"
        save_file(shards[0], path, meta)
        return [path]
    paths, weight_map, total = [], {}, 0
    for i, shard in enumerate(shards):
        path = out_dir / f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += save_file(shard, path, meta)
        weight_map.update({name: path.name for name in shard})
        paths.append(path)
    (out_dir / INDEX_FILE).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return paths


def load_dir(path, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of every ``*.safetensors`` shard under ``path``. With an
    index, each shard it names must exist and hold the tensors it lists."""
    path = Path(path)
    shards = sorted(path.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    index = path / INDEX_FILE
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        for shard in sorted(set(weight_map.values())):
            if not (path / shard).exists():
                raise FileNotFoundError(f"{index} names missing shard "
                                        f"{shard}")
            have = set(read_header(path / shard)[0])
            want = {k for k, v in weight_map.items() if v == shard}
            if want - have:
                raise KeyError(f"{shard} lacks {sorted(want - have)[:5]} "
                               f"that {INDEX_FILE} lists")
    sd: Dict[str, torch.Tensor] = {}
    for shard in shards:
        part = load_file(shard, device)
        dup = set(part) & set(sd)
        if dup:
            raise KeyError(f"{shard.name} repeats tensors "
                           f"{sorted(dup)[:5]} of another shard")
        sd.update(part)
    return sd
