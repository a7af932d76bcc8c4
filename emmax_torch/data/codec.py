"""Image decode and encode for the port's data path, with no TensorFlow,
OpenCV or PIL.

JPEG goes through ``emmax_torch/csrc/codec.cc``: a baseline decoder that
follows libjpeg-turbo's arithmetic, so that its pixels equal the library's
bit for bit, and a baseline encoder. The DCT method is an argument:

- ``"ifast"`` (libjpeg's ``JDCT_IFAST``) is what ``tf.io.decode_image``
  uses, so every RLDS path decodes with it;
- ``"islow"`` (``JDCT_ISLOW``, libjpeg's default, also OpenCV's) is what
  the frame store of the JAX package decodes with.

The library is compiled with ``g++`` at first use into the git-ignored
``emmax_torch/_build/`` (named by a hash of its source and flags, so an
edited source is rebuilt) and loaded with ``ctypes``; importing this module
builds nothing. PNG (8-bit, not interlaced), which ``tf.io.decode_image``
also reads, is decoded here on ``zlib`` and numpy. Other formats raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "codec.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
DCT_METHODS = {"ifast": 0, "islow": 1}
_ERRORS = {1: "truncated", 2: "unsupported", 3: "corrupt",
           4: "size mismatch"}
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcodec-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the codec unless it is built; returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded codec (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            c = ctypes
            so = c.CDLL(str(build()))
            u8p = c.POINTER(c.c_uint8)
            so.emx_jpeg_info.argtypes = [u8p, c.c_uint64,
                                         c.POINTER(c.c_int32),
                                         c.POINTER(c.c_int32),
                                         c.POINTER(c.c_int32)]
            so.emx_jpeg_info.restype = c.c_int
            so.emx_jpeg_decode.argtypes = [u8p, c.c_uint64, c.c_int32, u8p,
                                           c.c_int32, c.c_int32]
            so.emx_jpeg_decode.restype = c.c_int
            so.emx_jpeg_decode_batch.argtypes = [
                c.POINTER(c.c_void_p), c.POINTER(c.c_uint64), c.c_int32,
                c.c_int32, u8p, c.c_int32, c.c_int32, c.c_int32]
            so.emx_jpeg_decode_batch.restype = c.c_int
            so.emx_jpeg_encode.argtypes = [u8p, c.c_int32, c.c_int32,
                                           c.c_int32, u8p, c.c_int64]
            so.emx_jpeg_encode.restype = c.c_int64
            so.emx_crc32c.argtypes = [u8p, c.c_uint64, c.c_uint32]
            so.emx_crc32c.restype = c.c_uint32
            _lib = so
    return _lib


def _ptr(buf) -> ctypes.POINTER(ctypes.c_uint8):
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _bytes(blob):
    """``bytes``, or a 1-D uint8 array (a view into a mapped file) as it is."""
    if isinstance(blob, np.ndarray) and blob.dtype == np.uint8:
        return np.ascontiguousarray(blob)
    return bytes(blob)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, as TFRecord framing uses it."""
    data = bytes(data)
    return int(lib().emx_crc32c(_ptr(data), len(data), 0))


def jpeg_size(blob: bytes) -> tuple:
    """(width, height) of a JPEG from its frame header."""
    blob = _bytes(blob)
    w, h, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib().emx_jpeg_info(_ptr(blob), len(blob), ctypes.byref(w),
                             ctypes.byref(h), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"cannot read JPEG header: {_ERRORS.get(rc, rc)}")
    return int(w.value), int(h.value)


def _dct(method: str) -> int:
    if method not in DCT_METHODS:
        raise ValueError(f"dct method {method!r}; known {sorted(DCT_METHODS)}")
    return DCT_METHODS[method]


def decode_jpeg(blob: bytes, dct: str = "ifast") -> np.ndarray:
    """A JPEG as uint8 RGB ``[H, W, 3]``."""
    blob = _bytes(blob)
    w, h = jpeg_size(blob)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib().emx_jpeg_decode(_ptr(blob), len(blob), _dct(dct), _ptr(out),
                               w, h)
    if rc != 0:
        raise ValueError(f"JPEG decode failed: {_ERRORS.get(rc, rc)}")
    return out


def decode_jpeg_batch(blobs: Sequence[bytes], dct: str = "ifast",
                      threads: Optional[int] = None) -> np.ndarray:
    """JPEGs of one size as ``[N, H, W, 3]``, decoded on ``threads``
    threads (default: the CPUs this process may use)."""
    blobs = [_bytes(b) for b in blobs]
    if not blobs:
        raise ValueError("no frames to decode")
    w, h = jpeg_size(blobs[0])
    n = len(blobs)
    out = np.empty((n, h, w, 3), np.uint8)
    ptrs = (ctypes.c_void_p * n)(*[ctypes.cast(_ptr(b), ctypes.c_void_p).value
                                   for b in blobs])
    sizes = (ctypes.c_uint64 * n)(*[len(b) for b in blobs])
    threads = threads or len(os.sched_getaffinity(0))
    failed = lib().emx_jpeg_decode_batch(ptrs, sizes, n, _dct(dct),
                                         _ptr(out), w, h, threads)
    if failed:
        raise ValueError(f"{failed} of {n} frames failed to decode (frames "
                         f"of a batch must be JPEGs of one size)")
    return out


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """uint8 RGB ``[H, W, 3]`` as baseline 4:2:0 JPEG bytes."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an [H, W, 3] image, got {img.shape}")
    h, w = img.shape[:2]
    cap = h * w * 3 // 2 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib().emx_jpeg_encode(_ptr(img), w, h, int(quality), _ptr(out),
                                  cap)
        if n == 0:
            raise ValueError(f"cannot encode a {w}x{h} JPEG")
        if n > 0:
            return out[:n].tobytes()
        cap = -n


# --- PNG ---------------------------------------------------------------------

def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):     # left neighbours: sequential
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    cur[x] = (cur[x] + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
                else:
                    b = prev[x]
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                    cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as uint8 RGB ``[H, W, 3]``: grey is
    repeated over three channels and alpha dropped, as
    ``tf.io.decode_png(channels=3)`` gives them."""
    blob = bytes(blob)
    if not blob.startswith(PNG_MAGIC):
        raise ValueError("not a PNG")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(blob):
        length, ctype = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        if len(data) != length:
            raise ValueError("truncated PNG")
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, interlace {interlace} "
                         f"is not supported (8-bit, non-interlaced only)")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise ValueError(f"PNG colour type {color}")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                    channels).reshape(h, w, channels)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[pix[..., 0]]
    if color in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def decode_image(blob: bytes, dct: str = "ifast") -> np.ndarray:
    """``tf.io.decode_image(blob, channels=3)`` without TensorFlow: JPEG
    (with ``dct``) or PNG to uint8 RGB ``[H, W, 3]``."""
    blob = bytes(blob)
    if blob[:2] == b"\xff\xd8":
        return decode_jpeg(blob, dct)
    if blob.startswith(PNG_MAGIC):
        return decode_png(blob)
    raise ValueError("unsupported image format (JPEG and PNG are read)")
