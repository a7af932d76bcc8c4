"""Build and load the port's hand-written CUDA kernels.

Each kernel lives in one ``emmax_torch/csrc/<name>.cu`` with a plain C
entry point. It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``emmax_torch/_build/`` (listed in ``.gitignore``) at first
use, named by a hash of its sources so an edited source is rebuilt, and
loaded with ``ctypes``. Nothing is compiled or loaded at import time:
the CPU tests import every module on a machine with no ``nvcc``.

``build_all`` starts one ``nvcc`` per source at once and waits for all.
Several entry points of one source (``flash_bwd.cu``'s dQ and dK/dV
kernels) share its library and keep separate launch counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def torch_dtype_code(dtype: torch.dtype) -> int:
    """The ``dtype`` argument of the C entry points (csrc/common.cuh)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")


class CudaKernel:
    """One ``csrc/<source>`` kernel: build, load, launch bookkeeping.

    ``launches`` counts the wrapper's kernel launches; a run resets it to 0
    and reads it afterwards to show that a path went through the kernel.
    ``name`` defaults to the source's stem.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type], name: Optional[str] = None
                 ) -> None:
        self.source = source
        self._name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._fn = None

    @property
    def name(self) -> str:
        return self._name or Path(self.source).stem

    def library_path(self) -> Path:
        h = hashlib.sha1()
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = Path(self.source).stem
        return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> Optional[tuple]:
        """Start nvcc unless the library is already built; returns
        ``(process, temp path, library path, start time)`` or None."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / self.source)]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out, t0

    def finish_build(self, build: Optional[tuple]) -> None:
        if build is None:
            self.build_seconds = 0.0
            return
        proc, tmp, out, t0 = build
        log, _ = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)

    def fn(self):
        """The loaded C entry point (built on first use)."""
        if self._fn is None:
            if not self.library_path().exists():
                self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise on a non-zero cudaError_t."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError_t {rc}")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every source in parallel (one nvcc each); returns seconds per
    source (0.0 when the library was already built)."""
    kernels = list(kernels)
    first = {}
    for k in kernels:
        first.setdefault(k.source, k)
    procs = [k.start_build() for k in first.values()]
    for k, p in zip(first.values(), procs):
        k.finish_build(p)
    for k in kernels:
        k.fn()
    return {src: k.build_seconds for src, k in first.items()}


def current_stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
