"""Profiling hooks, port of ``emmax_tpu/util/profiling.py``.

- ``trace(log_dir)``: a ``torch.profiler`` capture of the enclosed block
  (host, and the card where there is one), written to ``log_dir`` as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``);
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``), and an NVTX range on the card;
- ``SectionTimer``: an accumulating host-side wall-clock timer for phases
  such as data loading, collation and the copy to the device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


@contextlib.contextmanager
def trace(log_dir: str = "emmax-profile",
          file_name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """Capture a host (+ card) profile of the enclosed block; the Chrome
    trace lands at ``log_dir/file_name``. Yields the profiler, whose
    ``key_averages()`` summarize the same events."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, file_name)
        prof.export_chrome_trace(path)
        overwatch.info(f"profile written to {path}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in the trace timeline (and to NVTX readers on
    the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class SectionTimer:
    """Accumulating host-side section timer.

    >>> timer = SectionTimer()
    >>> with timer("data"):
    ...     batch = next(loader)
    >>> timer.summary()   # {'data': {'total_s': ..., 'count': ..., 'mean_ms': ...}}
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}

    def log(self) -> None:
        for name, s in sorted(self.summary().items()):
            overwatch.info(f"[timer] {name}: {s['mean_ms']:.2f} ms avg "
                           f"x{s['count']}")
