"""Device prefetch for the training loop, port of
``emmax_tpu/data/prefetch.py``.

A background thread collates host batches (up to ``depth`` ahead) while
the device runs the current step, and each batch's copy to the card is
issued one step ahead on a side CUDA stream from pinned memory, so the
copy overlaps the step before it. The consumer's stream waits on the
copy's event before using the batch. On the CPU the batches are only
converted to tensors. Under a mesh each rank's loader yields its own rows
(``BatchLoader(num_shards=, shard_index=)``), and they go to the rank's
device in the mesh.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

_SENTINEL = object()


def _host_batches(batch_iter: Iterator, depth: int) -> Iterator:
    """Run ``batch_iter`` in a thread, ``depth`` batches ahead; an
    exception in the producer re-raises in the consumer, and a consumer
    that stops early (``max_steps`` inside an epoch) stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batch_iter:
                if not put(batch):
                    return
        except BaseException as e:  # propagate to the consumer
            put(e)
            return
        put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


def to_device(batch, device, pin: bool = False):
    """Numpy arrays and tensors of a batch (nested dicts too) onto
    ``device``, from pinned memory without blocking when ``pin``; other
    values (string labels) stay on the host."""
    if isinstance(batch, dict):
        return {k: to_device(v, device, pin) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        if pin:
            batch = batch.pin_memory()
        return batch.to(device, non_blocking=pin)
    return batch


def _record(batch, stream) -> None:
    if isinstance(batch, dict):
        for v in batch.values():
            _record(v, stream)
    elif isinstance(batch, torch.Tensor) and batch.is_cuda:
        batch.record_stream(stream)


def prefetch_to_device(batch_iter: Iterator, device, depth: int = 2
                       ) -> Iterator:
    """Yield the batches of ``batch_iter`` as tensors on ``device``."""
    device = torch.device(device)
    host = _host_batches(batch_iter, depth)
    if device.type != "cuda":
        for batch in host:
            yield to_device(batch, device)
        return
    side = torch.cuda.Stream(device)

    def issue(batch):
        with torch.cuda.stream(side):
            out = to_device(batch, device, pin=True)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    pending = None
    for batch in host:
        nxt = issue(batch)
        if pending is not None:
            yield _ready(*pending)
        pending = nxt
    if pending is not None:
        yield _ready(*pending)


def _ready(batch, event):
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    _record(batch, stream)
    return batch


class PrefetchingLoader:
    """``BatchLoader``-compatible wrapper adding device prefetch; with a
    ``mesh`` the batches (this rank's rows) go to the rank's device in it
    (``parallel.sharding.mesh_device``)."""

    def __init__(self, loader, device, depth: int = 2, mesh=None) -> None:
        from emmax_torch.parallel.sharding import mesh_device

        self.loader = loader
        self.device = mesh_device(mesh) if mesh is not None else device
        self.depth = depth

    def epoch(self, epoch: int = 0):
        return prefetch_to_device(self.loader.epoch(epoch), self.device,
                                  self.depth)

    def __len__(self) -> int:
        return len(self.loader)
