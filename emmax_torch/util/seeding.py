"""Deterministic seeding, port of ``emmax_tpu/util/seeding.py``.

``set_global_seed`` seeds Python's and numpy's global streams (and
torch's, which the port's data workers and initializers read), and can
hand back ``worker_init_function``, which derives a stream per data worker
by ``SeedSequence`` spawning; ``make_worker_rng`` is a stateless
per-(worker, epoch) generator. The numpy streams are the JAX package's,
bit for bit. ``check_bloat16_supported`` answers for the device in use.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional

import numpy as np
import torch


def set_global_seed(seed: int, get_worker_init_fn: bool = False
                    ) -> Optional[Callable[[int], None]]:
    assert np.iinfo(np.uint32).min < seed < np.iinfo(np.uint32).max
    os.environ["EXPERIMENT_GLOBAL_SEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return worker_init_function if get_worker_init_fn else None


def worker_init_function(worker_id: int) -> None:
    """A unique, deterministic stream per data worker (``SeedSequence``
    spawning over the global seed and the worker id)."""
    global_seed = int(os.environ["EXPERIMENT_GLOBAL_SEED"])
    base_seq = np.random.SeedSequence([global_seed, worker_id])
    np.random.seed(base_seq.generate_state(4))
    random.seed(int(base_seq.generate_state(1)[0]))


def make_worker_rng(seed: int, worker_id: int, epoch: int = 0
                    ) -> np.random.Generator:
    """Stateless per-(worker, epoch) generator for the data pipeline."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, worker_id, epoch]))


def check_bloat16_supported(device="cuda") -> bool:
    """Whether ``device`` computes in bf16: the card's own answer
    (``torch.cuda.is_bf16_supported()``; False with no card), True on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()
    return False
