"""Rank-aware logging ("overwatch"), port of ``emmax_tpu/overwatch.py``.

Rank and world size come from ``torch.distributed`` once its process
group is initialized, and are rank 0 of 1 before that. The surface is the
JAX package's: ``initialize_overwatch``, ``.rank()`` / ``.world_size()`` /
``.is_rank_zero()``, the ``rank_zero_only`` decorator, and log methods
that speak on rank 0 unless ``all_ranks=True``.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Any, Callable, Optional, Tuple, TypeVar

_T = TypeVar("_T")

LOG_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s :: %(message)s"
DATEFMT = "%m/%d %H:%M:%S"


def _dist_rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Overwatch:
    """Logger facade; the rank is read at each call, so one made before
    the process group exists still gates on it afterwards."""

    def __init__(self, name: str) -> None:
        self.logger = logging.getLogger(name)
        if not logging.getLogger().handlers and not self.logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(LOG_FORMAT,
                                                   datefmt=DATEFMT))
            self.logger.addHandler(handler)
            self.logger.propagate = False
        self.logger.setLevel(os.environ.get("EMMAX_LOG_LEVEL",
                                            "INFO").upper())

    def rank(self) -> int:
        return _dist_rank_world()[0]

    def world_size(self) -> int:
        return _dist_rank_world()[1]

    def is_rank_zero(self) -> bool:
        return self.rank() == 0

    def rank_zero_only(self, fn: Callable[..., _T]
                       ) -> Callable[..., Optional[_T]]:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Optional[_T]:
            if self.is_rank_zero():
                return fn(*args, **kwargs)
            return None

        return wrapper

    def _fmt(self, msg: str, ctx_level: int = 0) -> str:
        return f"{'  ' * ctx_level}{'=>> ' if ctx_level else ''}{msg}"

    def debug(self, msg: str, ctx_level: int = 0,
              all_ranks: bool = False) -> None:
        if all_ranks or self.is_rank_zero():
            self.logger.debug(self._fmt(msg, ctx_level))

    def info(self, msg: str, ctx_level: int = 0,
             all_ranks: bool = False) -> None:
        if all_ranks or self.is_rank_zero():
            self.logger.info(self._fmt(msg, ctx_level))

    def warning(self, msg: str, ctx_level: int = 0,
                all_ranks: bool = False) -> None:
        if all_ranks or self.is_rank_zero():
            self.logger.warning(self._fmt(msg, ctx_level))

    def error(self, msg: str, ctx_level: int = 0) -> None:
        self.logger.error(self._fmt(msg, ctx_level))


def initialize_overwatch(name: str) -> Overwatch:
    return Overwatch(name)
