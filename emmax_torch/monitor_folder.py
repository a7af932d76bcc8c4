"""Checkpoint-directory janitor, port of ``scripts/monitor_folder.py``.

Polls a folder and deletes the oldest ``step-*`` checkpoints (directories
or ``.pt`` files, oldest modification time first) while their total size
exceeds a limit (default 60 GB).

    python -m emmax_torch.monitor_folder --folder runs --limit_gb 60
"""

from __future__ import annotations

import shutil
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from emmax_torch.conf import parse_config
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("janitor")


@dataclass
class JanitorConfig:
    folder: Path = Path("runs")
    limit_gb: float = 60.0
    interval_s: float = 60.0
    once: bool = False


def dir_size(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def sweep(folder: Path, limit_bytes: float) -> int:
    """Delete the oldest checkpoints until they fit ``limit_bytes``;
    returns how many went."""
    entries = []
    for p in Path(folder).rglob("step-*"):
        if p.is_dir() or p.suffix == ".pt":
            entries.append((p.stat().st_mtime, p))
    entries.sort()
    total = sum(dir_size(p) if p.is_dir() else p.stat().st_size
                for _, p in entries)
    removed = 0
    while total > limit_bytes and entries:
        _, victim = entries.pop(0)
        size = dir_size(victim) if victim.is_dir() else victim.stat().st_size
        if victim.is_dir():
            shutil.rmtree(victim, ignore_errors=True)
        else:
            victim.unlink(missing_ok=True)
        total -= size
        removed += 1
        overwatch.info(f"removed {victim} ({size / 1e9:.2f} GB)")
    return removed


def main(cfg: JanitorConfig) -> None:
    limit = cfg.limit_gb * 1e9
    while True:
        sweep(cfg.folder, limit)
        if cfg.once:
            break
        time.sleep(cfg.interval_s)


if __name__ == "__main__":
    main(parse_config(JanitorConfig, sys.argv[1:]))
