"""GCOT plan generation CLI, port of ``scripts/gcot_generate_plans.py``.

Streams the bridge trajectories (``data.rlds.load_bridgev2_dataset``),
segments each (soft / soft_gripper / gripper / nstep; soft runs the port's
own HDBSCAN), sends the key frames to the plan annotator and writes
``{out_dir}/plans_{split}.json``: ``{file_path|episode_id: [instruction,
segments, plan text]}``. The annotator defaults to the offline
``HeuristicAnnotator``; ``--annotator gemini`` is the reference's Gemini
path (needs the network). Host code only.

    python -m emmax_torch.gcot_generate_plans --data_dir data/bridge_rlds \\
        --split train --segmentation soft --out_dir plans
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

from emmax_torch.conf import parse_config
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("gcot-plans")


@dataclass
class PlansConfig:
    data_dir: Path = Path("data/bridge_rlds")
    split: str = "train"
    out_dir: Path = Path("plans")
    segmentation: str = "soft"          # soft | soft_gripper | gripper | nstep
    annotator: str = "heuristic"        # heuristic | gemini
    nstep: int = 5
    limit: int = 0                      # 0 = all
    checkpoint_every: int = 1000


def segment(traj: Dict, cfg: PlansConfig) -> np.ndarray:
    """The trajectory's segment ids under ``cfg.segmentation``."""
    from emmax_torch.gcot.segmentation import (segment_gripper, segment_nstep,
                                               soft_plus_gripper_segment,
                                               soft_segment)

    proprio = traj["observation"]["proprio"][:, :6]
    if cfg.segmentation == "soft":
        return soft_segment(proprio)
    if cfg.segmentation == "soft_gripper":
        return soft_plus_gripper_segment(proprio, traj["action"][:, -1])
    if cfg.segmentation == "gripper":
        return np.asarray(segment_gripper(traj["action"][:, -1]))
    if cfg.segmentation == "nstep":
        return np.asarray(segment_nstep(len(proprio), cfg.nstep))
    raise ValueError(f"unknown --segmentation {cfg.segmentation!r} (soft, "
                     "soft_gripper, gripper, nstep)")


def main(cfg: PlansConfig) -> Dict[str, tuple]:
    """Write ``plans_{split}.json``; returns the plans."""
    from emmax_torch.data.rlds import load_bridgev2_dataset, trajectory_key
    from emmax_torch.gcot.plans import (GeminiAnnotator, HeuristicAnnotator,
                                        generate_plans)
    from emmax_torch.gcot.segmentation import (compress_segments,
                                               get_key_frames)

    ds, _ = load_bridgev2_dataset(cfg.data_dir, cfg.split)
    annotator = (HeuristicAnnotator() if cfg.annotator == "heuristic"
                 else GeminiAnnotator())
    samples = []
    for i, traj in enumerate(ds):
        if cfg.limit and i >= cfg.limit:
            break
        instruction = traj["task"]["language_instruction"]
        if isinstance(instruction, bytes):
            instruction = instruction.decode()
        overall = segment(traj, cfg)
        key_frames, count = get_key_frames(
            list(traj["observation"]["image_primary"]), overall)
        samples.append({"key": trajectory_key(traj),
                        "instruction": str(instruction),
                        "key_frames": key_frames, "segment_count": count,
                        "segments": compress_segments(overall)})

    out = Path(cfg.out_dir) / f"plans_{cfg.split}.json"
    plans = generate_plans(samples, annotator, out_path=out,
                           checkpoint_every=cfg.checkpoint_every)
    overwatch.info(f"wrote {out}")
    return plans


if __name__ == "__main__":
    main(parse_config(PlansConfig, sys.argv[1:]))
