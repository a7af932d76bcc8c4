"""GCOT dataset assembly CLI, port of ``scripts/gcot_create_dataset.py``.

Joins ``plans_{split}.json``, the 2D gripper labels (ECoT's
``embodied_features_bridge`` layout or a detector's output) and the bridge
trajectories by ``file_path|episode_id``, extracts the samples of the
chosen mode and writes ``{out_root}/{tag}/second_version.json`` and
``dataset_statistics.json``, which ``data.gcot.GCOTDataset`` and the
trainer read. Host code only.

    python -m emmax_torch.gcot_create_dataset --data_dir data/bridge_rlds \\
        --plans_dir plans --tag single_policy --mode single_policy
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from emmax_torch.conf import parse_config
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("gcot-dataset")


@dataclass
class AssembleConfig:
    data_dir: Path = Path("data/bridge_rlds")
    plans_dir: Path = Path("plans")
    gripper_positions: Optional[Path] = None   # ECoT embodied features JSON
    out_root: Path = Path("dataset")
    tag: str = "single_policy"
    mode: str = "single_policy"  # single_policy | multiple_policy | aug_multiple_policy
    splits: str = "train,val"
    image_size: int = 224        # gripper labels rescaled from 256 px


def main(cfg: AssembleConfig) -> Tuple[List[Dict], Dict, Dict[str, Dict]]:
    """Write the dataset; returns (samples, statistics, {split: validity
    report})."""
    from emmax_torch.data.rlds import load_bridgev2_dataset, trajectory_key
    from emmax_torch.gcot.assemble import RawSample, assemble_dataset

    gripper_index = {}
    if cfg.gripper_positions is not None:
        blob = json.loads(Path(cfg.gripper_positions).read_text())
        for k, v in blob.items():
            # ECoT keeps the per-frame positions under "gripper_position"
            gripper_index[k] = v.get("features", {}).get("gripper_position", v)

    all_samples: List[Dict] = []
    stats: Dict = {}
    reports: Dict[str, Dict] = {}
    for split in cfg.splits.split(","):
        plans = json.loads(
            (Path(cfg.plans_dir) / f"plans_{split}.json").read_text())
        ds, _ = load_bridgev2_dataset(cfg.data_dir, split)
        raw = []
        for traj in ds:
            key = trajectory_key(traj)
            if key not in plans:
                continue
            instruction, segments, plan_text = plans[key]
            T = len(traj["action"])
            if key in gripper_index:
                scale = cfg.image_size / 256.0
                g2d = [[int(round(p[0] * scale)), int(round(p[1] * scale))]
                       for p in gripper_index[key][:T]]
            else:
                g2d = [[0, 0]] * T
            raw.append(RawSample(
                sample_dir=key, instruction=instruction,
                highlevel_plan=plan_text, segments=list(segments)[:T],
                gripper_2d=g2d,
                full_state=np.asarray(traj["observation"]["proprio"]),
                action_policy=np.asarray(traj["action"])))
        samples, split_stats, report = assemble_dataset(raw, mode=cfg.mode)
        overwatch.info(f"{split}: {report} -> {len(samples)} samples")
        reports[split] = report
        all_samples.extend(samples)
        stats = split_stats or stats

    out_dir = Path(cfg.out_root) / cfg.tag
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "second_version.json").write_text(json.dumps(all_samples))
    (out_dir / "dataset_statistics.json").write_text(
        json.dumps(stats, indent=2))
    overwatch.info(f"wrote {len(all_samples)} samples to {out_dir}")
    return all_samples, stats, reports


if __name__ == "__main__":
    main(parse_config(AssembleConfig, sys.argv[1:]))
