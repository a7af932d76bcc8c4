"""GCOT dataset assembly (plans + gripper positions + trajectories -> JSON
records), port of ``emmax_tpu/gcot/assemble.py``.

Joins annotated high-level plans and 2D gripper labels with trajectory
states by ``file_path|episode_id``, validates the plan dicts, and emits
training samples in three modes: ``single_policy`` (one sample a frame,
next-frame targets; Emma-X's own data), ``multiple_policy`` (one a segment,
whole-segment policies) and ``aug_multiple_policy`` (one a frame, policies
to the segment's end); plus the movement Q1 / Q99 statistics of
``dataset_statistics.json``.
"""

from __future__ import annotations

import ast
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from emmax_torch.gcot.verbalize import describe_move

INPUT_TEMPLATE = (
    "What action should the robot take to achieve the instruction\n"
    "INSTRUCTION: \n{instruction}\n"
    "CURRENT GRIPPER: {gripper_2d}\n"
)
REASON_TEMPLATE = "REASONING: {reasoning}\nSUBTASK: {goal}\n"
POSITION_TEMPLATE = "NEXT GRIPPER: {gripper_2d_next}\n"
MOVEMENT_TEMPLATE = "MOVEMENT:\n{movement}\n"


@dataclass
class RawSample:
    """One annotated trajectory ready for sample extraction."""

    sample_dir: str                      # becomes current_image_path dirname
    instruction: str
    highlevel_plan: Union[str, Dict]     # raw annotator text or parsed dict
    segments: List[int]                  # per-frame segment ids (from 1)
    gripper_2d: List[List[int]]          # per-frame [x, y]
    full_state: np.ndarray               # [T, >=6]
    action_policy: np.ndarray            # [T, 7]
    segment_index_to_image_index: Dict[int, int] = field(default_factory=dict)
    valid: bool = False

    # --- validation (create_dataset.py:77-102) -------------------------------
    def prepare_segments(self) -> None:
        count, init, out = 0, None, []
        for i, oseg in enumerate(self.segments):
            if oseg != init:
                init = oseg
                count += 1
                self.segment_index_to_image_index[count] = i
            out.append(count)
        self.segment_index_to_image_index[-1] = len(self.segments) - 1
        self.segments = out

    def check_valid(self) -> Optional[str]:
        if self.highlevel_plan == "NA":
            return "no response"
        if isinstance(self.highlevel_plan, str):
            m = re.search(r"\{[\s\S]*\}", self.highlevel_plan)
            if m is None:
                return "no dict"
            try:
                parsed = ast.literal_eval(m.group(0))
            except Exception:
                return "no valid dict"
        else:
            parsed = self.highlevel_plan
        for v in parsed.values():
            if len(v) != 2:
                return "wrong format"
        self.highlevel_plan = parsed
        self.prepare_segments()
        if len(parsed) != max(self.segments):
            return "wrong segment number"
        self.valid = True
        return None

    # --- helpers -------------------------------------------------------------
    def get_gripper_position(self, index: int) -> List[int]:
        return list(self.gripper_2d[index])

    def get_position_change(self, i: int, j: int) -> np.ndarray:
        """Δxyz + absolute next rotation + next gripper action
        (create_dataset.py:317-328)."""
        delta_xyz = self.full_state[j][:3] - self.full_state[i][:3]
        rot = self.full_state[j][3:6]
        grip = self.action_policy[j][6]
        return np.concatenate([delta_xyz, rot, [grip]])

    def _plan_items(self):
        items = []
        for k, v in OrderedDict(self.highlevel_plan).items():
            if isinstance(k, str):
                k = int(re.findall(r"\d+", k)[0])
            items.append((k, tuple(v)))
        return items

    def _next_segment(self, plan, plan_index: int):
        segment_index = plan[plan_index][0]
        if segment_index == len(plan):
            return -1
        return plan[plan_index + 1][0]

    def _make(self, image_index: int, image_index_next: int, goal: str,
              reason: str, policy_end: int) -> Dict:
        delta = self.get_position_change(image_index, image_index_next)
        return {
            "current_image_path": f"{self.sample_dir}/im_{image_index}.jpg",
            "user": INPUT_TEMPLATE.format(
                instruction=self.instruction,
                gripper_2d=self.get_gripper_position(image_index)),
            "assistant_reason_level": REASON_TEMPLATE.format(
                reasoning=reason, goal=goal),
            "assistant_position_level": POSITION_TEMPLATE.format(
                gripper_2d_next=self.get_gripper_position(image_index_next)),
            "assistant_movement_level": MOVEMENT_TEMPLATE.format(
                movement=describe_move(delta)),
            "assistant_action_policy":
                self.action_policy[image_index:policy_end].tolist(),
            "delta_full_state": delta.tolist(),
        }

    # --- sample modes (create_dataset.py:103-315) ----------------------------
    def get_samples_multiple_policy(self) -> List[Dict]:
        plan = self._plan_items()
        samples = []
        for plan_index, (seg, (goal, reason)) in enumerate(plan):
            seg_next = self._next_segment(plan, plan_index)
            i = self.segment_index_to_image_index[seg]
            j = self.segment_index_to_image_index[seg_next]
            samples.append(self._make(i, j, goal, reason, policy_end=j))
        return samples

    def get_samples_single_policy(self) -> List[Dict]:
        plan = self._plan_items()
        samples = []
        for index in range(len(self.segments) - 1):
            plan_index = self.segments[index] - 1
            seg, (goal, reason) = plan[plan_index]
            i, j = index, index + 1
            if j >= len(self.segments):
                continue
            samples.append(self._make(i, j, goal, reason, policy_end=j))
        return samples

    def get_samples_aug_multiple_policy(self) -> List[Dict]:
        plan = self._plan_items()
        samples = []
        for frame_index in range(len(self.segments) - 1):
            plan_index = self.segments[frame_index] - 1
            seg, (goal, reason) = plan[plan_index]
            seg_next = self._next_segment(plan, plan_index)
            j = self.segment_index_to_image_index[seg_next]
            if not frame_index < j:
                continue
            samples.append(self._make(frame_index, j, goal, reason,
                                      policy_end=j))
        return samples


SAMPLE_MODES = {
    "single_policy": RawSample.get_samples_single_policy,
    "multiple_policy": RawSample.get_samples_multiple_policy,
    "aug_multiple_policy": RawSample.get_samples_aug_multiple_policy,
}


def normalize_movement(samples: Sequence[Dict]
                       ) -> Tuple[List[Dict], Dict]:
    """Q1/Q99 movement statistics + per-sample normalized movement vectors
    (create_dataset.py:347-375). Returns (samples, statistics)."""
    deltas = np.asarray([s["delta_full_state"] for s in samples], np.float64)
    q1 = np.quantile(deltas, 0.01, axis=0)
    q99 = np.quantile(deltas, 0.99, axis=0)
    stats = {"Q1": q1.tolist(), "Q99": q99.tolist(),
             "num_samples": len(samples)}
    out = []
    for s in samples:
        d = np.asarray(s["delta_full_state"])
        norm = np.clip(2 * (d - q1) / (q99 - q1 + 1e-8) - 1, -1, 1)
        s = dict(s)
        s["delta_full_state_norm"] = norm.tolist()
        out.append(s)
    return out, stats


def assemble_dataset(raw_samples: Sequence[RawSample],
                     mode: str = "single_policy") -> Tuple[List[Dict], Dict, Dict]:
    """Validate + extract samples + movement normalization.

    Returns (samples, dataset_statistics, validity_report)."""
    report: Dict[str, int] = {}
    samples: List[Dict] = []
    for rs in raw_samples:
        err = rs.check_valid()
        if err is not None:
            report[err] = report.get(err, 0) + 1
            continue
        report["valid"] = report.get("valid", 0) + 1
        samples.extend(SAMPLE_MODES[mode](rs))
    samples, stats = normalize_movement(samples) if samples else ([], {})
    return samples, stats, report
