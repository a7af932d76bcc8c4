"""Grounded-CoT output parser ("Solver").

Parses Emma-X generated text of the form::

    REASONING: ...
    SUBTASK: ...
    NEXT GRIPPER: [x, y]
    MOVEMENT: <7 action tokens>  |  "move forward 3 steps; open gripper;"
    POLICIES: <7 tokens>;<7 tokens>;...

into structured outputs (gripper coordinate, normalized movement vector,
list of normalized 7-DoF action vectors) and computes the eval metrics used
during training. Functional re-implementation of
``prismatic/vla/solver.py:8-190``; behavior preserved:

- policy strings are re-tokenized with ``add_special_tokens=False``, the
  first token (SentencePiece word-boundary) is dropped, and exactly 7 values
  are taken; malformed policies become ``[0]*7`` (``solver.py:122-131``).
- the textual movement grammar maps 18 direction phrases onto signed axes
  with per-axis scales: xyz ``π/180``, orientation ``1e-3``, gripper
  open=1/close=0 (``solver.py:59-101``); parse failure yields ``[-100]*7``.
- ``NEXT GRIPPER:`` coordinates are parsed from a python-literal list;
  failure yields ``[0, 0]`` (``solver.py:32-40``).
"""

from __future__ import annotations

import ast
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from emmax_torch.vla.action_tokenizer import ActionTokenizer

COORDINATES_KEY = "NEXT GRIPPER:"
MOVEMENT_KEY = "MOVEMENT:"
POLICY_KEY = "POLICIES:"

# direction phrase -> (sign, axis); mirrors solver.py:63-82
_MOVE_TO_AXIS = {
    "move_backward": (-1, "y"),
    "move_forward": (1, "y"),
    "move_right": (-1, "x"),
    "move_left": (1, "x"),
    "move_downward": (-1, "z"),
    "move_upward": (1, "z"),
    "roll_downward": (-1, "ox"),
    "roll_upward": (1, "ox"),
    "swing_downward": (-1, "ox"),
    "swing_upward": (1, "ox"),
    "pitch_downward": (-1, "oy"),
    "pitch_upward": (1, "oy"),
    "yaw_downward": (-1, "oz"),
    "yaw_upward": (1, "oz"),
    "rotate_clockwise": (-1, "oz"),
    "rotate_counterclockwise": (1, "oz"),
    # Strict-superset extension: ``describe_move`` (GCOT/utils.py:363-393)
    # verbalizes the yaw axis as "yaw clockwise/counterclockwise", which the
    # reference grammar cannot parse (it fails the whole movement to
    # [-100]*7). Reference-valid strings are unaffected by these entries.
    "yaw_clockwise": (-1, "oz"),
    "yaw_counterclockwise": (1, "oz"),
    "close_gripper": (-1, "grip"),
    "open_gripper": (1, "grip"),
}
_AXES = ("x", "y", "z", "ox", "oy", "oz", "grip")


def _first_nonempty_line(text: str) -> str:
    for line in text.split("\n"):
        if line.strip():
            return line.strip()
    return ""


class Solver:
    """Stateless parser/evaluator over generated GCOT text."""

    def __init__(self, action_tokenizer: Optional[ActionTokenizer] = None,
                 verbose: bool = False) -> None:
        self.action_tokenizer = action_tokenizer
        self.verbose = verbose

    # -- parsing ---------------------------------------------------------------
    def extract_2d_coordinates(self, text: str) -> List[int]:
        try:
            after = text[text.index(COORDINATES_KEY) + len(COORDINATES_KEY):]
            return list(ast.literal_eval(_first_nonempty_line(after)))
        except Exception:
            return [0, 0]

    def extract_movement_plan(self, text: str) -> Tuple[Optional[bool], np.ndarray]:
        """Returns (requires_unnormalization, movement_vector[7]).

        Tokenized-normalized movements (no "gripper" word) require Q1/Q99
        un-normalization downstream; textual movements are already absolute.
        On failure the flag reports how far parsing got — None (key
        missing), True (tokenized branch entered), False (textual branch
        entered) — exactly the reference's tri-state (``solver.py:42-58``
        sets ``require_unorm`` before the fallible parse, so callers can
        distinguish a malformed tokenized movement from a missing key).
        """
        require_unnorm = None
        try:
            after = text[text.index(MOVEMENT_KEY) + len(MOVEMENT_KEY):]
            line = _first_nonempty_line(after)
            if "gripper" not in line:
                require_unnorm = True
                ids = self.action_tokenizer.tokenizer.encode(
                    line, add_special_tokens=False)
                vals = self.action_tokenizer.decode_token_ids_to_actions(
                    np.array(ids))[1:8]
                assert len(vals) == 7
                return True, np.asarray(vals)
            # textual grammar
            require_unnorm = False
            acc = {a: 0.0 for a in _AXES}
            for clause in [c for c in line.split(";") if c][:7]:
                words = clause.split()
                sign, axis = _MOVE_TO_AXIS["_".join(words[:2])]
                if axis == "grip":
                    scale, level = 1.0, float("open" in clause)
                elif axis.startswith("o"):
                    scale, level = 1e-3, float(int(words[2]))
                else:
                    scale, level = math.pi / 180.0, float(int(words[2]))
                acc[axis] += sign * scale * level
            return False, np.array([acc[a] for a in _AXES])
        except Exception:
            return require_unnorm, np.array([-100.0] * 7)

    def extract_action_policies(self, text: str) -> Tuple[List[List[float]], str]:
        """Parse ``POLICIES:`` into a list of 7-vectors in [-1, 1].

        Returns (policies, remaining_text_before_POLICIES). If the key is
        absent the whole text is treated as the policy string
        (``solver.py:110-119``)."""
        try:
            if POLICY_KEY in text:
                cut = text.index(POLICY_KEY)
                remain, policy_blob = text[:cut], text[cut + len(POLICY_KEY):]
                policies_line = _first_nonempty_line(policy_blob)
            else:
                remain, policies_line = "", text.strip()

            out: List[List[float]] = []
            for policy_text in policies_line.split(";"):
                ids = self.action_tokenizer.tokenizer.encode(
                    policy_text, add_special_tokens=False)
                vals = self.action_tokenizer.decode_token_ids_to_actions(
                    np.array(ids))[1:][:7]  # drop word-boundary piece, take 7
                if len(vals) != 7:
                    # reference-exact: a malformed chunk aborts the WHOLE
                    # parse (its `[0]*7` list hits `.tolist()` →
                    # AttributeError → except clause, solver.py:128-136)
                    raise ValueError("malformed policy chunk")
                out.append(vals.tolist())
            return out, remain
        except Exception:
            return [[0.0] * 7], text

    # -- metrics ---------------------------------------------------------------
    @staticmethod
    def compare_movement(pred_pos: np.ndarray, label_pos: np.ndarray):
        dist = float(np.sum(np.abs(pred_pos - label_pos)))
        # relative L1 guarded against zero label dims (the reference
        # solver.py:154 divides unguarded and emits RuntimeWarnings/inf)
        label = np.asarray(label_pos, np.float64)
        denom = np.where(label == 0.0, 1.0, np.abs(label))
        relative = float(np.sum(np.abs(dist) / denom))
        return dist, relative, dist == 0

    @staticmethod
    def compare_policy(pred_pol: Sequence[Sequence[float]],
                       label_pol: Sequence[Sequence[float]]) -> float:
        hits, cnt = 0, 0
        for i in range(min(len(label_pol), len(pred_pol))):
            for j in range(len(label_pol[0])):
                hits += int(label_pol[i][j] == pred_pol[i][j])
                cnt += 1
        assert cnt % 7 == 0
        return hits / cnt if cnt else 0.0

    def evaluate_single(self, ground_truth: str, prediction: str):
        gt_policies, gt_rest = self.extract_action_policies(ground_truth)
        pred_policies, pred_rest = self.extract_action_policies(prediction)
        _, pred_movement = self.extract_movement_plan(pred_rest)
        _, gt_movement = self.extract_movement_plan(gt_rest)
        dist, relative, _ = self.compare_movement(pred_movement, gt_movement)
        acc = self.compare_policy(pred_policies, gt_policies)
        return 0, acc, dist, relative, pred_policies, gt_policies

    def evaluate_batch(self, batch_gt: Sequence[str], batch_pred: Sequence[str],
                       verbose: bool = False):
        cols = ([], [], [], [], [], [])
        for gt, pred in zip(batch_gt, batch_pred):
            for col, val in zip(cols, self.evaluate_single(gt, pred)):
                col.append(val)
        return cols
