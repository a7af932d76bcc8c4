"""GCOT (Grounded Chain-of-Thought) training dataset, port of
``emmax_tpu/data/gcot.py``.

Loads the GCOT JSON records, reads each record's frame from a pluggable
``FrameSource`` (a directory of pre-extracted frames, or synthetic frames
for tests and smoke runs) and assembles prompt and target text per
``data_mix``. Images stay uint8 until they reach the device; resize and
per-tower normalization happen there, inside the train step.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.vla.action_tokenizer import ActionTokenizer
from emmax_torch.vla.prompting import PromptBuilder

POLICY_PREFIX = "POLICIES:\n"
MOVEMENT_PREFIX = "MOVEMENT:\n"

DATA_MIXES = ("movement_only", "reason_position_movement",
              "action_policy_only", "openvla", "pred_all", "no_movement",
              "movement_policy", "no_position", "no_reason")


class FrameSource(Protocol):
    """Maps (trajectory_key, frame_index) -> uint8 RGB image [H, W, 3]."""

    def get_frame(self, key: str, index: int) -> np.ndarray: ...


class SyntheticFrameSource:
    """Deterministic random frames, seeded from (key, index) as the JAX
    package seeds them, so both packages see the same frames in one
    process."""

    def __init__(self, size: int = 256) -> None:
        self.size = size

    def get_frame(self, key: str, index: int) -> np.ndarray:
        rng = np.random.default_rng(hash((key, index)) & 0x7FFFFFFF)
        return rng.integers(0, 256, size=(self.size, self.size, 3),
                            dtype=np.uint8)


class DirectoryFrameSource:
    """Frames pre-extracted to ``<root>/<key>/im_<index>.jpg``, decoded by
    the port's codec with libjpeg's ISLOW DCT: the pixels OpenCV's
    ``imread`` gives the JAX package."""

    def __init__(self, root) -> None:
        self.root = Path(root)

    def get_frame(self, key: str, index: int) -> np.ndarray:
        from emmax_torch.data.codec import decode_image

        path = self.root / key / f"im_{index}.jpg"
        return decode_image(path.read_bytes(), "islow")


def parse_image_path(current_image_path: str):
    """``.../traj_key/im_12.jpg`` -> (traj_key, 12)."""
    parts = current_image_path.split("/")
    key = "/".join(parts[:-1])
    index = int(parts[-1].split("_")[-1].split(".")[0])
    return key, index


def assemble_gcot_text(item: Dict, data_mix: str,
                       action_tokenizer: ActionTokenizer,
                       normalized_movement: bool = False):
    """(prompt string, target string) of one record for ``data_mix``."""
    if data_mix not in DATA_MIXES:
        raise ValueError(f"unknown data mix {data_mix!r}; known {DATA_MIXES}")

    def policies() -> str:
        acts = action_tokenizer(np.asarray(item["assistant_action_policy"]))
        if isinstance(acts, str):
            acts = [acts]
        return POLICY_PREFIX + ";".join(acts) + "\n"

    reason = item.get("assistant_reason_level", "")
    position = item.get("assistant_position_level", "")
    movement = item.get("assistant_movement_level", "")
    user = item["user"]

    if data_mix == "movement_only":
        return user + "\n" + reason + position, movement
    if data_mix == "reason_position_movement":
        return user, reason + "\n" + position + "\n" + movement
    if data_mix == "action_policy_only":
        return user, policies()
    if data_mix == "openvla":
        return user.split("CURRENT GRIPPER")[0], policies()
    if data_mix == "pred_all":
        if normalized_movement:
            movement = MOVEMENT_PREFIX + action_tokenizer(
                np.asarray(item["delta_full_state_norm"]))
        return user, (reason + "\n" + position + "\n" + movement + "\n"
                      + policies())
    if data_mix == "no_movement":
        return user, reason + "\n" + position + "\n" + policies()
    if data_mix == "movement_policy":
        return user, movement + "\n" + policies()
    if data_mix == "no_position":
        return user, reason + "\n" + movement + "\n" + policies()
    return user, position + "\n" + movement + "\n" + policies()  # no_reason


class GCOTDataset:
    """Map-style dataset over the GCOT records; returns
    ``{"image": uint8 HWC, "input_ids": [L], "labels": [L]}`` (train) or the
    prompt ids with the target text as the label (val)."""

    def __init__(self, data, action_tokenizer: ActionTokenizer, tokenizer,
                 frame_source: FrameSource,
                 data_mix: str = "movement_policy", mask_inst: bool = False,
                 split: str = "train", prompt_style: str = "pure",
                 normalized_movement: bool = False) -> None:
        if isinstance(data, (str, Path)):
            with open(data) as f:
                data = json.load(f)
        self.data = list(data)
        self.action_tokenizer = action_tokenizer
        self.tokenizer = tokenizer
        self.frame_source = frame_source
        self.data_mix = data_mix
        self.mask_inst = mask_inst
        self.split = split
        self.prompt_style = prompt_style
        self.normalized_movement = normalized_movement

    def __len__(self) -> int:
        return len(self.data)

    def _build_prompt(self, prompt_str: str, gpt_output: str) -> str:
        pb = PromptBuilder(self.prompt_style)
        pb.add_turn("human", prompt_str)
        pb.add_turn("gpt", gpt_output)
        return pb.get_prompt()

    def __getitem__(self, idx: int) -> Dict:
        item = self.data[idx]
        key, frame_idx = parse_image_path(item["current_image_path"])
        image = self.frame_source.get_frame(key, frame_idx)
        prompt_str, gpt_output = assemble_gcot_text(
            item, self.data_mix, self.action_tokenizer,
            self.normalized_movement)

        if self.split == "train":
            full = self._build_prompt(prompt_str, gpt_output)
            input_ids = self.tokenizer.encode(full, add_special_tokens=True)
            labels = list(input_ids)
            if self.mask_inst:
                # mask the instruction prefix except its last 2 tokens
                prefix_ids = self.tokenizer.encode(
                    self._build_prompt(prompt_str, ""),
                    add_special_tokens=True)
                cut = max(len(prefix_ids) - 2, 0)
                labels[:cut] = [IGNORE_INDEX] * cut
            return {"image": image, "input_ids": input_ids, "labels": labels}

        # val: the prompt (empty gpt turn) without its last 2 tokens; the
        # target text is the label
        prompt = self._build_prompt(prompt_str, "")
        input_ids = self.tokenizer.encode(prompt, add_special_tokens=True)[:-2]
        return {"image": image, "input_ids": input_ids, "labels": gpt_output}


def key_items_to_frames(items: List[Dict], index: Dict[str, Sequence]
                        ) -> List[Dict]:
    """The records with each ``current_image_path`` pointing at a frame
    of ``index`` (``{trajectory key: frames}``, e.g.
    ``RLDSFrameSource.index``): record i takes trajectory i mod the count,
    frame i mod its length."""
    keys = sorted(index)
    out = []
    for i, item in enumerate(items):
        key = keys[i % len(keys)]
        out.append({**item, "current_image_path":
                    f"{key}/im_{i % len(index[key])}.jpg"})
    return out


def make_dummy_gcot_items(n: int, rng: Optional[np.random.Generator] = None
                          ) -> List[Dict]:
    """Synthetic GCOT records exercising every data-mix field."""
    rng = rng or np.random.default_rng(0)
    items = []
    for i in range(n):
        n_pol = int(rng.integers(1, 4))
        items.append({
            "current_image_path": f"bridge/train/traj_{i % 7}/im_{i % 30}.jpg",
            "user": ("What action should the robot take to achieve the "
                     f"instruction\nINSTRUCTION: \ntask {i}\nCURRENT GRIPPER: "
                     f"[{int(rng.integers(0, 224))}, "
                     f"{int(rng.integers(0, 224))}]\n"),
            "assistant_reason_level":
                f"REASONING:\nbecause {i}\nSUBTASK: sub {i}",
            "assistant_position_level":
                f"NEXT GRIPPER: [{i % 224}, {(2 * i) % 224}]",
            "assistant_movement_level":
                "MOVEMENT:\nmove forward 3 steps; open gripper;",
            "assistant_action_policy":
                rng.uniform(-1, 1, size=(n_pol, 7)).tolist(),
            "delta_full_state_norm": rng.uniform(-1, 1, size=(7,)).tolist(),
        })
    return items
