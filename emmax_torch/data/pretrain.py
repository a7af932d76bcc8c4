"""The GCOT validation set of ``emmax_torch.generate``: ``ValDataset``,
ported from ``emmax_tpu/data/pretrain.py``. (The align / finetune
pretraining datasets of that module are not ported yet.)"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from emmax_torch.data.gcot import assemble_gcot_text, parse_image_path
from emmax_torch.vla.prompting import PromptBuilder


class ValDataset:
    """Map-style GCOT val dataset: each item's raw frame, its prompt string
    (the "pure" prompt of the GCOT question) and its ground-truth text."""

    def __init__(self, data, action_tokenizer, frame_source,
                 data_mix: str = "movement_policy") -> None:
        if isinstance(data, (str, Path)):
            with open(data) as f:
                data = json.load(f)
        self.data = list(data)
        self.action_tokenizer = action_tokenizer
        self.frame_source = frame_source
        self.data_mix = data_mix

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        item = self.data[idx]
        key, frame_idx = parse_image_path(item["current_image_path"])
        image = self.frame_source.get_frame(key, frame_idx)
        prompt_str, gt = assemble_gcot_text(item, self.data_mix,
                                            self.action_tokenizer)
        pb = PromptBuilder("pure")
        pb.add_turn("human", prompt_str)
        return {"image": image, "prompt": pb.get_prompt(), "ground_truth": gt}
