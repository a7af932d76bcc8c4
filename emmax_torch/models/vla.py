"""Emma-X VLA policy: prompts in, 7-DoF actions out.

Port of ``emmax_tpu/models/vla.py`` on the plain ``ServingEngine``
(the speculative closed-loop engine is a later slice):

- ``generate_actions(image, prompt_text, type)``: decode the grounded
  chain of thought, parse it with the Solver, un-normalize with q01/q99
  (or the proprio Q1/Q99 for ``type="pos"``);
- ``predict_action(image, instruction, unnorm_key)``: OpenVLA-style, append
  the empty token and decode exactly ``action_dim`` action tokens;
- ``generate_batch(images, prompts)``: batched text, or with
  ``return_string_probabilities`` the first-token probabilities of
  candidate strings;
- ``get_prompt(task_label, gripper_position)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emmax_torch.models.vlm import VLMConfig
from emmax_torch.ops.image import ImageTransformConfig, preprocess_for_towers
from emmax_torch.serving.engine import (GenerateOptions, ServingEngine,
                                        resolve_device)
from emmax_torch.vla.action_tokenizer import (ActionTokenizer,
                                              unnormalize_actions,
                                              unnormalize_proprio)
from emmax_torch.vla.prompting import get_prompt_builder
from emmax_torch.vla.solver import Solver


def _as_uint8_array(image) -> np.ndarray:
    if hasattr(image, "convert"):  # PIL
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


class EmmaXVLA:
    def __init__(
        self,
        cfg: VLMConfig,
        params,
        tokenizer,
        transforms: Dict[str, ImageTransformConfig],
        norm_stats: Optional[dict] = None,
        proprio_stats: Optional[dict] = None,
        llm_family: str = "llama2-pure",
        attn_impl: str = "auto",
        action_dim: int = 7,
        options: Optional[GenerateOptions] = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.transforms = transforms
        self.norm_stats = norm_stats or {}
        self.proprio_stats = proprio_stats
        self.llm_family = llm_family
        self.action_dim = action_dim
        options = options or GenerateOptions(eos_id=tokenizer.eos_id)
        self.engine = ServingEngine(cfg, params, tokenizer, options=options,
                                    attn_impl=attn_impl, device=self.device)
        self.action_tokenizer = ActionTokenizer(tokenizer)
        self.solver = Solver(self.action_tokenizer)

    # -- prompts ---------------------------------------------------------------
    def get_prompt(self, task_label: str,
                   gripper_position: Optional[Sequence[int]] = None) -> str:
        """With a gripper position, the Emma-X eval prompt; without, the
        OpenVLA one."""
        pb = get_prompt_builder(self.llm_family)
        if gripper_position is not None:
            msg = ("What action should the robot take to achieve the instruction"
                   f"\nINSTRUCTION: \n{task_label}\nCURRENT GRIPPER: "
                   f"[{int(gripper_position[0])}, {int(gripper_position[1])}]\n")
        else:
            msg = f"What action should the robot take to {task_label.lower()}?"
        pb.add_turn("human", msg)
        return pb.get_prompt()

    # -- preprocessing ---------------------------------------------------------
    def _pixels(self, images) -> Dict[str, torch.Tensor]:
        if not isinstance(images, (list, tuple)):
            images = [images]
        arr = np.stack([_as_uint8_array(im) for im in images])
        return preprocess_for_towers(torch.from_numpy(arr).to(self.device),
                                     self.transforms)

    def _decode_row(self, row) -> str:
        row = list(row)
        eos = self.engine.options.eos_id
        if eos in row:
            row = row[:row.index(eos)]
        return self.tokenizer.decode(row).strip()

    # -- generation ------------------------------------------------------------
    def generate(self, image, prompt_text: str,
                 max_new_tokens: int = 512) -> str:
        """Free-form text generation for ONE frame."""
        if isinstance(image, (list, tuple)) and len(image) != 1:
            raise ValueError("generate/generate_actions/predict_action take "
                             "ONE frame")
        out = self.engine.generate_ids([prompt_text], self._pixels(image),
                                       max_new_tokens=max_new_tokens)
        return self._decode_row(out[0])

    def generate_batch(self, images, prompt_texts: List[str],
                       max_new_tokens: int = 512,
                       return_string_probabilities: Optional[List[str]] = None):
        """Batched generation, one frame per prompt. With
        ``return_string_probabilities``: per prompt, the normalized
        probabilities of those strings' first tokens instead (the
        reference's True/False and multiple-choice VQA scoring)."""
        pixels = self._pixels(images)
        if return_string_probabilities is None:
            return self.engine.generate(prompt_texts, pixels,
                                        max_new_tokens=max_new_tokens)
        candidate_ids = []
        for s in return_string_probabilities:
            ids = self.tokenizer.encode(s, add_special_tokens=False)
            # drop the word-boundary piece; take the first content token
            candidate_ids.append(ids[1] if len(ids) > 1 else ids[0])
        probs = self.engine.first_token_probs(prompt_texts, pixels,
                                              candidate_ids)
        return [row.tolist() for row in probs]

    def generate_actions(self, image, prompt_text: str, type: str = "act",
                         max_new_tokens: int = 512
                         ) -> Tuple[List[np.ndarray], str]:
        """One frame -> (list of 7-DoF unnormalized actions, generated text).

        ``type="act"``: parse POLICIES and un-normalize with action q01/q99.
        ``type="pos"``: parse MOVEMENT; tokenized movements un-normalize
        with proprio Q1/Q99.
        """
        text = self.generate(image, prompt_text, max_new_tokens)
        if type == "act":
            policies, _ = self.solver.extract_action_policies(text)
            stats = self.get_action_stats(None)
            actions = [unnormalize_actions(np.array(p), stats)
                       for p in policies]
            return actions, text
        if type == "pos":
            require_unnorm, delta = self.solver.extract_movement_plan(text)
            if require_unnorm:
                delta = unnormalize_proprio(delta, self.get_proprio_stats())
            return [np.asarray(delta)], text
        raise ValueError(f"unknown generate_actions type {type!r}")

    def predict_action(self, image, instruction: str,
                       unnorm_key: Optional[str] = None) -> np.ndarray:
        """Append the tokenizer's empty token, decode ``action_dim``
        action tokens, un-normalize."""
        pb = get_prompt_builder(self.llm_family)
        pb.add_turn("human",
                    f"What action should the robot take to {instruction.lower()}?")
        out = self.engine.generate_ids(
            [pb.get_prompt()], self._pixels(image),
            max_new_tokens=self.action_dim,
            suffix_ids=(self.tokenizer.empty_token_id,))
        norm_actions = self.action_tokenizer.decode_token_ids_to_actions(
            np.asarray(out[0][:self.action_dim]))
        return unnormalize_actions(norm_actions,
                                   self.get_action_stats(unnorm_key))

    # -- statistics ------------------------------------------------------------
    def get_action_stats(self, unnorm_key: Optional[str]) -> dict:
        """Default to the single dataset's action stats; identity stats
        (decode in normalized space) when none are loaded."""
        if not self.norm_stats:
            return {"q01": [-1.0] * self.action_dim,
                    "q99": [1.0] * self.action_dim}
        if unnorm_key is None:
            if len(self.norm_stats) != 1:
                raise ValueError(f"need unnorm_key; available: "
                                 f"{list(self.norm_stats)}")
            unnorm_key = next(iter(self.norm_stats))
        entry = self.norm_stats[unnorm_key]
        return entry["action"] if "action" in entry else entry

    def get_proprio_stats(self) -> dict:
        if self.proprio_stats is None:
            raise ValueError("no proprio stats loaded")
        return self.proprio_stats
