"""Emma-X VLA policy: prompts in, 7-DoF actions out.

Port of ``emmax_tpu/models/vla.py``, on the plain ``ServingEngine`` or
(``speculative=True``) the ``SpeculativeEngine``:

- ``generate_actions(image, prompt_text, type)``: decode the grounded
  chain of thought, parse it with the Solver, un-normalize with q01/q99
  (or the proprio Q1/Q99 for ``type="pos"``);
- ``predict_action(image, instruction, unnorm_key)``: OpenVLA-style, append
  the empty token and decode exactly ``action_dim`` action tokens;
- ``generate_batch(images, prompts)``: batched text, or with
  ``return_string_probabilities`` the first-token probabilities of
  candidate strings;
- ``get_prompt(task_label, gripper_position)``.

With ``speculative`` and ``closed_loop`` each frame keys a
``VisionCache`` on its host uint8 image, drafts from the previous frame's
output and refreshes only the prompt tail of the previous frame's KV
cache where the patches are reused (``serving/speculative.py``).

``mesh``: ``params`` are this rank's blocks
(``EmmaXVLA(cfg, parallel.shard_params(params, mesh), ..., mesh=mesh)``);
the engine reads them as ``ServingEngine`` does (the decoder split over
``tensor`` where ``parallel.tensor.decoder_split`` says so, each weight
gathered where it is used elsewhere) and every rank returns the same text
and actions, the single-device policy's up to the split's rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emmax_torch.models.vlm import VLMConfig
from emmax_torch.ops.image import ImageTransformConfig, preprocess_for_towers
from emmax_torch.serving.engine import (GenerateOptions, ServingEngine,
                                        VisionCache, resolve_device)
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
        speculative: bool = False,
        draft_k: int = 12,
        closed_loop: bool = True,
        prefix_tail: int = 24,
        vision_cache_threshold: float = 0.0,
        device="cuda",
        mesh=None,
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
        if speculative:
            # greedy-exact speculative decode. `closed_loop` adds the
            # cross-frame stack: vision cache, prefix-KV tail refresh and
            # drafts from the previous frame's output. At the default
            # threshold 0.0 only byte-identical frames reuse patches (the
            # output stays exact); a positive threshold trades slightly
            # stale patches for skipping the towers on near-identical frames
            from emmax_torch.serving.speculative import SpeculativeEngine

            self.engine = SpeculativeEngine(
                cfg, params, tokenizer, options=options, attn_impl=attn_impl,
                draft_k=draft_k, prefix_tail=prefix_tail if closed_loop else 0,
                vision_cache=(VisionCache(capacity=4,
                                          threshold=vision_cache_threshold)
                              if closed_loop else None),
                device=self.device, mesh=mesh)
        else:
            self.engine = ServingEngine(cfg, params, tokenizer,
                                        options=options, attn_impl=attn_impl,
                                        device=self.device, mesh=mesh)
        self._closed_loop = speculative and closed_loop
        self._last_output_ids = None
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
        """Free-form text generation for ONE frame. In closed-loop
        speculative mode the raw frame keys the vision cache and the
        previous frame's output seeds the drafts."""
        if isinstance(image, (list, tuple)) and len(image) != 1:
            raise ValueError("generate/generate_actions/predict_action take "
                             "ONE frame")
        frame = _as_uint8_array(image[0] if isinstance(image, (list, tuple))
                                else image)
        if self._closed_loop:
            out = self.engine.generate_ids(
                [prompt_text], self._pixels(image),
                max_new_tokens=max_new_tokens,
                draft_context=self._last_output_ids, frame_key=frame)
            self._last_output_ids = out[0]
            return self._decode_row(out[0])
        out = self.engine.generate_ids([prompt_text], self._pixels(image),
                                       max_new_tokens=max_new_tokens,
                                       **self._frame_kw(frame))
        return self._decode_row(out[0])

    def _frame_kw(self, frame) -> dict:
        """The host frame keys the vision cache, where the engine has one
        (every engine takes ``frame_key``)."""
        return {"frame_key": frame}

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
            suffix_ids=(self.tokenizer.empty_token_id,),
            **self._frame_kw(_as_uint8_array(image)))
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
