"""The Hugging Face-style surface of the README quickstart, port of
``emmax_tpu/extern/hf_facade.py``::

    vla = EmmaXForVision2Seq.from_pretrained(run_dir)
    processor = EmmaXProcessor(vla.vla)   # shares the loaded model
    prompt, image = processor.get_prompt(task_label, image)
    inputs = processor(prompt, image)
    action, reasoning = vla.generate_actions(inputs, processor.tokenizer,
                                             do_sample=False,
                                             max_new_tokens=512)

``from_pretrained`` takes what ``models.load.load_vla`` takes: a
checkpoint directory or a model id, and ``device`` (the card unless
``device="cpu"``). ``EmmaXProcessor.from_pretrained`` loads the model a
second time; build the processor from the loaded one as above. The gripper position in the Emma-X prompt defaults to
the image centre, as when no detector runs; pass ``gripper_position=`` for
the localized value.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from emmax_torch.models.vla import EmmaXVLA, _as_uint8_array


def extract_instruction(prompt: str) -> str:
    """The task instruction of a built Emma-X / OpenVLA prompt (the
    ``INSTRUCTION:`` template, or OpenVLA's ``to {task}?``); a copy of
    ``emmax_tpu/extern/hf_processor.py``'s."""
    if "INSTRUCTION:" in prompt:
        tail = prompt.split("INSTRUCTION:", 1)[1]
        tail = tail.split("CURRENT GRIPPER", 1)[0]
        return tail.strip()
    marker = "What action should the robot take to "
    if marker in prompt:
        tail = prompt.split(marker, 1)[1]
        for stop in ("?", "\n"):
            if stop in tail:
                tail = tail.split(stop, 1)[0]
        return tail.strip()
    return ""


class EmmaXProcessor:
    """Prompt and image packaging (the ``PrismaticProcessor`` role)."""

    def __init__(self, vla: EmmaXVLA) -> None:
        self._vla = vla
        self.tokenizer = vla.tokenizer

    @classmethod
    def from_pretrained(cls, path, **kw) -> "EmmaXProcessor":
        from emmax_torch.models.load import load_vla

        return cls(load_vla(path, **kw))

    def get_prompt(self, task_label: str, image,
                   gripper_position: Optional[Sequence[int]] = None
                   ) -> Tuple[str, np.ndarray]:
        image = _as_uint8_array(image)
        if gripper_position is None:
            h, w = image.shape[:2]
            gripper_position = (w // 2, h // 2)
        return (self._vla.get_prompt(task_label,
                                     gripper_position=gripper_position),
                image)

    def __call__(self, prompt: str, image,
                 task_label: Optional[str] = None) -> dict:
        return {"prompt": prompt, "image": _as_uint8_array(image),
                "task": (task_label if task_label is not None
                         else extract_instruction(prompt))}


class EmmaXForVision2Seq:
    """Model facade (the ``OpenVLAForActionPrediction`` role)."""

    def __init__(self, vla: EmmaXVLA) -> None:
        self._vla = vla

    @classmethod
    def from_pretrained(cls, path, **kw) -> "EmmaXForVision2Seq":
        from emmax_torch.models.load import load_vla

        return cls(load_vla(path, **kw))

    @property
    def vla(self) -> EmmaXVLA:
        return self._vla

    def generate_actions(self, inputs: dict, tokenizer=None, *,
                         do_sample: bool = False, max_new_tokens: int = 512,
                         type: str = "act"):
        """(actions, generated text); greedy only (``do_sample`` is taken
        for the signature's sake, and the reference evaluates greedy)."""
        if do_sample:
            raise ValueError("sampling is not supported (greedy only)")
        return self._vla.generate_actions(inputs["image"], inputs["prompt"],
                                          type=type,
                                          max_new_tokens=max_new_tokens)

    def predict_action(self, inputs: dict, unnorm_key: Optional[str] = None,
                       do_sample: bool = False) -> np.ndarray:
        """OpenVLA-style actions; the task comes from ``inputs["task"]``
        or, for hand-built inputs, from the prompt."""
        if do_sample:
            raise ValueError("sampling is not supported (greedy only)")
        task = inputs.get("task") or extract_instruction(
            inputs.get("prompt", ""))
        return self._vla.predict_action(inputs["image"], task,
                                        unnorm_key=unnorm_key)
