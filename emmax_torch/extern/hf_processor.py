"""The Hugging Face processor of an exported Emma-X, port of
``emmax_tpu/extern/hf_processor.py``.

- ``EmmaXImagePipeline``: the per-tower image pipeline as JSON-serializable
  resize / normalize parameters, applied through the port's
  ``ops/image.preprocess_for_towers``; it writes and reads
  ``preprocessor_config.json`` in ``transformers``' layout without
  ``transformers``.
- ``EmmaXImageProcessor``: the same pipeline on
  ``transformers.ImageProcessingMixin``, built on first access through the
  module's ``__getattr__``, so importing this module does not import
  ``transformers``. Its ``to_dict`` and files equal the pipeline's.
- ``EmmaXProcessor``: tokenizer + image pipeline with the README's
  ``get_prompt(task_label, image)``; its ``__call__`` carries the task
  through to ``predict_action``. Its ``save_pretrained`` /
  ``from_pretrained`` need no ``transformers``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emmax_torch.extern.hf_facade import extract_instruction
from emmax_torch.ops.image import ImageTransformConfig

PREPROCESSOR_CONFIG = "preprocessor_config.json"
_FIELDS = ("tower_names", "input_sizes", "means", "stds", "interpolations",
           "image_resize_strategy")


def _as_uint8(image) -> np.ndarray:
    from emmax_torch.models.vla import _as_uint8_array

    return _as_uint8_array(image)


class _TowerPipeline:
    """Fields and application shared by the pipeline and the HF class."""

    def _set_fields(self, tower_names=None, input_sizes=None, means=None,
                    stds=None, interpolations=None,
                    image_resize_strategy="resize-naive") -> None:
        self.tower_names = tower_names or ["dino", "siglip"]
        n = len(self.tower_names)
        self.input_sizes = input_sizes or [224] * n
        self.means = [list(m) for m in (means or [(0.5, 0.5, 0.5)] * n)]
        self.stds = [list(s) for s in (stds or [(0.5, 0.5, 0.5)] * n)]
        self.interpolations = interpolations or ["bicubic"] * n
        self.image_resize_strategy = image_resize_strategy

    @classmethod
    def for_backbone(cls, vision_backbone_id: str,
                     image_resize_strategy: str = "resize-naive"):
        """From a backbone id through the port's transform table
        (``KeyError`` for an unknown id)."""
        from emmax_torch.ops.image import transform_configs_for_backbone

        cfgs = transform_configs_for_backbone(vision_backbone_id,
                                              image_resize_strategy)
        names = list(cfgs)
        return cls(tower_names=names,
                   input_sizes=[cfgs[n].size for n in names],
                   means=[list(cfgs[n].mean) for n in names],
                   stds=[list(cfgs[n].std) for n in names],
                   interpolations=[cfgs[n].interpolation for n in names],
                   image_resize_strategy=image_resize_strategy)

    def transform_configs(self) -> Dict[str, ImageTransformConfig]:
        return {
            name: ImageTransformConfig(
                size=self.input_sizes[i],
                resize_strategy=self.image_resize_strategy,
                mean=tuple(self.means[i]), std=tuple(self.stds[i]),
                interpolation=self.interpolations[i])
            for i, name in enumerate(self.tower_names)
        }

    def preprocess(self, images, return_stacked: bool = False):
        """uint8 image(s) -> ``{tower: [B, S, S, 3] float32}`` numpy
        arrays, or with ``return_stacked`` the reference's channel-stacked
        ``[B, 3 * towers, S, S]``."""
        from emmax_torch.ops.image import preprocess_for_towers

        arr = _as_uint8(images)
        if arr.ndim == 3:
            arr = arr[None]
        pixels = preprocess_for_towers(
            torch.from_numpy(np.ascontiguousarray(arr)),
            self.transform_configs())
        pixels = {k: v.numpy() for k, v in pixels.items()}
        if not return_stacked:
            return pixels
        return np.concatenate([np.moveaxis(pixels[n], -1, 1)
                               for n in self.tower_names], axis=1)

    def __call__(self, images, **kw):
        return self.preprocess(images, **kw)


class EmmaXImagePipeline(_TowerPipeline):
    """The image pipeline without ``transformers``."""

    def __init__(self, tower_names: Optional[List[str]] = None,
                 input_sizes: Optional[List[int]] = None,
                 means: Optional[List[Sequence[float]]] = None,
                 stds: Optional[List[Sequence[float]]] = None,
                 interpolations: Optional[List[str]] = None,
                 image_resize_strategy: str = "resize-naive") -> None:
        self._set_fields(tower_names, input_sizes, means, stds,
                         interpolations, image_resize_strategy)

    def to_dict(self) -> Dict[str, Any]:
        """What ``EmmaXImageProcessor.to_dict`` holds, its class name
        included (``_processor_class`` aside)."""
        return {**{k: getattr(self, k) for k in _FIELDS},
                "image_processor_type": "EmmaXImageProcessor"}

    def save_pretrained(self, path) -> Path:
        """``preprocessor_config.json`` as ``ImageProcessingMixin`` writes
        it (sorted keys, indent 2, a final newline)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        out = path / PREPROCESSOR_CONFIG
        out.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True)
                       + "\n")
        return out

    @classmethod
    def from_dict(cls, blob: Dict[str, Any]) -> "EmmaXImagePipeline":
        return cls(**{k: blob[k] for k in _FIELDS if k in blob})

    @classmethod
    def from_pretrained(cls, path) -> "EmmaXImagePipeline":
        return cls.from_dict(json.loads(
            (Path(path) / PREPROCESSOR_CONFIG).read_text()))


class EmmaXProcessor:
    """Tokenizer + image pipeline (the ``PrismaticProcessor`` role) with
    the Hub ``get_prompt``."""

    def __init__(self, image_processor, tokenizer,
                 llm_family: str = "llama2") -> None:
        self.image_processor = image_processor
        self.tokenizer = tokenizer
        self.llm_family = llm_family

    def get_prompt(self, task_label: str, image,
                   gripper_position: Optional[Sequence[int]] = None
                   ) -> Tuple[str, np.ndarray]:
        """(prompt, image); the gripper at the image centre when no
        detector runs."""
        from emmax_torch.vla.prompting import get_prompt_builder

        image = _as_uint8(image)
        if gripper_position is None:
            h, w = image.shape[:2]
            gripper_position = (w // 2, h // 2)
        pb = get_prompt_builder(self.llm_family)
        pb.add_turn("human", (
            "What action should the robot take to achieve the instruction"
            f"\nINSTRUCTION: \n{task_label}\nCURRENT GRIPPER: "
            f"[{int(gripper_position[0])}, {int(gripper_position[1])}]\n"))
        return pb.get_prompt(), image

    def __call__(self, prompt: str, image,
                 task_label: Optional[str] = None) -> Dict[str, Any]:
        """The model inputs: prompt, token ids, image, per-tower pixels and
        the task (``predict_action`` reads it)."""
        image = _as_uint8(image)
        return {
            "prompt": prompt,
            "input_ids": np.asarray([self.tokenizer.encode(prompt)], np.int32),
            "image": image,
            "pixel_values": self.image_processor.preprocess(image),
            "task": (task_label if task_label is not None
                     else extract_instruction(prompt)),
        }

    def save_pretrained(self, path) -> Path:
        """``preprocessor_config.json``: the image processor's sorted keys,
        then ``llm_family`` and the tokenizer's kind and size (indent 2),
        as the JAX package's ``EmmaXProcessor.save_pretrained`` writes
        it."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        image = {k: v for k, v in self.image_processor.to_dict().items()
                 if k != "_processor_class"}
        blob = dict(sorted(image.items()))
        blob["llm_family"] = self.llm_family
        blob["tokenizer"] = {"kind": type(self.tokenizer).__name__,
                             "vocab_size": int(self.tokenizer.vocab_size)}
        out = path / PREPROCESSOR_CONFIG
        out.write_text(json.dumps(blob, indent=2))
        return out

    @classmethod
    def from_pretrained(cls, path, tokenizer=None) -> "EmmaXProcessor":
        """From ``preprocessor_config.json``, with the transformers-free
        ``EmmaXImagePipeline``; ``tokenizer`` defaults to the byte-level
        one of the stored size."""
        blob = json.loads((Path(path) / PREPROCESSOR_CONFIG).read_text())
        if tokenizer is None:
            from emmax_torch.vla.tokenizer import ByteLevelTokenizer

            tokenizer = ByteLevelTokenizer(vocab_size=int(
                blob.get("tokenizer", {}).get("vocab_size", 32000)))
        return cls(EmmaXImagePipeline.from_dict(blob), tokenizer,
                   llm_family=blob.get("llm_family", "llama2"))


def _build_image_processor() -> type:
    from transformers.image_processing_utils import ImageProcessingMixin

    class EmmaXImageProcessor(ImageProcessingMixin, _TowerPipeline):
        """The image pipeline as a ``transformers`` image processor."""

        model_input_names = ["pixel_values"]

        def __init__(self, tower_names: Optional[List[str]] = None,
                     input_sizes: Optional[List[int]] = None,
                     means: Optional[List[Sequence[float]]] = None,
                     stds: Optional[List[Sequence[float]]] = None,
                     interpolations: Optional[List[str]] = None,
                     image_resize_strategy: str = "resize-naive",
                     **kwargs: Any) -> None:
            self._set_fields(tower_names, input_sizes, means, stds,
                             interpolations, image_resize_strategy)
            super().__init__(**kwargs)

    EmmaXImageProcessor.__qualname__ = "EmmaXImageProcessor"
    return EmmaXImageProcessor


def __getattr__(name: str):
    if name == "EmmaXImageProcessor":
        globals()[name] = _build_image_processor()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
