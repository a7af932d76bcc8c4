"""2D gripper localization, port of ``emmax_tpu/experiments/gripper.py``.

The WidowX eval's pipeline (``gripper_position.py:7-112``): OWL-ViT
zero-shot detection ("the black robotic gripper") -> SAM box-prompted mask
-> a position heuristic, rescaled to the model's 224 px frame. The
detector is pluggable: ``HFDetectorBackend`` runs both models through
``transformers`` (imported when it is built, never at module import: the
card machine has neither ``transformers`` nor PIL), and without a detector
mask the locator takes JAX's darkest-region rule (the WidowX gripper is
black). A detector that raises ends the call: nothing here catches it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


def mask_to_pos_naive(mask: np.ndarray, x_offset: int = 10,
                      y_offset: int = -10) -> Tuple[int, int]:
    """Bottom-right-most mask pixel + offsets (the reference's fingertip
    heuristic, ``gripper_position.py:60-97``)."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0
    score = xs + ys
    i = int(np.argmax(score))
    return int(xs[i]) + x_offset, int(ys[i]) + y_offset


class HFDetectorBackend:
    """OWL-ViT + SAM backend (``gripper_position.py:99-112``) on ``device``.

    By default it loads the pretrained checkpoints (large gated
    downloads). Built ``owl_processor`` / ``owl`` / ``sam_processor`` /
    ``sam`` objects can be passed instead, e.g. to share one detector
    between locators. ``device`` as every entry point: the card unless the
    caller asks for the CPU.
    """

    def __init__(self, owl_model: str = "google/owlvit-base-patch32",
                 sam_model: str = "facebook/sam-vit-base",
                 query: str = "the black robotic gripper",
                 threshold: float = 0.05,
                 owl_processor=None, owl=None,
                 sam_processor=None, sam=None, device="cuda") -> None:
        from transformers import (AutoProcessor, OwlViTForObjectDetection,
                                  OwlViTProcessor, SamModel)

        from emmax_torch.serving.engine import resolve_device

        self.device = resolve_device(device)
        self.owl_processor = (owl_processor if owl_processor is not None
                              else OwlViTProcessor.from_pretrained(owl_model))
        self.owl = (owl if owl is not None
                    else OwlViTForObjectDetection.from_pretrained(owl_model)
                    ).to(self.device).eval()
        self.sam_processor = (sam_processor if sam_processor is not None
                              else AutoProcessor.from_pretrained(sam_model))
        self.sam = (sam if sam is not None
                    else SamModel.from_pretrained(sam_model)
                    ).to(self.device).eval()
        self.query = query
        self.threshold = threshold

    def _on_device(self, inputs) -> dict:
        return {k: v.to(self.device) if hasattr(v, "to") else v
                for k, v in inputs.items()}

    def __call__(self, image: np.ndarray) -> Optional[np.ndarray]:
        """uint8 ``[H, W, 3]`` -> the gripper's bool mask ``[H, W]``, or
        None when OWL-ViT finds no box above the threshold."""
        import torch
        from PIL import Image

        pil = Image.fromarray(image)
        inputs = self.owl_processor(text=[[self.query]], images=pil,
                                    return_tensors="pt")
        with torch.no_grad():
            out = self.owl(**self._on_device(inputs))
        target_size = torch.tensor([pil.size[::-1]], device=self.device)
        det = self.owl_processor.post_process_object_detection(
            out, threshold=self.threshold, target_sizes=target_size)[0]
        if len(det["boxes"]) == 0:
            return None
        box = det["boxes"][det["scores"].argmax()].tolist()
        sam_in = self.sam_processor(pil, input_boxes=[[box]],
                                    return_tensors="pt")
        with torch.no_grad():
            sam_out = self.sam(**self._on_device(sam_in))
        masks = self.sam_processor.image_processor.post_process_masks(
            sam_out.pred_masks.cpu(), sam_in["original_sizes"].cpu(),
            sam_in["reshaped_input_sizes"].cpu())[0]
        return masks[0, 0].numpy().astype(bool)


class GripperLocator:
    """image (uint8 ``[H, W, 3]``) -> (x, y) in model coordinates
    (224-scale)."""

    def __init__(self, backend: Optional[Callable] = None,
                 model_size: int = 224) -> None:
        self.backend = backend
        self.model_size = model_size
        self._warned = False

    def __call__(self, image: np.ndarray) -> Tuple[int, int]:
        H, W = image.shape[:2]
        mask = self.backend(image) if self.backend is not None else None
        if mask is None:
            # JAX's rule without a detector mask: the darkest region (the
            # WidowX gripper is black)
            if not self._warned:
                overwatch.info("no detector mask: gripper position from "
                               "the darkest region")
                self._warned = True
            gray = image.astype(np.float32).mean(-1)
            mask = gray <= gray.min() + 10.0
        x, y = mask_to_pos_naive(mask)
        # rescale to model (224) coordinates (gripper_position.py:99-112)
        return (int(round(x * self.model_size / W)),
                int(round(y * self.model_size / H)))
