"""Load-and-drive check of an Emma-X checkpoint, port of
``vla-scripts/extern/verify_emmax.py``.

Loads a run dir or a Hub export through ``load_vla`` in bf16 and in fp32
and runs ``generate_actions`` and ``predict_action`` on a seeded test
frame, logging what comes out. ``--smoke_test`` drives the tiny model
instead (fp32, random weights, a 1024-token byte vocabulary: the JAX
script's 512 fails ``ActionTokenizer``'s check, which needs >= 516). Runs
on the card unless ``--device cpu``.

    python -m emmax_torch.verify_emmax --checkpoint runs/<run>
    python -m emmax_torch.verify_emmax --smoke_test true --device cpu
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from emmax_torch.conf import parse_config
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("verify")


@dataclass
class VerifyConfig:
    checkpoint: Optional[Path] = None
    tokenizer_path: Optional[str] = None
    instruction: str = "put the spoon on the towel"
    max_new_tokens: int = 128
    smoke_test: bool = False
    device: str = "cuda"


def main(cfg: VerifyConfig) -> Dict[str, dict]:
    """{variant: {"actions", "text", "predict_action", "seconds"}}."""
    import torch

    if cfg.smoke_test:
        from emmax_torch.eval_success_rate import build_tiny_vla

        variants = {"fp32": lambda: build_tiny_vla(cfg.device)}
        max_new_tokens = 12
    else:
        from emmax_torch.models.load import load_vla

        if cfg.checkpoint is None:
            raise ValueError("--checkpoint is required without --smoke_test")
        variants = {name: (lambda dt=dt: load_vla(
            cfg.checkpoint, dtype=dt, tokenizer_path=cfg.tokenizer_path,
            device=cfg.device))
            for name, dt in (("bf16", torch.bfloat16),
                             ("fp32", torch.float32))}
        max_new_tokens = cfg.max_new_tokens

    frame = np.random.default_rng(0).integers(0, 256, (256, 256, 3),
                                              dtype=np.uint8)
    out = {}
    for name, make in variants.items():
        vla = make()     # one variant on the card at a time
        t0 = time.time()
        prompt = vla.get_prompt(cfg.instruction, gripper_position=(112, 112))
        actions, text = vla.generate_actions(
            frame, prompt, type="act", max_new_tokens=max_new_tokens)
        seconds = time.time() - t0
        overwatch.info(f"[{name}] generate_actions -> {len(actions)} actions "
                       f"in {seconds:.1f}s")
        overwatch.info(f"[{name}] first action: {np.round(actions[0], 4)}")
        overwatch.info(f"[{name}] text[:120]: {text[:120]!r}")
        action = vla.predict_action(frame, cfg.instruction)
        overwatch.info(f"[{name}] predict_action: {np.round(action, 4)}")
        out[name] = {"actions": np.asarray(actions), "text": text,
                     "predict_action": np.asarray(action),
                     "seconds": seconds}
        del vla
    return out


if __name__ == "__main__":
    main(parse_config(VerifyConfig, sys.argv[1:]))
