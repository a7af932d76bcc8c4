"""Offline evaluation: greedy generation over a GCOT val set, then the
metrics. Port of ``scripts/generate.py``.

``load_vla(--checkpoint)`` -> ``EmmaXVLA.generate_batch`` over a
``ValDataset`` -> per-sample JSON (``VLM_Response`` / ``ground_truth`` /
``prompt``) at ``--out`` -> policy-token precision / recall / F1 (token-
wise over ``;``-separated policies, the first word-boundary token
dropped) and the Solver's movement accuracy and L1. ``--smoke_test`` runs
the tiny model (random weights, a 1024-token byte vocabulary) on
synthetic items; ``--metric_file`` only scores a
results file. Runs on the card unless ``--device cpu``.

    python -m emmax_torch.generate --checkpoint runs/<run> \\
        --val_json data/gcot/val.json --frames_dir data/frames \\
        --out results.json
    python -m emmax_torch.generate --smoke_test true --device cpu
    python -m emmax_torch.generate --metric_file results.json
"""

from __future__ import annotations

import json
import logging
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from emmax_torch.conf import parse_config

log = logging.getLogger("emmax_torch.generate")


@dataclass
class GenerateConfig:
    checkpoint: Optional[Path] = None
    val_json: Optional[Path] = None
    frames_dir: Optional[Path] = None
    out: Path = Path("generate_results.json")
    metric_file: Optional[Path] = None     # skip generation, just score
    data_mix: str = "movement_policy"
    batch_size: int = 8
    max_new_tokens: int = 512
    limit: Optional[int] = None
    tokenizer_path: Optional[str] = None
    smoke_test: bool = False
    device: str = "cuda"


def policy_token_prf(results, tokenizer) -> dict:
    """Token-level precision / recall / F1 over the POLICIES strings (the
    leading word-boundary token of each policy dropped)."""
    correct = predicted = total = 0
    for r in results:
        pred = (r["VLM_Response"].split("POLICIES:")[-1].replace("\n", "")
                .split(";"))
        gt = (r["ground_truth"].split("POLICIES:")[-1].replace("\n", "")
              .split(";"))
        pred_tok = [tokenizer.encode(p, add_special_tokens=False)
                    for p in pred]
        gt_tok = [tokenizer.encode(g, add_special_tokens=False) for g in gt]
        for j in range(min(len(pred), len(gt))):
            m = min(len(pred_tok[j]), len(gt_tok[j]))
            predicted += len(pred_tok[j]) - 1
            total += len(gt_tok[j]) - 1
            for k in range(1, m):  # the first token is the boundary piece
                if pred_tok[j][k] == gt_tok[j][k]:
                    correct += 1
    p = correct / max(predicted, 1)
    r = correct / max(total, 1)
    f1 = 2 * p * r / max(p + r, 1e-9)
    return {"precision": p, "recall": r, "f1": f1,
            "correct": correct, "predicted": predicted, "total": total}


def report(results, tokenizer) -> dict:
    """The policy-token P / R / F1 and the Solver's mean accuracy and L1,
    logged and returned."""
    import numpy as np

    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.solver import Solver

    prf = policy_token_prf(results, tokenizer)
    _, acc, l1, _, _, _ = Solver(ActionTokenizer(tokenizer)).evaluate_batch(
        [r["ground_truth"] for r in results],
        [r["VLM_Response"] for r in results])
    metrics = {**prf, "solver_acc": float(np.mean(acc)),
               "solver_l1": float(np.mean(l1))}
    log.info("policy tokens: P=%.2f R=%.2f F1=%.2f | solver acc=%.3f "
             "L1=%.4f", prf["precision"] * 100, prf["recall"] * 100,
             prf["f1"] * 100, metrics["solver_acc"], metrics["solver_l1"])
    return metrics


def smoke_params(vlm_cfg, device):
    """The smoke test's random tiny weights (seed 0)."""
    import torch

    from emmax_torch.models.vlm import init_vlm_params

    generator = torch.Generator(device)
    generator.manual_seed(0)
    return init_vlm_params(generator, vlm_cfg, torch.float32, device)


def main(cfg: GenerateConfig) -> dict:
    """Generate (unless ``--metric_file``) and score; returns the
    metrics."""
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer, load_tokenizer

    if cfg.metric_file is not None:
        results = json.loads(Path(cfg.metric_file).read_text())
        tokenizer = (ByteLevelTokenizer() if cfg.tokenizer_path is None
                     else load_tokenizer(cfg.tokenizer_path))
        return report(results, tokenizer)

    from emmax_torch.data.gcot import (DirectoryFrameSource,
                                       SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.pretrain import ValDataset
    from emmax_torch.serving.engine import resolve_device
    from emmax_torch.vla.action_tokenizer import ActionTokenizer

    device = resolve_device(cfg.device)
    if cfg.smoke_test:
        from emmax_torch.models.vla import EmmaXVLA
        from emmax_torch.models.vlm import tiny_vlm_config
        from emmax_torch.ops.image import ImageTransformConfig

        # vocab >= 516, so the 256 action bins fit above the byte region
        # (the JAX script's 512 fails ActionTokenizer's check)
        tokenizer = ByteLevelTokenizer(vocab_size=1024)
        vlm_cfg = tiny_vlm_config(tokenizer.padded_vocab_size)
        vla = EmmaXVLA(vlm_cfg, smoke_params(vlm_cfg, device), tokenizer,
                       {n: ImageTransformConfig(size=v.img_size)
                        for n, v in vlm_cfg.vision}, device=device)
        items = make_dummy_gcot_items(8)
        frame_source = SyntheticFrameSource(64)
    else:
        from emmax_torch.models.load import load_vla

        vla = load_vla(cfg.checkpoint, tokenizer_path=cfg.tokenizer_path,
                       device=device)
        tokenizer = vla.tokenizer
        with open(cfg.val_json) as f:
            items = json.load(f)
        frame_source = DirectoryFrameSource(cfg.frames_dir)

    ds = ValDataset(items, ActionTokenizer(tokenizer), frame_source,
                    data_mix=cfg.data_mix)
    n = min(len(ds), cfg.limit or len(ds))
    results = []
    t0 = time.time()
    for start in range(0, n, cfg.batch_size):
        batch = [ds[i] for i in range(start, min(start + cfg.batch_size, n))]
        texts = vla.generate_batch([b["image"] for b in batch],
                                   [b["prompt"] for b in batch],
                                   max_new_tokens=cfg.max_new_tokens)
        for b, text in zip(batch, texts):
            results.append({"VLM_Response": text,
                            "ground_truth": b["ground_truth"],
                            "prompt": b["prompt"]})
        log.info("%d/%d in %.1f s", len(results), n, time.time() - t0)
    Path(cfg.out).write_text(json.dumps(results, indent=2))
    return report(results, tokenizer)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main(parse_config(GenerateConfig, sys.argv[1:]))
