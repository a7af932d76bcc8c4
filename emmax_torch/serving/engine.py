"""Autoregressive serving engine, port of ``emmax_tpu/serving/engine.py``.

Prompts are left-padded to a length bucket so that every row shares one
cache cursor. A generation encodes the frame (both towers + projector),
splices the patches after BOS, prefills a preallocated KV cache of
``patches + bucket + max_new`` slots rounded to 128, and decodes greedily
(or by temperature / top-p sampling) with EOS early exit. The cache is
updated in place. The loop asks the card whether every row is done only
every ``DONE_CHECK_EVERY`` steps: the output is EOS-padded either way.

The decode loop's semantics are the JAX package's ``_generate_multimodal``:
the first token comes from the prefill's last logits, each step writes
``out[:, t] = where(done, eos, tok)`` and sets ``done |= tok == eos``, and
the loop stops after ``max_new`` steps or when every row is done.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from emmax_torch.models.llama import embed_tokens, init_kv_cache
from emmax_torch.models.vlm import VLM, VLMConfig, fuse_multimodal, llm_apply

DEFAULT_BUCKETS = (32, 64, 96, 128, 192, 256)
DONE_CHECK_EVERY = 8


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card
    (nothing silently runs on the CPU instead)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class GenerateOptions:
    max_new_tokens: int = 512
    eos_id: int = 2
    # temperature 0 = greedy; > 0 samples with optional nucleus top_p
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0


def pick_bucket(length: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return ((length + 127) // 128) * 128


def _round_up(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


def _select_token(logits_f32: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_p: float) -> torch.Tensor:
    """Greedy (temperature == 0) or temperature/nucleus sampling."""
    if temperature == 0.0:
        return torch.argmax(logits_f32, dim=-1)
    logits = logits_f32 / temperature
    if top_p < 1.0:
        # keep exactly the sorted positions inside the nucleus (a value
        # threshold would re-admit every token tied at the cutoff)
        sorted_logits, idx = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, idx, keep_sorted)
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class ServingEngine:
    """Host-side wrapper: tokenizing, bucketing and left-padding around the
    prefill and decode loop. ``params`` must lie on ``device``.

    After each call, ``last_timings`` holds that generation's phases:
    vision encode, prefill (ending with the first token) and decode times
    in ms, the number of decode forwards and the prefill length, the times
    read from CUDA events on the card and from the host clock on the CPU.
    The same phases run inside ``torch.profiler`` ranges named
    ``emmax_torch.encode`` / ``.prefill`` / ``.decode``, which cost nothing
    when no profiler is active.
    """

    def __init__(self, cfg: VLMConfig, params, tokenizer,
                 options: Optional[GenerateOptions] = None,
                 attn_impl: str = "auto", buckets=DEFAULT_BUCKETS,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = VLM(cfg, params)
        for name, buf in self.model.named_buffers():
            if buf.device.type != self.device.type:
                raise ValueError(f"weight {name} is on {buf.device}, the "
                                 f"engine on {self.device}")
        self.tokenizer = tokenizer
        self.options = options or GenerateOptions()
        self.attn_impl = attn_impl
        self.buckets = buckets
        self.last_timings: Dict[str, float] = {}
        self._step = 0

    def _prepare(self, prompts, suffix_ids=()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, mask) [B, bucket] on the device, LEFT-padded."""
        enc = [self.tokenizer.encode(p) + list(suffix_ids) for p in prompts]
        bucket = pick_bucket(max(len(e) for e in enc), self.buckets)
        ids = np.full((len(enc), bucket), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(enc), bucket), bool)
        for i, e in enumerate(enc):
            e = e[:bucket]
            ids[i, bucket - len(e):] = e
            mask[i, bucket - len(e):] = True
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _marks(self, n: int):
        """``n`` timing marks: CUDA events on the card, else None."""
        if self.device.type != "cuda":
            return [None] * n
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    @torch.inference_mode()
    def _generate(self, ids: torch.Tensor, mask: torch.Tensor,
                  pixel_values: Dict[str, torch.Tensor], max_new: int,
                  generator: torch.Generator) -> torch.Tensor:
        """ids/mask [B, L] (left-padded) -> tokens [B, max_new], EOS-padded."""
        opts, cfg = self.options, self.cfg
        params = self.model.tree()
        llm = params["llm"]
        B, L = ids.shape
        cache_len = _round_up(cfg.num_patches + L + max_new)
        cache = init_kv_cache(cfg.llm, B, cache_len,
                              dtype=llm["embed"].dtype, device=self.device)
        marks = self._marks(4)
        host_t = [0.0] * 4

        def mark(i):
            if marks[i] is not None:
                marks[i].record()
            else:
                host_t[i] = time.perf_counter()

        mark(0)
        with record_function("emmax_torch.encode"):
            patch_embeds = self.model(pixel_values, attn_impl=self.attn_impl)
        mark(1)
        with record_function("emmax_torch.prefill"):
            embeds, fmask, _, positions = fuse_multimodal(
                patch_embeds, embed_tokens(llm, ids), mask)
            logits, cache = llm_apply(llm, cfg.llm, embeds, mask=fmask,
                                      positions=positions, kv_cache=cache,
                                      attn_impl=self.attn_impl)
            tok = _select_token(logits[:, -1].float(), generator,
                                opts.temperature, opts.top_p)
        mark(2)
        next_pos = positions[:, -1] + 1
        out = torch.full((B, max_new), opts.eos_id, dtype=torch.int64,
                         device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        eos = torch.tensor(opts.eos_id, device=self.device)
        forwards = 0
        with record_function("emmax_torch.decode"):
            for t in range(max_new):
                out[:, t] = torch.where(done, eos, tok)
                done |= tok == opts.eos_id
                if t + 1 == max_new or (
                        (t + 1) % DONE_CHECK_EVERY == 0 and bool(done.all())):
                    break
                lg, cache = llm_apply(llm, cfg.llm,
                                      embed_tokens(llm, tok[:, None]),
                                      positions=(next_pos + t)[:, None],
                                      kv_cache=cache,
                                      attn_impl=self.attn_impl)
                forwards += 1
                tok = _select_token(lg[:, 0].float(), generator,
                                    opts.temperature, opts.top_p)
        mark(3)
        if marks[0] is not None:
            marks[3].synchronize()
            ms = [marks[0].elapsed_time(m) for m in marks[1:]]
        else:
            ms = [(t - host_t[0]) * 1e3 for t in host_t[1:]]
        self.last_timings = {"encode_ms": ms[0], "prefill_ms": ms[1] - ms[0],
                             "decode_ms": ms[2] - ms[1],
                             "decode_forwards": float(forwards),
                             "prefill_tokens": float(embeds.shape[1])}
        return out

    def generate_ids(self, prompts, pixel_values: Dict[str, torch.Tensor],
                     max_new_tokens: Optional[int] = None,
                     suffix_ids=()) -> np.ndarray:
        """prompts: list[str]; pixel_values: tower name -> [B, H, W, 3]
        normalized, on the device. Returns [B, max_new] token ids."""
        ids, mask = self._prepare(prompts, suffix_ids)
        max_new = (self.options.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        self._step += 1
        generator = torch.Generator(self.device)
        generator.manual_seed(self.options.seed + self._step)
        out = self._generate(ids, mask, pixel_values, max_new, generator)
        return out.cpu().numpy()

    def generate(self, prompts, pixel_values,
                 max_new_tokens: Optional[int] = None):
        """Decoded strings, cut at EOS, special tokens stripped."""
        out = self.generate_ids(prompts, pixel_values, max_new_tokens)
        eos = self.options.eos_id
        texts = []
        for row in out:
            row = list(row)
            if eos in row:
                row = row[:row.index(eos)]
            texts.append(self.tokenizer.decode(row).strip())
        return texts
