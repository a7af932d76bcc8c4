"""Autoregressive serving engine, port of ``emmax_tpu/serving/engine.py``.

Prompts are left-padded to a length bucket so that every row shares one
cache cursor. A generation encodes the frame (both towers + projector),
splices the patches after BOS, prefills a preallocated KV cache of
``patches + bucket + max_new`` slots rounded to 128 (int8 with
``quantized_cache``), and decodes greedily (or by temperature / top-p
sampling) with EOS early exit. The cache is updated in place. A
``VisionCache`` reuses the patches of a near-identical earlier frame
(batch 1, the closed control loop). The loop asks the card whether every
row is done only every ``DONE_CHECK_EVERY`` steps: the output is
EOS-padded either way.

The decode loop's semantics are the JAX package's ``_generate_multimodal``:
the first token comes from the prefill's last logits, each step writes
``out[:, t] = where(done, eos, tok)`` and sets ``done |= tok == eos``, and
the loop stops after ``max_new`` steps or when every row is done.

``ServingEngine(cfg, parallel.shard_params(params, mesh), tok, mesh=mesh)``
serves from each rank's blocks: every rank runs the same host loop on the
same request, gathering each weight where it is used, and produces the
tokens of the single-device engine (a quantized tree's ``q4`` / ``q8`` /
``scale`` leaves are replicated, so it computes as on one device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from emmax_torch.models.llama import embed_tokens, init_kv_cache
from emmax_torch.models.vlm import (VLM, VLMConfig, encode_images,
                                    fuse_multimodal, llm_apply)

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


def resolve_patches(params, cfg: VLMConfig, vision_input: Dict,
                    attn_impl: str = "auto", mesh=None) -> torch.Tensor:
    """``vision_input`` is a tower -> pixels dict (encoded now) or
    ``{"patches": [B, P, D]}``, projected patch embeddings made earlier
    (``encode_frame``). Engines compared token for token are fed the same
    patches: two encodes of one frame may round differently."""
    if "patches" in vision_input:
        return vision_input["patches"]
    return encode_images(params, cfg, vision_input, attn_impl=attn_impl,
                         mesh=mesh)


@torch.inference_mode()
def encode_frame(params, cfg: VLMConfig, pixel_values: Dict, *,
                 attn_impl: str = "auto", mesh=None) -> torch.Tensor:
    """Vision towers + projector: pixels -> patch embeds [B, P, D]."""
    return encode_images(params, cfg, pixel_values, attn_impl=attn_impl,
                         mesh=mesh)


class VisionCache:
    """Host-side cross-frame patch-embedding cache (batch-1 closed loop).

    Keyed on a downsampled mean-pooled fingerprint of the raw pixels; a
    lookup hits when the mean absolute difference against a cached frame is
    at most ``threshold`` (normalized-pixel units). ``threshold=0`` means
    exact-frame reuse only.
    """

    def __init__(self, capacity: int = 4, threshold: float = 0.0,
                 pool: int = 16) -> None:
        self.capacity = capacity
        self.threshold = threshold
        self.pool = pool
        self.entries = {}  # fingerprint shape -> [(fp, patches)] newest last
        self.hits = 0
        self.misses = 0

    def _pooled(self, img: np.ndarray) -> np.ndarray:
        """[B, H, W, C] -> the pool x pool block means, flattened."""
        B = img.shape[0]
        h, w = img.shape[1] // self.pool, img.shape[2] // self.pool
        img = img[:, : h * self.pool, : w * self.pool]
        img = img.reshape(B, h, self.pool, w, self.pool, -1)
        return img.mean(axis=(2, 4)).ravel()

    def fingerprint(self, pixel_values: Dict[str, torch.Tensor]
                    ) -> np.ndarray:
        """Fingerprint of normalized tower pixels (one device fetch per
        tower)."""
        return np.concatenate([
            self._pooled(pixel_values[name].float().cpu().numpy())
            for name in sorted(pixel_values)])

    def fingerprint_host(self, frame) -> np.ndarray:
        """Fingerprint of a host uint8 camera frame, scaled to roughly
        match the normalized-pixel threshold (no device fetch)."""
        img = np.asarray(frame, np.float32) / 127.5 - 1.0
        return self._pooled(img[None] if img.ndim == 3 else img)

    def _ring(self, fp: np.ndarray) -> list:
        # host-keyed and pixel-keyed fingerprints have different shapes and
        # never match each other: each kind keeps its own capacity ring, so
        # one kind of caller cannot evict the other's entries
        return self.entries.setdefault(fp.shape, [])

    def lookup(self, fp: np.ndarray):
        for cached_fp, patches in reversed(self._ring(fp)):
            if np.mean(np.abs(cached_fp - fp)) <= self.threshold:
                self.hits += 1
                return patches
        self.misses += 1
        return None

    def store(self, fp: np.ndarray, patches) -> None:
        ring = self._ring(fp)
        ring.append((fp, patches))
        if len(ring) > self.capacity:
            ring.pop(0)


@torch.inference_mode()
def _prefill_last_logits(params, cfg: VLMConfig, input_ids: torch.Tensor,
                         mask: torch.Tensor, pixel_values: Dict, *,
                         cache_len: int, attn_impl: str = "auto",
                         mesh=None) -> torch.Tensor:
    """Last-position fp32 logits [B, V] of the multimodal prefill (for
    string scoring)."""
    B = input_ids.shape[0]
    cache = init_kv_cache(cfg.llm, B, cache_len,
                          dtype=params["llm"]["embed"].dtype,
                          device=input_ids.device)
    patch_embeds = resolve_patches(params, cfg, pixel_values, attn_impl,
                                   mesh)
    embeds, fmask, _, positions = fuse_multimodal(
        patch_embeds, embed_tokens(params["llm"], input_ids, mesh), mask)
    logits, _ = llm_apply(params["llm"], cfg.llm, embeds, mask=fmask,
                          positions=positions, kv_cache=cache,
                          attn_impl=attn_impl, mesh=mesh)
    return logits[:, -1].float()


class ServingEngine:
    """Host-side wrapper: tokenizing, bucketing and left-padding around the
    prefill and decode loop. ``params`` must lie on ``device``.
    ``quantized_cache`` keeps K/V in int8 (``models/llama.init_kv_cache``);
    ``vision_cache`` reuses patches across frames (batch 1).

    After each call, ``last_timings`` holds that generation's phases:
    vision encode, prefill (ending with the first token) and decode times
    in ms, the number of decode forwards and the prefill length, the times
    read from CUDA events on the card and from the host clock on the CPU.
    The same phases run inside ``torch.profiler`` ranges named
    ``emmax_torch.encode`` / ``.prefill`` / ``.decode``, which cost nothing
    when no profiler is active.

    ``mesh``: ``params`` are this rank's blocks (module docstring).
    """

    def __init__(self, cfg: VLMConfig, params, tokenizer,
                 options: Optional[GenerateOptions] = None,
                 attn_impl: str = "auto", buckets=DEFAULT_BUCKETS,
                 quantized_cache: bool = False,
                 vision_cache: Optional[VisionCache] = None,
                 device="cuda", mesh=None) -> None:
        self.device = resolve_device(device)
        self.mesh = mesh
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
        self.quantized_cache = quantized_cache
        self.vision_cache = vision_cache
        self.last_timings: Dict[str, float] = {}
        self._step = 0

    def _vision_input(self, pixel_values: Dict, frame_key=None) -> Dict:
        """Cross-frame patch reuse through ``vision_cache`` (batch 1 only):
        ``{"patches": ...}`` from a hit, or from encoding the frame now and
        storing it. ``frame_key``: the host uint8 frame to fingerprint
        instead of the device pixels."""
        if "patches" in pixel_values or self.vision_cache is None:
            return pixel_values
        if next(iter(pixel_values.values())).shape[0] != 1:
            return pixel_values
        vc = self.vision_cache
        fp = (vc.fingerprint_host(frame_key) if frame_key is not None
              else vc.fingerprint(pixel_values))
        patches = vc.lookup(fp)
        if patches is None:
            patches = encode_frame(self.model.tree(), self.cfg, pixel_values,
                                   attn_impl=self.attn_impl, mesh=self.mesh)
            vc.store(fp, patches)
        return {"patches": patches}

    def _prepare_host(self, prompts, suffix_ids=()
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, mask) [B, bucket] numpy arrays, LEFT-padded."""
        enc = [self.tokenizer.encode(p) + list(suffix_ids) for p in prompts]
        bucket = pick_bucket(max(len(e) for e in enc), self.buckets)
        ids = np.full((len(enc), bucket), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(enc), bucket), bool)
        for i, e in enumerate(enc):
            e = e[:bucket]
            ids[i, bucket - len(e):] = e
            mask[i, bucket - len(e):] = True
        return ids, mask

    def _prepare(self, prompts, suffix_ids=()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, mask) [B, bucket] on the device, LEFT-padded."""
        ids, mask = self._prepare_host(prompts, suffix_ids)
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
        opts, cfg, mesh = self.options, self.cfg, self.mesh
        params = self.model.tree()
        llm = params["llm"]
        B, L = ids.shape
        cache_len = _round_up(cfg.num_patches + L + max_new)
        cache = init_kv_cache(cfg.llm, B, cache_len,
                              dtype=llm["embed"].dtype, device=self.device,
                              quantized=self.quantized_cache)
        marks = self._marks(4)
        host_t = [0.0] * 4

        def mark(i):
            if marks[i] is not None:
                marks[i].record()
            else:
                host_t[i] = time.perf_counter()

        mark(0)
        with record_function("emmax_torch.encode"):
            patch_embeds = resolve_patches(params, cfg, pixel_values,
                                           self.attn_impl, mesh)
        mark(1)
        with record_function("emmax_torch.prefill"):
            embeds, fmask, _, positions = fuse_multimodal(
                patch_embeds, embed_tokens(llm, ids, mesh), mask)
            logits, cache = llm_apply(llm, cfg.llm, embeds, mask=fmask,
                                      positions=positions, kv_cache=cache,
                                      attn_impl=self.attn_impl, mesh=mesh)
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
                                      embed_tokens(llm, tok[:, None], mesh),
                                      positions=(next_pos + t)[:, None],
                                      kv_cache=cache,
                                      attn_impl=self.attn_impl, mesh=mesh)
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
                     suffix_ids=(), frame_key=None) -> np.ndarray:
        """prompts: list[str]; pixel_values: tower name -> [B, H, W, 3]
        normalized, on the device, or ``{"patches": [B, P, D]}`` (see
        :func:`resolve_patches`). ``frame_key``: the host uint8 frame that
        keys the vision cache. Returns [B, max_new] token ids."""
        ids, mask = self._prepare(prompts, suffix_ids)
        max_new = (self.options.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        self._step += 1
        generator = torch.Generator(self.device)
        generator.manual_seed(self.options.seed + self._step)
        out = self._generate(ids, mask,
                             self._vision_input(pixel_values,
                                                frame_key=frame_key),
                             max_new, generator)
        return out.cpu().numpy()

    def _zero_pixels(self) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros((1, v.img_size, v.img_size, 3),
                                  device=self.device)
                for name, v in self.cfg.vision}

    def warmup(self, example_prompts, pixel_values=None,
               max_new_tokens: Optional[int] = None,
               batch_sizes=(1,)) -> list:
        """Run a throwaway generation for every (batch size, prompt) pair a
        deployment will send, before its first real request (the first
        call of a shape pays the kernels' and allocator's first-use costs).
        ``pixel_values``: tower input for the runs (zeros if None).
        Returns the warmed (batch, bucket) pairs."""
        max_new = (self.options.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if pixel_values is None:
            pixel_values = self._zero_pixels()
        warmed = []
        for b in batch_sizes:
            pv = {k: (v[:1].expand((b,) + v.shape[1:]) if v.shape[0] != b
                      else v) for k, v in pixel_values.items()}
            for p in example_prompts:
                self.generate_ids([p] * b, pv, max_new_tokens=max_new)
                warmed.append((b, pick_bucket(len(self.tokenizer.encode(p)),
                                              self.buckets)))
        return warmed

    def first_token_probs(self, prompts, pixel_values,
                          candidate_ids) -> np.ndarray:
        """Normalized probabilities of candidate first generated tokens
        (the reference's ``generate_batch(return_string_probabilities=)``).
        Returns [B, n_candidates]."""
        ids, mask = self._prepare(prompts)
        cache_len = _round_up(self.cfg.num_patches + ids.shape[1] + 8)
        logits = _prefill_last_logits(self.model.tree(), self.cfg, ids, mask,
                                      self._vision_input(pixel_values),
                                      cache_len=cache_len,
                                      attn_impl=self.attn_impl,
                                      mesh=self.mesh)
        probs = torch.softmax(logits, dim=-1).cpu().numpy()
        sel = probs[:, np.asarray(candidate_ids)]
        return sel / sel.sum(axis=-1, keepdims=True)

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
