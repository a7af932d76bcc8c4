"""Continuous-batching serving engine: a fixed pool of KV-cache slots.

Port of ``emmax_tpu/serving/continuous.py``. Requests are admitted into
free slots as they arrive and leave when they hit EOS or spend their token
budget, so the decoder runs as full a batch as the queue allows and the
weight reads are shared by every active slot.

Mechanics:
- every slot's sequence is left-aligned at cache position 0 with its own
  cursor; the decoder's cached path takes per-row cursors (a [B] tensor
  ``cache["len"]``) with per-row writes, RoPE positions and causal masks
  (``models/llama.py``);
- admission groups the queue's equal-length head into one multimodal
  prefill into a fresh G-row cache (``_prefill_batch``), whose rows are
  then copied into the pool's slots in place (``_insert_slots``);
- decode runs in bursts of ``burst`` tokens between scheduling points; the
  host reads the emitted tokens and the active flags once per burst.

``mesh``: the params are this rank's blocks (``parallel.shard_params``),
used as in ``ServingEngine``: under a ``tensor`` split each rank's slot
pool holds its ``n_kv_heads / t`` KV heads, else the pool is whole. Every
rank runs the same schedule.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from emmax_torch.models.llama import embed_tokens, init_kv_cache
from emmax_torch.models.vlm import VLMConfig, fuse_multimodal, llm_apply
from emmax_torch.parallel.tensor import decoder_split
from emmax_torch.serving.engine import (check_mesh, resolve_device,
                                        resolve_patches)

_CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


def _prefill_batch(params, cfg: VLMConfig, input_ids: torch.Tensor,
                   mask: torch.Tensor, pixel_values: Dict, *,
                   cache_len: int, attn_impl: str,
                   quantized_cache: bool = False, mesh=None):
    """G-request multimodal prefill (equal prompt lengths, all-ones masks)
    -> (first tokens [G], cache tensors, slot masks [G, S], used lengths
    [G]). Grouping the queue's equal-length head shares the towers' and
    the decoder's weight reads among G requests."""
    G = input_ids.shape[0]
    cache = init_kv_cache(cfg.llm, G, cache_len,
                          dtype=params["llm"]["embed"].dtype,
                          device=input_ids.device, quantized=quantized_cache,
                          split=decoder_split(params["llm"], cfg.llm,
                                              mesh).t)
    patch_embeds = resolve_patches(params, cfg, pixel_values, attn_impl,
                                   mesh)
    embeds, fmask, _, positions = fuse_multimodal(
        patch_embeds, embed_tokens(params["llm"], input_ids, mesh), mask)
    logits, cache = llm_apply(params["llm"], cfg.llm, embeds, mask=fmask,
                              positions=positions, kv_cache=cache,
                              attn_impl=attn_impl, mesh=mesh)
    first = torch.argmax(logits[:, -1].float(), dim=-1)
    tensors = {key: cache[key] for key in _CACHE_KEYS if key in cache}
    return first, tensors, cache["mask"], positions[:, -1] + 1


def _insert_slots(pool: Dict, slots: torch.Tensor, tensors: Dict,
                  slot_masks: torch.Tensor, used_lens: torch.Tensor,
                  first_toks: torch.Tensor, max_new: torch.Tensor) -> None:
    """Copy a G-row prefilled cache into the pool's ``slots`` [G], in
    place."""
    for key, tg in tensors.items():
        pool[key][:, slots] = tg
    pool["mask"][slots] = slot_masks
    pool["len"][slots] = used_lens.to(pool["len"].dtype)
    pool["cur"][slots] = first_toks.to(pool["cur"].dtype)
    pool["remaining"][slots] = max_new
    pool["active"][slots] = True


def _decode_burst(params, pool: Dict, *, cfg: VLMConfig, burst: int,
                  eos_id: int, attn_impl: str, mesh=None) -> torch.Tensor:
    """Decode ``burst`` tokens for every slot, updating ``pool`` in place.
    Returns packed [B, burst + 1] int32 on the device: the emitted tokens
    (EOS for inactive or finished rows) and the post-burst active flag in
    the last column, so the host reads what it schedules on in one
    fetch."""
    S = pool["k"].shape[2]
    llm = params["llm"]
    emitted = []
    for _ in range(burst):
        cursors, cur, active = pool["len"], pool["cur"], pool["active"]
        cache = {key: pool[key] for key in _CACHE_KEYS if key in pool}
        cache["mask"] = pool["mask"]
        cache["len"] = torch.clamp(cursors, max=S - 1)
        lg, cache = llm_apply(llm, cfg.llm,
                              embed_tokens(llm, cur[:, None], mesh),
                              positions=cursors[:, None], kv_cache=cache,
                              attn_impl=attn_impl, mesh=mesh)
        nxt = torch.argmax(lg[:, 0].float(), dim=-1).to(cur.dtype)
        emitted.append(torch.where(active, cur, eos_id))
        remaining = torch.where(active, pool["remaining"] - 1,
                                pool["remaining"])
        # per-slot token budget: retire at EOS or when max_new is spent
        active = active & (cur != eos_id) & (remaining > 0)
        # advance only live rows; clamp to stay in bounds
        pool["len"] = torch.where(
            active, torch.clamp(cache["len"], max=S - 1), cursors)
        pool["cur"] = torch.where(active, nxt, cur)
        pool["remaining"] = remaining
        pool["active"] = active
    return torch.cat([torch.stack(emitted, dim=1),
                      pool["active"].to(torch.int32)[:, None]], dim=1)


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt_ids: np.ndarray
    pixel_values: Dict
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None


class ContinuousServingEngine:
    """Slot-pool continuous batching around the shared decoder (greedy).

    ``params`` must lie on ``device``; pixel values (or ``{"patches"}``)
    passed to ``submit`` too. ``quantized_cache`` stores the pool as int8
    rows with fp32 scales (``init_kv_cache(quantized=True)``). ``mesh``:
    ``params`` are this rank's blocks (module docstring).
    """

    def __init__(self, cfg: VLMConfig, params, tokenizer, *,
                 num_slots: int = 8, cache_len: int = 1024, burst: int = 16,
                 attn_impl: str = "auto", quantized_cache: bool = False,
                 device="cuda", mesh=None) -> None:
        self.device = resolve_device(device)
        check_mesh(mesh, self.device)
        embed = params["llm"]["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"weights are on {embed.device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.burst = burst
        self.attn_impl = attn_impl
        self.quantized_cache = quantized_cache
        base = init_kv_cache(cfg.llm, num_slots, cache_len,
                             dtype=embed.dtype, device=self.device,
                             quantized=quantized_cache,
                             split=decoder_split(params["llm"], cfg.llm,
                                                 mesh).t)

        def zeros(dtype):
            return torch.zeros((num_slots,), dtype=dtype, device=self.device)

        self.pool = {**{key: base[key] for key in _CACHE_KEYS if key in base},
                     "mask": base["mask"], "len": zeros(torch.int32),
                     "cur": zeros(torch.int32),
                     "remaining": zeros(torch.int32),
                     "active": zeros(torch.bool)}
        self._ids = itertools.count()
        self.queue: List[_Request] = []
        self.running: Dict[int, _Request] = {}   # slot -> request
        self.finished: Dict[int, List[int]] = {}

    # -- API -------------------------------------------------------------------
    def submit(self, prompt: str, pixel_values: Dict,
               max_new_tokens: int = 512) -> int:
        rid = next(self._ids)
        ids = np.asarray([self.tokenizer.encode(prompt)], np.int64)
        # Reject up front if the fused sequence (patches spliced after BOS
        # plus the prompt) and the decode budget cannot fit in a slot:
        # otherwise the burst would clamp the cursor at cache_len - 1 and
        # overwrite the slot's last KV entry while RoPE positions grow.
        fused = ids.shape[1] + self.cfg.num_patches
        need = fused + max_new_tokens
        if need > self.cache_len:
            raise ValueError(
                f"request needs {need} cache slots ({fused} fused prompt + "
                f"{max_new_tokens} new tokens) but cache_len={self.cache_len}; "
                "shorten the prompt/max_new_tokens or raise cache_len")
        self.queue.append(_Request(rid, ids, pixel_values, max_new_tokens))
        return rid

    @torch.no_grad()
    def _admit(self) -> None:
        free = [s for s in range(self.num_slots) if s not in self.running]
        while free and self.queue:
            # one batched prefill for the queue's equal-length head (a
            # different-length request ends the group)
            lead_len = self.queue[0].prompt_ids.shape[1]
            lead_keys = set(self.queue[0].pixel_values)
            group: List[_Request] = []
            for req in self.queue:
                if (len(group) >= len(free)
                        or req.prompt_ids.shape[1] != lead_len
                        # raw pixels and pre-encoded {"patches"} requests
                        # cannot concatenate into one prefill batch
                        or set(req.pixel_values) != lead_keys):
                    break
                group.append(req)
            del self.queue[:len(group)]
            slots = [free.pop(0) for _ in group]
            ids = torch.from_numpy(np.concatenate(
                [r.prompt_ids for r in group], 0)).to(self.device)
            pixels = {k: torch.cat([r.pixel_values[k] for r in group], dim=0)
                      for k in group[0].pixel_values}
            firsts, tensors, masks, used = _prefill_batch(
                self.params, self.cfg, ids, torch.ones_like(ids, dtype=bool),
                pixels, cache_len=self.cache_len, attn_impl=self.attn_impl,
                quantized_cache=self.quantized_cache, mesh=self.mesh)
            _insert_slots(
                self.pool, torch.tensor(slots, device=self.device), tensors,
                masks, used, firsts,
                torch.tensor([r.max_new_tokens for r in group],
                             dtype=torch.int32, device=self.device))
            for req, slot in zip(group, slots):
                req.slot = slot
                self.running[slot] = req

    @torch.no_grad()
    def step(self) -> List[Tuple[int, List[int]]]:
        """Admit + one decode burst. Returns the newly finished
        (request_id, tokens) pairs."""
        self._admit()
        if not self.running:
            return []
        packed = _decode_burst(self.params, self.pool, cfg=self.cfg,
                               burst=self.burst,
                               eos_id=self.tokenizer.eos_id,
                               attn_impl=self.attn_impl, mesh=self.mesh)
        packed = packed.cpu().numpy()          # one fetch per burst
        emitted, active = packed[:, :-1], packed[:, -1].astype(bool)
        done_now = []
        for slot, req in list(self.running.items()):
            for t in emitted[slot]:
                if int(t) == self.tokenizer.eos_id:
                    break
                req.tokens.append(int(t))
            if not active[slot]:
                self.finished[req.request_id] = req.tokens[:req.max_new_tokens]
                done_now.append((req.request_id,
                                 self.finished[req.request_id]))
                del self.running[slot]
        return done_now

    def run_until_complete(self, max_steps: int = 1000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and not self.running:
                break
        return self.finished

    def decode_text(self, tokens: List[int]) -> str:
        return self.tokenizer.decode(tokens).strip()


def _release_slot(pool: Dict, slot: int) -> Dict:
    """Mark ``slot`` inactive, in place (its cache rows stay as they are;
    the next admission overwrites them). Returns the pool."""
    pool["active"][slot] = False
    return pool
