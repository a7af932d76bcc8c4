"""Paged KV cache for continuous batching, port of
``emmax_tpu/serving/paged.py``.

The slot-pool engine (``serving/continuous.py``) reserves ``cache_len``
slots of KV per request up front. This engine allocates the cache in
fixed-size pages from a shared pool: per-request page tables are int32
index rows, pages are allocated at admission for the prefill and then one
at a time as decode crosses page boundaries, and retired requests return
their pages to the free list.

Layout:
- ``k``/``v``: ``[KV_heads, n_layers * (n_pages + 1), page_size, head_dim]``.
  Layer ``l``'s local page ``p`` is global page ``l * (n_pages + 1) + p``;
  the last page of each layer's range is a trash page that inactive rows
  write to. With ``quantized=True`` the pages are int8 rows with fp32
  absmax scales ``k_scale``/``v_scale`` ``[..., 1]``.
- ``page_table``: ``[num_slots, max_pages]`` int32 (local page id, -1 =
  unused), plus per-slot ``len``/``cur``/``remaining``/``active``.

Decode modes (``paged_attn``):
- ``"burstdense"`` (the default, ``"auto"``): each slot's pages are
  gathered into a contiguous scratch once per burst, the burst decodes
  densely against it, and only the touched pages are written back;
- ``"kernel"``: each step's attention reads the pages in place through the
  hand-written paged-attention kernel (``ops/paged_attention.py``, CUDA
  ``csrc/paged_attention.cu``; its plain version for CPU tensors);
- ``"gather"``: each step gathers the pages and runs the plain attention;
- ``"gather2"``: the same gather, the products taken on the head-major
  ``[KV, B, S, hd]`` view (no transposed copy);
- ``"pagescan"``: a walk over the page-table width with an online softmax,
  one page per slot at a time, so no whole gathered view exists;
- ``"poolmask"``: every row attends to the whole layer pool under a mask of
  the pages its slot owns (``page_owner`` / ``page_pos``, built on the host
  from the running requests and passed to each burst); int8 scales fold
  into the fp32 scores and probabilities. It cannot express shared pages,
  so ``submit_shared`` refuses it, as in JAX. A row that owns no page (an
  empty slot) attends to nothing and gives zeros, where JAX's gives NaN
  that then reaches every row through the trash page.

Any other name raises.

``mesh``: the params are this rank's blocks (``parallel.shard_params``);
the layers run as in ``llama_forward``: split over ``tensor`` where
``parallel.tensor.decoder_split`` says so (each rank's page pool then
holds its ``n_kv_heads / t`` KV heads and the kernel reads those), else
each layer's weights gathered where they are read; the embedding and the
logits are vocab-parallel where those leaves are ``tensor`` blocks.
Every rank runs the same schedule.

The pool is updated in place. Where JAX drops an out-of-bounds scatter
(an admission with no slot, ``submit_shared``'s prefix prefill) the port
skips the write explicitly, and every page id the JAX code clips or routes
to the trash page is clipped or routed the same way here: a torch index of
-1 would read the last page.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from emmax_torch.models.llama import (LlamaConfig, attn_mlp_tail,
                                      embed_tokens, layer_slice, lm_logits,
                                      mm)
from emmax_torch.models.vlm import VLMConfig, fuse_multimodal
from emmax_torch.ops.attention import multi_head_attention
from emmax_torch.ops.norms import rms_norm
from emmax_torch.ops.paged_attention import paged_attention
from emmax_torch.ops.rope import apply_rope, rope_cos_sin
from emmax_torch.parallel.tensor import decoder_split
from emmax_torch.serving.engine import (check_mesh, resolve_device,
                                        resolve_patches)

_MAX_INT8 = 127.5   # the paged-attention kernel's quantization convention
PAGED_ATTN_MODES = ("burstdense", "kernel", "gather", "gather2", "pagescan",
                    "poolmask")


def _row_quantize(x: torch.Tensor):
    """[..., hd] float -> (int8 rows, fp32 absmax scales [..., 1])."""
    scale = x.float().abs().amax(dim=-1, keepdim=True)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    # a tensor numerator: torch computes python-scalar / tensor through a
    # reciprocal, which rounds differently from JAX's division
    factor = torch.full_like(safe, _MAX_INT8) / safe
    # rint(x * 127.5 / absmax) is +-128 at the absmax element. JAX's float
    # -> int8 cast saturates 128 to 127; torch's wraps it to -128, which
    # would flip the sign of every row's largest positive entry. Clamp.
    q = torch.round(x.float() * factor).clamp(-128, 127)
    return q.to(torch.int8), scale


def _row_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale / _MAX_INT8).to(dtype)


def _write_rows(pages: torch.Tensor, rows: torch.Tensor, gids: torch.Tensor,
                offs: torch.Tensor) -> None:
    """In place: ``rows [KV, B, last]`` into ``pages [KV, P, ps, last]`` at
    page ``gids[b]``, offset ``offs[b]``."""
    pages[:, gids, offs] = rows.to(pages.dtype)


def _q_grouped(q: torch.Tensor, kv: int) -> torch.Tensor:
    """[B, 1, H, hd] -> [B, KV, G, hd] (head k*G+g reads KV head k)."""
    B, _, H, hd = q.shape
    return q[:, 0].reshape(B, kv, H // kv, hd)


def _gather2_attention(q, k_pages, v_pages, k_scale, v_scale, table_l,
                       lengths, *, page_size: int):
    """Decode attention over the gathered pages in head-major layout: the
    products read the ``[KV, B, S, hd]`` view as gathered, so no
    ``[B, S, KV, hd]`` transpose is materialized. fp32 scores; the
    probabilities meet V in q's dtype, as in JAX."""
    B, MP = table_l.shape
    kv, _, _, hd = k_pages.shape
    S = MP * page_size
    q2 = _q_grouped(q, kv)                                 # [B, KV, G, hd]
    flat = table_l.reshape(-1).long()
    k_c, v_c = k_pages[:, flat], v_pages[:, flat]
    if k_scale is not None:
        k_c = _row_dequantize(k_c, k_scale[:, flat], q.dtype)
        v_c = _row_dequantize(v_c, v_scale[:, flat], q.dtype)
    k_c = k_c.reshape(kv, B, S, hd)
    v_c = v_c.reshape(kv, B, S, hd).to(q.dtype)
    s = torch.einsum("bkgd,kbsd->bkgs", q2.float(),
                     k_c.float()) * (hd ** -0.5)
    valid = torch.arange(S, device=q.device)[None] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,kbsd->bkgd", w.to(q.dtype), v_c)
    return out.reshape(B, 1, -1, hd)                       # [B, 1, H, hd]


def _pagescan_attention(q, k_pages, v_pages, k_scale, v_scale, table_l,
                        lengths, *, page_size: int):
    """Page walk with an online softmax in fp32: each iteration gathers
    one page per slot (``[KV, B, ps, hd]``), so the whole gathered view of
    ``gather`` / ``gather2`` never exists and each page is read once."""
    B, MP = table_l.shape
    kv, _, _, hd = k_pages.shape
    q2 = _q_grouped(q, kv).float()                         # [B, KV, G, hd]
    G = q2.shape[2]
    scale = hd ** -0.5
    pos = torch.arange(page_size, device=q.device)
    m = torch.full((B, kv, G, 1), float("-inf"), device=q.device)
    den = torch.zeros((B, kv, G, 1), device=q.device)
    num = torch.zeros((B, kv, G, hd), device=q.device)
    for j in range(MP):
        ids = table_l[:, j].long()                         # [B]
        kj, vj = k_pages[:, ids], v_pages[:, ids]          # [KV, B, ps, hd]
        if k_scale is not None:
            kj = _row_dequantize(kj, k_scale[:, ids], torch.float32)
            vj = _row_dequantize(vj, v_scale[:, ids], torch.float32)
        s = torch.einsum("bkgd,kbpd->bkgp", q2, kj.float()) * scale
        valid = (j * page_size + pos)[None] < lengths[:, None]    # [B, ps]
        s = s.masked_fill(~valid[:, None, None], float("-inf"))
        mj = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        c = torch.exp(m - mj)
        sj = torch.exp(s - mj)                             # [B, KV, G, ps]
        den = den * c + sj.sum(dim=-1, keepdim=True)
        num = num * c + torch.einsum("bkgp,kbpd->bkgd", sj, vj.float())
        m = mj
    out = num / torch.clamp(den, min=1e-30)
    return out.reshape(B, 1, -1, hd).to(q.dtype)


def _poolmask_attention(q, k_pages, v_pages, k_scale, v_scale, layer: int,
                        stride: int, page_owner, page_pos, lengths, *,
                        page_size: int):
    """Decode attention over the whole layer pool with an ownership mask,
    no gather: token ``(p, o)`` is visible to row ``b`` iff
    ``page_owner[p] == b`` and ``page_pos[p] * ps + o < len[b]``. int8
    pages enter the products as they are (exact in bf16), their per-row
    scales fold into the fp32 scores and probabilities. Product operands:
    the compute dtype on the card (JAX: bf16 on the TPU), fp32 on the CPU,
    as JAX's CPU path."""
    B = lengths.shape[0]
    kv, _, _, hd = k_pages.shape
    S = stride * page_size
    opd = q.dtype if q.device.type == "cuda" else torch.float32
    q2 = _q_grouped(q, kv).to(opd)                         # [B, KV, G, hd]
    sl = slice(layer * stride, (layer + 1) * stride)
    k_l = k_pages[:, sl].reshape(kv, S, hd).to(opd)
    v_l = v_pages[:, sl].reshape(kv, S, hd).to(opd)
    s = torch.einsum("bkgd,ksd->bkgs", q2, k_l).float() * (hd ** -0.5)
    if k_scale is not None:
        ksf = k_scale[:, sl].reshape(kv, S)                # [KV, S] fp32
        s = s * (ksf / _MAX_INT8)[None, :, None, :]
    dev = q.device
    tok_owner = page_owner.to(dev).repeat_interleave(page_size)       # [S]
    tok_pos = (page_pos.to(dev).repeat_interleave(page_size) * page_size
               + torch.arange(page_size, device=dev).repeat(stride))
    visible = ((tok_owner[None] == torch.arange(B, device=dev)[:, None])
               & (tok_pos[None] < lengths[:, None]))      # [B, S]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    # a row with no visible token (a slot that owns no page) would softmax
    # to NaN, write NaN K/V into the trash page from the next layer on and
    # poison every row through its zero weights there: keep it at zero.
    # JAX's copy has no such guard
    w = torch.softmax(s, dim=-1).masked_fill(
        ~visible.any(dim=-1)[:, None, None, None], 0.0)
    if k_scale is not None:
        vsf = v_scale[:, sl].reshape(kv, S)
        w = w * (vsf / _MAX_INT8)[None, :, None, :]
    out = torch.einsum("bkgs,ksd->bkgd", w.to(opd), v_l).float()
    return out.reshape(B, 1, -1, hd).to(q.dtype)


def init_paged_pool(cfg: VLMConfig, *, n_pages: int, page_size: int,
                    num_slots: int, max_pages_per_slot: int,
                    dtype: torch.dtype = torch.bfloat16,
                    quantized: bool = False, device="cpu",
                    split: int = 1) -> Dict:
    """Page pool with one trash page per layer (local id ``n_pages``):
    inactive rows of the batched decode step write there instead of
    clobbering a live page. ``quantized=True`` stores int8 pages with
    per-row absmax scales (half the page bytes). ``split``: the decoder's
    tensor split; this rank's pages hold KV / split heads."""
    llm = cfg.llm
    shape = (llm.n_kv_heads // split, llm.n_layers * (n_pages + 1),
             page_size, llm.head_dim)

    def zeros(shape_, dt):
        return torch.zeros(shape_, dtype=dt, device=device)

    pool = {"page_table": torch.full((num_slots, max_pages_per_slot), -1,
                                     dtype=torch.int32, device=device),
            "len": zeros((num_slots,), torch.int32),
            "cur": zeros((num_slots,), torch.int32),
            "remaining": zeros((num_slots,), torch.int32),
            "active": zeros((num_slots,), torch.bool)}
    if quantized:
        sshape = shape[:-1] + (1,)
        pool.update(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                    k_scale=torch.ones(sshape, dtype=torch.float32,
                                       device=device),
                    v_scale=torch.ones(sshape, dtype=torch.float32,
                                       device=device))
    else:
        pool.update(k=zeros(shape, dtype), v=zeros(shape, dtype))
    return pool


def _finish(h, llm_params, llm_cfg, mesh=None):
    """Final norm, fp32 logits [B, V] of the last position, greedy ids."""
    h = rms_norm(h[:, -1:], llm_params["final_norm"], llm_cfg.norm_eps)
    logits = lm_logits(h, llm_params["lm_head"], mesh).float()[:, 0]
    return logits, torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def _paged_decode_step(llm_params, llm_cfg, pool: Dict, *, page_size: int,
                     n_pages: int, paged_attn: str = "gather",
                     page_owner: Optional[torch.Tensor] = None,
                     page_pos: Optional[torch.Tensor] = None, mesh=None):
    """One greedy token for every slot, K/V in pages. Writes each row's new
    K/V into its page in place (inactive rows into the trash page) and
    returns (pool, next ids [B] int32, fp32 logits [B, V]); the per-slot
    cursors are left to the caller. ``"poolmask"`` needs the host's
    ``page_owner`` / ``page_pos`` (``[n_pages + 1]`` int32)."""
    B, MP = pool["page_table"].shape
    stride = n_pages + 1
    split = decoder_split(llm_params, llm_cfg, mesh)
    n_heads, kv = split.heads(llm_cfg)
    hd = llm_cfg.head_dim
    t = pool["len"]                                     # [B] cursors
    dev = t.device
    cos, sin = rope_cos_sin(t[:, None], hd, llm_cfg.rope_theta)
    S = MP * page_size
    # JAX's gather clamps an index past the table; clip as it does
    page_of_t = torch.clamp(t // page_size, max=MP - 1).long()
    off_of_t = (t % page_size).long()
    rows = torch.arange(B, device=dev)
    local_table = torch.clamp(pool["page_table"], min=0)      # [B, MP]
    raw_ids = pool["page_table"][rows, page_of_t]             # [B] local
    local_ids = torch.where(pool["active"] & (raw_ids >= 0), raw_ids,
                            n_pages)                          # trash id
    lengths = t + 1                                           # incl. this
    quantized = "k_scale" in pool
    h = embed_tokens(llm_params, pool["cur"][:, None], mesh)  # [B, 1, D]
    for i in range(llm_cfg.n_layers):
        p = split.weights(layer_slice(llm_params["layers"], i))
        x = split.enter(rms_norm(h, p["attn_norm"], llm_cfg.norm_eps))
        k_new = apply_rope(mm(x, p["wk"]).reshape(B, 1, kv, hd), cos, sin)
        v_new = mm(x, p["wv"]).reshape(B, 1, kv, hd)
        gids = (i * stride + local_ids).long()
        k_row = k_new[:, 0].transpose(0, 1)                   # [KV, B, hd]
        v_row = v_new[:, 0].transpose(0, 1)
        if quantized:
            k_row, ks = _row_quantize(k_row)
            v_row, vs = _row_quantize(v_row)
            _write_rows(pool["k_scale"], ks, gids, off_of_t)
            _write_rows(pool["v_scale"], vs, gids, off_of_t)
        _write_rows(pool["k"], k_row, gids, off_of_t)
        _write_rows(pool["v"], v_row, gids, off_of_t)

        q = apply_rope(mm(x, p["wq"]).reshape(B, 1, n_heads, hd), cos, sin)
        table_l = i * stride + local_table                    # [B, MP] global
        if paged_attn == "kernel":
            # no 1/sqrt(hd) in the kernel: pre-scale q in fp32, as JAX
            # does for the upstream kernel. That kernel takes bf16 q beside
            # int8 pages; this one takes fp32 too, so q keeps the compute
            # dtype (the same for a bf16 model).
            qdt = h.dtype if quantized else pool["k"].dtype
            attn = paged_attention(
                (q[:, 0].float() * hd ** -0.5).to(qdt), pool["k"],
                pool["v"], lengths, table_l, k_scale=pool.get("k_scale"),
                v_scale=pool.get("v_scale"))
            attn = attn[:, None].to(h.dtype)                  # [B, 1, H, hd]
        elif paged_attn == "gather":
            flat = table_l.reshape(-1).long()
            k_c, v_c = pool["k"][:, flat], pool["v"][:, flat]
            if quantized:
                k_c = _row_dequantize(k_c, pool["k_scale"][:, flat], h.dtype)
                v_c = _row_dequantize(v_c, pool["v_scale"][:, flat], h.dtype)
            k_c = k_c.reshape(kv, B, S, hd).permute(1, 2, 0, 3)
            v_c = v_c.reshape(kv, B, S, hd).permute(1, 2, 0, 3)
            kv_mask = torch.arange(S, device=dev)[None] < lengths[:, None]
            attn = multi_head_attention(
                q, k_c.to(h.dtype), v_c.to(h.dtype), kv_mask=kv_mask,
                causal=True, q_offset=t, impl="torch")
        elif paged_attn == "gather2":
            attn = _gather2_attention(
                q, pool["k"], pool["v"], pool.get("k_scale"),
                pool.get("v_scale"), table_l, lengths, page_size=page_size)
        elif paged_attn == "pagescan":
            attn = _pagescan_attention(
                q, pool["k"], pool["v"], pool.get("k_scale"),
                pool.get("v_scale"), table_l, lengths, page_size=page_size)
        elif paged_attn == "poolmask":
            attn = _poolmask_attention(
                q, pool["k"], pool["v"], pool.get("k_scale"),
                pool.get("v_scale"), i, stride, page_owner, page_pos,
                lengths, page_size=page_size)
        else:
            raise ValueError(f"unknown per-step paged_attn {paged_attn!r}")
        h = attn_mlp_tail(h, attn.reshape(B, 1, -1), p, llm_cfg.norm_eps,
                          split)
    logits, nxt = _finish(h, llm_params, llm_cfg, mesh)
    return pool, nxt, logits



@torch.no_grad()
def _burstdense_decode_burst(llm_params, llm_cfg, pool: Dict, *,
                             page_size: int, n_pages: int, burst: int,
                             eos_id: int, uniform_write: bool = False,
                             mesh=None):
    """Burst decode against a contiguous per-slot scratch cache.

    Each slot's pages are gathered into a dense ``[KV, L, B, S, hd]``
    scratch once per burst (page tables only change between bursts); the
    steps then run plain attention over the scratch (int8 rows with the
    scales folded into the fp32 scores and probabilities, or the compute
    dtype), write their new rows into it, and at burst end only the
    touched pages (at most 2 per slot per layer, since ``burst <=
    page_size``) are copied back into the pool."""
    B, MP = pool["page_table"].shape
    stride = n_pages + 1
    S = MP * page_size
    L = llm_cfg.n_layers
    split = decoder_split(llm_params, llm_cfg, mesh)
    n_heads, kv = split.heads(llm_cfg)
    hd = llm_cfg.head_dim
    quantized = "k_scale" in pool
    dev = pool["len"].device
    len0 = pool["len"]                                  # [B] at burst start
    active0 = pool["active"]
    local_table = torch.where(pool["page_table"] >= 0, pool["page_table"],
                              n_pages)                  # [B, MP], trash=-1
    ids_all = (torch.arange(L, device=dev)[:, None, None] * stride
               + local_table[None]).reshape(-1).long()  # [L*B*MP]

    def to_scratch(pages):
        return pages[:, ids_all].reshape(kv, L, B, S, *pages.shape[3:])

    kc, vc = to_scratch(pool["k"]), to_scratch(pool["v"])
    if quantized:
        ksc = to_scratch(pool["k_scale"])[..., 0]       # [KV, L, B, S]
        vsc = to_scratch(pool["v_scale"])[..., 0]
    compute = llm_params["embed"].dtype
    # product operands: the compute dtype on the card (the JAX package
    # uses bf16 on the TPU); fp32 on the CPU, as JAX's CPU path
    opd = compute if dev.type == "cuda" else torch.float32
    pos = torch.arange(S, device=dev)[None]             # [1, S]
    rows = torch.arange(B, device=dev)
    active, cur, t, remaining = (active0, pool["cur"], len0,
                                 pool["remaining"])
    emitted = []
    for it in range(burst):
        cos, sin = rope_cos_sin(t[:, None], hd, llm_cfg.rope_theta)
        t_w = torch.clamp(t, max=S - 1).long()          # clamped write slot
        # uniform fast path: every slot entered the burst at the same
        # length (the host checks its mirrors), so every row writes at
        # len0[0] + it. Rows that went inactive mid-burst froze `t`, so
        # their junk row lands past their length, where it is masked and
        # tolerated by the writeback.
        slot = (torch.clamp(len0[0] + it, max=S - 1).long()
                if uniform_write else t_w)
        lengths = t + 1
        h = embed_tokens(llm_params, cur[:, None], mesh)    # [B, 1, D]
        for i in range(L):
            p = split.weights(layer_slice(llm_params["layers"], i))
            x = split.enter(rms_norm(h, p["attn_norm"], llm_cfg.norm_eps))
            k_new = apply_rope(mm(x, p["wk"]).reshape(B, 1, kv, hd), cos,
                               sin)
            v_new = mm(x, p["wv"]).reshape(B, 1, kv, hd)
            k_row = k_new[:, 0].transpose(0, 1)         # [KV, B, hd]
            v_row = v_new[:, 0].transpose(0, 1)
            k_l, v_l = kc[:, i], vc[:, i]               # [KV, B, S, hd]
            if quantized:
                k_row, ks_row = _row_quantize(k_row)
                v_row, vs_row = _row_quantize(v_row)
                ksc[:, i, rows, slot] = ks_row[..., 0]
                vsc[:, i, rows, slot] = vs_row[..., 0]
            k_l[:, rows, slot] = k_row.to(k_l.dtype)
            v_l[:, rows, slot] = v_row.to(v_l.dtype)

            q = apply_rope(mm(x, p["wq"]).reshape(B, 1, n_heads, hd), cos,
                           sin)
            q2 = _q_grouped(q, kv).to(opd)              # [B, KV, G, hd]
            s = torch.einsum("bkgd,kbsd->bkgs", q2,
                             k_l.to(opd)).float() * (hd ** -0.5)
            if quantized:
                s = s * (ksc[:, i].transpose(0, 1)[:, :, None]
                         / _MAX_INT8)                   # [B, KV, 1, S]
            s = s.masked_fill(~(pos < lengths[:, None])[:, None, None],
                              float("-inf"))
            w = torch.softmax(s, dim=-1)
            if quantized:
                w = w * (vsc[:, i].transpose(0, 1)[:, :, None] / _MAX_INT8)
            attn = torch.einsum("bkgs,kbsd->bkgd", w.to(opd), v_l.to(opd))
            h = attn_mlp_tail(h, attn.reshape(B, 1, -1).to(h.dtype), p,
                              llm_cfg.norm_eps, split)
        _, nxt = _finish(h, llm_params, llm_cfg, mesh)
        emitted.append(torch.where(active, cur, eos_id))
        remaining = torch.where(active, remaining - 1, remaining)
        nxt_active = active & (cur != eos_id) & (remaining > 0)
        cur = torch.where(nxt_active, nxt, cur)
        t = torch.where(nxt_active, t + 1, t)
        active = nxt_active

    # Write back only the touched pages (burst <= page_size: at most 2 per
    # slot per layer), whole pages: untouched rows equal the pool's, rows
    # past `len` are junk on both sides (masked). The gate matters: a slot
    # inactive at burst start writes to the trash page. A finished slot
    # keeps its stale page-table row (the host only returns its page ids
    # to the free list), so once a freed page is reassigned, an ungated
    # stale writeback would clobber the new owner's KV every burst.
    n_touch = burst // page_size + 2
    l_idx, b_idx, j_idx = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(L, device=dev), rows,
        torch.arange(n_touch, device=dev), indexing="ij"))
    pi = torch.clamp(len0.long()[b_idx] // page_size + j_idx, max=MP - 1)
    local = torch.where(active0[b_idx], local_table[b_idx, pi], n_pages)
    dst = (l_idx * stride + local).long()

    def writeback(pool_arr, scratch):
        pages = scratch.reshape(kv, L, B, MP, page_size, *pool_arr.shape[3:])
        pool_arr[:, dst] = pages[:, l_idx, b_idx, pi].to(pool_arr.dtype)

    writeback(pool["k"], kc)
    writeback(pool["v"], vc)
    if quantized:
        writeback(pool["k_scale"], ksc[..., None])
        writeback(pool["v_scale"], vsc[..., None])
    pool.update(len=t, cur=cur, remaining=remaining, active=active)
    status = torch.stack([active.to(torch.int32), t, remaining], dim=1)
    return pool, torch.cat([torch.stack(emitted, dim=1), status], dim=1)


@torch.no_grad()
def _paged_decode_burst(llm_params, llm_cfg, pool: Dict, *, page_size: int,
                        n_pages: int, burst: int, eos_id: int,
                        paged_attn: str = "gather",
                        page_owner: Optional[torch.Tensor] = None,
                        page_pos: Optional[torch.Tensor] = None,
                        uniform_write: bool = False, mesh=None):
    """``burst`` greedy tokens for every active slot. The caller must have
    allocated pages covering ``len + burst`` for every active slot.
    Returns (pool, packed [B, burst + 3] int32): the emitted tokens (EOS
    for inactive rows), then the post-burst [active, len, remaining]
    columns: what the host scheduler needs, in one fetch."""
    if paged_attn == "burstdense":
        assert burst <= page_size, \
            "burstdense writeback assumes burst <= page_size"
        return _burstdense_decode_burst(llm_params, llm_cfg, pool,
                                        page_size=page_size,
                                        n_pages=n_pages, burst=burst,
                                        eos_id=eos_id,
                                        uniform_write=uniform_write,
                                        mesh=mesh)
    emitted = []
    for _ in range(burst):
        active, cur = pool["active"], pool["cur"]
        pool, nxt, _ = _paged_decode_step(llm_params, llm_cfg, pool,
                                         page_size=page_size,
                                         n_pages=n_pages,
                                         paged_attn=paged_attn,
                                         page_owner=page_owner,
                                         page_pos=page_pos, mesh=mesh)
        emitted.append(torch.where(active, cur, eos_id))
        remaining = torch.where(active, pool["remaining"] - 1,
                                pool["remaining"])
        nxt_active = active & (cur != eos_id) & (remaining > 0)
        pool.update(len=torch.where(nxt_active, pool["len"] + 1,
                                    pool["len"]),
                    cur=torch.where(nxt_active, nxt, cur),
                    remaining=remaining, active=nxt_active)
    status = torch.stack([pool["active"].to(torch.int32), pool["len"],
                          pool["remaining"]], dim=1)
    return pool, torch.cat([torch.stack(emitted, dim=1), status], dim=1)


def _set_slots(pool: Dict, slots: Sequence[int], table_rows: torch.Tensor,
               lens: int, first: torch.Tensor, max_new: Sequence[int]) -> None:
    """Admission metadata for ``slots``, in place. A slot id past the pool
    (``submit_shared``'s prefix prefill passes one) is skipped, as XLA
    drops the out-of-bounds scatter update; the arrays never grow."""
    num_slots = pool["page_table"].shape[0]
    keep = [g for g, s in enumerate(slots) if 0 <= s < num_slots]
    if not keep:
        return
    dev = pool["len"].device
    idx = torch.tensor([slots[g] for g in keep], device=dev)
    sel = torch.tensor(keep, device=dev)
    pool["page_table"][idx] = table_rows[sel]
    pool["len"][idx] = lens
    pool["cur"][idx] = first[sel].to(torch.int32)
    pool["remaining"][idx] = torch.tensor(
        [int(max_new[g]) for g in keep], dtype=torch.int32, device=dev)
    pool["active"][idx] = True


def _write_pages(pages: torch.Tensor, src: torch.Tensor, start: int,
                 ids: torch.Tensor, contiguous: bool) -> None:
    """In place: ``src [n, KV, ps, last]`` into global pages ``start +
    ids``. The contiguous fast path (ids are consecutive, the common case
    after a cold start) is one slice copy instead of an index write."""
    val = src.transpose(0, 1).to(pages.dtype)           # [KV, n, ps, last]
    if contiguous:
        first = start + int(ids[0])
        pages[:, first:first + val.shape[1]] = val
    else:
        pages[:, start + ids.to(pages.device).long()] = val


@torch.no_grad()
def _prefill_into_pool(params, cfg: VLMConfig, pool: Dict,
                       input_ids: torch.Tensor, pixel_values: Dict,
                       page_ids: torch.Tensor, slots: Sequence[int],
                       max_new: Sequence[int], *, page_size: int,
                       n_pages: int, attn_impl: str = "auto",
                       contiguous: bool = False, mesh=None) -> Dict:
    """Multimodal prefill of G equal-length prompts written directly into
    each slot's pages (``page_ids`` [G, n0] local ids, a host tensor).

    Each layer's K/V rows go straight into the page pool inside the layer
    loop; attention runs on the in-flight K/V (plain causal), and the
    lm_head runs on the last position only. Only equal fused lengths batch
    (the mask stays all ones), so the whole K/V, padded to the page
    boundary, is live."""
    llm_cfg = cfg.llm
    stride = n_pages + 1
    G, n0 = page_ids.shape
    quantized = "k_scale" in pool
    llm = params["llm"]
    patch_embeds = resolve_patches(params, cfg, pixel_values, attn_impl,
                                   mesh)
    mask = torch.ones(input_ids.shape, dtype=torch.bool,
                      device=input_ids.device)
    embeds, fmask, _, positions = fuse_multimodal(
        patch_embeds, embed_tokens(llm, input_ids, mesh), mask)
    B, S, _ = embeds.shape
    cos, sin = rope_cos_sin(positions, llm_cfg.head_dim, llm_cfg.rope_theta)
    split = decoder_split(llm, llm_cfg, mesh)
    n_heads, kv = split.heads(llm_cfg)
    hd = llm_cfg.head_dim
    pad = n0 * page_size - S
    gid_local = page_ids.reshape(-1)                    # [G*n0]

    def to_pages(rows):                 # [G, S, KV, hd] -> [G*n0, KV, ps, hd]
        rows = F.pad(rows, (0, 0, 0, 0, 0, pad))
        rows = rows.reshape(G, n0, page_size, kv, hd)
        return rows.permute(0, 1, 3, 2, 4).reshape(G * n0, kv, page_size, hd)

    h = embeds
    for i in range(llm_cfg.n_layers):
        p = split.weights(layer_slice(llm["layers"], i))
        x = split.enter(rms_norm(h, p["attn_norm"], llm_cfg.norm_eps))
        q = apply_rope(mm(x, p["wq"]).reshape(B, S, n_heads, hd), cos, sin)
        k = apply_rope(mm(x, p["wk"]).reshape(B, S, kv, hd), cos, sin)
        v = mm(x, p["wv"]).reshape(B, S, kv, hd)
        k_pg, v_pg = to_pages(k), to_pages(v)
        if quantized:
            k_pg, k_s = _row_quantize(k_pg)
            v_pg, v_s = _row_quantize(v_pg)
            _write_pages(pool["k_scale"], k_s, i * stride, gid_local,
                         contiguous)
            _write_pages(pool["v_scale"], v_s, i * stride, gid_local,
                         contiguous)
        _write_pages(pool["k"], k_pg, i * stride, gid_local, contiguous)
        _write_pages(pool["v"], v_pg, i * stride, gid_local, contiguous)
        attn = multi_head_attention(q, k, v, kv_mask=fmask, causal=True,
                                    impl=attn_impl)
        h = attn_mlp_tail(h, attn.reshape(B, S, -1), p, llm_cfg.norm_eps,
                          split)
    _, first = _finish(h, llm, llm_cfg, mesh)
    table_rows = torch.full((G, pool["page_table"].shape[1]), -1,
                            dtype=torch.int32)
    table_rows[:, :n0] = page_ids
    _set_slots(pool, slots, table_rows.to(pool["len"].device), S, first,
               max_new)
    return pool


def _append_page(pool: Dict, slot: int, table_idx: int,
                 page_id: int) -> Dict:
    pool["page_table"][slot, table_idx] = page_id
    return pool


@torch.no_grad()
def _prefill_tail_into_pool(llm_params, llm_cfg, pool: Dict,
                            tail_ids: torch.Tensor,
                            prefix_table: torch.Tensor,
                            own_ids: torch.Tensor, slots: Sequence[int],
                            max_new: Sequence[int],
                            table_rows: torch.Tensor, *, prefix_len: int,
                            page_size: int, n_pages: int,
                            contiguous: bool = False, mesh=None) -> Dict:
    """Admit a group of requests whose first ``prefix_len`` fused positions
    (BOS + patch block) already live in the same shared pages
    (``prefix_table``, local ids): only the equal-length prompt tails
    (``tail_ids`` [G, T]) run through the decoder, batched into one
    forward. Each request's tail K/V rows (plus the shared boundary page's
    prefix rows, when ``prefix_len`` is not page-aligned) are written into
    its own pages (``own_ids`` [G, n_own], a host tensor); the shared full
    pages are referenced by ``table_rows`` [G, MP] and never written."""
    stride = n_pages + 1
    G, T = tail_ids.shape
    split = decoder_split(llm_params, llm_cfg, mesh)
    n_heads, kv = split.heads(llm_cfg)
    hd = llm_cfg.head_dim
    quantized = "k_scale" in pool
    dev = tail_ids.device
    n_pre = prefix_table.shape[0]
    n_own = own_ids.shape[1]
    Sp = n_pre * page_size
    p0 = prefix_len // page_size                       # full shared pages
    own_start = p0 * page_size
    pad = own_start + n_own * page_size - (prefix_len + T)
    h = embed_tokens(llm_params, tail_ids, mesh)       # [G, T, D]
    positions = prefix_len + torch.arange(T, dtype=torch.int32,
                                          device=dev)[None]
    cos, sin = rope_cos_sin(positions, hd, llm_cfg.rope_theta)  # [1, T, hd]
    pre_valid = torch.arange(Sp, device=dev) < prefix_len       # [Sp]
    kv_mask = torch.cat([pre_valid, torch.ones(T, dtype=torch.bool,
                                               device=dev)])[None].expand(
        G, Sp + T)
    own_flat = own_ids.reshape(-1)
    pre_ids = prefix_table.to(dev).long()

    def gather_prefix(i):
        gids = i * stride + pre_ids
        k_p, v_p = pool["k"][:, gids], pool["v"][:, gids]  # [KV, n_pre, ps, hd]
        if quantized:
            k_p = _row_dequantize(k_p, pool["k_scale"][:, gids], h.dtype)
            v_p = _row_dequantize(v_p, pool["v_scale"][:, gids], h.dtype)
        return (k_p.reshape(kv, Sp, hd).transpose(0, 1)[None],
                v_p.reshape(kv, Sp, hd).transpose(0, 1)[None])  # [1, Sp, KV, hd]

    def write_own(pages, rows, i):
        # rows [G, own span, KV, w]: each request's own region (boundary
        # prefix rows + tail + junk pad), cut into pages
        rows = rows.reshape(G * n_own, page_size, kv, -1).transpose(1, 2)
        _write_pages(pages, rows, i * stride, own_flat, contiguous)

    for i in range(llm_cfg.n_layers):
        p = split.weights(layer_slice(llm_params["layers"], i))
        x = split.enter(rms_norm(h, p["attn_norm"], llm_cfg.norm_eps))
        q = apply_rope(mm(x, p["wq"]).reshape(G, T, n_heads, hd), cos, sin)
        k_t = apply_rope(mm(x, p["wk"]).reshape(G, T, kv, hd), cos, sin)
        v_t = mm(x, p["wv"]).reshape(G, T, kv, hd)
        k_pre, v_pre = gather_prefix(i)
        k_cat = torch.cat([k_pre.expand(G, -1, -1, -1).to(k_t.dtype), k_t],
                          dim=1)
        v_cat = torch.cat([v_pre.expand(G, -1, -1, -1).to(v_t.dtype), v_t],
                          dim=1)
        # the JAX package's call takes its default attention, the plain one
        attn = multi_head_attention(q, k_cat, v_cat, kv_mask=kv_mask,
                                    causal=True, q_offset=Sp, impl="torch")
        h = attn_mlp_tail(h, attn.reshape(G, T, -1), p, llm_cfg.norm_eps,
                          split)
        # own region = prefix rows past the last full shared page + tail
        full_k = torch.cat([k_pre[:, own_start:prefix_len].expand(
            G, -1, -1, -1).to(k_t.dtype), k_t], dim=1)
        full_v = torch.cat([v_pre[:, own_start:prefix_len].expand(
            G, -1, -1, -1).to(v_t.dtype), v_t], dim=1)
        full_k = F.pad(full_k, (0, 0, 0, 0, 0, pad))
        full_v = F.pad(full_v, (0, 0, 0, 0, 0, pad))
        if quantized:
            qk, sk = _row_quantize(full_k)
            qv, sv = _row_quantize(full_v)
            write_own(pool["k_scale"], sk, i)
            write_own(pool["v_scale"], sv, i)
            write_own(pool["k"], qk, i)
            write_own(pool["v"], qv, i)
        else:
            write_own(pool["k"], full_k, i)
            write_own(pool["v"], full_v, i)
    _, first = _finish(h, llm_params, llm_cfg, mesh)
    _set_slots(pool, slots, table_rows.to(pool["len"].device),
               prefix_len + T, first, max_new)
    return pool


@dataclasses.dataclass
class _Request:
    request_id: int
    prompt_ids: np.ndarray
    pixel_values: Dict
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    n_pages: int = 0
    # host mirror of this slot's own page-table entries (pages are assigned
    # by the host, so the table never needs a device read-back); shared
    # prefix pages are tracked per group in the engine's _shared_refs
    page_ids: List[int] = dataclasses.field(default_factory=list)
    tail_ids: Optional[np.ndarray] = None    # set => shared-prefix request
    shared_key: Optional[int] = None


class PagedServingEngine:
    """Continuous batching over a shared page pool (greedy, Llama family).

    ``paged_attn``: "burstdense" (per-burst page gather + dense decode),
    "kernel" (the hand-written paged-attention kernel on the card, its
    plain version on the CPU), "gather" / "gather2" / "pagescan" /
    "poolmask" (per-step plain variants, see the module docstring) or
    "auto" (= "burstdense", the JAX package's default).
    ``params`` must lie on ``device``, and so must the pixel values (or
    ``{"patches"}``) passed to ``submit``. ``mesh``: ``params`` are this
    rank's blocks (module docstring).
    """

    def __init__(self, cfg: VLMConfig, params, tokenizer, *,
                 num_slots: int = 8, n_pages: int = 64, page_size: int = 64,
                 max_pages_per_slot: int = 16, attn_impl: str = "auto",
                 burst: int = 8, paged_attn: str = "auto",
                 quantized_cache: bool = False,
                 uniform_burst_writes: bool = True, device="cuda",
                 mesh=None) -> None:
        self.device = resolve_device(device)
        check_mesh(mesh, self.device)
        if not isinstance(cfg.llm, LlamaConfig):
            raise TypeError(f"the paged engine runs the Llama family only, "
                            f"as in the JAX package; got {type(cfg.llm)}")
        embed = params["llm"]["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"weights are on {embed.device}, the engine on "
                             f"{self.device}")
        if paged_attn == "auto":
            paged_attn = "burstdense"
        if paged_attn not in PAGED_ATTN_MODES:
            raise ValueError(f"unknown paged_attn {paged_attn!r}; expected "
                             f"one of {PAGED_ATTN_MODES} or 'auto'")
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.tokenizer = tokenizer
        self.num_slots = num_slots
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages_per_slot = max_pages_per_slot
        self.attn_impl = attn_impl
        self.burst = burst
        self.paged_attn = paged_attn
        # burstdense: when every slot enters a burst at the same length
        # (host-checked), the new rows are written with one index per
        # buffer per layer for the whole batch
        self.uniform_burst_writes = uniform_burst_writes
        self.pool = init_paged_pool(
            cfg, n_pages=n_pages, page_size=page_size, num_slots=num_slots,
            max_pages_per_slot=max_pages_per_slot, dtype=embed.dtype,
            quantized=quantized_cache, device=self.device,
            split=decoder_split(params["llm"], cfg.llm, mesh).t)
        self.free_pages: List[int] = list(range(n_pages))
        # host mirrors of the per-slot scheduler state; refreshed from the
        # burst's packed status (one fetch) and set directly at admission
        self._len = np.zeros((num_slots,), np.int64)
        self._remaining = np.zeros((num_slots,), np.int64)
        self._ids = itertools.count()
        self._shared_keys = itertools.count()
        # shared-prefix groups: key -> {"ids": [page ids], "count": live refs}
        self._shared_refs: Dict[int, Dict] = {}
        self.queue: List[_Request] = []
        self.running: Dict[int, _Request] = {}
        self.finished: Dict[int, List[int]] = {}

    # -- API --------------------------------------------------------------
    def _encode(self, prompt: str) -> np.ndarray:
        return np.asarray([self.tokenizer.encode(prompt)], np.int64)

    def submit(self, prompt: str, pixel_values: Dict,
               max_new_tokens: int = 512) -> int:
        rid = next(self._ids)
        ids = self._encode(prompt)
        fused = ids.shape[1] + self.cfg.num_patches
        need_pages = -(-(fused + max_new_tokens) // self.page_size)
        if need_pages > self.max_pages_per_slot:
            raise ValueError(
                f"request needs {need_pages} pages (> max_pages_per_slot="
                f"{self.max_pages_per_slot}); raise it or shorten the "
                "prompt/max_new_tokens")
        if need_pages > self.n_pages:
            raise ValueError(
                f"request needs {need_pages} pages but the pool only holds "
                f"{self.n_pages}: it could never be admitted")
        self.queue.append(_Request(rid, ids, pixel_values, max_new_tokens))
        return rid

    def submit_shared(self, prompts: List[str], pixel_values: Dict,
                      max_new_tokens: int = 512) -> List[int]:
        """Admit N queries over one frame with a shared prefix: the BOS +
        patch block (``1 + num_patches`` fused positions) is prefilled once
        into refcounted shared pages; each request then prefills only its
        prompt tail (``_prefill_tail_into_pool``), and the shared full
        pages are held once."""
        if self.paged_attn == "poolmask":
            raise ValueError("poolmask's single-owner page mask cannot "
                             "express shared pages; use burstdense/gather")
        if not prompts:
            raise ValueError("submit_shared needs at least one prompt")
        ps = self.page_size
        prefix_len = 1 + self.cfg.num_patches
        n_pre = -(-prefix_len // ps)
        p0 = prefix_len // ps                  # full (table-referenced) pages
        enc = [self._encode(p) for p in prompts]
        for ids in enc:
            if ids.shape[1] < 2:
                raise ValueError("shared-prefix prompts need at least one "
                                 "token after BOS (the tail prefill cannot "
                                 "run on an empty tail)")
            fused = ids.shape[1] + self.cfg.num_patches
            n_own = -(-(fused + max_new_tokens) // ps) - p0
            if p0 + n_own > self.max_pages_per_slot:
                raise ValueError(
                    f"request needs {p0 + n_own} page-table entries "
                    f"(> max_pages_per_slot={self.max_pages_per_slot})")
        if len(self.free_pages) < n_pre:
            raise RuntimeError("no free pages for the shared prefix")
        shared = [self.free_pages.pop(0) for _ in range(n_pre)]
        contig = shared == list(range(shared[0], shared[0] + n_pre))
        # slot num_slots is past the pool: the prefix K/V lands in the
        # pages and no slot's metadata is written
        _prefill_into_pool(
            self.params, self.cfg, self.pool,
            torch.from_numpy(enc[0][:, :1]).to(self.device), pixel_values,
            torch.tensor([shared], dtype=torch.int32), [self.num_slots], [0],
            page_size=ps, n_pages=self.n_pages, attn_impl=self.attn_impl,
            contiguous=contig, mesh=self.mesh)
        key = next(self._shared_keys)
        self._shared_refs[key] = {"ids": shared, "count": len(prompts)}
        rids = []
        for ids in enc:
            rid = next(self._ids)
            self.queue.append(_Request(rid, ids, pixel_values,
                                       max_new_tokens, tail_ids=ids[:, 1:],
                                       shared_key=key))
            rids.append(rid)
        return rids

    def _pages_needed(self, req: _Request) -> int:
        fused = req.prompt_ids.shape[1] + self.cfg.num_patches
        return -(-fused // self.page_size)

    def _own_pages(self, req: _Request, p0: int) -> int:
        fused = req.prompt_ids.shape[1] + self.cfg.num_patches
        return -(-(fused + req.max_new_tokens) // self.page_size) - p0

    def _admit_shared_tails(self, reqs: List[_Request],
                            slots: List[int]) -> None:
        """One batched tail prefill for a group of same-prefix, equal-shape
        requests (same shared_key, tail length and own-page count)."""
        ps = self.page_size
        prefix_len = 1 + self.cfg.num_patches
        p0 = prefix_len // ps
        G = len(reqs)
        fused = reqs[0].prompt_ids.shape[1] + self.cfg.num_patches
        n_own = self._own_pages(reqs[0], p0)
        shared = self._shared_refs[reqs[0].shared_key]["ids"]
        own = np.asarray([[self.free_pages.pop(0) for _ in range(n_own)]
                          for _ in range(G)], np.int32)
        own_flat = own.reshape(-1)
        contig = bool(np.all(own_flat == own_flat[0] + np.arange(G * n_own)))
        table_rows = np.full((G, self.max_pages_per_slot), -1, np.int32)
        table_rows[:, :p0] = shared[:p0]
        table_rows[:, p0:p0 + n_own] = own
        _prefill_tail_into_pool(
            self.params["llm"], self.cfg.llm, self.pool,
            torch.from_numpy(np.concatenate([r.tail_ids for r in reqs],
                                            0)).to(self.device),
            torch.tensor(shared, dtype=torch.int32), torch.from_numpy(own),
            slots, [r.max_new_tokens for r in reqs],
            torch.from_numpy(table_rows), prefix_len=prefix_len,
            page_size=ps, n_pages=self.n_pages, contiguous=contig,
            mesh=self.mesh)
        for g, (req, slot) in enumerate(zip(reqs, slots)):
            req.slot = slot
            req.n_pages = p0 + n_own
            req.page_ids = [int(p) for p in own[g]]
            self._len[slot] = fused
            self._remaining[slot] = req.max_new_tokens
            self.running[slot] = req

    def _admit(self) -> None:
        free_slots = [s for s in range(self.num_slots)
                      if s not in self.running]
        while free_slots and self.queue:
            if self.queue[0].tail_ids is not None:
                # shared-prefix requests: batch same-key, equal-shape tails
                # at the queue front into one tail prefill
                lead = self.queue[0]
                p0 = (1 + self.cfg.num_patches) // self.page_size
                n_own = self._own_pages(lead, p0)
                group: List[_Request] = []
                pages_taken = 0
                for req in self.queue:
                    if (len(group) >= len(free_slots)
                            or req.tail_ids is None
                            or req.shared_key != lead.shared_key
                            or req.tail_ids.shape[1]
                            != lead.tail_ids.shape[1]
                            or self._own_pages(req, p0) != n_own
                            or (len(self.free_pages) - pages_taken
                                < n_own + 1)):
                        break                    # admission waits for pages
                    group.append(req)
                    pages_taken += n_own
                if not group:
                    break
                del self.queue[:len(group)]
                slots = [free_slots.pop(0) for _ in group]
                self._admit_shared_tails(group, slots)
                continue
            # group the front of the queue: equal prompt lengths batch into
            # one prefill (all-ones mask); a different-length (or
            # shared-prefix) head request ends the group
            lead_len = self.queue[0].prompt_ids.shape[1]
            lead_keys = set(self.queue[0].pixel_values)
            n0 = self._pages_needed(self.queue[0])
            group = []
            pages_taken = 0
            for req in self.queue:
                if (len(group) >= len(free_slots)
                        or req.tail_ids is not None
                        or req.prompt_ids.shape[1] != lead_len
                        # raw pixels and pre-encoded {"patches"} requests
                        # cannot concatenate into one prefill batch
                        or set(req.pixel_values) != lead_keys
                        or len(self.free_pages) - pages_taken < n0 + 1):
                    break                        # admission waits for pages
                group.append(req)
                pages_taken += n0
            if not group:
                break
            del self.queue[:len(group)]
            G = len(group)
            slots = [free_slots.pop(0) for _ in range(G)]
            page_ids = np.asarray(
                [[self.free_pages.pop(0) for _ in range(n0)]
                 for _ in range(G)], np.int32)
            prompt_ids = np.concatenate([r.prompt_ids for r in group], 0)
            pixels = {k: torch.cat([r.pixel_values[k] for r in group], dim=0)
                      for k in group[0].pixel_values}
            flat = page_ids.reshape(-1)
            contig = bool((flat == flat[0] + np.arange(flat.size)).all())
            _prefill_into_pool(
                self.params, self.cfg, self.pool,
                torch.from_numpy(prompt_ids).to(self.device), pixels,
                torch.from_numpy(page_ids), slots,
                [r.max_new_tokens for r in group], page_size=self.page_size,
                n_pages=self.n_pages, attn_impl=self.attn_impl,
                contiguous=contig, mesh=self.mesh)
            fused = lead_len + self.cfg.num_patches
            for g, (req, slot) in enumerate(zip(group, slots)):
                req.slot = slot
                req.n_pages = n0
                req.page_ids = [int(p) for p in page_ids[g]]
                # the fused prompt length is host-known: prompt length +
                # num_patches (all-ones mask)
                self._len[slot] = fused
                self._remaining[slot] = req.max_new_tokens
                self.running[slot] = req

    def _ensure_pages(self) -> bool:
        """Grow page tables so every running slot can write its next burst
        (capped at its remaining token budget: a nearly finished slot must
        not demand pages it will never write). Works off the host mirrors
        alone. Returns False only if the pool is exhausted."""
        for slot, req in self.running.items():
            headroom = max(1, min(self.burst, int(self._remaining[slot])))
            needed = (int(self._len[slot]) + headroom - 1) \
                // self.page_size + 1
            needed = min(needed, self.max_pages_per_slot)
            while req.n_pages < needed:
                if not self.free_pages:
                    return False
                page = self.free_pages.pop(0)
                _append_page(self.pool, slot, req.n_pages, page)
                req.n_pages += 1
                req.page_ids.append(page)
        return True

    def _ownership(self) -> Dict[str, torch.Tensor]:
        """poolmask's page ownership for the next burst, from the running
        requests (empty in the other modes): ``page_owner [n_pages + 1]``
        (slot id, -1 = free; index n_pages is the trash page) and
        ``page_pos`` (each page's rank in its slot's table)."""
        if self.paged_attn != "poolmask":
            return {}
        owner = np.full((self.n_pages + 1,), -1, np.int32)
        pos = np.zeros((self.n_pages + 1,), np.int32)
        for slot, req in self.running.items():
            own = len(req.page_ids)          # a shared prefix comes first
            owner[req.page_ids] = slot
            pos[req.page_ids] = req.n_pages - own + np.arange(own)
        return {"page_owner": torch.from_numpy(owner).to(self.device),
                "page_pos": torch.from_numpy(pos).to(self.device)}

    def warmup(self) -> List[bool]:
        """Build the hand-written kernels a card engine launches, so no
        request pays the build (eager PyTorch compiles nothing per burst
        variant, which is what the JAX package's ``warmup`` does). Returns
        the decode-burst variants the engine can run: burstdense with
        ``uniform_burst_writes`` has the uniform-write fast path and the
        per-row fallback taken once lengths diverge; the rest one."""
        if self.device.type == "cuda":
            from emmax_torch.ops import flash_attention, int4_matmul
            from emmax_torch.ops import paged_attention as pa
            from emmax_torch.ops.cuda_build import build_all

            build_all([flash_attention.KERNEL, int4_matmul.KERNEL,
                       pa.KERNEL])
        if self.uniform_burst_writes and self.paged_attn == "burstdense":
            return [True, False]
        return [False]

    @torch.no_grad()
    def step(self) -> List[Tuple[int, List[int]]]:
        """Admit + one ``burst``-token decode (one host fetch per burst)."""
        self._admit()
        if not self.running:
            return []
        if not self._ensure_pages():
            raise RuntimeError("page pool exhausted mid-decode; add pages "
                               "or lower num_slots")
        # the uniform-write fast path is safe only when the write base
        # (slot 0's length) is live and equal across every slot: every
        # slot running at the same length
        uniform = (self.uniform_burst_writes
                   and self.paged_attn == "burstdense"
                   and len(self.running) == self.num_slots
                   and bool(np.all(self._len == self._len[0])))
        self.pool, packed = _paged_decode_burst(
            self.params["llm"], self.cfg.llm, self.pool,
            page_size=self.page_size, n_pages=self.n_pages, burst=self.burst,
            eos_id=self.tokenizer.eos_id, paged_attn=self.paged_attn,
            uniform_write=uniform, mesh=self.mesh, **self._ownership())
        packed = packed.cpu().numpy()          # one fetch per burst
        emitted = packed[:, :self.burst]
        active_after = packed[:, self.burst].astype(bool)
        self._len = packed[:, self.burst + 1].astype(np.int64)
        self._remaining = packed[:, self.burst + 2].astype(np.int64)
        done_now = []
        for slot, req in list(self.running.items()):
            for tok in emitted[slot]:
                if int(tok) == self.tokenizer.eos_id:
                    break
                req.tokens.append(int(tok))
            if not active_after[slot]:
                self.finished[req.request_id] = req.tokens[:req.max_new_tokens]
                done_now.append((req.request_id,
                                 self.finished[req.request_id]))
                self.free_pages.extend(req.page_ids)
                req.page_ids = []
                if req.shared_key is not None:
                    rec = self._shared_refs[req.shared_key]
                    rec["count"] -= 1
                    if rec["count"] == 0:       # last group member retired
                        self.free_pages.extend(rec["ids"])
                        del self._shared_refs[req.shared_key]
                del self.running[slot]
        return done_now

    def run_until_complete(self, max_steps: int = 2000
                           ) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and not self.running:
                break
        return self.finished

    def decode_text(self, tokens: List[int]) -> str:
        return self.tokenizer.decode(tokens).strip()
