#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``emmax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (one card)
    python3 chip_smoke.py --kernels-only   # build + kernel checks only

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. build the four hand-written kernel sources from ``emmax_torch/csrc``
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes: flash-attention forward for DINOv2, SigLIP and the Llama
   prefill (left-padded, into the whole cache); int4 matmul at M = 1 and
   M = prefill length for every Llama-2-7B weight shape, through the
   stacked view. Each in the dtype the main path gives it (the towers
   run in fp32, as in JAX; the decoder in bf16). Max error against the
   stated tolerance; kernel, plain and library
   (``scaled_dot_product_attention``; ``torch._weight_int4pack_mm`` on
   the weight repacked outside the timed calls) device times from CUDA
   events over a captured CUDA graph, and the kernel's eager time per
   call; the bound (bytes over 3.35 TB/s or operations over the peak for
   their dtype, whichever is larger);
4. the tiny config on the card (fp32, through the kernels) against the
   same weights on the CPU (plain versions): identical greedy tokens;
5. Emma-X at full width (random weights from a seeded generator):
   ``load_vla("prism-dinosiglip-224px+7b")`` with bf16 weights and then
   with int4 weights, a few ``generate_actions`` requests each on 256x256
   frames; per request vision-encode / prefill ms, decode tok/s, peak
   memory, and each kernel's launches in that path's run (counts set to 0
   just before, read just after; a kernel of the path with no launch
   fails the run); then one shorter request under ``torch.profiler`` for
   each phase's device busy time, and each phase's bound;
6. training kernels (in phase 3's call): the forward's LSE, dQ and dK/dV
   (separate and fused) against the plain backward at the Llama training
   shape (B2, fused 448, H32, D128, causal, one row right-padded, bf16:
   the tensor-core kernels) and the DINOv2 / SigLIP shapes
   (bidirectional, fp32: the scalar kernels), with device and eager ms,
   bounds and ``scaled_dot_product_attention`` forward and backward
   through autograd as the library time; the bf16 backward kernels'
   registers, spills and shared memory from the ``-Xptxas -v`` build log;
7. ``align7b``: the full 7B (full width and depth) in the align stage
   (towers and Llama frozen, projector trained; B2, text 192 -> fused
   448; full remat; bf16 compute on fp32 master params; constant LR): one
   step's loss and projector gradient through the kernels against the
   plain path from the same state, each kernel's launches in one step
   (dQ = dK/dV = 32; the forward twice per layer plus the towers' 49),
   then a few steps on one batch: step ms, tokens/s, peak memory, and
   the step's share of the bf16 peak by ``scripts/bench_train_step.py``'s
   accounting; then steps under ``attn_impl="cuda_fused"`` (the dK/dV
   kernel's dQ partials, no dQ kernel; launches checked) and "cuda" in
   turns, and one profiled fused step;
8. the paged-attention kernel (in phase 3's call, so ``--kernels-only``
   runs it) against its plain version at the batched engines' shape (B6,
   H32, hd 128, page size 128, 6 pages per row, ragged lengths 1 / 127 /
   128 / 129 / 458 / 768 on non-contiguous pages) with bf16 pages, int8
   pages and one GQA case (KV 8, G 4); device and eager ms, plain ms, the
   bound (the valid tokens' K/V bytes and scales, q and out over 3.35
   TB/s) and, as the library time, ``scaled_dot_product_attention`` on the
   K/V gathered to a dense layout outside the timed region;
9. batched serving, tiny config: ``PagedServingEngine(paged_attn=
   "kernel")`` on the card gives the CPU engine's greedy tokens (fp32,
   int8 pages off and on), and the card's kernel decode step agrees with
   the gather step (logits rel-RMSE < 2e-2 after two bursts, mixed
   prompt lengths; fp32 and bf16, int8 pages off and on);
10. batched serving at full width with int4 weights, at the settings of
   ``bench.py:606-677``: six requests of 64 new tokens through
   ``PagedServingEngine`` (6 slots, 34 pages of 128, burst 64) under
   "kernel" and "burstdense" with int8 pages and under "kernel" with bf16
   pages, four equal-length queries over one frame admitted with
   ``submit_shared`` and independently, and ``ContinuousServingEngine``
   (6 slots, cache 1024, burst 32); per run aggregate tokens/s after a
   warm-up run, admission ms, median burst ms, peak memory, each
   kernel's launches, and the device's busy share of one profiled burst;
11. ``vla-train``: full width with the decoder cut to 8 of 32 layers (a
   cut of memory: fp32 master, gradients and AdamW moments of a 32-layer
   decoder do not fit one card), GCOT records and synthetic frames
   through ``GCOTDataset`` -> ``collate_train`` -> the prefetching loader
   -> ``run_discrete_vla_training`` with AdamW over the LLM and the
   projector, a Solver eval, and a checkpoint saved to a temporary
   directory, restored, and held equal to the live state.

Phases 7 and 11 run after phase 10. The line before the last is the
card's name and power limit; the one before it a JSON object with one
entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores (no TF32)
MODEL_ID = "prism-dinosiglip-224px+7b"
TASK = "put the carrot in the pot"
MAX_NEW = 64
REQUESTS = 3                   # timed requests per path, after one warm-up
PROFILE_TOKENS = 16            # the profiled request's max_new_tokens
# bf16: the kernel keeps P in fp32 where the plain version rounds it to bf16
# (flash) or rounds dequantized weights to bf16 (int4); both round the
# output to bf16. Held relative to the largest |reference| value.
BF16_RTOL = 2e-2
FP32_RTOL = 1e-4               # the same inputs in fp32: summation order only
# align7b (scripts/bench_train_step.py --config align7b): batch 2, text
# bucket 192 -> fused 448; the last row right-padded by ALIGN_PAD tokens
ALIGN_B, ALIGN_TEXT, ALIGN_PAD = 2, 192, 40
ALIGN_STEPS = 3                # timed steps after one warm-up step
# align7b parity, kernels vs plain from one state: the loss, and the
# projector gradient relative to its largest entry
LOSS_RTOL, GRAD_RTOL = 1e-2, 2e-2
VLA_LAYERS = 8                 # vla-train: decoder cut to 8 of 32 layers
VLA_B, VLA_STEPS = 4, 3
# batched serving (bench.py:606-677): six requests of 64 new tokens
PAGED_REQUESTS, PAGED_NEW = 6, 64
PAGED_KW = dict(num_slots=6, n_pages=34, page_size=128,
                max_pages_per_slot=6, burst=64)
PAGED_LENGTHS = (1, 127, 128, 129, 458, 768)   # kernel check, ragged rows
SHARED_QUERIES, SHARED_NEW = 4, 8
PROFILE_BURST = 8              # the profiled burst's length, in steps


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_phase(name: str) -> None:
    log(f"phase {name} starts at {time.perf_counter() - T0:.1f} s")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_ms(fn, iters: int = 20) -> tuple:
    """(device ms, eager ms) per call of ``fn()``, from CUDA events.

    Device time: ``iters`` calls captured in one CUDA graph and replayed,
    so the host's launch overhead (Python, checks, ctypes) is not in it.
    Eager time: the same calls launched one by one, as the serving loop
    launches them; where it exceeds the device time the host is the limit.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    eager = _events_ms(fn, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay, 3) / iters
    del graph
    return device, eager


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = BF16_FLOPS_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_name(mangled: str) -> str:
    """``tc::dkv_kernel<128, true>`` for a backward kernel's mangled name;
    other names as they are."""
    m = re.search(r"(tc|scalar)\d+(dq_kernel|dkv_kernel)ILi(\d+)E"
                  r"(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    ns, kern, dp, fused = m.groups()
    flag = "" if fused is None else (", true" if fused == "1" else ", false")
    return f"{ns}::{kern}<{dp}{flag}>"


def ptxas_usage(build_log: str) -> dict:
    """Registers, spill bytes (stores + loads) and static shared memory of
    each kernel, from nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["registers"] = int(m.group(1))
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def bwd_resources(kernel) -> dict:
    """The bf16 backward kernels at D 128 (the training shape): registers
    per thread, spill bytes and shared memory per block (static from
    ptxas, dynamic from ``emmax_flash_bwd_smem_bytes``)."""
    usage = ptxas_usage(kernel.build_log)
    f = ctypes.CDLL(str(kernel.library_path())).emmax_flash_bwd_smem_bytes
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    out = {}
    for name, dkv, fused in (("tc::dq_kernel<128>", 0, 0),
                             ("tc::dkv_kernel<128, false>", 1, 0),
                             ("tc::dkv_kernel<128, true>", 1, 1)):
        u = usage.get(name, {})
        out[name] = {"registers": u.get("registers"),
                     "spill_bytes": u.get("spill_bytes"),
                     "smem_bytes": f(dkv, fused, 128)
                     + u.get("static_smem", 0)}
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def prefill_shape(tokenizer, num_patches: int) -> tuple:
    """(prompt tokens, bucket, fused length, cache slots) of one request."""
    from emmax_torch.serving.engine import _round_up, pick_bucket
    from emmax_torch.vla.prompting import build_emma_x_task_prompt

    n = len(tokenizer.encode(build_emma_x_task_prompt(TASK, (128, 96))))
    bucket = pick_bucket(n)
    return n, bucket, num_patches + bucket, _round_up(num_patches + bucket
                                                      + MAX_NEW)


# ----------------------------------------------------------------- kernels --

def check_flash(dev, gen, name, B, Lq, S, H, D, causal, n_pad, dtype):
    """Kernel vs plain at one shape in fp32 and in bf16; ``n_pad`` left-pad
    slots (kv_mask). Timed in ``dtype``, the one the main path gives it."""
    from emmax_torch.ops import flash_attention as fa
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    qkv32 = (rnd(B, Lq, H, D), rnd(B, S, H, D), rnd(B, S, H, D))
    kv_mask = None
    if n_pad or S != Lq:
        kv_mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        kv_mask[:, n_pad:Lq] = True           # the slots the prefill wrote
    kw = dict(kv_mask=kv_mask, causal=causal, q_offset=0)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt) for t in qkv32)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        errs[dt] = rel_err(got, fa.flash_attention_reference(q, k, v, **kw))
        if n_pad and causal and got[:, :n_pad].abs().max().item() != 0.0:
            raise AssertionError(f"flash {name}: pad query rows are not zero")
    rel32, rel = errs[torch.float32][1], errs[torch.bfloat16][1]
    if not (rel32 <= FP32_RTOL and rel <= BF16_RTOL):
        raise AssertionError(f"flash {name}: rel err fp32 {rel32:.3g} "
                             f"(tol {FP32_RTOL}), bf16 {rel:.3g} "
                             f"(tol {BF16_RTOL})")
    q, k, v = (t.to(dtype) for t in qkv32)
    ms, eager = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    plain, _ = time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw))
    dense = fa._dense_mask(Lq, S, kv_mask, causal, 0, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib, _ = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense))
    pairs = (dense.expand(B, 1, Lq, S).sum().item() if dense is not None
             else B * Lq * S)
    n_bytes = q.element_size() * (2 * B * Lq * H * D + 2 * B * S * H * D) + (
        B * S if kv_mask is not None else 0)
    bms, by = bound_ms(n_bytes, 4.0 * H * D * pairs,
                       FP32_FLOPS_PER_S if dtype == torch.float32
                       else BF16_FLOPS_PER_S)
    return {"name": "flash_fwd", "shape": name, "dtype": str(dtype)[6:],
            "max_abs_err": errs[dtype][0], "rel_err": rel,
            "fp32_rel_err": rel32, "ms": ms, "eager_ms": eager,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by}


def tinygemm_weight(q4: torch.Tensor, scale: torch.Tensor) -> tuple:
    """One layer's int4 weight in the layout ``torch._weight_int4pack_mm``
    (the library yardstick; the port never calls it) takes: the codes
    ``q + 8`` as [F, D] nibbles, two to a byte with the first in the high
    nibble, packed by ``_convert_weight_to_int4pack``; and per group a
    (scale, zero) pair [G, F, 2] decoding ``(u - 8) * s + z``, so z = s / 2
    gives the port's mid-rise ``(q + 0.5) * s`` exactly."""
    b = q4.to(torch.int32)
    u = torch.cat([b & 15, (b >> 4) + 8], dim=0).t()       # [F, D], 0..15
    packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous()
    return (torch._convert_weight_to_int4pack(packed, 8),
            torch.stack([scale, scale * 0.5], dim=-1).contiguous())


def check_int4(dev, gen, name, M, D, F, layers=8):
    """Kernel vs plain at one shape on layer 1 of a stacked weight; timed
    over ``layers`` stacked layers in turn, so the weights come from HBM
    (the stack is larger than the 50 MB L2) as in the decode loop. The
    library call is held against the plain version too, and timed the
    same way on the same weights repacked beforehand."""
    from emmax_torch.ops import int4_matmul as im

    group = 128
    q4 = torch.randint(-128, 128, (layers, D // 2, F), dtype=torch.int8,
                       device=dev, generator=gen)
    scale = (torch.rand((layers, D // group, F), generator=gen, device=dev)
             * 0.02).bfloat16()
    x32 = torch.randn((M, D), generator=gen, device=dev)
    x = x32.bfloat16()
    got32 = im.int4_matmul_cuda(x32, q4[1], scale[1])
    _, rel32 = rel_err(got32, im.int4_matmul_reference(x32, q4[1], scale[1]))
    ref = im.int4_matmul_reference(x, q4[1], scale[1])
    err, rel = rel_err(im.int4_matmul_cuda(x, q4[1], scale[1]), ref)
    packs = [tinygemm_weight(q4[i], scale[i]) for i in range(layers)]
    _, lib_rel = rel_err(torch._weight_int4pack_mm(x, packs[1][0], group,
                                                   packs[1][1]), ref)
    if not (rel32 <= FP32_RTOL and rel <= BF16_RTOL
            and lib_rel <= BF16_RTOL):
        raise AssertionError(f"int4 {name}: rel err fp32 {rel32:.3g} "
                             f"(tol {FP32_RTOL}), bf16 {rel:.3g}, library "
                             f"{lib_rel:.3g} (tol {BF16_RTOL})")
    state = {"l": 0}

    def rotate(fn):
        def run():
            state["l"] = (state["l"] + 1) % layers
            fn(state["l"])
        return run

    ms, eager = time_ms(rotate(
        lambda i: im.int4_matmul_cuda(x, q4[i], scale[i])), iters=4 * layers)
    plain, _ = time_ms(rotate(
        lambda i: im.int4_matmul_reference(x, q4[i], scale[i])), iters=layers)
    lib, _ = time_ms(rotate(
        lambda i: torch._weight_int4pack_mm(x, packs[i][0], group,
                                            packs[i][1])), iters=4 * layers)
    n_bytes = M * D * 2 + D // 2 * F + (D // group) * F * 2 + M * F * 2
    bms, by = bound_ms(n_bytes, 2.0 * M * D * F)
    return {"name": "int4_matmul", "shape": name, "dtype": "bfloat16",
            "max_abs_err": err, "rel_err": rel, "fp32_rel_err": rel32,
            "library_rel_err": lib_rel, "ms": ms, "eager_ms": eager,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by}


def kernel_phase(dev):
    from emmax_torch.models.vlm import emma_x_vlm_config
    from emmax_torch.vla.tokenizer import load_tokenizer

    cfg = emma_x_vlm_config()
    n_tok, bucket, Lq, S = prefill_shape(load_tokenizer(None),
                                         cfg.num_patches)
    log(f"prefill shape: prompt {n_tok} tokens, bucket {bucket}, fused "
        f"{Lq}, cache {S} slots")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    (_, dino), (_, sig) = cfg.vision
    llm = cfg.llm
    flash = [
        check_flash(dev, gen, f"dino B1 L{dino.num_patches + dino.num_prefix}"
                    f" H{dino.n_heads} D{dino.head_dim}", 1,
                    dino.num_patches + dino.num_prefix,
                    dino.num_patches + dino.num_prefix, dino.n_heads,
                    dino.head_dim, False, 0, torch.float32),
        check_flash(dev, gen, f"siglip B1 L{sig.num_patches} H{sig.n_heads}"
                    f" D{sig.head_dim}", 1, sig.num_patches,
                    sig.num_patches, sig.n_heads, sig.head_dim, False, 0,
                    torch.float32),
        check_flash(dev, gen, f"llama prefill B1 Lq{Lq} S{S} H{llm.n_heads}"
                    f" D{llm.head_dim} causal pad{bucket - n_tok}", 1, Lq, S,
                    llm.n_heads, llm.head_dim, True, bucket - n_tok,
                    torch.bfloat16),
    ]
    D, Fh, V = llm.dim, llm.hidden_dim, llm.vocab_size
    shapes = [("wq/wk/wv/wo", D, D), ("w_gate/w_up", D, Fh),
              ("w_down", Fh, D), ("lm_head", D, V)]
    int4 = [check_int4(dev, gen, f"{n} M{M} D{d} F{f}", M, d, f)
            for M in (1, Lq) for n, d, f in shapes]
    for r in flash + int4:
        log("kernel " + json.dumps(r))
    return flash, int4


def _pad_mask(dev, B, S, rpad):
    """[B, S] slot mask with the last row right-padded by ``rpad`` slots
    (None when nothing is padded)."""
    if not rpad:
        return None
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    mask[-1, S - rpad:] = False
    return mask


def check_flash_bwd(dev, gen, name, B, L, H, D, causal, rpad, dtype):
    """The training kernels at one shape (Lq == S == L): the forward's LSE,
    dQ, dK/dV and the fused dK/dV + dQ partials, each against the plain
    versions on the same inputs; then their device and eager times, the
    plain versions' times, the bound, and the library's
    ``scaled_dot_product_attention`` forward and backward (autograd)."""
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops.cuda_build import current_stream_ptr
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, k, v, do = (torch.randn((B, L, H, D), generator=gen,
                               device=dev).to(dtype) for _ in range(4))
    kv_mask = _pad_mask(dev, B, L, rpad)
    kw = dict(kv_mask=kv_mask, causal=causal)
    tol = FP32_RTOL if dtype == torch.float32 else BF16_RTOL
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    out_err, out_rel = rel_err(out, fa.flash_attention_reference(q, k, v,
                                                                 **kw))
    lse_err, lse_rel = rel_err(lse, fa.flash_lse_reference(q, k, **kw))
    di = (out.float() * do.float()).sum(-1)
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, di, **kw)
    errs = {}
    for fused in (False, True):
        got = fa.flash_attention_bwd_cuda(q, k, v, do, lse, di, fused=fused,
                                          **kw)
        for n, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[f"{n}{'_fused' if fused else ''}"] = rel_err(g, w)
    bad = {n: e[1] for n, e in errs.items() if e[1] > tol}
    if out_rel > tol or lse_rel > FP32_RTOL or bad:
        raise AssertionError(f"flash bwd {name}: out {out_rel:.3g}, lse "
                             f"{lse_rel:.3g} (tol {FP32_RTOL}), grads over "
                             f"{tol}: {bad}")

    def stream_args(fused):
        (args, keep), outs = fa.bwd_launch_args(q, k, v, do, lse, di,
                                                fused=fused, **kw)
        return (lambda kernel: kernel.launch(*args[:-1],
                                             current_stream_ptr(dev))), (
            keep, outs)

    sep, keep_sep = stream_args(False)
    fus, keep_fus = stream_args(True)
    times = {
        "flash_fwd_lse": time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, return_lse=True, **kw)),
        "flash_bwd_dq": time_ms(lambda: sep(fa.DQ_KERNEL)),
        "flash_bwd_dkv": time_ms(lambda: sep(fa.DKV_KERNEL)),
        "flash_bwd_dkv_fused": time_ms(lambda: fus(fa.DKV_KERNEL)),
    }
    dq_sum_ms, _ = time_ms(lambda: keep_fus[1][3].sum(dim=0).to(q.dtype))
    plain_fwd, _ = time_ms(lambda: (fa.flash_attention_reference(q, k, v,
                                                                  **kw),
                                    fa.flash_lse_reference(q, k, **kw)))
    plain_bwd, _ = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, do, lse, di, **kw), iters=5)

    dense = fa._dense_mask(L, L, kv_mask, causal, 0, dev)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    lib_fwd, _ = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense))

    def lib_fwd_bwd():
        o = sdpa(qt, kt, vt, attn_mask=dense)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    lib_both, _ = time_ms(lib_fwd_bwd)

    pairs = H * (dense.expand(B, 1, L, L).sum().item()
                 if dense is not None else B * L * L)
    el = q.element_size()
    act = B * L * H * D * el                       # one [B, L, H, D] array
    rows = B * L * H * 4                           # one fp32 [B, L, H]
    mask_b = B * L if kv_mask is not None else 0
    peak = FP32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    n_kv_tiles = -(-L // fa.BWD_KV_TILE)
    work = {   # (bytes: each input read once, each output written once; ops)
        "flash_fwd_lse": (4 * act + rows + mask_b, 4.0 * D * pairs),
        "flash_bwd_dq": (5 * act + 2 * rows + mask_b, 6.0 * D * pairs),
        "flash_bwd_dkv": (6 * act + 2 * rows + mask_b, 8.0 * D * pairs),
        "flash_bwd_dkv_fused": (6 * act + 2 * rows + mask_b
                                + n_kv_tiles * B * L * H * D * 4,
                                10.0 * D * pairs),
    }
    errs_out = {"flash_fwd_lse": (out_err, out_rel),
                "flash_bwd_dq": errs["dq"],
                "flash_bwd_dkv": max(errs["dk"], errs["dv"],
                                     key=lambda e: e[1]),
                "flash_bwd_dkv_fused": max(errs["dq_fused"],
                                           errs["dk_fused"],
                                           errs["dv_fused"],
                                           key=lambda e: e[1])}
    plain = {"flash_fwd_lse": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd, "flash_bwd_dkv_fused": plain_bwd}
    library = {"flash_fwd_lse": lib_fwd, "flash_bwd_dq": lib_both - lib_fwd,
               "flash_bwd_dkv": lib_both - lib_fwd,
               "flash_bwd_dkv_fused": lib_both - lib_fwd}
    recs = []
    for kname, (ms, eager) in times.items():
        bms, by = bound_ms(*work[kname], peak)
        recs.append({"name": kname, "shape": name, "dtype": str(dtype)[6:],
                     "max_abs_err": errs_out[kname][0],
                     "rel_err": errs_out[kname][1], "ms": ms,
                     "eager_ms": eager, "plain_ms": plain[kname],
                     "library_ms": library[kname], "bound_ms": bms,
                     "bound_by": by})
    recs[0]["lse_max_abs_err"] = lse_err
    recs[-1]["dq_partial_sum_ms"] = dq_sum_ms
    recs[-1]["library_note"] = recs[1]["library_note"] = recs[2][
        "library_note"] = "sdpa backward (dq, dk and dv together)"
    return recs


def training_kernel_phase(dev):
    from emmax_torch.models.vlm import emma_x_vlm_config

    cfg = emma_x_vlm_config()
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    (_, dino), (_, sig) = cfg.vision
    llm = cfg.llm
    F = cfg.num_patches + ALIGN_TEXT
    recs = (check_flash_bwd(dev, gen, f"llama train B{ALIGN_B} L{F} "
                            f"H{llm.n_heads} D{llm.head_dim} causal "
                            f"rpad{ALIGN_PAD}", ALIGN_B, F, llm.n_heads,
                            llm.head_dim, True, ALIGN_PAD, torch.bfloat16)
            + check_flash_bwd(dev, gen, f"dino B{ALIGN_B} L"
                              f"{dino.num_patches + dino.num_prefix} "
                              f"H{dino.n_heads} D{dino.head_dim}", ALIGN_B,
                              dino.num_patches + dino.num_prefix,
                              dino.n_heads, dino.head_dim, False, 0,
                              torch.float32)
            + check_flash_bwd(dev, gen, f"siglip B{ALIGN_B} "
                              f"L{sig.num_patches} H{sig.n_heads} "
                              f"D{sig.head_dim}", ALIGN_B, sig.num_patches,
                              sig.n_heads, sig.head_dim, False, 0,
                              torch.float32))
    for r in recs:
        log("kernel " + json.dumps(r))
    return recs


def check_paged(dev, gen, name, KV, G, kdt):
    """The paged-attention kernel against its plain version at the batched
    engines' shape: B = len(PAGED_LENGTHS) rows of ragged lengths, page
    size 128, 6 pages per row on shuffled page ids, hd 128. Held in fp32
    q (tolerance FP32_RTOL) and bf16 q (BF16_RTOL: the TPU kernel re-rounds
    its bf16 output once per compute block, this one keeps fp32 and rounds
    once); timed with bf16 q, as the engine gives it."""
    from emmax_torch.ops import paged_attention as pa
    from emmax_torch.serving.paged import _row_quantize
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    B, hd, ps, MP = len(PAGED_LENGTHS), 128, PAGED_KW["page_size"], 6
    H, P = KV * G, B * MP + 4
    k = torch.randn((KV, P, ps, hd), generator=gen, device=dev)
    v = torch.randn((KV, P, ps, hd), generator=gen, device=dev)
    ks = vs = None
    if kdt == torch.int8:
        (k, ks), (v, vs) = _row_quantize(k), _row_quantize(v)
    else:
        k, v = k.to(kdt), v.to(kdt)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * MP]
    table = perm.reshape(B, MP).to(torch.int32)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    q32 = torch.randn((B, H, hd), generator=gen, device=dev) * hd ** -0.5
    kw = dict(k_scale=ks, v_scale=vs)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q = q32.to(dt)
        errs[dt] = rel_err(pa.paged_attention_cuda(q, k, v, lengths, table,
                                                   **kw),
                           pa.paged_attention_reference(q, k, v, lengths,
                                                        table, **kw))
    rel32, rel = errs[torch.float32][1], errs[torch.bfloat16][1]
    if not (rel32 <= FP32_RTOL and rel <= BF16_RTOL):
        raise AssertionError(f"paged {name}: rel err fp32 {rel32:.3g} "
                             f"(tol {FP32_RTOL}), bf16 {rel:.3g} "
                             f"(tol {BF16_RTOL})")
    q = q32.bfloat16()
    ms, eager = time_ms(lambda: pa.paged_attention_cuda(q, k, v, lengths,
                                                        table, **kw))
    plain, _ = time_ms(lambda: pa.paged_attention_reference(
        q, k, v, lengths, table, **kw), iters=5)
    # library yardstick: SDPA over the same K/V gathered to a dense
    # [B, H, S, hd] bf16 layout (dequantized, GQA heads repeated) outside
    # the timed calls; no PyTorch call takes a page table
    ids = table.long()

    def dense(pages, scale):
        g = pages[:, ids].float()
        if scale is not None:
            g = g * scale[:, ids] / pa.MAX_INT8
        g = g.reshape(KV, B, MP * ps, hd).permute(1, 0, 2, 3)
        return g.repeat_interleave(G, dim=1).bfloat16().contiguous()

    kd, vd = dense(k, ks), dense(v, vs)
    mask = (torch.arange(MP * ps, device=dev)[None]
            < lengths[:, None])[:, None, None]             # [B, 1, 1, S]
    lib, _ = time_ms(lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                                  scale=1.0))
    _, lib_rel = rel_err(sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                              scale=1.0)[:, :, 0],
                         pa.paged_attention_reference(q, k, v, lengths,
                                                      table, **kw))
    tokens = int(lengths.sum())
    row = hd * k.element_size() + (4 if kdt == torch.int8 else 0)
    n_bytes = 2 * KV * tokens * row + 2 * B * H * hd * q.element_size() + (
        B * 4 + B * MP * 4)
    bms, by = bound_ms(n_bytes, 4.0 * H * hd * tokens)
    return {"name": "paged_attention", "shape": name,
            "dtype": f"q bf16, pages {str(kdt)[6:]}",
            "max_abs_err": errs[torch.bfloat16][0], "rel_err": rel,
            "fp32_rel_err": rel32, "library_rel_err": lib_rel, "ms": ms,
            "eager_ms": eager, "plain_ms": plain, "library_ms": lib,
            "library_note": "sdpa on K/V gathered to dense bf16 [B, H, S, "
                            "hd] outside the timed calls",
            "bound_ms": bms, "bound_by": by}


def paged_kernel_phase(dev):
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    lens = "/".join(str(n) for n in PAGED_LENGTHS)
    recs = [check_paged(dev, gen, f"B6 KV{kv} G{g} hd128 ps128 MP6 "
                        f"len {lens}", kv, g, kdt)
            for kv, g, kdt in ((32, 1, torch.bfloat16),
                               (32, 1, torch.int8), (8, 4, torch.bfloat16))]
    for r in recs:
        log("kernel " + json.dumps(r))
    return recs


# --------------------------------------------------------------- the path --

def tiny_parity(dev):
    """The tiny config through the kernels (fp32) on the card against the
    same weights through the plain versions on the CPU."""
    from emmax_torch.models.load import load
    from emmax_torch.models.vla import EmmaXVLA

    for quantize in (None, "int4"):
        cfg, params, tok, transforms, family = load(
            "tiny", dtype=torch.float32, quantize=quantize, device="cpu",
            seed=3)
        on_card = _tree_to(params, dev)
        frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                                  dtype=np.uint8)
        texts = []
        for device, p in (("cpu", params), (dev, on_card)):
            vla = EmmaXVLA(cfg, p, tok, transforms, llm_family=family,
                           device=device)
            prompt = vla.get_prompt(TASK, gripper_position=(10, 20))
            ids = vla.engine.generate_ids([prompt], vla._pixels(frame),
                                          max_new_tokens=24)
            texts.append(ids[0].tolist())
        if texts[0] != texts[1]:
            raise AssertionError(f"tiny {quantize}: card tokens {texts[1]} "
                                 f"!= CPU tokens {texts[0]}")
        log(f"tiny parity ({quantize or 'fp32'}): card == CPU, 24 tokens")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def profile_request(vla, frame, prompt) -> dict:
    """One more request (``PROFILE_TOKENS`` long, to bound the profiler's
    cost) under ``torch.profiler``. Per engine phase (the ``emmax_torch.*``
    ranges as the card saw them): the span from its first to its last
    kernel and the summed time of the kernels and copies inside it; per
    decode forward the same sum; and the kernels that took the most device
    time. The profiler slows the host, so spans here are longer than
    unprofiled ones; the summed device times are not. With no device
    events the numbers are reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vla.generate_actions(frame, prompt, type="act",
                             max_new_tokens=PROFILE_TOKENS)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.name.split(".", 1)[1]: e.time_range for e in on_card
             if e.name.startswith("emmax_torch.")}
    work = [e for e in on_card if not e.name.startswith("emmax_torch.")]
    if not spans or not work:
        return {"tokens": PROFILE_TOKENS, "device": "not measured"}
    phases = {}
    for name, span in spans.items():
        busy = sum(e.time_range.elapsed_us() for e in work
                   if span.start <= e.time_range.start < span.end) / 1e3
        phases[name] = {"span_ms": span.elapsed_us() / 1e3, "busy_ms": busy}
    forwards = vla.engine.last_timings["decode_forwards"]
    phases["decode"]["busy_ms_per_forward"] = (
        phases["decode"]["busy_ms"] / forwards)
    by_name = {}
    for e in work:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"tokens": PROFILE_TOKENS, "phases": phases,
            "device_ms_total": sum(by_name.values()), "top_kernels_ms": top}


def path_bounds(vla, prefill_tokens: int, valid_tokens: float) -> dict:
    """Least times for one request's phases on this card, from the loaded
    tree's shapes. Decode reads every decoder weight once per token plus
    the KV cache's ``valid_tokens`` live slots (the mean over the decode;
    bytes over the HBM rate). Prefill does 2 operations per matmul weight
    per token over the bf16 peak, encode the same over the fp32 peak (the
    towers and projector run in fp32, as in JAX); each takes the larger of
    that and its bytes. The attention products are left out (< 4% of the
    operations at these lengths), so these are lower bounds."""
    cfg = vla.cfg
    llm = vla.engine.model.llm.params.tree()
    flat = [t for k, v in llm.items() if k != "embed"
            for t in (_leaves(v) if isinstance(v, dict) else [v])]
    weight_bytes = sum(t.numel() * t.element_size() for t in flat)
    L, D, Fh, V = (cfg.llm.n_layers, cfg.llm.dim, cfg.llm.hidden_dim,
                   cfg.llm.vocab_size)
    kv_bytes = (2 * L * cfg.llm.n_kv_heads * cfg.llm.head_dim * 2
                * valid_tokens)                       # bf16 K and V
    llm_params = L * (4 * D * D + 3 * D * Fh) + D * V
    enc_flops = 0.0
    for _, v in cfg.vision:
        blocks = (v.depth - 1) * (4 * v.dim * v.dim + 2 * v.dim * v.hidden_dim)
        enc_flops += 2.0 * (blocks + 3 * v.patch_size ** 2 * v.dim) * (
            v.num_patches + v.num_prefix)
    proj = cfg.vision_dim * 4 * cfg.vision_dim + 4 * cfg.vision_dim * D + D * D
    enc_flops += 2.0 * proj * cfg.num_patches
    return {
        "decode_ms_per_token": bound_ms(weight_bytes + kv_bytes,
                                        2.0 * llm_params)[0],
        "prefill_ms": bound_ms(weight_bytes,
                               2.0 * llm_params * prefill_tokens)[0],
        "encode_ms": enc_flops / FP32_FLOPS_PER_S * 1e3,
        "decoder_weight_gb": weight_bytes / 1e9,
        "kv_read_gb_per_token": kv_bytes / 1e9,
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def run_path(dev, quantize, kernels):
    """Full-width Emma-X through ``load_vla`` -> ``generate_actions``."""
    import emmax_torch

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vla = emmax_torch.load_vla(MODEL_ID, quantize=quantize, device="cuda",
                               seed=0)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    load_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
              for _ in range(REQUESTS + 1)]
    prompt = vla.get_prompt(TASK, gripper_position=(128, 96))
    for k in kernels:
        k.launches = 0
    rows = []
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        actions, text = vla.generate_actions(frame, prompt, type="act",
                                             max_new_tokens=MAX_NEW)
        wall = (time.perf_counter() - t0) * 1e3
        for a in actions:
            if a.shape != (7,) or not np.isfinite(a).all():
                raise AssertionError(f"bad action {a!r}")
        if not isinstance(text, str):
            raise AssertionError("generate_actions returned no text")
        tm = dict(vla.engine.last_timings)
        tm["request_ms"] = wall
        tm["decode_tok_s"] = (tm["decode_forwards"] / tm["decode_ms"] * 1e3
                              if tm["decode_forwards"] else None)
        tm["n_actions"] = len(actions)
        tm["warmup"] = i == 0
        rows.append(tm)
        log(f"{quantize or 'bf16'} request {i}: " + json.dumps(tm))
    act = vla.predict_action(frames[0], TASK)
    if act.shape != (7,) or not np.isfinite(act).all():
        raise AssertionError(f"bad predict_action {act!r}")
    launches = {k.name: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    profile = profile_request(vla, frames[1], prompt)
    log(f"{quantize or 'bf16'} profile " + json.dumps(profile))
    n_tok, _, _, _ = prefill_shape(vla.tokenizer, vla.cfg.num_patches)
    bounds = path_bounds(vla, int(rows[0]["prefill_tokens"]),
                         n_tok + vla.cfg.num_patches + MAX_NEW / 2)
    del vla
    gc.collect()
    torch.cuda.empty_cache()
    timed = [r for r in rows if not r["warmup"]]
    summary = {
        "path": quantize or "bf16", "load_s": load_s,
        "load_peak_gb": load_peak_gb, "serving_peak_gb": peak_gb,
        "launches": launches,
        "encode_ms": float(np.mean([r["encode_ms"] for r in timed])),
        "prefill_ms": float(np.mean([r["prefill_ms"] for r in timed])),
        "decode_tok_s": float(np.mean([r["decode_tok_s"] for r in timed
                                       if r["decode_tok_s"]])),
        "request_ms": float(np.mean([r["request_ms"] for r in timed])),
        "prefill_tokens": timed[0]["prefill_tokens"],
        "profile": profile,
        "bounds": bounds,
    }
    if "phases" in profile:
        # device busy per decode forward over the unprofiled time per forward
        per_forward = np.mean([r["decode_ms"] / r["decode_forwards"]
                               for r in timed])
        summary["decode_busy_share"] = (
            profile["phases"]["decode"]["busy_ms_per_forward"] / per_forward)
    log("path " + json.dumps(summary))
    return summary


# --------------------------------------------------------- batched serving --

def _rel_rmse(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).mean().sqrt()
                 / ((want ** 2).mean().sqrt() + 1e-9))


def tiny_batched_parity(dev):
    """The tiny config through ``PagedServingEngine(paged_attn="kernel")``:
    the card (the kernel) against the CPU (its plain version) in fp32,
    token for token, with int8 pages off and on; then the card's kernel
    decode step against the gather step on one admitted pool after two
    bursts (``scripts/tpu_checks.py:paged_parity``), in fp32 and bf16."""
    from emmax_torch.models.load import load
    from emmax_torch.serving.engine import encode_frame
    from emmax_torch.serving.paged import (PagedServingEngine,
                                           _paged_decode_step)

    cfg, params, tok, _, _ = load("tiny", dtype=torch.float32, device="cpu",
                                  seed=3)
    on_card = _tree_to(params, dev)
    rng = np.random.default_rng(11)
    prompts = [f"In: stack the {w} cups\nOut:"
               for w in ("red", "blue", "green")]   # mixed lengths
    # one encode, fed to both sides: two encodes may round differently
    patches = [encode_frame(params, cfg, {
        n: torch.from_numpy(rng.normal(size=(1, v.img_size, v.img_size, 3))
                            .astype(np.float32)) for n, v in cfg.vision})
        for _ in prompts]
    for quantized in (False, True):
        outs = []
        for device, p in (("cpu", params), (dev, on_card)):
            eng = PagedServingEngine(
                cfg, p, tok, num_slots=2, n_pages=24, page_size=16,
                max_pages_per_slot=8, burst=4, paged_attn="kernel",
                quantized_cache=quantized, device=device)
            rids = [eng.submit(pr, {"patches": pt.to(device)},
                               max_new_tokens=12)
                    for pr, pt in zip(prompts, patches)]
            done = eng.run_until_complete()
            outs.append([done[r] for r in rids])
        if outs[0] != outs[1]:
            raise AssertionError(f"tiny paged kernel, int8 pages "
                                 f"{quantized}: card {outs[1]} != CPU "
                                 f"{outs[0]}")
        log(f"tiny paged kernel parity (int8 pages {quantized}): card == "
            f"CPU, {sum(len(o) for o in outs[1])} tokens over 3 requests")
    steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, p, _, _, _ = load("tiny", dtype=dtype, device=dev, seed=3)
        for quantized in (False, True):
            eng = PagedServingEngine(
                cfg, p, tok, num_slots=3, n_pages=16, page_size=128,
                max_pages_per_slot=8, burst=8, paged_attn="gather",
                quantized_cache=quantized, device=dev)
            for pr, pt in zip(prompts, patches):
                eng.submit(pr, {"patches": pt.to(dev, dtype)},
                           max_new_tokens=24)
            eng.step()
            eng.step()                  # two real bursts first
            out = {mode: _paged_decode_step(
                p["llm"], cfg.llm, eng.pool, page_size=128, n_pages=16,
                paged_attn=mode) for mode in ("gather", "kernel")}
            rmse = _rel_rmse(out["kernel"][2], out["gather"][2])
            agree = int((out["kernel"][1] == out["gather"][1]).sum())
            key = f"{str(dtype)[6:]} int8 pages {quantized}"
            steps[key] = {"logit_rel_rmse": rmse, "argmax_agree": agree}
            if not (rmse < 2e-2 and agree >= 2):
                raise AssertionError(f"kernel vs gather step, {key}: "
                                     f"rel-RMSE {rmse:.3g}, argmax agree "
                                     f"{agree}/3")
    log("tiny kernel-vs-gather step " + json.dumps(steps))
    return steps


def serve(make_engine, submit):
    """One batched run: ``submit(engine)`` queues the requests (returns
    their ids), then admission and every burst are timed on the host clock
    ending in a sync (each burst ends in its one fetch)."""
    eng = make_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = submit(eng)
    eng._admit()
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) * 1e3
    bursts = []
    while eng.queue or eng.running:
        t1 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        bursts.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    out = [eng.finished[r] for r in rids]
    return eng, out, {"admit_ms": admit_ms, "burst_ms": bursts,
                      "median_burst_ms": float(np.median(bursts)),
                      "wall_s": wall, "tokens": sum(len(o) for o in out),
                      "agg_tok_s": sum(len(o) for o in out) / wall}


def batched_run(dev, name, make_engine, submit, kernels, burst):
    """A warm-up run, a timed run (launches counted, peak memory), then
    one profiled burst of ``PROFILE_BURST`` steps (to bound the profiler's
    cost) of a fresh engine that differs only in its burst length; its
    busy share is the device time per step over the timed run's wall time
    per step. Checks the outputs."""
    serve(make_engine, submit)                              # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    eng, out, rec = serve(make_engine, submit)
    launches = {k.name: k.launches for k in kernels}
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rec["launches"] = launches
    rec["decode_steps"] = len(rec["burst_ms"]) * burst
    for o in out:
        if not o or any(not (0 <= t < eng.cfg.llm.vocab_size) for t in o):
            raise AssertionError(f"{name}: bad tokens {o[:8]}")
    fresh = make_engine(burst=PROFILE_BURST)
    submit(fresh)
    fresh._admit()
    torch.cuda.synchronize()
    rec["profile"] = profile_step(
        fresh.step, rec["median_burst_ms"] * PROFILE_BURST / burst)
    rec["profile"]["steps"] = PROFILE_BURST
    rec.pop("burst_ms")
    rec["name"] = name
    log("batched " + json.dumps(rec))
    return rec


def batched_phase(dev, kernels):
    """Full-width Emma-X (int4 weights, random from the seeded generator)
    through the batched engines at bench.py's settings."""
    from emmax_torch.models.load import load
    from emmax_torch.ops.image import preprocess_for_towers
    from emmax_torch.serving.continuous import ContinuousServingEngine
    from emmax_torch.serving.paged import PagedServingEngine
    from emmax_torch.vla.prompting import build_emma_x_task_prompt

    cfg, params, tok, transforms, _ = load(MODEL_ID, quantize="int4",
                                           device="cuda", seed=0)
    rng = np.random.default_rng(9)
    pixels = [preprocess_for_towers(torch.from_numpy(rng.integers(
        0, 256, (1, 256, 256, 3), dtype=np.uint8)).to(dev), transforms)
        for _ in range(PAGED_REQUESTS)]
    prompt = build_emma_x_task_prompt(TASK, (128, 96))

    def submit_all(eng):
        return [eng.submit(prompt, px, max_new_tokens=PAGED_NEW)
                for px in pixels]

    def paged(mode, quantized, **kw):
        return lambda **o: PagedServingEngine(
            cfg, params, tok, paged_attn=mode, quantized_cache=quantized,
            device="cuda", **{**PAGED_KW, **kw, **o})

    runs = {}
    for name, mode, quantized in (("paged kernel int8", "kernel", True),
                                  ("paged burstdense int8", "burstdense",
                                   True),
                                  ("paged kernel bf16", "kernel", False)):
        rec = batched_run(dev, name, paged(mode, quantized), submit_all,
                          kernels, PAGED_KW["burst"])
        n = rec["launches"]
        if mode == "kernel" and n["paged_attention"] < (
                cfg.llm.n_layers * rec["decode_steps"]):
            raise AssertionError(f"{name}: {n['paged_attention']} "
                                 f"paged_attention launches for "
                                 f"{rec['decode_steps']} decode steps")
        runs[name] = rec
    cont = batched_run(dev, "continuous", lambda **o: (
        ContinuousServingEngine(cfg, params, tok, **{
            "num_slots": PAGED_REQUESTS, "cache_len": 1024, "burst": 32,
            "device": "cuda", **o})), submit_all, kernels, 32)
    runs["continuous"] = cont

    # shared prefix: four equal-length queries over one frame, admitted
    # with submit_shared (the prefix prefill is timed from submission)
    # and independently
    queries = [prompt[:-1] + c for c in "ABCD"[:SHARED_QUERIES]]
    shared = {}
    for how in ("shared", "independent"):
        def submit(eng, how=how):
            if how == "shared":
                return eng.submit_shared(queries, pixels[0],
                                         max_new_tokens=SHARED_NEW)
            return [eng.submit(q, pixels[0], max_new_tokens=SHARED_NEW)
                    for q in queries]

        make = paged("burstdense", True, num_slots=SHARED_QUERIES,
                     max_pages_per_slot=8)
        serve(make, submit)                                  # warm-up
        for k in kernels:
            k.launches = 0
        _, out, rec = serve(make, submit)
        rec["launches"] = {k.name: k.launches for k in kernels}
        rec.pop("burst_ms")
        shared[how] = rec
        log(f"shared-prefix {how} " + json.dumps(rec))
    runs["shared_prefix"] = shared
    for name, rec in [*runs.items()][:4] + [
            (f"shared {h}", r) for h, r in shared.items()]:
        for kname in ("flash_fwd", "int4_matmul"):
            if rec["launches"][kname] == 0:
                raise AssertionError(f"{name}: launched no {kname}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- training --

def _count(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


def align_batch(dev, pad_id: int):
    """B2 x 192 tokens (BOS first, the first third unsupervised, the last
    row right-padded) and 256x256 uint8 frames, from a seeded numpy
    generator (scripts/bench_train_step.py's batch, with padding)."""
    rng = np.random.default_rng(0)
    B, T = ALIGN_B, ALIGN_TEXT
    ids = rng.integers(3, 30000, size=(B, T)).astype(np.int32)
    ids[:, 0] = 1
    labels = ids.copy()
    labels[:, :T // 3] = -100
    mask = np.ones((B, T), bool)
    ids[-1, T - ALIGN_PAD:] = pad_id
    labels[-1, T - ALIGN_PAD:] = -100
    mask[-1, T - ALIGN_PAD:] = False
    images = rng.integers(0, 256, (B, 256, 256, 3), dtype=np.uint8)
    return {k: torch.from_numpy(v).to(dev) for k, v in (
        ("input_ids", ids), ("labels", labels), ("attention_mask", mask),
        ("images", images))}


def profile_step(run, step_ms: float) -> dict:
    """One more train step under ``torch.profiler``: the kernels' summed
    device time, its share of the unprofiled step time, the attention
    kernels' device ms, and the kernels that took the most of it. With no
    device events: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    attn = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
            for key, part in (("flash_fwd", "flash_fwd_kernel"),
                              ("flash_bwd_dq", "::dq_kernel<"),
                              ("flash_bwd_dkv", "::dkv_kernel<")):
                if part in e.name:
                    attn[key] += ms
    if not by_name:
        return {"device": "not measured"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": busy, "busy_share": busy / step_ms,
            "attention_ms": attn, "top_kernels_ms": top}


def align7b_phase(dev, kernels):
    """Full 7B, align stage: kernel-vs-plain step parity, launch counts per
    step, then timed steps on one batch."""
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    from emmax_torch.training.train_step import (make_grad_fn,
                                                  make_train_step)

    cfg = emma_x_vlm_config()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    tx, _ = make_optimizer(params, learning_rate=2e-5, weight_decay=0.01,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=100, stage="align")
    state = create_train_state(params, tx)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_llm, n_vis, n_proj = (_count(params[k]) for k in
                            ("llm", "vision", "projector"))
    batch = align_batch(dev, 32000)
    common = dict(remat=True, stop_vision_gradient=True,
                  compute_dtype=torch.bfloat16,
                  transforms=get_image_transforms("dinosiglip-vit-so-224px",
                                                  "resize-naive"),
                  freeze_mask=trainable_mask(params, "align"),
                  action_vocab_size=32000)

    # One step's loss and projector gradient from one state, through the
    # kernels and through the plain path, in fp32 (held at LOSS_RTOL and
    # GRAD_RTOL of the largest entry) and in bf16 (each held against the
    # fp32 plain run: the kernels no farther from it than twice the plain
    # path's distance, or GRAD_RTOL; the two bf16 paths round differently
    # through 32 layers, so they are not held to each other).
    results = {}
    for impl, dtype in (("torch", torch.float32), ("cuda", torch.float32),
                        ("cuda", torch.bfloat16), ("torch", torch.bfloat16)):
        loss, _, grads = make_grad_fn(
            cfg, attn_impl=impl, **{**common, "compute_dtype": dtype})(
                params, batch)
        results[impl, dtype] = (loss.item(), [g.float() for g in _leaves(
            grads["projector"])])
        del grads
    ref_loss, ref_g = results["torch", torch.float32]
    g_scale = max(g.abs().max().item() for g in ref_g)

    def dist(key):
        loss, g = results[key]
        return abs(loss - ref_loss) / abs(ref_loss), max(
            (a - b).abs().max().item() for a, b in zip(g, ref_g)) / g_scale

    parity = {f"{impl}_{str(dt)[6:]}": dist((impl, dt))
              for impl, dt in results}
    del results, ref_g
    k32, kb, pb = (parity["cuda_float32"], parity["cuda_bfloat16"],
                   parity["torch_bfloat16"])
    if not (np.isfinite(ref_loss) and k32[0] <= LOSS_RTOL
            and k32[1] <= GRAD_RTOL and kb[0] <= LOSS_RTOL
            and kb[1] <= max(2 * pb[1], GRAD_RTOL)):
        raise AssertionError(f"align7b parity (loss rel, grad err / max) "
                             f"against the fp32 plain step: {parity}")
    log(f"align7b parity against the fp32 plain step (loss {ref_loss:.6f}, "
        f"projector grad max {g_scale:.4g}): {json.dumps(parity)}")

    step = make_train_step(cfg, tx, attn_impl="cuda", **common)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    state, m = step(state, batch)                 # warm-up; counts one step
    torch.cuda.synchronize(dev)
    launches = {k.name: k.launches for k in kernels}
    L = cfg.llm.n_layers
    tower_blocks = sum(v.depth - 1 for _, v in cfg.vision)
    expected = {"flash_fwd": 2 * L + tower_blocks, "flash_bwd_dq": L,
                "flash_bwd_dkv": L, "int4_matmul": 0}
    if launches != expected:
        raise AssertionError(f"align7b launches per step {launches} != "
                             f"{expected}")
    times, losses = [], []
    for _ in range(ALIGN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        vals = {k: v.item() for k, v in m.items()}   # ends in a sync
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(vals["loss"])
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"align7b: non-finite metrics {vals}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_s = float(np.median(times)) / 1e3
    profile = profile_step(lambda: step(state, batch)[1]["loss"].item(),
                           step_s * 1e3)
    log("align7b profile " + json.dumps(profile))

    # attn_impl="cuda_fused" beside the default "cuda": the dK/dV kernel
    # writes the fp32 dQ partials and no dQ kernel runs. Steps of the two
    # in turns (fused, cuda, cuda, fused, ...) on the same batch, then one
    # profiled fused step.
    step_fused = make_train_step(cfg, tx, attn_impl="cuda_fused", **common)
    for k in kernels:
        k.launches = 0
    state, m = step_fused(state, batch)           # warm-up; counts one step
    torch.cuda.synchronize(dev)
    fused_launches = {k.name: k.launches for k in kernels}
    if fused_launches != {**expected, "flash_bwd_dq": 0}:
        raise AssertionError(f"align7b cuda_fused launches per step "
                             f"{fused_launches}")
    turns = {"cuda_fused": [], "cuda": []}
    order = ["cuda_fused", "cuda", "cuda", "cuda_fused"] * ALIGN_STEPS
    for key in order[:2 * ALIGN_STEPS]:
        t0 = time.perf_counter()
        state, m = (step_fused if key == "cuda_fused" else step)(state, batch)
        loss = m["loss"].item()
        turns[key].append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            raise AssertionError(f"align7b {key}: loss {loss}")
    fused_med = float(np.median(turns["cuda_fused"]))
    fused = {"launches_per_step": fused_launches,
             **{f"{k}_step_ms": v for k, v in turns.items()},
             **{f"{k}_step_ms_median": float(np.median(v))
                for k, v in turns.items()},
             "profile": profile_step(
                 lambda: step_fused(state, batch)[1]["loss"].item(),
                 fused_med)}
    log("align7b cuda_fused " + json.dumps(fused))
    del step_fused
    B, P = ALIGN_B, cfg.num_patches
    F = ALIGN_TEXT + P
    tok_llm, tok_vis = B * F, B * (P + 8)
    # scripts/bench_train_step.py:377-400 (align: no trainable LLM, no
    # tower backward; full remat re-runs the forward)
    fwd = 2 * (n_llm * tok_llm + n_vis * tok_vis + n_proj * B * P)
    bwd = 2 * n_llm * tok_llm + 4 * n_proj * B * P
    attn = 4 * B * F * F * cfg.llm.dim
    flops_6nd = 6 * (n_llm * tok_llm + n_vis * tok_vis + n_proj * B * P)
    flops_hw = fwd + bwd + fwd + 3 * attn
    out = {"phase": "align7b", "params_b": (n_llm + n_vis + n_proj) / 1e9,
           "batch": B, "text_len": ALIGN_TEXT, "fused_seq": F,
           "init_s": init_s, "launches_per_step": launches,
           "loss_fp32_plain": ref_loss, "proj_grad_max": g_scale,
           "parity": parity,
           "step_ms": times, "step_ms_median": step_s * 1e3,
           "tokens_per_s": tok_llm / step_s, "peak_gb": peak_gb,
           "losses": losses, "profile": profile, "fused_bwd": fused,
           "bound_ms": flops_hw / BF16_FLOPS_PER_S * 1e3,
           "mfu_6nd": flops_6nd / step_s / BF16_FLOPS_PER_S,
           "mfu_hw": flops_hw / step_s / BF16_FLOPS_PER_S}
    log("align7b " + json.dumps(out))
    del state, step, params, tx, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def vla_train_phase(dev, kernels):
    """Emma-X's vla-train stage at full width, decoder cut to
    ``VLA_LAYERS``, through the GCOT data path and the discrete training
    loop, then a checkpoint round trip."""
    import dataclasses
    import shutil
    import tempfile

    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.gcot import (GCOTDataset, SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.prefetch import PrefetchingLoader
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.training.checkpointing import CheckpointManager
    from emmax_torch.training.loop import (LoopConfig, make_eval_fn,
                                           run_discrete_vla_training)
    from emmax_torch.training.metrics import (VLADiscreteMetrics,
                                              build_trackers)
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.solver import Solver
    from emmax_torch.vla.tokenizer import load_tokenizer

    base = emma_x_vlm_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=VLA_LAYERS))
    tokenizer = load_tokenizer(None)
    at = ActionTokenizer(tokenizer)
    dataset = GCOTDataset(make_dummy_gcot_items(4 * VLA_B), at, tokenizer,
                          SyntheticFrameSource(256),
                          data_mix="movement_policy", mask_inst=True)
    loader = BatchLoader(dataset, VLA_B, lambda s: collate_train(
        s, tokenizer.pad_id, max_length=cfg.llm.max_seq_len), seed=7)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    stage = stage_from_flags(True, False, False)
    tx, schedule = make_optimizer(params, learning_rate=2e-5,
                                  weight_decay=0.0, max_grad_norm=1.0,
                                  lr_scheduler_type="constant",
                                  total_steps=VLA_STEPS, stage=stage)
    state = create_train_state(params, tx)
    transforms = get_image_transforms("dinosiglip-vit-so-224px",
                                      "resize-naive")
    step_fn = make_train_step(
        cfg, tx, attn_impl="cuda", remat=True, compute_dtype=torch.bfloat16,
        transforms=transforms, stop_vision_gradient=True,
        freeze_mask=trainable_mask(params, stage),
        action_vocab_size=tokenizer.vocab_size)
    eval_fn = make_eval_fn(cfg, transforms=transforms, attn_impl="cuda",
                           compute_dtype=torch.bfloat16)
    n_train = sum(t.numel() for m, t in zip(
        _leaves(trainable_mask(params, stage)), _leaves(params)) if m)
    tmp = tempfile.mkdtemp(prefix="emmax_vla_train_")
    try:
        ckpt = CheckpointManager(tmp)
        metrics = VLADiscreteMetrics(build_trackers(["jsonl"], "vla-train",
                                                    tmp))
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        state = run_discrete_vla_training(
            vlm_cfg=cfg, state=state, train_step=step_fn,
            loader=PrefetchingLoader(loader, dev), metrics=metrics,
            loop_cfg=LoopConfig(epochs=1, max_steps=VLA_STEPS,
                                eval_every=VLA_STEPS, save_every=1000,
                                log_every=1),
            device=dev, tokenizer=tokenizer, solver=Solver(at),
            eval_fn=eval_fn, ckpt_manager=ckpt, lr_fn=schedule)
        torch.cuda.synchronize(dev)
        loop_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        losses = list(metrics.deques["loss"])
        if state.step != VLA_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"vla-train: step {state.step}, losses "
                                 f"{losses}")
        if "solver_action_accuracy" not in metrics.deques:
            raise AssertionError("vla-train: no Solver eval ran")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if launches[name] == 0:
                raise AssertionError(f"vla-train launched no {name}")
        path = ckpt.latest()
        ckpt_gb = sum(f.stat().st_size for f in path.iterdir()) / 1e9
        t0 = time.perf_counter()
        restored = ckpt.restore(path, device="cpu")
        restore_s = time.perf_counter() - t0
        same = restored.step == state.step and (
            restored.opt_state["count"] == state.opt_state["count"])
        for a, b in zip(_leaves(state.params), _leaves(restored.params)):
            same = same and torch.equal(a.cpu(), b)
        for key in ("mu", "nu"):
            for a, b in zip(state.opt_state[key], restored.opt_state[key]):
                same = same and ((a is None and b is None)
                                 or torch.equal(a.cpu(), b))
        if not same:
            raise AssertionError(f"vla-train: checkpoint {path.name} does "
                                 f"not restore the saved state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "vla-train", "decoder_layers": VLA_LAYERS,
           "params_b": _count(params) / 1e9, "trainable_b": n_train / 1e9,
           "batch": VLA_B, "steps": VLA_STEPS, "losses": losses,
           "step_times_s": list(metrics.step_times), "loop_s": loop_s,
           "launches": launches, "peak_gb": peak_gb,
           "checkpoint": path.name, "checkpoint_gb": ckpt_gb,
           "restore_s": restore_s, "restored_equal": True,
           "solver_action_accuracy":
               list(metrics.deques["solver_action_accuracy"])}
    log("vla-train " + json.dumps(out))
    del state, restored, params, tx, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops import int4_matmul
    from emmax_torch.ops import paged_attention as pa
    from emmax_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = [fa.KERNEL, fa.DQ_KERNEL, fa.DKV_KERNEL, int4_matmul.KERNEL]
    serving_kernels = [fa.KERNEL, int4_matmul.KERNEL, pa.KERNEL]
    t0 = time.perf_counter()
    secs = build_all(kernels + [pa.KERNEL])
    log(f"built {secs} in {time.perf_counter() - t0:.1f} s (parallel)")
    for k in (fa.KERNEL, fa.DQ_KERNEL, int4_matmul.KERNEL, pa.KERNEL):
        log(f"--- nvcc {k.source}\n{k.build_log.strip()}")
    log("flash_bwd.cu ptxas " + json.dumps(ptxas_usage(fa.DQ_KERNEL.build_log)))
    bwd_res = bwd_resources(fa.DQ_KERNEL)
    log("flash_bwd bf16 D128 resources " + json.dumps(bwd_res))
    flash, int4 = kernel_phase(dev)
    train_kernels = training_kernel_phase(dev)
    paged_kernels = paged_kernel_phase(dev)
    if "--kernels-only" in argv:
        return 0
    log_phase("tiny_parity")
    tiny_parity(dev)
    tiny_steps = tiny_batched_parity(dev)
    log_phase("run_path")
    bf16 = run_path(dev, None, kernels)
    if bf16["launches"]["flash_fwd"] == 0:
        raise AssertionError("bf16 path launched no flash_fwd kernel")
    q4 = run_path(dev, "int4", kernels)
    for name in ("flash_fwd", "int4_matmul"):
        if q4["launches"][name] == 0:
            raise AssertionError(f"int4 path launched no {name} kernel")
    log_phase("batched_phase")
    batched = batched_phase(dev, serving_kernels)
    log("batched serving " + json.dumps({"tiny_steps": tiny_steps,
                                         "runs": batched}))
    log_phase("align7b_phase")
    align = align7b_phase(dev, kernels)
    log_phase("vla_train_phase")
    vla = vla_train_phase(dev, kernels)
    log("training " + json.dumps({"align7b": align, "vla_train": vla}))

    def entry(rec, kernel, replaces, launches, **extra):
        return {"name": kernel.name, "route": "cuda",
                "source": f"emmax_torch/csrc/{kernel.source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], **extra}

    by_name = {r["name"]: r for r in train_kernels[:4]}   # Llama training
    step = align["launches_per_step"]
    prefill = flash[-1]                       # the Llama prefill shape
    entries = [
        entry(by_name["flash_fwd_lse"], fa.KERNEL,
              "emmax_tpu/ops/flash_attention.py:202", step["flash_fwd"],
              launches_path="align7b train step",
              serving={"shape": prefill["shape"], "ms": prefill["ms"],
                       "plain_ms": prefill["plain_ms"],
                       "library_ms": prefill["library_ms"],
                       "bound_ms": prefill["bound_ms"],
                       "launches_int4_path": q4["launches"]["flash_fwd"]}),
        entry(by_name["flash_bwd_dq"], fa.DQ_KERNEL,
              "emmax_tpu/ops/flash_attention.py:395", step["flash_bwd_dq"],
              launches_path="align7b train step",
              **bwd_res["tc::dq_kernel<128>"]),
        entry(by_name["flash_bwd_dkv"], fa.DKV_KERNEL,
              "emmax_tpu/ops/flash_attention.py:445",
              step["flash_bwd_dkv"], launches_path="align7b train step",
              **bwd_res["tc::dkv_kernel<128, false>"],
              fused={**{k: by_name["flash_bwd_dkv_fused"][k] for k in
                        ("ms", "eager_ms", "max_abs_err", "bound_ms",
                         "bound_by", "dq_partial_sum_ms")},
                     **bwd_res["tc::dkv_kernel<128, true>"]}),
        entry(int4[1], int4_matmul.KERNEL,
              "emmax_tpu/ops/int4_matmul.py:404",
              q4["launches"]["int4_matmul"],
              launches_path="int4 serving requests"),
        entry(paged_kernels[1], pa.KERNEL, "emmax_tpu/serving/paged.py:362",
              batched["paged kernel int8"]["launches"]["paged_attention"],
              launches_path="full-width paged kernel run (int8 pages), "
                            "one burst of 64 steps",
              library_note=paged_kernels[1]["library_note"],
              bf16_pages={k: paged_kernels[0][k] for k in
                          ("ms", "plain_ms", "library_ms", "bound_ms",
                           "max_abs_err")},
              gqa={k: paged_kernels[2][k] for k in
                   ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err")}),
    ]
    log_phase("report")
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
