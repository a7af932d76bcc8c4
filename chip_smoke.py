#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``emmax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (one card)
    python3 chip_smoke.py --kernels-only   # build + kernel checks only

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. build both hand-written kernels from ``emmax_torch/csrc`` (one ``nvcc``
   per source, started together);
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
   each phase's device busy time, and each phase's bound.

The line before the last is the card's name and power limit; the one
before it a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from emmax_torch.ops import flash_attention, int4_matmul
    from emmax_torch.ops.cuda_build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = [flash_attention.KERNEL, int4_matmul.KERNEL]
    t0 = time.perf_counter()
    secs = build_all(kernels)
    log(f"built {secs} in {time.perf_counter() - t0:.1f} s (parallel)")
    for k in kernels:
        log(f"--- nvcc {k.source}\n{k.build_log.strip()}")
    flash, int4 = kernel_phase(dev)
    if "--kernels-only" in argv:
        return 0
    tiny_parity(dev)
    bf16 = run_path(dev, None, kernels)
    if bf16["launches"]["flash_fwd"] == 0:
        raise AssertionError("bf16 path launched no flash_fwd kernel")
    q4 = run_path(dev, "int4", kernels)
    for name, n in q4["launches"].items():
        if n == 0:
            raise AssertionError(f"int4 path launched no {name} kernel")
    flash_main = flash[-1]                   # the Llama prefill shape
    int4_main = int4[1]                      # decode M=1, w_gate/w_up
    entries = []
    for rec, kernel, replaces in (
            (flash_main, flash_attention.KERNEL,
             "emmax_tpu/ops/flash_attention.py:156"),
            (int4_main, int4_matmul.KERNEL,
             "emmax_tpu/ops/int4_matmul.py:374")):
        entries.append({
            "name": rec["name"], "route": "cuda",
            "source": f"emmax_torch/csrc/{kernel.source}",
            "replaces": replaces, "launches": q4["launches"][kernel.name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"]})
    print(json.dumps({"kernels": entries}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
