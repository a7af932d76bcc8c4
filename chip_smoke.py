#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``emmax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase (one card)
    python3 chip_smoke.py --kernels-only   # build + kernel checks only

Phases, each raising on failure (the script then exits non-zero):

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. build the four hand-written kernel sources from ``emmax_torch/csrc``
   (one ``nvcc`` per source, started together);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes: flash-attention forward for DINOv2 and SigLIP (batch 1,
   a served frame, and batch 6, an admission's frames), the Llama prefill
   (left-padded, into the whole cache), the Llama training shape and the
   speculative engine's tail refresh (24 queries at q_offset F - 24 into
   the closed loop's whole cache); int4 matmul at M = 1, 6, 13 and 43 (the
   speculative verifier's linear and (7, 5)-tree chunks), 24 (the tail
   refresh), 48 and the prefill length for every Llama-2-7B weight shape,
   through the stacked view. The flash forward runs bf16 on
   the bf16 tensor-core kernel and fp32 on the 3xTF32 one (exact zeros
   and the LSE sentinel on rows that see no key, the same bits on a rerun,
   in both); the int4 matmul's bf16 x the tensor-core kernel, fp32 x the
   scalar one. Each is timed
   in the dtype the main path gives it (the towers run in fp32, as in
   JAX; the decoder in bf16). Max error against the
   stated tolerance; kernel, plain and library
   (``scaled_dot_product_attention``; ``torch._weight_int4pack_mm`` on
   the weight repacked outside the timed calls) device times from CUDA
   events over a captured CUDA graph, and the kernel's eager time per
   call; the bound (bytes over 3.35 TB/s or operations over the peak for
   their dtype, whichever is larger; the 3xTF32 forward's fp32 operations
   count three times over the TF32 peak, with one over the fp32 peak
   beside it);
4. the tiny config on the card (fp32, through the kernels) against the
   same weights on the CPU (plain versions): identical greedy tokens;
   4c. ``hub``: a tiny run dir (fp32, vocab 32064, seeded) exported by
   ``python -m emmax_torch.convert_weights --mode export_hf`` on this
   machine, which has no ``transformers`` (the six files of the JAX
   exporter and the ``csrc/`` copy written), loaded from the export
   directory alone through the port's facade (``EmmaXForVision2Seq`` /
   ``EmmaXProcessor.from_pretrained``) on the card and on the CPU:
   ``predict_action`` gives the same action, the card's through the fp32
   flash forward (launches counted); then ``verify_emmax.main`` on the
   export (bf16 and fp32 on the card). The standalone bundle's own kernel
   build (``modeling_emmax.py`` building ``flash_fwd.cu`` from the export's
   ``csrc/``) runs outside the smoke, ``scripts/chip_standalone_bundle.py``;
   4b. the tiny config with an action-bin region (vocab 2048) on the
   ``SpeculativeEngine`` (linear drafts, the (5, 3) tree, ``draft_layers=1``,
   the int8 cache; each over three closed-loop frames with prefix tail 24):
   the CPU plain engine's tokens exactly, the CPU speculative engine's
   steps and prefill kinds;
5. Emma-X at full width (random weights from a seeded generator):
   ``load_vla("prism-dinosiglip-224px+7b")`` with bf16 weights and then
   with int4 weights, a few ``generate_actions`` requests each on 256x256
   frames; per request vision-encode / prefill ms, decode tok/s, peak
   memory, and each kernel's launches in that path's run (counts set to 0
   just before, read just after; a kernel of the path with no launch
   fails the run, and the towers' fp32 forward must launch depth - 1
   times per tower in every encode of that run); then one shorter request under ``torch.profiler`` for
   each phase's device busy time, and each phase's bound;
5b. ``checkpoint``: phase 5's seeded full-width bf16 params written by
   ``emmax_torch.convert_weights`` as OpenVLA-layout safetensors (shards of
   at most 5 GB, the index, config.json in ``EmmaXVLAConfig``'s layout
   with ``norm_stats``, the Hub processor and remote-code files) into
   a temporary directory and served back through ``load_vla(dir)``: in
   bf16 every leaf equal to the params in memory, the in-memory model's
   greedy tokens and text, the written statistics; with
   ``quantize="int4"`` (the loader converts the tree on the host and
   quantizes each stacked leaf on the card, one layer moved at a time)
   the tree equal to the params in memory quantized on the card (phase
   5's route; the codes and scales that differ are printed), that model's
   tokens, the launch gates of a request (fp32 flash
   forward depth - 1 per tower, the bf16 one once per decoder layer, int4
   on all 7 weights of every layer and the lm_head in every forward), and
   the load's device peak under the int4 tree plus one bf16 stacked leaf;
   then a reference ``.pt`` loaded back bit for bit; a
   run dir of the trainer's ``--smoke_test`` on the card giving the same
   tokens on the card and the CPU; and ``--pretrained_checkpoint`` at the
   vla-train cut (``VLA_LAYERS``): the trainer's conversion of a ``.pt``
   equal to the params in memory, with the same step-0 loss and projector
   gradient. A bf16 load's host heap (malloc's bytes in use) grows by
   less than one bf16 stacked leaf (no host copy of the tree). Export and
   load seconds, host RSS and heap peaks and the device peak are printed;
6. training kernels (in phase 3's call): the forward's LSE, dQ and dK/dV
   (separate and fused) against the plain backward at the Llama training
   shape (B2, fused 448, H32, D128, causal, one row right-padded) and the
   DINOv2 / SigLIP shapes (B2, bidirectional), each in bf16 (the bf16
   tensor-core kernels) and in fp32 (the 3xTF32 kernels, the bound
   counting three TF32 products with one at the fp32 peak beside it), with
   device and eager ms, bounds and ``scaled_dot_product_attention``
   forward and backward through autograd as the library time; the
   tensor-core kernels' (forward and backward, bf16 and 3xTF32; int4) and
   the paged kernels' registers, spills and shared memory from the
   ``-Xptxas -v`` build log and the sources' ``*_smem_bytes`` entries;
7. ``align7b``: the full 7B (full width and depth) in the align stage
   (towers and Llama frozen, projector trained; B2, text 192 -> fused
   448; full remat; bf16 compute on fp32 master params; constant LR): one
   step's loss and projector gradient through the kernels against the
   plain path from the same state, each kernel's launches in one step
   (dQ = dK/dV = 32; the forward twice per layer plus the towers' 49),
   then a few steps on one batch: step ms, tokens/s, peak memory, and
   the step's share of the bf16 peak by ``scripts/bench_train_step.py``'s
   accounting (the launch gate counts by dtype: every launch bf16); then steps under ``attn_impl="cuda_fused"`` (the dK/dV
   kernel's dQ partials, no dQ kernel; launches checked) and "cuda" in
   turns, and one profiled fused step;
7b. ``pretrain``: ``python -m emmax_torch.pretrain`` driven in-process
   (``pretrain.build`` with an ``image_loader`` of seeded 375x500 uint8
   frames, then ``pretrain.run``) over a LLaVA-format chat JSON of 48
   examples, every 4th text-only. The align stage at full width, batch 16,
   2 epochs, ``--cache_vision``: the split-modality batches are
   modality-pure and cover every example each epoch; the tower encodes
   equal the count the images' content keys predict (epoch 1: none, the
   towers released); the per-step losses equal an uncached run's over
   the same batches from the same state (``PT_CACHE_RTOL``); the loader
   reads the state's tower tensors (``data_ptr``) and keeps no device
   bytes after the run; launches per step by dtype (cached: the bf16
   forward twice per layer, dQ and dK/dV once; uncached: plus the towers'
   49) and per encode (49). Then the finetune stage for 2 steps at
   vla-train's cut (``VLA_LAYERS``): the first step's loss against the
   plain fp32 loss (``LOSS_RTOL``) and its launches. Step, encode and
   checkpoint times, cache bytes and device peaks are printed; each
   checkpoint is removed after its save is measured;
8. the paged-attention kernel (in phase 3's call, so ``--kernels-only``
   runs it) against its plain version at the batched engines' shape (B6,
   H32, hd 128, page size 128, 6 pages per row, ragged lengths 1 / 127 /
   128 / 129 / 458 / 768 on non-contiguous pages) with bf16 pages, int8
   pages and one GQA case (KV 8, G 4), split into ``splits(6, 128)`` page
   ranges; the same bits on a rerun, and a CUDA graph of one call that,
   replayed after the lengths change on the device, equals the eager call
   on the new lengths; device and eager ms, plain ms, the
   bound (the valid tokens' K/V bytes and scales, q and out over 3.35
   TB/s) and, as the library time, ``scaled_dot_product_attention`` on the
   K/V gathered to a dense layout outside the timed region;
9. batched serving, tiny config: ``PagedServingEngine(paged_attn=
   "kernel")`` on the card gives the CPU engine's greedy tokens (fp32,
   int8 pages off and on), and so do the plain modes "gather2",
   "pagescan" and "poolmask" (every token; the third request runs beside
   an empty slot), and the card's kernel decode step agrees with
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
   then the plain modes "gather2", "pagescan" and "poolmask" on int8
   pages (``paged_modes_full``): each one's first decode step on one
   admitted pool against "gather"'s (logits within ``EVAL_PAGED_RMSE``:
   1e-6 for gather2, 5e-2 for the others; the kernel's distance printed
   beside), and one batch of the six requests of ``EVAL_PAGED_NEW``
   tokens in one burst each (aggregate tokens/s, admission and burst ms,
   launches);
11. ``vla-train``: full width with the decoder cut to ``VLA_LAYERS`` (4)
   of 32 layers (a cut of memory: fp32 master, gradients and AdamW moments
   of a 32-layer decoder do not fit one card; 8 layers until the pretrain
   phase's checkpoints needed the time), GCOT records and synthetic frames
   through ``GCOTDataset`` -> ``collate_train`` -> the prefetching loader
   -> ``run_discrete_vla_training`` with AdamW over the LLM and the
   projector, a Solver eval, and a checkpoint saved to a temporary
   directory, restored, and held equal to the live state;
12. ``vla-full-train-fp32``: Emma-X's own stage (``stage_from_flags(False,
   False, False)``: towers, projector and LLM trained) in fp32 compute, as
   ``emmax_torch/train.py`` runs it without mixed precision; the same cut
   and batch as phase 11 through ``GCOTDataset`` -> ``collate_train``, full
   remat: one step's loss and tower / projector / decoder-layer gradients
   through the kernels against the plain path from the same params and
   batch (tolerances stated at ``FULL_LOSS_RTOL``), the fp32 kernels'
   launches in one step by dtype (forward 2 per decoder layer + 49 tower
   blocks, dQ and dK/dV 1 each), then optimizer steps: finite losses,
   step ms, peak memory, and one profiled step.

10b. ``speculative``: Emma-X at full width with int4 weights on the
   closed-loop ``SpeculativeEngine`` at ``bench.py:370-382``'s settings
   (draft_k 12, the (7, 5) action tree, the int8 cache, prefix tail 24, a
   vision cache of 4 at 0.05): a warm-up and a timed episode of 12 frames
   of 96 forced GCOT tokens built as ``bench.py:286-338`` builds them;
   each frame reproduces its stream in the verifier steps of
   ``scripts/sim_spec_drafts.simulate_steps`` on the same stream and
   history, prefills in full only where its patches change and refreshes
   the prompt tail elsewhere, and launches the bf16 flash forward once per
   decoder layer and the fp32 one only on a vision-cache miss; ms per
   frame (cold, warm median), verifier forwards per token, peak memory,
   the device-busy share of one profiled warm frame. Then ``load_vla(...,
   speculative=True)`` -> ``generate_actions`` over 3 closed-loop frames
   under int4 and then bf16 weights beside the plain ``EmmaXVLA``: request
   ms, the bf16 fence's verdict, and the same tokens or, at the first
   difference, a printed near-tie (``free_run``).

12b. ``rlds``: the RLDS data path with no TensorFlow, OpenCV or PIL:
   ``RLDS_EPISODES`` synthetic BridgeV2-shaped episodes (24-40 steps of
   256x256 frames encoded by the port's JPEG encoder at quality 95,
   proprio and actions of width 7 with a 0/1 gripper) written by the
   port's TFRecord writer into a train and a val shard; one state at
   vla-train's cut and batch drives (a) ``RLDS_GCOT_STEPS`` steps of
   ``run_discrete_vla_training`` over ``GCOTDataset`` records that the
   port's GCOT pipeline generates from the same shards
   (``gcot_generate_plans.main``: soft segmentation through the port's
   HDBSCAN and the ``HeuristicAnnotator``; ``gcot_create_dataset.main`` in
   ``single_policy`` mode; each episode kept or dropped as its segments
   predict (the reference drops one whose clustering returns to an
   earlier cluster), sum(T - 1) samples over the kept ones, each
   ``current_image_path`` a frame of ``RLDSFrameSource.index``; segment
   counts and generation seconds printed) with frames through
   ``RLDSFrameSource`` (IFAST decode), and (b)
   ``RLDS_VLA_STEPS`` steps of ``run_vla_training`` over
   ``get_vla_dataset_and_collator(..., "bridge_orig", image_aug=True,
   resize_resolution=(224, 224))`` through ``StreamingBatcher`` and the
   prefetching loader, with a Solver eval; each loop's losses finite and
   each training kernel launched; then ``pack_rlds_to_framestore`` with
   every stored frame (ISLOW) equal to the RLDS frame decoded with ISLOW,
   and two passes of the stream with one seed giving equal batches.
   Printed: frames decoded per second on one thread and by the store's
   batch decode, host ms to assemble a batch against the step's ms, and
   each step's wait for data. No checkpoint is written. 25-35 s on
   the H100.

12c. ``eval``: robot evaluation (``eval_phase``): (a) the tiny model
   (fp32, vocab 1024; weights drawn once on the host) through
   ``evaluate_policy(VLAEnvPolicy)`` on the card and on the CPU, one task,
   ``EVAL_TINY_STEPS`` steps: the same texts, actions, frames and report;
   (b) ``load_vla("prism-dinosiglip-224px+7b")`` in bf16 (phase 5's
   seed) through ``evaluate_policy(VLAEnvPolicy)`` on the four tasks of
   the kinematic world, one episode of ``EVAL_TASK_STEPS`` steps each at
   its 128 px frames, ``EVAL_NEW`` new tokens a decode, then
   ``run_closed_loop`` on ``DummyEnv``'s 256 px frames for
   ``EVAL_LOOP_STEPS`` actions with the ``GripperLocator`` and no
   detector: every decode launches the fp32 flash forward depth - 1 times
   a tower and the bf16 one once a decoder layer (read just before and
   just after it), and each env takes exactly the steps asked for;
   printed: per-decode ms (median, maximum; host clock, synced), one
   decode's encode / prefill / decode ms (the engine's CUDA events), host
   ms per env step outside the decode, actions per second, the device
   peak; then one int4 episode (``quantize="int4"``, the first task, the
   same steps and tokens; the int4 kernel on 7 weights a layer and the
   lm_head in every forward of every decode); (c) ``python -m
   emmax_torch.eval_success_rate``'s ``scripted``
   mode (1.0 on every task) and ``fixture`` -> ``gt_replay`` (1.0), host
   only, through the port's JPEG codec and TFRecord reader and writer.
   Random weights score 0 by construction: the success rate is not a
   result. One ``eval {...}`` line.

13. ``multigpu``: the multi-GPU path (``emmax_torch.parallel``) at world
   size 1: a NCCL process group of one rank joined in-process
   (``initialize_distributed``, 127.0.0.1 and a free port) and the (1, 1,
   1) mesh on "cuda". The full 7B align step through
   ``make_train_step(..., mesh=mesh)`` on ``shard_params`` of the params
   (no leaf copied) against the unwrapped step from the same state: loss,
   grad norm, projector gradient and update within ``MESH_RTOL`` (0
   expected), the same launches (113 / 32 / 32, all bf16), the wrapped
   step's device peak minus the unwrapped one's, step ms in turns;
   vla-train's ``VLA_LAYERS`` cut for ``MESH_VLA_STEPS`` steps through
   ``run_discrete_vla_training(mesh=)`` against the unwrapped run's
   losses, with the mesh's checkpoint save (rank 0 writes the gathered
   tree) and restore (every rank's blocks) held equal to the live state;
   one 64-token request of ``ServingEngine`` on the sharded bf16 tree with
   the unsharded engine's tokens and launches (49 fp32 + 32 bf16 flash
   forwards). The group is destroyed at the end.

14. ``zoo``: the Prismatic backbones beyond Emma-X's (``models/
   materialize.py``) at full width and depth on seeded random weights made
   on the card, each model freed before the next is built (peak bytes
   each): (a) the seven new vision backbones (CLIP-L, CLIP-L/336,
   SigLIP-384, DINOv2-L, IN1K-L, DINO + CLIP-336, DINO + SigLIP-384), one
   preprocessed 256x256 frame each, encoded in fp32 through the kernels
   against the plain path (``ZOO_TOWER_RTOL``; patch count; depth - 1
   fp32 forwards a tower); (b) ``phi-2+3b`` (CLIP-L/336 + Phi-2): a bf16
   and an int4 request of ``ZOO_NEW`` tokens through ``load_vla`` ->
   ``generate_actions`` (launch gates: 23 fp32 forwards an encode, 32 bf16
   in the prefill, int4 on w{q,k,v,o}, w1, w2 and the biased lm_head in
   every forward), the prefill's logits kernel vs plain (``BF16_RTOL``)
   and the greedy tokens equal up to the plain path's first near-tie,
   and one align step at B2 (loss and projector gradient against the
   plain path, as align7b; launches 87 / 32 / 32, the D 80 training
   kernels); (c) ``llama2+13b`` (40 heads at D 128) in bf16; (d)
   ``mistral-v0.1+7b`` (GQA, 8 KV heads) in bf16 and int4 (``wk`` / ``wv``
   at 4096 -> 1024); then each kernel at the zoo's shapes against its
   plain version, timed (the towers' 577 / 729 / 734 tokens in fp32, Phi's
   prefill and training shapes at D 80, int4 at Phi's and Mistral's
   weights). One JSON line.

Phases 4b, 4c, 5b, 10b, 7, 7b, 11, 12, 12b, 12c, 13 and 14 run after phase 10 (4b and
4c with phase 4, 5b with phase 5); ``--kernels-only`` skips them. The line
before the last is the card's name and power limit; the one before it a
JSON object with one entry per kernel; the last line is
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
TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor-core peak
MODEL_ID = "prism-dinosiglip-224px+7b"
TASK = "put the carrot in the pot"
MAX_NEW = 64
REQUESTS = 3                   # timed requests per path, after one warm-up
PROFILE_TOKENS = 16            # the profiled request's max_new_tokens
# bf16: kernel and plain version round at different places: the flash
# forward rounds each tile's unnormalised P, the plain version the
# normalised probabilities; the backward takes P in bf16 for dV where the
# plain version keeps it in fp32; the plain int4 rounds the dequantized
# weight to bf16, the kernel does not. Both round the output to bf16.
# Held relative to the largest |reference| value.
BF16_RTOL = 2e-2
FP32_RTOL = 1e-4               # the same inputs in fp32: summation order only
# align7b (scripts/bench_train_step.py --config align7b): batch 2, text
# bucket 192 -> fused 448; the last row right-padded by ALIGN_PAD tokens
ALIGN_B, ALIGN_TEXT, ALIGN_PAD = 2, 192, 40
ALIGN_STEPS = 3                # timed steps after one warm-up step
# align7b parity, kernels vs plain from one state: the loss, and the
# projector gradient relative to its largest entry
LOSS_RTOL, GRAD_RTOL = 1e-2, 2e-2
VLA_LAYERS = 4                 # vla-train: decoder cut to 4 of 32 layers
VLA_B, VLA_STEPS = 4, 3
# vla-full-train-fp32 (the same cut and batch): optimizer steps, the first
# counted; kernels vs plain in fp32 from one state: the loss, relative
# (one fp32 forward, sums in another order), and each group's gradient
# relative to its largest entry (the backward through the decoder layers and
# 23 / 26 tower blocks compounds the ~1e-6 of each attention call)
FULL_STEPS = 3
FULL_LOSS_RTOL, FULL_GRAD_RTOL = 1e-5, 1e-3
# batched serving (bench.py:606-677): six requests of 64 new tokens
PAGED_REQUESTS, PAGED_NEW = 6, 64
PAGED_KW = dict(num_slots=6, n_pages=34, page_size=128,
                max_pages_per_slot=6, burst=64)
PAGED_LENGTHS = (1, 127, 128, 129, 458, 768)   # kernel check, ragged rows
SHARED_QUERIES, SHARED_NEW = 4, 8
PROFILE_BURST = 8              # the profiled burst's length, in steps
# the closed loop (bench.py:69-73,370-382): 12 frames of 96 forced GCOT
# tokens (8 actions of 7 bins and ~40 of text); draft_k 12, the (7, 5)
# action tree, the int8 cache, prefix tail 24, a vision cache (4, 0.05)
SPEC_FRAMES, SPEC_TOKENS, SPEC_ACTIONS = 12, 96, 8
TAIL = 24
SPEC_KW = dict(draft_k=12, prefix_tail=TAIL, quantized_cache=True,
               action_tree=(7, 5))
SPEC_W_LINEAR, SPEC_W_TREE = 13, 43   # verifier widths: 12 + 1, 1 + 7 + 35
SPEC_PROFILE_FRAME = 2
FREE_FRAMES = 3                # the free runs' closed-loop frames
# pretrain (``python -m emmax_torch.pretrain``): a LLaVA-format chat JSON of
# PT_EXAMPLES, every PT_TEXT_EVERY-th text-only; seeded uint8 frames of
# PT_FRAME (the typical LAION / COCO size of LLaVA-558k); the align stage
# at full width for PT_EPOCHS epochs at batch PT_BATCH (the reference's
# per-device batch; its global batch is 256) with --cache_vision, then
# PT_FT_STEPS finetune steps at the vla-train cut (VLA_LAYERS)
PT_EXAMPLES, PT_TEXT_EVERY, PT_FRAME = 48, 4, (375, 500, 3)
PT_BATCH, PT_EPOCHS, PT_FT_STEPS = 16, 2, 2
# an uncached align run against the cached one: the same per-step losses
# (the loader encodes as the step does: bit-equal expected)
PT_CACHE_RTOL = 1e-6
# multigpu: wrapped against unwrapped at world size 1, relative (the same
# kernels on the same tensors: 0 expected); vla-train steps through the mesh
MESH_RTOL = 1e-6
MESH_VLA_STEPS = 2
# rlds: synthetic BridgeV2-shaped episodes (256x256 JPEG at quality 95,
# proprio and actions of width 7), a train and a val shard, at vla-train's
# cut and batch
RLDS_EPISODES, RLDS_VAL, RLDS_STEPS_RANGE = 8, 2, (24, 40)
RLDS_GCOT_STEPS, RLDS_VLA_STEPS, RLDS_SHUFFLE = 2, 3, 64
# hub: the tiny model exported (fp32, the hermetic tokenizer's padded vocab)
# and served from the export directory; verify_emmax's new tokens
HUB_VOCAB, HUB_VERIFY_NEW = 32064, 16
HUB_STATS = {"bridge_orig": {"action": {
    "q01": [-0.05] * 6 + [0.0], "q99": [0.05] * 6 + [1.0],
    "mask": [True] * 6 + [False]}}}
HUB_FILES = {"model.safetensors", "config.json", "preprocessor_config.json",
             "modeling_emmax.py", "configuration_emmax.py",
             "processing_emmax.py"}
# zoo: the Prismatic backbones beyond Emma-X's (emmax_torch/models/
# materialize.py): the new vision backbones' encodes, phi-2+3b served and
# trained, llama2+13b and mistral-v0.1+7b served; ZOO_NEW new tokens a
# request. Towers kernel vs plain in fp32: the features relative to their
# largest entry (the 3xTF32 attention's ~2e-6 a call through 23-26 blocks)
ZOO_TOWERS = ("clip-vit-l", "clip-vit-l-336px", "siglip-vit-so400m-384px",
              "dinov2-vit-l", "in1k-vit-l", "dinoclip-vit-l-336px",
              "dinosiglip-vit-so-384px")
ZOO_PHI, ZOO_13B, ZOO_MISTRAL = "phi-2+3b", "llama2+13b", "mistral-v0.1+7b"
ZOO_NEW = 32
ZOO_TOWER_RTOL = 1e-4
# eval: (a) the tiny model card vs CPU through evaluate_policy: one task,
# EVAL_TINY_STEPS steps, EVAL_TINY_NEW new tokens a decode; (b) full-width
# Emma-X (bf16) on every task of the kinematic world, 1 episode of
# EVAL_TASK_STEPS steps each at the evaluator's 128 px frames, EVAL_NEW new
# tokens a decode, then run_closed_loop for EVAL_LOOP_STEPS actions on
# 256 px frames. (d) the paged engine's plain modes: on the int4 model,
# six requests of EVAL_PAGED_NEW new tokens on int8 pages in one burst;
# the first decode step's logits held to "gather"'s (relative RMSE) within
# EVAL_PAGED_RMSE[mode]. gather2 computes gather's bf16 values in the same
# order (0.0 apart in two card runs), so it is held to 1e-6. pagescan
# (fp32 online softmax over fp32-dequantized pages) and poolmask (int8
# scales folded into the fp32 scores and probabilities) round in other
# places than gather's bf16-dequantized rows, and 32 random layers amplify
# that: both read 2.6-2.7% in two card runs, as did the paged kernel
# beside them, so 5e-2 leaves less than twice that. Their exact check is
# the tiny config's, card against CPU, every token
EVAL_TINY_STEPS, EVAL_TINY_NEW = 4, 16
EVAL_TASK_STEPS, EVAL_NEW, EVAL_LOOP_STEPS = 3, 32, 2
EVAL_PAGED_MODES = ("gather2", "pagescan", "poolmask")
EVAL_PAGED_NEW = 16
EVAL_PAGED_RMSE = {"gather2": 1e-6, "pagescan": 5e-2, "poolmask": 5e-2}


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


def _template_args(s: str) -> list:
    """``float, int8, 4, 16`` from the mangled ``faLi4ELi16E``; a
    substitution (``S1_``, a type named before) repeats the last type."""
    out, last = [], None
    while s:
        m = re.match(r"Li(-?\d+)E", s)
        if m:
            out.append(m.group(1))
            s = s[m.end():]
            continue
        m = re.match(r"(\d+)", s)
        if m:
            name = s[m.end():m.end() + int(m.group(1))]
            last = {"__nv_bfloat16": "bf16"}.get(name, name)
            s = s[m.end() + len(name):]
        elif re.match(r"S\d*_", s):
            s = s[re.match(r"S\d*_", s).end():]
        else:
            last = {"f": "float", "a": "int8"}.get(s[0], s[0])
            s = s[1:]
        out.append(last)
    return out


def _kernel_name(mangled: str) -> str:
    """``tc::dkv_kernel<128, true>`` (or ``tc::int4_tc_kernel<8, 1, 4,
    true>``) for a tensor-core kernel's mangled name; other names as they
    are."""
    m = re.search(r"tc\d+int4_tc_kernelI((?:L[ib]\d+E)+)E", mangled)
    if m:
        args = [v if k == "i" else ("true" if v == "1" else "false")
                for k, v in re.findall(r"L([ib])(\d+)E", m.group(1))]
        return f"tc::int4_tc_kernel<{', '.join(args)}>"
    m = re.search(r"paged_attention_cu_\w+?\d+(split_kernel|merge_kernel)"
                  r"I(.*?)EEv", mangled)
    if m:
        return f"paged::{m.group(1)}<{', '.join(_template_args(m.group(2)))}>"
    m = re.search(r"(tc|tf32)\d+(dq_kernel|dkv_kernel|fwd_kernel)"
                  r"ILi(\d+)E(?:Lb([01])E)?", mangled)
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


def kernel_resources(kernel, smem_symbol: str, entries: dict) -> dict:
    """Registers per thread, spill bytes and shared memory per block
    (static from ptxas, dynamic from the source's ``smem_symbol`` entry
    point called with the entry's arguments) of each named kernel."""
    usage = ptxas_usage(kernel.build_log)
    f = getattr(ctypes.CDLL(str(kernel.library_path())), smem_symbol)
    f.restype = ctypes.c_int
    out = {}
    for name, args in entries.items():
        u = usage.get(name, {})
        f.argtypes = [ctypes.c_int] * len(args)
        out[name] = {"registers": u.get("registers"),
                     "spill_bytes": u.get("spill_bytes"),
                     "smem_bytes": f(*args) + u.get("static_smem", 0)}
    return out


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def spec_shape(tokenizer, num_patches: int) -> tuple:
    """(prompt tokens, bucket, fused length, cache slots) of a closed-loop
    frame at ``SPEC_KW``'s settings (``SpeculativeEngine.generate_ids``)."""
    from emmax_torch.serving.engine import _round_up, pick_bucket

    n = len(tokenizer.encode(spec_prompt(0)))
    bucket = pick_bucket(n)
    return n, bucket, num_patches + bucket, _round_up(
        num_patches + bucket + SPEC_TOKENS + SPEC_W_TREE)


def spec_prompt(f: int) -> str:
    """``bench.py:337``: the closed loop's prompt at frame f; the gripper
    coordinates move and keep their width (and so the prompt's length)."""
    return ("In: What action should the robot take to achieve the "
            "instruction\nINSTRUCTION: \nPut the eggplant in the "
            f"pot\nCURRENT GRIPPER: [{104 + 2 * f:03d}, {98 + f:03d}]\nOut:")


def prefill_shape(tokenizer, num_patches: int) -> tuple:
    """(prompt tokens, bucket, fused length, cache slots) of one request."""
    from emmax_torch.serving.engine import _round_up, pick_bucket
    from emmax_torch.vla.prompting import build_emma_x_task_prompt

    n = len(tokenizer.encode(build_emma_x_task_prompt(TASK, (128, 96))))
    bucket = pick_bucket(n)
    return n, bucket, num_patches + bucket, _round_up(num_patches + bucket
                                                      + MAX_NEW)


# ----------------------------------------------------------------- kernels --

def check_flash(dev, gen, name, B, Lq, S, H, D, causal, n_pad, dtype,
                rpad=0, q_offset=0):
    """Kernel vs plain at one shape in fp32 (the 3xTF32 kernel) and in bf16
    (the bf16 tensor-core kernel); ``n_pad`` left-pad slots in every row and
    ``rpad`` right-pad slots in the last (kv_mask); the queries sit at slots
    [q_offset, q_offset + Lq) and the slots past them are empty (the
    kv_mask of a cache). Query rows that see no
    key must be exact zeros with the LSE sentinel bit for bit, and a
    rerun must give the same bits. Timed in ``dtype``, the one the main
    path gives it. In fp32 the bound counts the three TF32 products the
    kernel makes of each product at the TF32 peak; the record keeps the
    bound of one product at the fp32 peak beside it
    (``bound_fp32_fma_ms``)."""
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops.attention import NEG_INF
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    qkv32 = (rnd(B, Lq, H, D), rnd(B, S, H, D), rnd(B, S, H, D))
    kv_mask = None
    if n_pad or rpad or S != Lq:
        kv_mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        kv_mask[:, n_pad:q_offset + Lq] = True   # the slots written so far
        if rpad:
            kv_mask[-1, Lq - rpad:] = False
    kw = dict(kv_mask=kv_mask, causal=causal, q_offset=q_offset)
    dense = fa._dense_mask(Lq, S, kv_mask, causal, q_offset, dev)
    dead = (~dense.any(dim=-1)[:, 0]).expand(B, Lq) if dense is not None \
        else torch.zeros((B, Lq), dtype=torch.bool, device=dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt) for t in qkv32)
        got, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        again, lse2 = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        errs[dt] = rel_err(got, fa.flash_attention_reference(q, k, v, **kw))
        if not (torch.equal(got, again) and torch.equal(lse, lse2)):
            raise AssertionError(f"flash {name} {dt}: a rerun changed bits")
        if got[dead].any() or not bool((lse[dead] == NEG_INF).all()):
            raise AssertionError(f"flash {name} {dt}: rows that see no key "
                                 f"are not exact zeros with the sentinel")
        if n_pad and causal and not q_offset and not dead[:, :n_pad].all():
            raise AssertionError(f"flash {name}: pad rows see a key")
    rel32, rel = errs[torch.float32][1], errs[torch.bfloat16][1]
    if not (rel32 <= FP32_RTOL and rel <= BF16_RTOL):
        raise AssertionError(f"flash {name}: rel err fp32 {rel32:.3g} "
                             f"(tol {FP32_RTOL}), bf16 {rel:.3g} "
                             f"(tol {BF16_RTOL})")
    q, k, v = (t.to(dtype) for t in qkv32)
    ms, eager = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    plain, _ = time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib, _ = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=dense))
    pairs = (dense.expand(B, 1, Lq, S).sum().item() if dense is not None
             else B * Lq * S)
    n_bytes = q.element_size() * (2 * B * Lq * H * D + 2 * B * S * H * D) + (
        B * S if kv_mask is not None else 0)
    flops = 4.0 * H * D * pairs
    if dtype == torch.float32:
        bms, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS_PER_S)
    else:
        bms, by = bound_ms(n_bytes, flops)
    rec = {"name": "flash_fwd", "shape": name, "dtype": str(dtype)[6:],
           "max_abs_err": errs[dtype][0], "rel_err": rel,
           "fp32_rel_err": rel32, "ms": ms, "eager_ms": eager,
           "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
           "bound_by": by, "dead_rows": int(dead.sum().item())}
    if dtype == torch.float32:
        rec["bound_fp32_fma_ms"] = bound_ms(n_bytes, flops,
                                            FP32_FLOPS_PER_S)[0]
    return rec


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
    """Kernel vs plain at one shape on layer 1 of a stacked weight: fp32 x
    (the scalar kernel) at FP32_RTOL, bf16 x (the tensor-core kernel) at
    BF16_RTOL and the same bits on a rerun. Timed in bf16 over ``layers``
    stacked layers in turn, so the weights come from HBM (the stack is
    larger than the 50 MB L2) as in the decode loop. The library call is
    held against the plain version too, and timed the same way on the same
    weights repacked beforehand."""
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
    got = im.int4_matmul_cuda(x, q4[1], scale[1])
    err, rel = rel_err(got, ref)
    if not torch.equal(im.int4_matmul_cuda(x, q4[1], scale[1]), got):
        raise AssertionError(f"int4 {name}: a rerun changed bits")
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
    tok = load_tokenizer(None)
    n_tok, bucket, Lq, S = prefill_shape(tok, cfg.num_patches)
    log(f"prefill shape: prompt {n_tok} tokens, bucket {bucket}, fused "
        f"{Lq}, cache {S} slots")
    s_tok, s_bucket, s_fused, s_cache = spec_shape(tok, cfg.num_patches)
    log(f"closed-loop shape: prompt {s_tok} tokens, bucket {s_bucket}, "
        f"fused {s_fused}, cache {s_cache} slots")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    (_, dino), (_, sig) = cfg.vision
    llm = cfg.llm
    F = cfg.num_patches + ALIGN_TEXT          # the align7b fused length
    Ld = dino.num_patches + dino.num_prefix
    # the towers for one served frame (B1) and an admission's frames (B6)
    towers = [check_flash(dev, gen, f"{n} B{B} L{L} H{t.n_heads} "
                          f"D{t.head_dim}", B, L, L, t.n_heads, t.head_dim,
                          False, 0, torch.float32)
              for B in (1, PAGED_REQUESTS)
              for n, t, L in (("dino", dino, Ld),
                              ("siglip", sig, sig.num_patches))]
    flash = towers[:2] + [
        check_flash(dev, gen, f"llama prefill B1 Lq{Lq} S{S} H{llm.n_heads}"
                    f" D{llm.head_dim} causal pad{bucket - n_tok}", 1, Lq, S,
                    llm.n_heads, llm.head_dim, True, bucket - n_tok,
                    torch.bfloat16),
        check_flash(dev, gen, f"llama train B{ALIGN_B} L{F} H{llm.n_heads}"
                    f" D{llm.head_dim} causal rpad{ALIGN_PAD}", ALIGN_B, F,
                    F, llm.n_heads, llm.head_dim, True, 0, torch.bfloat16,
                    rpad=ALIGN_PAD),
    ]
    D, Fh, V = llm.dim, llm.hidden_dim, llm.vocab_size
    shapes = [("wq/wk/wv/wo", D, D), ("w_gate/w_up", D, Fh),
              ("w_down", Fh, D), ("lm_head", D, V)]
    # M 1: decode; 6: the batched engines' slots; 13: the speculative
    # verifier's linear chunk (draft_k 12 + 1); 24: the tail refresh; 43:
    # the (7, 5) tree's chunk; 48: its former upper bound; Lq: prefill
    int4 = [check_int4(dev, gen, f"{n} M{M} D{d} F{f}", M, d, f)
            for M in (1, 6, SPEC_W_LINEAR, TAIL, SPEC_W_TREE, 48, Lq)
            for n, d, f in shapes]
    flash += towers[2:] + [
        # the prefix-KV tail refresh: the last TAIL fused slots again, at
        # their offset, into the closed loop's whole cache
        check_flash(dev, gen, f"llama tail refresh B1 Lq{TAIL} S{s_cache} "
                    f"q_offset{s_fused - TAIL} H{llm.n_heads} "
                    f"D{llm.head_dim} causal pad{s_bucket - s_tok}", 1, TAIL,
                    s_cache, llm.n_heads, llm.head_dim, True,
                    s_bucket - s_tok, torch.bfloat16,
                    q_offset=s_fused - TAIL)]
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
        n_bytes, ops = work[kname]
        if dtype == torch.float32:
            # 3xTF32: three TF32 products for each one; one product at the
            # fp32 FMA peak beside it
            bms, by = bound_ms(n_bytes, 3 * ops, TF32_FLOPS_PER_S)
        else:
            bms, by = bound_ms(n_bytes, ops, BF16_FLOPS_PER_S)
        recs.append({"name": kname, "shape": name, "dtype": str(dtype)[6:],
                     "max_abs_err": errs_out[kname][0],
                     "rel_err": errs_out[kname][1], "ms": ms,
                     "eager_ms": eager, "plain_ms": plain[kname],
                     "library_ms": library[kname], "bound_ms": bms,
                     "bound_by": by})
        if dtype == torch.float32:
            recs[-1]["bound_fp32_fma_ms"] = bound_ms(n_bytes, ops,
                                                     FP32_FLOPS_PER_S)[0]
    recs[0]["lse_max_abs_err"] = lse_err
    recs[-1]["dq_partial_sum_ms"] = dq_sum_ms
    recs[-1]["library_note"] = recs[1]["library_note"] = recs[2][
        "library_note"] = "sdpa backward (dq, dk and dv together)"
    return recs


def training_kernel_phase(dev):
    """The training kernels at the shapes a train step gives them: the
    Llama's (B2, fused 448, causal, the last row right-padded) in bf16
    (mixed-precision training) and in fp32 (fp32 compute), and the
    towers' (B2, bidirectional) in fp32 (fp32 compute, the
    vla-full-train phase) and in bf16 (mixed-precision vla-full-train), and
    in fp32 at the vla-full-train phase's batch."""
    from emmax_torch.models.vlm import emma_x_vlm_config

    cfg = emma_x_vlm_config()
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    (_, dino), (_, sig) = cfg.vision
    llm = cfg.llm
    F = cfg.num_patches + ALIGN_TEXT
    Ld = dino.num_patches + dino.num_prefix
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        recs += check_flash_bwd(dev, gen, f"llama train B{ALIGN_B} L{F} "
                                f"H{llm.n_heads} D{llm.head_dim} causal "
                                f"rpad{ALIGN_PAD}", ALIGN_B, F, llm.n_heads,
                                llm.head_dim, True, ALIGN_PAD, dtype)
    # B2 in both dtypes, then fp32 at VLA_B, the vla-full-train phase's
    # batch
    for B, dtype in ((ALIGN_B, torch.float32), (ALIGN_B, torch.bfloat16),
                     (VLA_B, torch.float32)):
        recs += check_flash_bwd(dev, gen, f"dino B{B} L{Ld} "
                                f"H{dino.n_heads} D{dino.head_dim}", B, Ld,
                                dino.n_heads, dino.head_dim, False, 0, dtype)
        recs += check_flash_bwd(dev, gen, f"siglip B{B} "
                                f"L{sig.num_patches} H{sig.n_heads} "
                                f"D{sig.head_dim}", B, sig.num_patches,
                                sig.n_heads, sig.head_dim, False, 0, dtype)
    for r in recs:
        log("kernel " + json.dumps(r))
    return recs


def check_paged(dev, gen, name, KV, G, kdt):
    """The paged-attention kernel against its plain version at the batched
    engines' shape: B = len(PAGED_LENGTHS) rows of ragged lengths, page
    size 128, 6 pages per row on shuffled page ids, hd 128. Held in fp32
    q (tolerance FP32_RTOL) and bf16 q (BF16_RTOL: the TPU kernel re-rounds
    its bf16 output once per compute block, this one keeps fp32 and rounds
    once); timed with bf16 q, as the engine gives it. A rerun must give the
    same bits, and a CUDA graph of one call, replayed after the lengths
    change in place, must equal the eager call on the new lengths: the
    split count is fixed by the shapes, nothing is read back to the
    host."""
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
    eager = pa.paged_attention_cuda(q, k, v, lengths, table, **kw)
    if not torch.equal(pa.paged_attention_cuda(q, k, v, lengths, table, **kw),
                       eager):
        raise AssertionError(f"paged {name}: a rerun changed bits")
    live_lengths = lengths.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = pa.paged_attention_cuda(q, k, v, live_lengths, table, **kw)
    graph.replay()
    same = torch.equal(replayed, eager)
    live_lengths.copy_(lengths.flip(0))        # new lengths, on the device
    graph.replay()
    same &= torch.equal(replayed, pa.paged_attention_cuda(
        q, k, v, lengths.flip(0).contiguous(), table, **kw))
    del graph
    if not same:
        raise AssertionError(f"paged {name}: the CUDA graph's replay differs "
                             f"from the eager call")
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
            "n_split": pa.splits(MP, ps),
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


def hub_step(dev, kernels) -> dict:
    """4c: the tiny model's Hugging Face export made and served on this
    machine (no ``transformers``): ``export_hf``'s files, the export
    directory through the facade on the card (fp32 flash forward) and on
    the CPU (plain) with the same action, then ``verify_emmax``."""
    import shutil
    import tempfile
    from pathlib import Path

    from emmax_torch import convert_weights as cw
    from emmax_torch import verify_emmax
    from emmax_torch.extern.hf_facade import EmmaXForVision2Seq
    from emmax_torch.extern.hf_processor import EmmaXProcessor
    from emmax_torch.models.load import save_pretrained
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config

    import importlib.util

    t_step = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="emmax_hub_"))
    try:
        generator = torch.Generator("cpu")
        generator.manual_seed(0)
        save_pretrained(tmp / "run", {
            "vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
            "arch_specifier": "fused-gelu-mlp",
            "text_config": {"vocab_size": HUB_VOCAB}},
            init_vlm_params(generator, tiny_vlm_config(HUB_VOCAB)))
        (tmp / "stats.json").write_text(json.dumps(HUB_STATS))
        out = tmp / "export"
        t0 = time.perf_counter()
        cw.main(["--mode", "export_hf", "--src", str(tmp / "run"), "--dst",
                 str(out), "--base_vlm", "tiny", "--export_dtype", "float32",
                 "--dataset_statistics", str(tmp / "stats.json")])
        export_s = time.perf_counter() - t0
        files = {p.name for p in out.iterdir()}
        if not HUB_FILES | {"csrc"} <= files:
            raise AssertionError(f"hub: export wrote {sorted(files)}")
        frame = np.random.default_rng(9).integers(0, 256, (256, 256, 3),
                                                  dtype=np.uint8)
        runs = {}
        for device in ("cpu", dev):
            model = EmmaXForVision2Seq.from_pretrained(
                out, dtype=torch.float32, device=device)
            proc = EmmaXProcessor.from_pretrained(
                out, tokenizer=model.vla.tokenizer)
            prompt, image = proc.get_prompt(TASK, frame)
            inputs = proc(prompt, image)
            if inputs["task"] != TASK:
                raise AssertionError(f"hub: task {inputs['task']!r}")
            for k in kernels:
                k.reset_counts()
            t0 = time.perf_counter()
            action = model.predict_action(inputs, unnorm_key="bridge_orig")
            if device != "cpu":
                torch.cuda.synchronize(dev)
            runs[str(device)] = {
                "action": np.asarray(action).tolist(),
                "s": time.perf_counter() - t0,
                "flash_fwd_fp32": kernels[0].launches_by.get("float32", 0)}
            del model
        card, cpu = runs[str(dev)], runs["cpu"]
        if card["action"] != cpu["action"]:
            raise AssertionError(f"hub: card action {card['action']} != CPU "
                                 f"{cpu['action']}")
        if card["flash_fwd_fp32"] == 0 or cpu["flash_fwd_fp32"] != 0:
            raise AssertionError(f"hub: fp32 flash forward launches {runs}")
        t0 = time.perf_counter()
        verify = verify_emmax.main(verify_emmax.VerifyConfig(
            checkpoint=out, device="cuda", max_new_tokens=HUB_VERIFY_NEW))
        verify_s = time.perf_counter() - t0
        for name, v in verify.items():
            a = v["predict_action"]
            if a.shape != (7,) or not np.isfinite(a).all():
                raise AssertionError(f"hub verify {name}: {a}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {"files": sorted(files), "export_s": export_s,
              "transformers_here": importlib.util.find_spec(
                  "transformers") is not None,
              "runs": runs, "actions_equal": True, "verify_s": verify_s,
              "verify": {k: v["predict_action"].tolist()
                         for k, v in verify.items()},
              "step_s": time.perf_counter() - t_step}
    log("hub " + json.dumps(result))
    return result


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
    fp32_fwd = sum(e.time_range.elapsed_us() for e in work
                   if "tf32::fwd_kernel<" in e.name) / 1e3
    return {"tokens": PROFILE_TOKENS, "phases": phases,
            "device_ms_total": sum(by_name.values()),
            "flash_fwd_fp32_ms": fp32_fwd, "top_kernels_ms": top}


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
        k.reset_counts()
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
    launches_by = {k.name: dict(k.launches_by) for k in kernels}
    # the towers' fp32 forward launches in this run: every request and
    # predict_action encode one frame, each tower in depth - 1 blocks
    encodes = len(frames) + 1
    fp32_fwd = launches_by["flash_fwd"].get("float32", 0)
    blocks = sum(v.depth - 1 for _, v in vla.cfg.vision)
    if fp32_fwd != encodes * blocks:
        raise AssertionError(f"{fp32_fwd} fp32 flash_fwd launches in "
                             f"{encodes} encodes, not {blocks} each")
    per_encode = fp32_fwd // encodes
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
        "launches": launches, "flash_fwd_launches_per_encode": per_encode,
        "launches_by": launches_by,
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


# ------------------------------------------------------------- checkpoints --

class _MallInfo2(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


class HostPeak:
    """This process's host memory on entry and at its peak while the block
    runs, in two measures: ``rss``, the resident set from /proc/self/statm
    (pages mapped from a checkpoint's files count), sampled every 5 ms,
    and ``heap``, the bytes malloc holds in use (glibc's ``mallinfo2``:
    ``uordblks + hblkhd``), where every CPU tensor torch allocates lives
    (a converted host tree, the quantizer's work) and no mapped file page
    does. /proc/self/status on the card machine has no ``RssAnon`` /
    ``RssFile`` to split the resident set instead. ``mallinfo2`` locks
    malloc's arenas and walks their free lists, so it is read only every
    ``HEAP_EVERY`` samples (100 ms)."""

    HEAP_EVERY = 20

    def __init__(self) -> None:
        import os
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        libc = ctypes.CDLL("libc.so.6")
        libc.mallinfo2.restype = _MallInfo2
        self._mallinfo2 = libc.mallinfo2
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _read(self, heap: bool = True) -> dict:
        with open("/proc/self/statm") as f:
            got = {"rss": int(f.read().split()[1]) * self._page}
        if heap:
            m = self._mallinfo2()
            got["heap"] = m.uordblks + m.hblkhd
        return got

    def _sample(self, heap: bool = True) -> None:
        for name, value in self._read(heap).items():
            self.peak[name] = max(self.peak[name], value)

    def _run(self) -> None:
        tick = 0
        while not self._stop.wait(0.005):
            tick += 1
            self._sample(tick % self.HEAP_EVERY == 0)

    def __enter__(self) -> "HostPeak":
        self.base = self._read()
        self.peak = dict(self.base)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._sample()

    def gb(self) -> dict:
        return {f"{name}_{when}_gb": v[name] / 1e9 for name in ("rss", "heap")
                for when, v in (("base", self.base), ("peak", self.peak))}


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def no_host_copy(host: HostPeak, limit: int, what: str) -> float:
    """Gate that a load converted straight onto the card: the host heap
    grew by less than ``limit`` bytes (one bf16 stacked leaf), not by a
    copy of the tree. Returns the growth in GB."""
    grown = host.peak["heap"] - host.base["heap"]
    if not grown < limit:
        raise AssertionError(f"{what}: host heap grew {grown} B, not below "
                             f"one bf16 stacked leaf ({limit} B)")
    return grown / 1e9


def _differing_leaves(got, want) -> list:
    """Paths where two trees differ in structure, dtype, shape or bits."""
    from emmax_torch.models.tree import leaves_with_path

    a, b = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return [p for p in a if a[p].dtype != b[p].dtype
            or a[p].shape != b[p].shape
            or not torch.equal(a[p], b[p].to(a[p].device))]


def served_request(vla, frame, prompt, kernels, quantized: bool) -> dict:
    """One ``generate_actions`` request with the launch gates: the towers'
    fp32 flash forward depth - 1 times a tower, the bf16 one once per
    decoder layer (the prefill), and with int4 weights the int4 kernel on
    every decoder weight read (7 a layer and the lm_head, each forward)."""
    for k in kernels:
        k.reset_counts()
    t0 = time.perf_counter()
    actions, text = vla.generate_actions(frame, prompt, type="act",
                                         max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    by = {k.name: dict(k.launches_by) for k in kernels}
    launches = {k.name: k.launches for k in kernels}
    cfg = vla.cfg
    forwards = 1 + vla.engine.last_timings["decode_forwards"]
    want = {"float32": sum(v.depth - 1 for _, v in cfg.vision),
            "bfloat16": cfg.llm.n_layers}
    if by["flash_fwd"] != want:
        raise AssertionError(f"flash_fwd launches by dtype {by['flash_fwd']}"
                             f" != {want} in one request")
    int4 = (7 * cfg.llm.n_layers + 1) * forwards if quantized else 0
    if launches["int4_matmul"] != int4:
        raise AssertionError(f"{launches['int4_matmul']} int4 launches in "
                             f"{forwards} forwards, not {int4}")
    if not all(a.shape == (7,) and np.isfinite(a).all() for a in actions):
        raise AssertionError(f"bad actions {actions!r}")
    return {"request_ms": ms, "text": text, "forwards": forwards,
            "launches": launches, "flash_fwd_by_dtype": by["flash_fwd"]}


def greedy_ids(vla, frame, prompt, n: int = MAX_NEW) -> list:
    return vla.engine.generate_ids([prompt], vla._pixels(frame),
                                   max_new_tokens=n)[0].tolist()


def checkpoint_phase(dev, kernels) -> dict:
    """Serve and fine-tune from checkpoints written by the port's
    exporters from phase 5's seeded full-width params (``load(MODEL_ID,
    seed=0)``):

    1. an OpenVLA-layout Hugging Face dir (``convert_weights.save_hf``:
       shards of at most 5 GB, their index, ``config.json`` in
       ``EmmaXVLAConfig``'s layout with ``norm_stats``, and the Hub
       processor and remote-code files) -> ``load_vla(dir)`` in bf16 (every leaf equal, the
       in-memory model's greedy tokens, the written stats, the host heap
       grown by less than one bf16 stacked leaf: the leaves go straight
       from the mapped shards to the card) and with
       ``quantize="int4"`` (the tree equal to the in-memory params
       quantized on the card by ``quantize_vlm_params``; the in-memory
       model's tokens under that tree; the launch gates; the
       device peak of the load under the int4 tree plus one bf16 stacked
       leaf);
    2. a reference ``.pt`` (``save_reference_pt``) -> ``load_vla(dir)``:
       every leaf equal, the host heap gated as in 1;
    3. a run dir of ``emmax_torch.train --smoke_test`` on the card ->
       ``load_vla(run_dir)`` on the card and on the CPU: the same tokens;
    4. the vla-train cut (``VLA_LAYERS`` layers) as a reference ``.pt`` ->
       the trainer's ``--pretrained_checkpoint`` conversion: every leaf,
       step 0's loss and projector gradient equal those of the params in
       memory.
    Export and load seconds, each load's host RSS and heap (base and peak)
    and the int4 load's device peak are printed. Each temporary directory
    goes before the next step."""
    import shutil
    import tempfile
    from pathlib import Path

    from emmax_torch import convert_weights as cw
    from emmax_torch.models.load import load, load_vla
    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.serving.quant import QUANT_KEYS, quantize_vlm_params

    out = {}
    cfg, params, tok, transforms, family = load(MODEL_ID, device="cuda",
                                                seed=0)
    stats = {"bridge_orig": {"action": {
        "q01": [-0.05] * 6 + [0.0], "q99": [0.05] * 6 + [1.0],
        "mask": [True] * 6 + [False]}}}
    frame = np.random.default_rng(7).integers(0, 256, (256, 256, 3),
                                              dtype=np.uint8)
    ids = cw.vlm_ids(MODEL_ID)
    weights = [k for k in QUANT_KEYS if k in params["llm"]["layers"]]
    leaf_bytes = max(_tree_bytes(params["llm"]["layers"][k])
                     for k in weights)

    def in_memory(tree):
        return EmmaXVLA(cfg, tree, tok, transforms, norm_stats=stats,
                        llm_family=family, device=dev)

    ref = in_memory(params)
    prompt = ref.get_prompt(TASK, gripper_position=(128, 96))
    ref_ids = greedy_ids(ref, frame, prompt)
    ref_text = ref.generate_actions(frame, prompt,
                                    max_new_tokens=MAX_NEW)[1]
    del ref

    # 1. Hugging Face safetensors, full width
    tmp = Path(tempfile.mkdtemp(prefix="emmax_ckpt_hf_"))
    try:
        t0 = time.perf_counter()
        shards = cw.save_hf(params, cfg, ids, tmp, norm_stats=stats,
                            dtype=torch.bfloat16)
        export_s = time.perf_counter() - t0
        sizes = [p.stat().st_size for p in shards]
        if len(shards) < 2 or not (tmp / "model.safetensors.index.json"
                                   ).exists() or max(sizes) > 5.01e9:
            raise AssertionError(f"HF export: shards {sizes}, no index?")
        with HostPeak() as host:
            t0 = time.perf_counter()
            vla = load_vla(tmp, device="cuda")
            torch.cuda.synchronize(dev)
            load_s = time.perf_counter() - t0
        heap_gb = no_host_copy(host, leaf_bytes, "HF bf16 load")
        bad = _differing_leaves(vla.engine.model.tree(), params)
        if bad:
            raise AssertionError(f"HF bf16 load: leaves differ: {bad[:8]}")
        if vla.get_action_stats(None) != stats["bridge_orig"]["action"]:
            raise AssertionError("HF load: action statistics differ from "
                                 "the written ones")
        got_ids = greedy_ids(vla, frame, prompt)
        if got_ids != ref_ids:
            raise AssertionError(f"HF bf16 load: tokens {got_ids} != "
                                 f"in-memory {ref_ids}")
        req = served_request(vla, frame, prompt, kernels, quantized=False)
        if req["text"] != ref_text:
            raise AssertionError("HF bf16 load: generate_actions text "
                                 "differs from the in-memory model's")
        out["hf_bf16"] = {"shards": len(shards), "shard_gb": [
            s / 1e9 for s in sizes], "export_s": export_s, "load_s": load_s,
            **host.gb(), "heap_growth_gb": heap_gb,
            "largest_bf16_leaf_gb": leaf_bytes / 1e9, "request": {k: v for k, v in req.items()
                                     if k != "text"}}
        log("checkpoint hf bf16 " + json.dumps(out["hf_bf16"]))
        del vla
        gc.collect()
        torch.cuda.empty_cache()

        # int4: the loader quantizes each stacked leaf on the card, one
        # layer moved from the host tree at a time
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with HostPeak() as host:
            t0 = time.perf_counter()
            vla4 = load_vla(tmp, device="cuda", quantize="int4")
            torch.cuda.synchronize(dev)
            load4_s = time.perf_counter() - t0
        device_peak = torch.cuda.max_memory_allocated(dev) - before
        tree4 = vla4.engine.model.tree()
        bound = _tree_bytes(tree4) + leaf_bytes
        if not device_peak < bound:
            raise AssertionError(f"int4 load: device peak {device_peak} B "
                                 f">= int4 tree + one bf16 leaf {bound} B")
        # the reference: the params in memory quantized on the card, whole
        # leaves at a time (phase 5's route)
        t0 = time.perf_counter()
        want4 = quantize_vlm_params(params, bits=4)
        torch.cuda.synchronize(dev)
        ref_quant_s = time.perf_counter() - t0
        diff = {"codes": 0, "scales": 0}
        for k in (*weights, None):
            a = want4["llm"]["layers"][k] if k else want4["llm"]["lm_head"]
            b = tree4["llm"]["layers"][k] if k else tree4["llm"]["lm_head"]
            diff["codes"] += int((a["q4"] != b["q4"]).sum())
            diff["scales"] += int(
                (a["scale"].view(torch.int16)
                 != b["scale"].view(torch.int16)).sum())
        bad = _differing_leaves(tree4, want4)
        if bad:
            raise AssertionError(f"HF int4 load: leaves differ from the "
                                 f"in-memory params quantized on the card "
                                 f"({diff}): {bad[:8]}")
        ref4 = in_memory(want4)
        ref4_ids = greedy_ids(ref4, frame, prompt)
        del ref4
        got4_ids = greedy_ids(vla4, frame, prompt)
        if got4_ids != ref4_ids:
            raise AssertionError(f"HF int4 load: tokens {got4_ids} != "
                                 f"in-memory card-quantized {ref4_ids}")
        req = served_request(vla4, frame, prompt, kernels, quantized=True)
        out["hf_int4"] = {
            "load_s": load4_s, **host.gb(),
            "device_peak_gb": device_peak / 1e9,
            "device_bound_gb": bound / 1e9,
            "int4_tree_gb": _tree_bytes(tree4) / 1e9,
            "largest_bf16_leaf_gb": leaf_bytes / 1e9,
            "reference_quantize_s": ref_quant_s,
            "differing_from_reference": diff,
            "same_tokens_as_bf16": got4_ids == ref_ids,
            "request": {k: v for k, v in req.items() if k != "text"}}
        log("checkpoint hf int4 " + json.dumps(out["hf_int4"]))
        del vla4, tree4, want4
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 2. reference .pt, full width
    tmp = Path(tempfile.mkdtemp(prefix="emmax_ckpt_pt_"))
    try:
        t0 = time.perf_counter()
        cw.save_reference_pt(params, cfg,
                             tmp / "checkpoints" / "latest-checkpoint.pt")
        (tmp / "config.json").write_text(json.dumps({"model": ids}))
        export_s = time.perf_counter() - t0
        with HostPeak() as host:
            t0 = time.perf_counter()
            vla = load_vla(tmp, device="cuda")
            torch.cuda.synchronize(dev)
            load_s = time.perf_counter() - t0
        heap_gb = no_host_copy(host, leaf_bytes, ".pt bf16 load")
        bad = _differing_leaves(vla.engine.model.tree(), params)
        if bad:
            raise AssertionError(f".pt load: leaves differ: {bad[:8]}")
        out["pt_bf16"] = {
            "decoder_layers": cfg.llm.n_layers, "export_s": export_s,
            "file_gb": sum(p.stat().st_size for p in
                           (tmp / "checkpoints").iterdir()) / 1e9,
            "load_s": load_s, **host.gb(), "heap_growth_gb": heap_gb}
        log("checkpoint pt bf16 " + json.dumps(out["pt_bf16"]))
        del vla
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the port's own run dir (the trainer's --smoke_test, on the card)
    from emmax_torch.conf import VLAConfig, parse_config
    from emmax_torch.train import TrainConfig
    from emmax_torch.train import main as train_main

    tmp = Path(tempfile.mkdtemp(prefix="emmax_ckpt_run_"))
    try:
        t0 = time.perf_counter()
        train_main(parse_config(TrainConfig, [
            "--smoke_test", "true", "--device", dev.type,
            "--vla.max_steps", "2",
            "--vla.global_batch_size", "2", "--eval_interval", "100",
            "--run_root_dir", str(tmp)], choice_fields={"vla": VLAConfig}))
        train_s = time.perf_counter() - t0
        run = next(tmp.iterdir())
        small = np.random.default_rng(5).integers(0, 256, (64, 64, 3),
                                                  dtype=np.uint8)
        toks = []
        for device in (dev, "cpu"):
            tv = load_vla(run, dtype=torch.float32, device=device)
            toks.append(greedy_ids(tv, small, tv.get_prompt(
                TASK, gripper_position=(10, 20)), 24))
        if toks[0] != toks[1]:
            raise AssertionError(f"run dir: card tokens {toks[0]} != CPU "
                                 f"tokens {toks[1]}")
        out["run_dir"] = {"train_s": train_s, "tokens": len(toks[0]),
                          "checkpoint": next((run / "checkpoints")
                                             .iterdir()).name}
        log("checkpoint run dir " + json.dumps(out["run_dir"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 4. --pretrained_checkpoint at the vla-train cut
    out["pretrained"] = pretrained_checkpoint_step(dev)
    log("checkpoint pretrained " + json.dumps(out["pretrained"]))
    return out


def pretrained_checkpoint_step(dev) -> dict:
    """vla-train's params (the ``VLA_LAYERS`` cut, seed 1) written as a
    reference ``.pt`` and converted by the trainer's own code
    (``train.initial_params``): every leaf, step 0's loss and the
    projector's gradient equal those of the params in memory."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    from emmax_torch.convert_weights import save_reference_pt
    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.gcot import (GCOTDataset, SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.prefetch import to_device
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.train import TrainConfig, initial_params
    from emmax_torch.training.train_state import (stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_grad_fn
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.tokenizer import load_tokenizer

    base = emma_x_vlm_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=VLA_LAYERS))
    tokenizer = load_tokenizer(None)
    dataset = GCOTDataset(make_dummy_gcot_items(VLA_B),
                          ActionTokenizer(tokenizer), tokenizer,
                          SyntheticFrameSource(256),
                          data_mix="movement_policy", mask_inst=True)
    batch = to_device(next(iter(BatchLoader(dataset, VLA_B, lambda s:
                                            collate_train(
        s, tokenizer.pad_id, max_length=cfg.llm.max_seq_len),
        seed=7).epoch(0))), dev)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    grad_fn = make_grad_fn(
        cfg, attn_impl="cuda", remat=True, compute_dtype=torch.bfloat16,
        transforms=get_image_transforms("dinosiglip-vit-so-224px",
                                        "resize-naive"),
        stop_vision_gradient=True,
        freeze_mask=trainable_mask(params, stage_from_flags(True, False,
                                                            False)),
        action_vocab_size=tokenizer.vocab_size)

    def step0(p):
        loss, _, grads = grad_fn(p, batch)
        proj = [g.clone() for path, g in leaves_with_path(grads)
                if path.startswith("projector/")]
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        return loss.item(), proj

    loss_mem, proj_mem = step0(params)
    tmp = Path(tempfile.mkdtemp(prefix="emmax_ckpt_pretrained_"))
    try:
        pt = tmp / "base.pt"
        t0 = time.perf_counter()
        save_reference_pt(params, cfg, pt)
        export_s = time.perf_counter() - t0
        file_gb = pt.stat().st_size / 1e9
        t0 = time.perf_counter()
        conv = initial_params(TrainConfig(pretrained_checkpoint=pt,
                                          device="cuda"), cfg, dev)
        torch.cuda.synchronize(dev)
        convert_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = _differing_leaves(conv, params)
    if bad:
        raise AssertionError(f"--pretrained_checkpoint: leaves differ: "
                             f"{bad[:8]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    loss_conv, proj_conv = step0(conv)
    same = loss_conv == loss_mem and all(
        torch.equal(a, b) for a, b in zip(proj_conv, proj_mem))
    if not same:
        loss_again, proj_again = step0(conv)
        raise AssertionError(
            f"--pretrained_checkpoint step 0: loss {loss_conv} vs "
            f"{loss_mem} in memory, projector gradients equal: "
            f"{[torch.equal(a, b) for a, b in zip(proj_conv, proj_mem)]}; "
            f"a rerun on the same params gives loss {loss_again}, "
            f"equal gradients "
            f"{[torch.equal(a, b) for a, b in zip(proj_again, proj_conv)]}")
    del conv
    gc.collect()
    torch.cuda.empty_cache()
    return {"decoder_layers": VLA_LAYERS, "batch": VLA_B,
            "export_s": export_s, "file_gb": file_gb,
            "convert_s": convert_s, "loss": loss_mem,
            "projector_grad_max": max(g.abs().max().item()
                                      for g in proj_mem),
            "equal": True}


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
    modes = {}
    for mode in ("kernel",) + EVAL_PAGED_MODES:
        # every token of every mode: fp32 operands on both sides, and the
        # third request runs alone, beside an empty slot
        for quantized in (False, True):
            outs = []
            for device, p in (("cpu", params), (dev, on_card)):
                eng = PagedServingEngine(
                    cfg, p, tok, num_slots=2, n_pages=24, page_size=16,
                    max_pages_per_slot=8, burst=4, paged_attn=mode,
                    quantized_cache=quantized, device=device)
                rids = [eng.submit(pr, {"patches": pt.to(device)},
                                   max_new_tokens=12)
                        for pr, pt in zip(prompts, patches)]
                done = eng.run_until_complete()
                outs.append([done[r] for r in rids])
            if outs[0] != outs[1]:
                raise AssertionError(f"tiny paged {mode}, int8 pages "
                                     f"{quantized}: card {outs[1]} != CPU "
                                     f"{outs[0]}")
            key = f"{mode} int8 pages {quantized}"
            modes[key] = sum(len(o) for o in outs[1])
            log(f"tiny paged {key}: card == CPU, {modes[key]} tokens over "
                f"3 requests")
    steps = {"card_eq_cpu_tokens": modes}
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
        k.reset_counts()
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
            k.reset_counts()
        _, out, rec = serve(make, submit)
        rec["launches"] = {k.name: k.launches for k in kernels}
        rec.pop("burst_ms")
        shared[how] = rec
        log(f"shared-prefix {how} " + json.dumps(rec))
    runs["shared_prefix"] = shared
    runs["new_paged_modes"] = paged_modes_full(cfg, params, tok, pixels,
                                               prompt, kernels)
    for name, rec in [*runs.items()][:4] + [
            (f"shared {h}", r) for h, r in shared.items()]:
        for kname in ("flash_fwd", "int4_matmul"):
            if rec["launches"][kname] == 0:
                raise AssertionError(f"{name}: launched no {kname}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------- speculative --

def tiny_spec_parity(dev):
    """Phase 4b: the tiny config with an action-bin region (vocab 2048) in
    fp32 through the kernels on the card. ``SpeculativeEngine`` under each
    setting runs three closed-loop frames (one image, the gripper moving,
    prefix tail 24 and a vision cache, each frame drafting from the
    previous output, the prompt ending in a 7-bin action run): its tokens
    equal the CPU plain engine's exactly, and its steps, prefill kinds and
    tree use the CPU ``SpeculativeEngine``'s."""
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config
    from emmax_torch.serving.engine import (GenerateOptions, ServingEngine,
                                            VisionCache)
    from emmax_torch.serving.speculative import SpeculativeEngine
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    cfg = tiny_vlm_config(vocab_size=2048)
    params = init_vlm_params(torch.Generator().manual_seed(3), cfg)
    on_card = _tree_to(params, dev)
    tok = ByteLevelTokenizer(vocab_size=2048)
    opts = GenerateOptions(eos_id=tok.eos_id)
    rng = np.random.default_rng(21)
    pixels = {n: torch.from_numpy(rng.normal(
        size=(1, v.img_size, v.img_size, 3)).astype(np.float32))
        for n, v in cfg.vision}
    frame = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    suffix = [int(t) for t in ActionTokenizer(tok).encode_to_ids(
        rng.uniform(-0.5, 0.5, 7))]
    prompts = ["In: What action should the robot take\nCURRENT GRIPPER: "
               f"[{100 + 4 * f:03d}, 090]\nOut:" for f in range(3)]
    settings = {"linear": dict(action_drafts=False),
                "tree (5, 3)": dict(action_tree=(5, 3)),
                "draft_layers 1": dict(draft_layers=1, action_drafts=False),
                "int8 cache": dict(quantized_cache=True,
                                   action_tree=(5, 3))}
    steps = {}
    for name, kw in settings.items():
        plain = ServingEngine(cfg, params, tok, options=opts,
                              quantized_cache=kw.get("quantized_cache",
                                                     False), device="cpu")
        want = [plain.generate_ids([p], pixels, max_new_tokens=24,
                                   suffix_ids=suffix)[0].tolist()
                for p in prompts]
        runs = []
        for device, p in ((torch.device("cpu"), params), (dev, on_card)):
            eng = SpeculativeEngine(cfg, p, tok, options=opts, draft_k=12,
                                    prefix_tail=TAIL,
                                    vision_cache=VisionCache(threshold=0.0),
                                    device=device, **kw)
            frames, prev = [], None
            for prompt in prompts:
                out = eng.generate_ids(
                    [prompt], {k: v.to(device) for k, v in pixels.items()},
                    max_new_tokens=24, suffix_ids=suffix, draft_context=prev,
                    frame_key=frame)
                prev = out[0]
                frames.append((out[0].tolist(), eng.last_steps,
                               eng.last_prefill, eng.last_tree))
            runs.append(frames)
        cpu, card = runs
        if [f[0] for f in card] != want:
            raise AssertionError(f"tiny speculative {name}: card tokens "
                                 f"{[f[0] for f in card]} != CPU plain "
                                 f"{want}")
        if [f[1:] for f in card] != [f[1:] for f in cpu]:
            raise AssertionError(f"tiny speculative {name}: card steps / "
                                 f"prefills / tree {[f[1:] for f in card]}"
                                 f" != CPU {[f[1:] for f in cpu]}")
        if [f[2] for f in card] != ["full", "tail", "tail"]:
            raise AssertionError(f"tiny speculative {name}: prefills "
                                 f"{[f[2] for f in card]}")
        steps[name] = [f[1] for f in card]
    log("tiny speculative parity (card == CPU plain tokens, steps == CPU "
        "speculative, 3 frames x 24 tokens): " + json.dumps(steps))
    return steps


def closed_loop_inputs(tok):
    """``bench.py:286-338``: per frame the forced GCOT stream (the text
    scaffold, then a window of 8 consecutive drifting actions that slides
    by one action a frame), the cold frame's seed template, and the host
    camera frames (frame 0 brightened by f levels at frame f)."""
    from emmax_torch.vla.action_tokenizer import ActionTokenizer

    atok = ActionTokenizer(tok)
    rng_a = np.random.default_rng(1)
    base = rng_a.uniform(-0.4, 0.4, size=7)
    rollout = [np.clip(base + rng_a.normal(scale=0.02, size=7), -1, 1)
               for _ in range(SPEC_ACTIONS + SPEC_FRAMES)]

    def stream(f):
        text = ("REASONING: the gripper must reach the eggplant before "
                "grasping it\nSUBTASK: move the gripper to the eggplant"
                f"\nNEXT GRIPPER: [{112 + 2 * f}, {96 + f}]\nMOVEMENT:\n"
                f"move forward {21 - f} steps; move left 3 steps; close "
                "gripper;\nPOLICIES: ")
        ids = tok.encode(text)[:SPEC_TOKENS - SPEC_ACTIONS * 7]
        for a in rollout[f:f + SPEC_ACTIONS]:
            ids.extend(int(t) for t in atok.encode_to_ids(a))
        return np.asarray(ids[:SPEC_TOKENS], np.int64)

    seed = tok.encode(
        "REASONING: the gripper must \nSUBTASK: move the gripper to "
        "the \nNEXT GRIPPER: [1, 1]\nMOVEMENT:\nmove forward 1 steps; "
        "move left 1 steps; close gripper;\nPOLICIES: "
        "REASONING: the gripper must reach the \nSUBTASK: move the "
        "gripper to the \nNEXT GRIPPER: [10, 10]\nMOVEMENT:\nmove "
        "backward 2 steps; move right 2 steps; open gripper;\nPOLICIES: "
        "REASONING: the gripper must reach the eggplant \nSUBTASK: "
        "grasp the eggplant\nNEXT GRIPPER: [12, 9]\nMOVEMENT:\nmove "
        "down 3 steps; close gripper;\nPOLICIES: ",
        add_special_tokens=False)
    img = np.random.default_rng(0).integers(0, 256, size=(1, 256, 256, 3),
                                            dtype=np.uint8)
    frames = [np.clip(img[0].astype(np.int32) + f, 0, 255).astype(np.uint8)
              for f in range(SPEC_FRAMES)]
    return ([stream(f) for f in range(SPEC_FRAMES)],
            np.asarray(seed, np.int64), img, frames)


def sim_context(eng, prompt: str, prev: np.ndarray) -> np.ndarray:
    """The lookup history ``SpeculativeEngine.generate_ids`` builds before
    the first step, as ``scripts/sim_spec_drafts.simulate_steps`` takes
    it: the prompt's last 8 tokens, the draft context without its EOS
    padding, the prompt."""
    ids, mask = eng._prepare_host([prompt])
    real = np.flatnonzero(prev != eng.options.eos_id)
    prev = prev[:real[-1] + 1 if real.size else 1]
    return np.concatenate([ids[0, -8:], prev, ids[0][mask[0]]])


def closed_loop_episode(eng, inputs, pixels, fa_kernel,
                        int4_kernel) -> list:
    """One episode of ``SPEC_FRAMES`` frames, ``bench.py``'s ``episode``:
    frame f decodes its forced stream drafting from frame f - 1's output
    (frame 0 from the seed template), its host frame keying the vision
    cache, its pixels frame 0's + 0.001 f. Per frame: host ms (ending in
    the output's fetch), steps, prefill kind, vision-cache misses and each
    kernel's launches."""
    streams, prev, _, frames = inputs
    rows = []
    for f in range(SPEC_FRAMES):
        noisy = {k: v + 0.001 * f for k, v in pixels.items()}
        before = (fa_kernel.launches_by.get("bfloat16", 0),
                  fa_kernel.launches_by.get("float32", 0),
                  int4_kernel.launches, eng.vision_cache.misses)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate_ids([spec_prompt(f)], noisy,
                               max_new_tokens=SPEC_TOKENS,
                               forced_tokens=streams[f], draft_context=prev,
                               frame_key=frames[f])
        ms = (time.perf_counter() - t0) * 1e3
        after = (fa_kernel.launches_by.get("bfloat16", 0),
                 fa_kernel.launches_by.get("float32", 0),
                 int4_kernel.launches, eng.vision_cache.misses)
        rows.append({"ms": ms, "steps": eng.last_steps,
                     "prefill": eng.last_prefill, "out": out[0],
                     "context": prev,
                     **dict(zip(("flash_bf16", "flash_fp32", "int4",
                                 "vision_misses"),
                                (a - b for a, b in zip(after, before))))})
        prev = out[0]
    return rows


def check_episode(eng, inputs, rows, full_at, name) -> None:
    """The closed loop's gates: each frame reproduces its forced stream
    with ``simulate_steps``'s verifier steps on the same stream and
    history; prefills in full exactly on ``full_at`` and refreshes the
    tail elsewhere; launches the bf16 flash forward once per decoder
    layer (the prefill or the tail refresh: the verifier's chunks take the
    plain path) and the fp32 one once per tower block on a vision-cache
    miss only; launches the int4 kernel."""
    sys.path.insert(0, str(__import__("pathlib").Path(
        __file__).resolve().parent / "scripts"))
    from sim_spec_drafts import simulate_steps

    streams = inputs[0]
    lo, hi = eng.action_bins
    # the towers' blocks whose token count takes the kernel (>= 8)
    blocks = sum(v.depth - 1 for _, v in eng.cfg.vision
                 if v.num_patches + v.num_prefix >= 8)
    for f, r in enumerate(rows):
        if not np.array_equal(r["out"], streams[f]):
            raise AssertionError(f"{name} frame {f}: output is not the "
                                 "forced stream")
        sim = simulate_steps(
            streams[f], sim_context(eng, spec_prompt(f), r["context"]),
            k=SPEC_KW["draft_k"], bin_lo=lo, bin_hi=hi, stride=True,
            tree=SPEC_KW["action_tree"], max_new=SPEC_TOKENS,
            vocab_size=eng.cfg.llm.vocab_size)
        want = "full" if f in full_at else "tail"
        launches = (r["flash_bf16"], r["flash_fp32"])
        if (r["steps"] != sim or r["prefill"] != want
                or launches != (eng.cfg.llm.n_layers,
                                blocks * r["vision_misses"])
                or r["int4"] == 0):
            raise AssertionError(
                f"{name} frame {f}: steps {r['steps']} (simulator {sim}), "
                f"prefill {r['prefill']} (want {want}), flash bf16 / fp32 "
                f"launches {launches} (want {eng.cfg.llm.n_layers}, "
                f"{blocks} x {r['vision_misses']} misses), int4 "
                f"{r['int4']}")


def logits_both_ways(vla, frame, prompt, tokens, p) -> tuple:
    """The fp32 logits that predict token ``p`` of the greedy output
    ``tokens``, after a fresh prefill: (decode of tokens[:p] one at a time,
    as plain decode runs them; tokens[:p] in one chunk at a per-row cursor,
    as a verifier forward runs them)."""
    from emmax_torch.models.llama import embed_tokens, init_kv_cache
    from emmax_torch.models.vlm import fuse_multimodal, llm_apply
    from emmax_torch.serving.engine import _round_up, encode_frame

    eng = vla.engine
    params = eng.model.tree()
    llm, cfg = params["llm"], eng.cfg.llm
    ids, mask = eng._prepare([prompt])
    dev = ids.device
    patches = encode_frame(params, eng.cfg, vla._pixels(frame),
                           attn_impl=eng.attn_impl)
    toks = torch.tensor([list(tokens[:p])], dtype=torch.int64, device=dev)
    out = []
    with torch.inference_mode():
        for chunked in (False, True):
            cache = init_kv_cache(cfg, 1, _round_up(
                eng.cfg.num_patches + ids.shape[1] + p + 1),
                dtype=llm["embed"].dtype, device=dev)
            embeds, fmask, _, positions = fuse_multimodal(
                patches, embed_tokens(llm, ids), mask)
            lg, cache = llm_apply(llm, cfg, embeds, mask=fmask,
                                  positions=positions, kv_cache=cache,
                                  attn_impl=eng.attn_impl)
            nxt = positions[:, -1:] + 1
            if p and chunked:
                cache["len"] = torch.tensor([cache["len"]], device=dev)
                lg, _ = llm_apply(llm, cfg, embed_tokens(llm, toks),
                                  positions=nxt + torch.arange(p, device=dev),
                                  kv_cache=cache, attn_impl=eng.attn_impl)
            for i in range(p if not chunked else 0):
                lg, _ = llm_apply(llm, cfg, embed_tokens(llm, toks[:, i:i + 1]),
                                  positions=nxt + i, kv_cache=cache,
                                  attn_impl=eng.attn_impl)
            out.append(lg[0, -1].float())
    return tuple(out)


def free_run(dev, quantize) -> dict:
    """(b) / (c): ``load_vla(..., speculative=True)`` and
    ``generate_actions`` over ``FREE_FRAMES`` closed-loop frames (one
    camera image, the gripper moving: frames 1 on are vision-cache hits
    and tail refreshes), beside the plain ``EmmaXVLA`` on the same weights
    and frames. Gate: the same tokens; where they differ, the logits at
    the first differing position are recomputed both ways
    (``logits_both_ways``) and in each the two tokens' logits must lie
    within ``BF16_RTOL`` of the largest |logit| (a near-tie, printed with
    how far the two ways' logits lie apart)."""
    import emmax_torch
    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.serving.speculative import _spec_bf16_oom_risk

    label = quantize or "bf16"
    torch.cuda.reset_peak_memory_stats(dev)
    spec = emmax_torch.load_vla(MODEL_ID, quantize=quantize, device="cuda",
                                speculative=True, seed=0)
    load_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    fenced = _spec_bf16_oom_risk(spec.engine.model.tree())
    plain = EmmaXVLA(spec.cfg, spec.engine.model.tree(), spec.tokenizer,
                     spec.transforms, llm_family=spec.llm_family,
                     device="cuda")
    frame = np.random.default_rng(13).integers(0, 256, (256, 256, 3),
                                               dtype=np.uint8)
    prompts = [spec.get_prompt(TASK, (120 + 4 * f, 90 + 2 * f))
               for f in range(FREE_FRAMES)]
    rec = {"path": label, "fenced": fenced,
           "fallback": spec.engine._bf16_fallback,
           "load_peak_gb": load_peak_gb}
    outs = {}
    for name, vla in (("speculative", spec), ("plain", plain)):
        captured = []
        generate_ids = vla.engine.generate_ids

        def capture(*a, _gen=generate_ids, _out=captured, **kw):
            _out.append(_gen(*a, **kw)[0])
            return _out[-1][None]

        vla.engine.generate_ids = capture
        vla.generate_actions(frame, prompts[0], max_new_tokens=MAX_NEW)
        captured.clear()                                   # warm-up frame
        if name == "speculative":
            vla._last_output_ids = None
            vla.engine._prefix = None
        ms, kinds, steps = [], [], []
        for prompt in prompts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            actions, _ = vla.generate_actions(frame, prompt,
                                              max_new_tokens=MAX_NEW)
            ms.append((time.perf_counter() - t0) * 1e3)
            for a in actions:
                if a.shape != (7,) or not np.isfinite(a).all():
                    raise AssertionError(f"{label} {name}: bad action {a!r}")
            kinds.append(getattr(vla.engine, "last_prefill", None))
            steps.append(getattr(vla.engine, "last_steps", None))
        del vla.engine.generate_ids
        outs[name] = [o.tolist() for o in captured]
        rec[name] = {"request_ms": ms, "prefill": kinds, "steps": steps}
    if not spec.engine._bf16_fallback and rec["speculative"]["prefill"] != [
            "full"] + ["tail"] * (FREE_FRAMES - 1):
        raise AssertionError(f"{label}: prefills "
                             f"{rec['speculative']['prefill']}")
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    rec["tokens_equal"] = outs["speculative"] == outs["plain"]
    if not rec["tokens_equal"]:
        f = next(i for i, (a, b) in enumerate(zip(outs["speculative"],
                                                  outs["plain"])) if a != b)
        a, b = outs["speculative"][f], outs["plain"][f]
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        one, chunk = logits_both_ways(spec, frame, prompts[f], b, p)

        def gap(lg):   # the two tokens' logits, relative to the largest
            return abs(lg[a[p]] - lg[b[p]]).item() / lg.abs().max().item()

        tie = {"frame": f, "position": p, "speculative_token": a[p],
               "plain_token": b[p], "argmax_decode": int(one.argmax()),
               "argmax_chunk": int(chunk.argmax()),
               "gap_decode": gap(one), "gap_chunk": gap(chunk),
               "decode_vs_chunk": (one - chunk).abs().max().item()
               / one.abs().max().item(), "tolerance": BF16_RTOL}
        rec["near_tie"] = tie
        log(f"free run {label}: first difference " + json.dumps(tie))
        if not (tie["gap_decode"] <= BF16_RTOL
                and tie["gap_chunk"] <= BF16_RTOL):
            raise AssertionError(f"free run {label}: tokens differ at frame "
                                 f"{f} position {p}, not a near-tie: "
                                 f"{tie}")
    del spec, plain
    gc.collect()
    torch.cuda.empty_cache()
    log("free run " + json.dumps(rec))
    return rec


def speculative_phase(dev, kernels) -> dict:
    """Full-width Emma-X (int4 weights, random from the seeded generator)
    on the closed-loop ``SpeculativeEngine`` at ``bench.py``'s settings:
    (a) a warm-up episode and a timed episode of forced frames, gated by
    ``check_episode``, and one warm frame profiled; (b) the free run under
    int4 weights and (c) under bf16 weights (``free_run``)."""
    from emmax_torch.models.load import load
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops import int4_matmul
    from emmax_torch.ops.image import preprocess_for_towers
    from emmax_torch.serving.engine import GenerateOptions, VisionCache
    from emmax_torch.serving.speculative import SpeculativeEngine

    cfg, params, tok, transforms, _ = load(MODEL_ID, quantize="int4",
                                           device="cuda", seed=0)
    inputs = closed_loop_inputs(tok)
    pixels = preprocess_for_towers(torch.from_numpy(inputs[2]).to(dev),
                                   transforms)
    eng = SpeculativeEngine(cfg, params, tok,
                            options=GenerateOptions(eos_id=tok.eos_id),
                            vision_cache=VisionCache(capacity=4,
                                                     threshold=0.05),
                            device="cuda", **SPEC_KW)
    warm = closed_loop_episode(eng, inputs, pixels, fa.KERNEL,
                               int4_matmul.KERNEL)
    # frame f's host frame is frame 0's + f levels and a hit is within
    # 6.4 levels (0.05), newest entry first: the first episode misses at
    # frames 0 and 7; the second hits frame 0's own entry (not the
    # prefix's frame-7 patches) and at frame 1 frame 7's, then keeps those
    # (tests/test_torch_speculative_actions.py holds the same frames
    # against the JAX engine)
    check_episode(eng, inputs, warm, {0, 7}, "warm-up episode")
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.reset_counts()
    timed = closed_loop_episode(eng, inputs, pixels, fa.KERNEL,
                                int4_matmul.KERNEL)
    launches = {k.name: k.launches for k in kernels}
    launches_by = {k.name: dict(k.launches_by) for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check_episode(eng, inputs, timed, {0, 1}, "timed episode")
    for k in ("flash_fwd", "int4_matmul"):
        if launches[k] == 0:
            raise AssertionError(f"closed loop launched no {k}")
    frame_ms = [r["ms"] for r in timed]
    warm_ms = float(np.median(frame_ms[1:]))
    # frame 2 once more, as it ran (its host frame hits the prefix's
    # patches: a tail refresh), against its own unprofiled time
    f = SPEC_PROFILE_FRAME
    noisy = {k: v + 0.001 * f for k, v in pixels.items()}
    profile = profile_step(lambda: eng.generate_ids(
        [spec_prompt(f)], noisy, max_new_tokens=SPEC_TOKENS,
        forced_tokens=inputs[0][f], draft_context=timed[f]["context"],
        frame_key=inputs[3][f]), timed[f]["ms"])
    profile.update(frame=f, prefill=eng.last_prefill, steps=eng.last_steps)
    if (eng.last_prefill, eng.last_steps) != ("tail", timed[f]["steps"]):
        raise AssertionError(f"profiled frame: {eng.last_prefill}, "
                             f"{eng.last_steps} steps")
    episode = {
        "frames": SPEC_FRAMES, "tokens_per_frame": SPEC_TOKENS,
        "settings": {**SPEC_KW, "vision_cache": [4, 0.05]},
        "frame_ms": frame_ms, "cold_frame_ms": frame_ms[0],
        "warm_frame_ms_median": warm_ms,
        "steps": [r["steps"] for r in timed],
        "warm_up_steps": [r["steps"] for r in warm],
        "prefills": [r["prefill"] for r in timed],
        "warm_up_prefills": [r["prefill"] for r in warm],
        "verifier_forwards_per_token": sum(r["steps"] for r in timed)
        / (SPEC_FRAMES * SPEC_TOKENS),
        "peak_gb": peak_gb, "launches": launches, "launches_by": launches_by,
        "warm_up_flash_fp32": [r["flash_fp32"] for r in warm],
        "vision_cache": [eng.vision_cache.hits, eng.vision_cache.misses],
        "profile": profile}
    log("closed loop " + json.dumps(episode))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"episode": episode, "int4": free_run(dev, "int4"),
            "bf16": free_run(dev, None)}


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
    # the forward's bf16 kernel (the Llama) and 3xTF32 kernel (fp32
    # towers), the two backward kernels, the paged decode's two kernels
    parts = (("flash_fwd_bf16", "tc::fwd_kernel<"),
             ("flash_fwd_fp32", "tf32::fwd_kernel<"),
             ("flash_bwd_dq", "::dq_kernel<"),
             ("flash_bwd_dkv", "::dkv_kernel<"),
             ("paged_attention", "split_kernel<"),
             ("paged_merge", "merge_kernel<"))
    attn = {key: 0.0 for key, _ in parts}
    for e in prof.events():
        # the engines' emmax_torch.* ranges span kernels; they are not one
        if (e.device_type == DeviceType.CUDA
                and not e.name.startswith("emmax_torch.")):
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
            for key, part in parts:
                if part in e.name:
                    attn[key] += ms
    attn["flash_fwd"] = attn["flash_fwd_bf16"] + attn["flash_fwd_fp32"]
    if not by_name:
        return {"device": "not measured"}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": busy, "busy_share": busy / step_ms,
            "attention_ms": attn, "top_kernels_ms": top}


def align_parity(cfg, params, batch, common, what) -> tuple:
    """One align step's loss and projector gradient from one state,
    through the kernels and through the plain path, in fp32 (held at
    LOSS_RTOL and GRAD_RTOL of the largest entry) and in bf16 (each held
    against the fp32 plain run: the kernels no farther from it than twice
    the plain path's distance, or GRAD_RTOL; the two bf16 paths round
    differently through every decoder layer, so they are not held to each
    other). Returns (the fp32 plain loss, the largest projector gradient
    entry, {path: (loss rel, grad err / max)})."""
    from emmax_torch.training.train_step import make_grad_fn

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
    k32, kb, pb = (parity["cuda_float32"], parity["cuda_bfloat16"],
                   parity["torch_bfloat16"])
    if not (np.isfinite(ref_loss) and k32[0] <= LOSS_RTOL
            and k32[1] <= GRAD_RTOL and kb[0] <= LOSS_RTOL
            and kb[1] <= max(2 * pb[1], GRAD_RTOL)):
        raise AssertionError(f"{what} parity (loss rel, grad err / max) "
                             f"against the fp32 plain step: {parity}")
    return ref_loss, g_scale, parity


def align7b_phase(dev, kernels):
    """Full 7B, align stage: kernel-vs-plain step parity, launch counts per
    step, then timed steps on one batch."""
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step

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

    ref_loss, g_scale, parity = align_parity(cfg, params, batch, common,
                                             "align7b")
    log(f"align7b parity against the fp32 plain step (loss {ref_loss:.6f}, "
        f"projector grad max {g_scale:.4g}): {json.dumps(parity)}")

    step = make_train_step(cfg, tx, attn_impl="cuda", **common)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.reset_counts()
    state, m = step(state, batch)                 # warm-up; counts one step
    torch.cuda.synchronize(dev)
    launches = {k.name: k.launches for k in kernels}
    L = cfg.llm.n_layers
    tower_blocks = sum(v.depth - 1 for _, v in cfg.vision)
    expected = {"flash_fwd": 2 * L + tower_blocks, "flash_bwd_dq": L,
                "flash_bwd_dkv": L, "int4_matmul": 0}
    by_dtype = {k.name: dict(k.launches_by) for k in kernels}
    if launches != expected or by_dtype != {
            k: ({"bfloat16": n} if n else {}) for k, n in expected.items()}:
        raise AssertionError(f"align7b launches per step {launches} (by "
                             f"dtype {by_dtype}) != {expected}, all bf16")
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
        k.reset_counts()
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


def _launches(kernels) -> dict:
    return {k.name: dict(k.launches_by) for k in kernels}


def _launch_delta(before: dict, after: dict) -> dict:
    return {name: {dt: n - before[name].get(dt, 0)
                   for dt, n in by.items() if n != before[name].get(dt, 0)}
            for name, by in after.items()}


def pretrain_chat(root) -> None:
    """The LLaVA-format chat JSON of the pretrain phase (the text of
    ``make_synthetic_chat_json``, which needs OpenCV to write its JPEGs)."""
    examples = []
    for i in range(PT_EXAMPLES):
        ex = {"conversations": [
            {"from": "human", "value": f"<image>\nWhat is in image {i}?"},
            {"from": "gpt", "value": f"A synthetic object number {i}."}]}
        if i % PT_TEXT_EVERY:
            ex["image"] = f"img_{i}.jpg"
        examples.append(ex)
    with open(root / "chat.json", "w") as f:
        json.dump(examples, f)


def pretrain_frames(root, rel):
    """The datasets' ``image_loader``: a seeded uint8 frame per image name
    (None for a text-only example)."""
    if rel is None:
        return None
    i = int(rel[len("img_"):-len(".jpg")])
    return np.random.default_rng(1000 + i).integers(0, 256, PT_FRAME,
                                                    dtype=np.uint8)


def _timed(record: list, fn):
    """``fn`` with each call's seconds (ending in a device sync) appended
    to ``record``."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out

    return wrapped


def pretrain_phase(dev, kernels):
    """``python -m emmax_torch.pretrain``'s align stage at full width with
    ``--cache_vision`` against an uncached run over the same batches, then
    its finetune stage at the vla-train cut."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    from emmax_torch import pretrain as entry
    from emmax_torch.conf import parse_config
    from emmax_torch.data.prefetch import to_device
    from emmax_torch.models.tree import leaves_with_path
    from emmax_torch.models.vlm import emma_x_vlm_config, vlm_forward
    from emmax_torch.training.train_step import cast_params
    from emmax_torch.training.vision_cache import CachedVisionLoader

    def parse(args):
        return parse_config(entry.PretrainConfig, args, choice_fields={
            "model": entry.ModelConfig, "dataset": entry.DatasetConfig})

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="emmax_pretrain_"))
    try:
        pretrain_chat(tmp)
        common = ["--model.type", MODEL_ID, "--attn_impl", "cuda",
                  "--run_root_dir", str(tmp / "runs"),
                  "--dataset.dataset_root_dir", str(tmp),
                  "--dataset.align_stage_components", '["chat.json", "."]',
                  "--dataset.finetune_stage_components",
                  '["chat.json", "."]']
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p = entry.build(parse(common + [
            "--stage", "align", "--cache_vision", "true",
            "--model.align_global_batch_size", str(PT_BATCH),
            "--model.align_epochs", str(PT_EPOCHS)]),
            image_loader=pretrain_frames)
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        cache, inner = p.cache, p.cache.loader

        # (a) modality-pure batches, every example in each epoch
        for epoch in range(PT_EPOCHS):
            idx = inner.batches(epoch)
            pure = all(len({inner.is_multimodal[i] for i in b}) == 1
                       for b in idx)
            if not (pure and {i for b in idx for i in b}
                    == set(range(PT_EXAMPLES))
                    and all(len(b) == PT_BATCH for b in idx)):
                raise AssertionError(f"pretrain: epoch {epoch} batches "
                                     f"{idx} are not modality-pure batches "
                                     f"of {PT_BATCH} covering every example")
        # (b) the encodes a content-keyed store must make, epoch by epoch
        keys, predicted = set(), []
        for epoch in range(PT_EPOCHS):
            misses = 0
            for batch in inner.epoch(epoch):
                new = {CachedVisionLoader.key(r) for r in batch["images"]}
                misses += bool(new - keys)
                keys |= new
            predicted.append(misses)
        # (d) the loader reads the state's own tower tensors
        shared = [a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(
            leaves_with_path(cache.vision),
            leaves_with_path(p.state.params["vision"]))]
        if not (shared and all(shared)):
            raise AssertionError("pretrain: the vision cache holds tower "
                                 "tensors of its own")

        # the uncached run over the same batches, from the same state (only
        # the projector and its moments change in align: kept and restored)
        proj = [t.clone() for _, t in leaves_with_path(
            p.state.params["projector"])]
        opt = {k: ([None if t is None else t.clone() for t in v]
                   if isinstance(v, list) else v)
               for k, v in p.state.opt_state.items()}
        state, plain_losses, plain_ms, plain_steps = p.state, [], [], []
        for epoch in range(PT_EPOCHS):
            for batch in inner.epoch(epoch):
                before = _launches(kernels)
                t0 = time.perf_counter()
                state, m = p.train_step(state, to_device(
                    {k: v for k, v in batch.items()
                     if k != "multimodal_indices"}, p.device))
                plain_losses.append(m["loss"].item())
                plain_ms.append((time.perf_counter() - t0) * 1e3)
                plain_steps.append(_launch_delta(before, _launches(kernels)))
        for (_, t), t0 in zip(leaves_with_path(p.state.params["projector"]),
                              proj):
            t.copy_(t0)
        for k, v in opt.items():
            if isinstance(v, list):
                for t, t0 in zip(p.state.opt_state[k], v):
                    if t is not None:
                        t.copy_(t0)
            else:
                p.state.opt_state[k] = v
        del proj, opt, state

        # the cached run through the entry (counts from 0 just before)
        steps, step_s, encode_s, save_s, ckpt_bytes = [], [], [], [], []
        train_step = p.train_step

        def counted_step(state, batch):
            before = _launches(kernels)
            t0 = time.perf_counter()
            out = train_step(state, batch)
            torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            steps.append(_launch_delta(before, _launches(kernels)))
            return out

        save = p.ckpt.save

        def timed_save(state, **kw):
            t0 = time.perf_counter()
            path = save(state, **kw)
            save_s.append(time.perf_counter() - t0)
            ckpt_bytes.append(sum(f.stat().st_size for f in path.iterdir()))
            shutil.rmtree(path)          # one checkpoint on disk at a time
            return path

        p.train_step, p.ckpt.save = counted_step, timed_save
        cache.encode = _timed(encode_s, cache.encode)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels:
            k.reset_counts()
        t0 = time.perf_counter()
        state = entry.run(p)
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        by_dtype = _launches(kernels)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        kept = torch.cuda.memory_allocated(dev) - resident
        losses = list(p.metrics.deques["loss"])

        L = p.vlm_cfg.llm.n_layers
        tower = sum(v.depth - 1 for _, v in p.vlm_cfg.vision)
        n_steps = PT_EPOCHS * len(inner)
        per_step = {"flash_fwd": {"bfloat16": 2 * L},
                    "flash_bwd_dq": {"bfloat16": L},
                    "flash_bwd_dkv": {"bfloat16": L}, "int4_matmul": {}}
        uncached_step = {**per_step, "flash_fwd": {"bfloat16": 2 * L + tower}}
        if state.step != n_steps or len(losses) != n_steps:
            raise AssertionError(f"pretrain align: step {state.step}, "
                                 f"losses {losses}")
        if cache.encodes != sum(predicted) or predicted[1:] != [0] * (
                PT_EPOCHS - 1) or cache.vision is not None:
            raise AssertionError(f"pretrain: {cache.encodes} encodes against "
                                 f"{predicted} predicted by epoch (towers "
                                 f"released: {cache.vision is None})")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        if not all(np.isfinite(losses)) or max(rel) > PT_CACHE_RTOL:
            raise AssertionError(f"pretrain: cached losses {losses} against "
                                 f"uncached {plain_losses}")
        if any(s != per_step for s in steps) or any(
                s != uncached_step for s in plain_steps):
            raise AssertionError(f"pretrain launches per step: cached "
                                 f"{steps}, uncached {plain_steps}; want "
                                 f"{per_step} / {uncached_step}")
        if by_dtype != {name: {dt: n * n_steps + (
                tower * cache.encodes if name == "flash_fwd" else 0)
                for dt, n in by.items()} for name, by in per_step.items()}:
            raise AssertionError(f"pretrain: the run launched {by_dtype}")
        tower_bytes = _count(p.state.params["vision"]) * 2    # bf16
        if kept > 64 << 20:
            raise AssertionError(f"pretrain: {kept} device bytes kept after "
                                 f"the run (a tower copy is {tower_bytes})")
        align = {
            "build_s": build_s, "run_s": run_s, "steps": n_steps,
            "losses": losses, "uncached_losses": plain_losses,
            "cached_vs_uncached_max_rel": max(rel),
            "bit_equal": losses == plain_losses,
            "encodes": cache.encodes, "encodes_predicted": predicted,
            "encode_ms": [s * 1e3 for s in encode_s],
            "step_ms_cached": [s * 1e3 for s in step_s],
            "step_ms_uncached": plain_ms,
            "step_ms_cached_median": float(np.median(step_s)) * 1e3,
            "step_ms_uncached_median": float(np.median(plain_ms)),
            "cache_entries": len(cache._store), "cache_bytes": cache.nbytes,
            "cache_capacity": cache.capacity,
            "launches": launches, "launches_by_dtype": by_dtype,
            "launches_per_step_cached": per_step,
            "launches_per_step_uncached": uncached_step,
            "device_peak_gb": peak_gb, "device_bytes_kept": kept,
            "tower_bf16_bytes": tower_bytes,
            "checkpoint_gb": [b / 1e9 for b in ckpt_bytes],
            "checkpoint_s": save_s}
        log("pretrain align " + json.dumps(align))
        del p, state, cache, inner, train_step, save
        gc.collect()
        torch.cuda.empty_cache()

        # finetune at the vla-train cut: the kernels' first-step loss against
        # the plain fp32 loss from the same params and batch
        base = emma_x_vlm_config()
        cut = dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, n_layers=VLA_LAYERS))
        torch.cuda.reset_peak_memory_stats(dev)
        p = entry.build(parse(common + [
            "--stage", "finetune", "--max_steps", str(PT_FT_STEPS),
            "--model.finetune_global_batch_size", str(PT_BATCH)]),
            image_loader=pretrain_frames, vlm_cfg=cut)
        first = next(iter(p.loader.epoch(0)))
        batch = to_device({k: v for k, v in first.items()
                           if k != "multimodal_indices"}, p.device)
        from emmax_torch.ops.image import preprocess_for_towers

        with torch.no_grad():
            _, plain_loss, _ = vlm_forward(
                cast_params(p.state.params, torch.float32), cut,
                batch["input_ids"], preprocess_for_towers(
                    batch["images"], p.transforms),
                mask=batch["attention_mask"], labels=batch["labels"],
                attn_impl="torch",
                multimodal_mask=batch["multimodal_mask"])
        plain_loss = plain_loss.item()
        del batch, first
        save_s, ckpt_bytes = [], []
        save = p.ckpt.save
        p.ckpt.save = timed_save
        for k in kernels:
            k.reset_counts()
        t0 = time.perf_counter()
        state = entry.run(p)
        torch.cuda.synchronize(dev)
        ft_s = time.perf_counter() - t0
        ft_launches = _launches(kernels)
        ft_losses = list(p.metrics.deques["loss"])
        ft_rel = abs(ft_losses[0] - plain_loss) / abs(plain_loss)
        want = {"flash_fwd": {"bfloat16": PT_FT_STEPS * (2 * VLA_LAYERS
                                                         + tower)},
                "flash_bwd_dq": {"bfloat16": PT_FT_STEPS * VLA_LAYERS},
                "flash_bwd_dkv": {"bfloat16": PT_FT_STEPS * VLA_LAYERS},
                "int4_matmul": {}}
        if not (state.step == PT_FT_STEPS and np.isfinite(ft_losses).all()
                and ft_rel <= LOSS_RTOL):
            raise AssertionError(f"pretrain finetune: losses {ft_losses}, "
                                 f"plain fp32 first-step loss {plain_loss}")
        if ft_launches != want:
            raise AssertionError(f"pretrain finetune launches {ft_launches} "
                                 f"!= {want}")
        finetune = {"decoder_layers": VLA_LAYERS, "steps": PT_FT_STEPS,
                    "losses": ft_losses, "plain_fp32_loss": plain_loss,
                    "first_step_rel": ft_rel, "run_s": ft_s,
                    "launches_by_dtype": ft_launches,
                    "device_peak_gb": torch.cuda.max_memory_allocated(dev)
                    / 1e9,
                    "checkpoint_gb": [b / 1e9 for b in ckpt_bytes],
                    "checkpoint_s": save_s}
        log("pretrain finetune " + json.dumps(finetune))
        del p, state, save
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "pretrain", "align": align, "finetune": finetune,
           "phase_s": time.perf_counter() - t_phase}
    log("pretrain " + json.dumps({"phase_s": out["phase_s"]}))
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
            k.reset_counts()
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


def rlds_write_episodes(root) -> dict:
    """The phase's TFRecord shards: BridgeV2-shaped episodes of a moving
    square on a per-episode gradient, JPEG-encoded by the port."""
    from emmax_torch.data import codec, rlds

    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:256, 0:256]
    t0 = time.perf_counter()
    n_frames = 0
    for split, ids in (("train", range(RLDS_EPISODES - RLDS_VAL)),
                       ("val", range(RLDS_EPISODES - RLDS_VAL,
                                     RLDS_EPISODES))):
        eps = []
        for i in ids:
            T = int(rng.integers(RLDS_STEPS_RANGE[0], RLDS_STEPS_RANGE[1] + 1))
            base = np.stack([x * (i + 1) % 256, y, (x + y) // 2], -1)
            frames = []
            for t in range(T):
                img = base.copy()
                r0, c0 = 40 + 4 * t, 60 + 3 * t
                img[r0:r0 + 48, c0:c0 + 48] = (200, 40 + 5 * i, 30)
                img = img + rng.integers(-6, 7, img.shape)
                frames.append(codec.encode_jpeg(
                    np.clip(img, 0, 255).astype(np.uint8), 95))
            n_frames += T
            grip = (np.arange(T) // 8 % 2).astype(np.float32)
            eps.append({
                "image_bytes": frames,
                "proprio": np.cumsum(rng.normal(0, 0.01, (T, 7)), 0),
                "action": np.concatenate(
                    [rng.normal(0, 0.02, (T, 6)), grip[:, None]], 1),
                "language": f"put the block {i} in the pot",
                "file_path": f"/data/bridge/raw/traj{i}",
                "episode_id": i})
        rlds.write_episodes(root / f"bridge_orig-{split}-00000.tfrecord", eps)
    return {"episodes": RLDS_EPISODES, "frames": n_frames,
            "bytes": sum(f.stat().st_size for f in root.iterdir()),
            "write_s": time.perf_counter() - t0}


def rlds_gcot_records(root, source) -> dict:
    """The ``rlds`` phase's GCOT records, made by the port's pipeline from
    the phase's shards: ``gcot_generate_plans.main`` per split (soft
    segmentation through the port's HDBSCAN, ``HeuristicAnnotator``) then
    ``gcot_create_dataset.main`` in ``single_policy`` mode.

    The reference keeps an episode only if its segment ids, numbered by
    first appearance, change as many times as there are ids; an episode
    whose clustering returns to an earlier cluster is dropped as "wrong
    segment number" (the JAX package the same). Raises unless each
    episode's verdict is the one its segments predict, no other kind of
    rejection occurs, each split keeps one episode or more, the samples
    number sum(T - 1) over the kept episodes, and each
    ``current_image_path`` names a frame of ``source.index``."""
    from emmax_torch import gcot_create_dataset as create
    from emmax_torch import gcot_generate_plans as plans_cli
    from emmax_torch.data.gcot import parse_image_path

    t0 = time.perf_counter()
    segments, kept = {}, []
    want_reports = {}
    for split in ("train", "val"):
        plans = plans_cli.main(plans_cli.PlansConfig(
            data_dir=root, split=split, out_dir=root / "gcot_plans",
            segmentation="soft"))
        segments[split] = [max(segs) for _, segs, _ in plans.values()]
        for key, (_, segs, _) in plans.items():
            runs = 1 + sum(a != b for a, b in zip(segs, segs[1:]))
            if runs == max(segs):
                kept.append(key)
        n_kept = sum(k in kept for k in plans)
        want_reports[split] = {"valid": n_kept}
        if n_kept < len(plans):
            want_reports[split]["wrong segment number"] = len(plans) - n_kept
    records, _, reports = create.main(create.AssembleConfig(
        data_dir=root, plans_dir=root / "gcot_plans",
        out_root=root / "gcot_dataset", tag="single_policy",
        mode="single_policy"))
    generate_s = time.perf_counter() - t0
    for split, want in want_reports.items():
        if reports.get(split) != want or not want["valid"]:
            raise AssertionError(f"gcot {split}: {reports.get(split)}, want "
                                 f"{want}")
    want = sum(len(source.index[k]) - 1 for k in kept)
    if len(records) != want:
        raise AssertionError(f"gcot: {len(records)} samples, want {want}")
    for r in records:
        key, i = parse_image_path(r["current_image_path"])
        if key not in kept or not 0 <= i < len(source.index[key]):
            raise AssertionError(f"gcot: {r['current_image_path']} names "
                                 "no frame of a kept episode")
    out = {"segments": segments, "reports": reports, "samples": len(records),
           "generate_s": generate_s}
    log("rlds gcot generation " + json.dumps(out))
    return {"records": records, **out}


def _waited(it, record: list):
    """``it`` with the seconds each ``next`` blocked appended to
    ``record``."""
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        record.append(time.perf_counter() - t0)
        yield batch


def rlds_phase(dev, kernels):
    """The RLDS data path on the card at vla-train's cut: GCOT steps with
    RLDS frames, OpenVLA RLDS steps, the frame store and determinism."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    from emmax_torch.data import codec
    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.framestore import (FrameStore,
                                             pack_rlds_to_framestore)
    from emmax_torch.data.gcot import GCOTDataset
    from emmax_torch.data.prefetch import PrefetchingLoader
    from emmax_torch.data.rlds import RLDSFrameSource
    from emmax_torch.data.rlds_vla import StreamingBatcher
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.training.loop import (LoopConfig, make_eval_fn,
                                           run_discrete_vla_training,
                                           run_vla_training)
    from emmax_torch.training.metrics import VLADiscreteMetrics
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.materialize import get_vla_dataset_and_collator
    from emmax_torch.vla.solver import Solver
    from emmax_torch.vla.tokenizer import load_tokenizer

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="emmax_rlds_"))
    try:
        data = rlds_write_episodes(tmp)
        t0 = time.perf_counter()
        codec.lib()
        build_s = time.perf_counter() - t0      # 0 once the writer built it

        base = emma_x_vlm_config()
        cfg = dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, n_layers=VLA_LAYERS))
        tokenizer = load_tokenizer(None)
        at = ActionTokenizer(tokenizer)
        gen = torch.Generator(dev)
        gen.manual_seed(3)
        params = init_vlm_params(gen, cfg, torch.float32, dev)
        stage = stage_from_flags(True, False, False)
        tx, schedule = make_optimizer(
            params, learning_rate=2e-5, weight_decay=0.0, max_grad_norm=1.0,
            lr_scheduler_type="constant",
            total_steps=RLDS_GCOT_STEPS + RLDS_VLA_STEPS, stage=stage)
        state = create_train_state(params, tx)
        transforms = get_image_transforms("dinosiglip-vit-so-224px",
                                          "resize-naive")
        step_fn = make_train_step(
            cfg, tx, attn_impl="cuda", remat=True,
            compute_dtype=torch.bfloat16, transforms=transforms,
            stop_vision_gradient=True,
            freeze_mask=trainable_mask(params, stage),
            action_vocab_size=tokenizer.vocab_size)
        eval_fn = make_eval_fn(cfg, transforms=transforms, attn_impl="cuda",
                               compute_dtype=torch.bfloat16)

        def gate(name, metrics, launches, steps):
            losses = list(metrics.deques["loss"])
            if len(losses) != steps or not np.isfinite(losses).all():
                raise AssertionError(f"rlds {name}: losses {losses}")
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                if launches[k] == 0:
                    raise AssertionError(f"rlds {name} launched no {k}")
            return losses

        # (a) Emma-X's GCOT loop on records the port's GCOT pipeline made
        # from the shards, with frames from the shards
        t0 = time.perf_counter()
        source = RLDSFrameSource(tmp)
        index_s = time.perf_counter() - t0
        generated = rlds_gcot_records(tmp, source)
        dataset = GCOTDataset(generated.pop("records"), at, tokenizer,
                              source, data_mix="movement_policy",
                              mask_inst=True)
        loader = BatchLoader(dataset, VLA_B, lambda s: collate_train(
            s, tokenizer.pad_id, max_length=cfg.llm.max_seq_len), seed=7)
        gcot_wait: list = []
        gcot_metrics = VLADiscreteMetrics([])
        for k in kernels:
            k.reset_counts()
        t0 = time.perf_counter()
        state = run_discrete_vla_training(
            vlm_cfg=cfg, state=state, train_step=step_fn,
            loader=_WaitedLoader(PrefetchingLoader(loader, dev), gcot_wait),
            metrics=gcot_metrics,
            loop_cfg=LoopConfig(epochs=1, max_steps=RLDS_GCOT_STEPS,
                                eval_every=1000, save_every=1000,
                                log_every=1), device=dev)
        torch.cuda.synchronize(dev)
        gcot_s = time.perf_counter() - t0
        gcot_launches = {k.name: k.launches for k in kernels}
        gcot_losses = gate("gcot", gcot_metrics, gcot_launches,
                           RLDS_GCOT_STEPS)

        # (b) OpenVLA's RLDS loop: augmented, resized, shuffled stream
        def stream():
            ds, collate = get_vla_dataset_and_collator(
                tmp, "bridge_orig", at, tokenizer, image_aug=True,
                resize_resolution=(224, 224),
                shuffle_buffer_size=RLDS_SHUFFLE)
            return ds, StreamingBatcher(ds, VLA_B, collate)

        ds, batcher = stream()
        vla_wait: list = []
        vla_metrics = VLADiscreteMetrics([])
        for k in kernels:
            k.reset_counts()
        t0 = time.perf_counter()
        state = run_vla_training(
            vlm_cfg=cfg, state=state, train_step=step_fn,
            batch_iter=_waited(iter(PrefetchingLoader(batcher, dev).epoch(0)),
                               vla_wait),
            metrics=vla_metrics, max_steps=RLDS_VLA_STEPS,
            loop_cfg=LoopConfig(eval_every=RLDS_VLA_STEPS, save_every=1000,
                                log_every=1), device=dev,
            tokenizer=tokenizer, solver=Solver(at), eval_fn=eval_fn)
        torch.cuda.synchronize(dev)
        vla_s = time.perf_counter() - t0
        vla_launches = {k.name: k.launches for k in kernels}
        vla_losses = gate("vla", vla_metrics, vla_launches, RLDS_VLA_STEPS)
        if state.step != RLDS_GCOT_STEPS + RLDS_VLA_STEPS:
            raise AssertionError(f"rlds: state at step {state.step}")
        if "solver_action_accuracy" not in vla_metrics.deques:
            raise AssertionError("rlds: no Solver eval ran")
        del state, params, tx, step_fn, eval_fn
        gc.collect()
        torch.cuda.empty_cache()

        # host cost of a batch: a fresh stream, batches one after another
        # (the first fills the shuffle buffer)
        _, fresh = stream()
        it = iter(fresh)
        assemble_ms = []
        for _ in range(4):
            t0 = time.perf_counter()
            next(it)
            assemble_ms.append((time.perf_counter() - t0) * 1e3)

        # determinism: two passes of one stream give equal batches
        passes = []
        for _ in range(2):
            it = iter(batcher)
            passes.append([next(it) for _ in range(2)])
        for a, b in zip(*passes):
            for key in ("input_ids", "labels", "attention_mask", "images"):
                if not np.array_equal(a[key], b[key]):
                    raise AssertionError(f"rlds: two passes differ in {key}")

        # the frame store: ISLOW frames equal the RLDS frames decoded so
        t0 = time.perf_counter()
        store = FrameStore(pack_rlds_to_framestore(tmp, tmp / "bridge.efs"))
        pack_s = time.perf_counter() - t0
        keys, idxs, blobs = [], [], []
        for key in store.keys():
            n, _, _ = store.traj_info(key)
            for i in range(n):
                keys.append(key)
                idxs.append(i)
                blobs.append(source.index[key][i])
        for key, i, blob in zip(keys, idxs, blobs):
            if not np.array_equal(store.get_frame(key, i),
                                  codec.decode_jpeg(blob, "islow")):
                raise AssertionError(f"rlds: store frame {key}[{i}] differs")
        t0 = time.perf_counter()
        for blob in blobs:
            codec.decode_jpeg(blob, "ifast")
        one_fps = len(blobs) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        store.get_batch(keys, idxs)
        batch_fps = len(blobs) / (time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gcot_steps = list(gcot_metrics.step_times)
    vla_steps = list(vla_metrics.step_times)
    out = {"phase": "rlds", **data, "decoder_layers": VLA_LAYERS,
           "batch": VLA_B, "codec_build_s": build_s, "index_s": index_s,
           "gcot_generation": generated,
           "gcot": {"steps": RLDS_GCOT_STEPS, "losses": gcot_losses,
                    "launches": gcot_launches, "loop_s": gcot_s,
                    "step_s": gcot_steps,
                    "data_wait_ms": [w * 1e3 for w in gcot_wait]},
           "vla": {"steps": RLDS_VLA_STEPS, "losses": vla_losses,
                   "launches": vla_launches, "loop_s": vla_s,
                   "step_s": vla_steps,
                   "data_wait_ms": [w * 1e3 for w in vla_wait],
                   "solver_action_accuracy":
                       list(vla_metrics.deques["solver_action_accuracy"])},
           "assemble_batch_ms": assemble_ms,
           "step_ms_median": float(np.median(vla_steps[1:] or vla_steps)
                                   * 1e3),
           "decode_fps_one_thread_ifast": one_fps,
           "decode_fps_store_batch_islow": batch_fps,
           "store_frames": len(blobs), "pack_s": pack_s,
           "store_equals_rlds_islow": True, "passes_equal": True,
           "phase_s": time.perf_counter() - t_phase}
    log("rlds " + json.dumps(out))
    return out


class _WaitedLoader:
    """A loader whose epochs record each batch's wait (``_waited``)."""

    def __init__(self, loader, record: list) -> None:
        self.loader, self.record = loader, record

    def epoch(self, epoch: int = 0):
        return _waited(iter(self.loader.epoch(epoch)), self.record)


def _grad_groups(grads, layer: int) -> dict:
    """The gradients the vla-full-train parity compares, as fp32 lists:
    each tower's, the projector's, and decoder layer ``layer``'s."""
    from emmax_torch.models.tree import leaves_with_path

    groups = {"dino": [], "siglip": [], "projector": [],
              f"llm_layer{layer}": []}
    for path, g in leaves_with_path(grads):
        if path.startswith("vision/dino/"):
            groups["dino"].append(g.float())
        elif path.startswith("vision/siglip/"):
            groups["siglip"].append(g.float())
        elif path.startswith("projector/"):
            groups["projector"].append(g.float())
        elif path.startswith("llm/layers/"):
            groups[f"llm_layer{layer}"].append(g[layer].float())
    return groups


def vla_full_train_fp32_phase(dev, kernels):
    """Emma-X's own stage, vla-full-train (towers, projector and LLM
    trained; ``stop_vision_gradient=False``), in fp32 compute (the step
    ``emmax_torch/train.py`` builds when mixed precision is off): full
    width, the decoder cut to ``VLA_LAYERS``, ``VLA_B`` GCOT records
    through ``GCOTDataset`` -> ``collate_train``, attention through the
    kernels, full remat. One step's loss and gradients against the plain
    path from the same params and batch; the fp32 kernels' launches per
    step, counted by dtype; then optimizer steps: losses, step ms, peak
    memory, and one profiled step."""
    import dataclasses

    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.gcot import (GCOTDataset, SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.prefetch import to_device
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import (make_grad_fn,
                                                  make_train_step)
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.tokenizer import load_tokenizer

    base = emma_x_vlm_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=VLA_LAYERS))
    tokenizer = load_tokenizer(None)
    dataset = GCOTDataset(make_dummy_gcot_items(4 * VLA_B),
                          ActionTokenizer(tokenizer), tokenizer,
                          SyntheticFrameSource(256),
                          data_mix="movement_policy", mask_inst=True)
    loader = BatchLoader(dataset, VLA_B, lambda s: collate_train(
        s, tokenizer.pad_id, max_length=cfg.llm.max_seq_len), seed=7)
    batches = [to_device(b, dev) for b in list(loader.epoch(0))[:FULL_STEPS]]
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    stage = stage_from_flags(False, False, False)
    if stage != "vla-full-train":
        raise AssertionError(f"stage_from_flags gave {stage}")
    freeze = trainable_mask(params, stage)
    common = dict(remat=True, stop_vision_gradient=False,
                  compute_dtype=torch.float32,
                  transforms=get_image_transforms("dinosiglip-vit-so-224px",
                                                  "resize-naive"),
                  freeze_mask=freeze, action_vocab_size=tokenizer.vocab_size)
    n_train = sum(t.numel() for m, t in zip(_leaves(freeze), _leaves(params))
                  if m)

    # one step's loss and gradients from the same params and batch,
    # through the kernels and through the plain path
    results = {}
    for impl in ("torch", "cuda"):
        loss, _, grads = make_grad_fn(cfg, attn_impl=impl, **common)(
            params, batches[0])
        results[impl] = (loss.item(), _grad_groups(grads, VLA_LAYERS - 1))
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    ref_loss, ref = results["torch"]
    loss, got = results["cuda"]
    parity = {"loss_rel": abs(loss - ref_loss) / abs(ref_loss)}
    for name, gs in ref.items():
        scale = max(g.abs().max().item() for g in gs)
        parity[f"{name}_grad_err_over_max"] = max(
            (a - b).abs().max().item() for a, b in zip(got[name], gs)) / scale
        parity[f"{name}_grad_max"] = scale
    del results, ref, got
    bad = {k: v for k, v in parity.items() if k.endswith("over_max")
           and not v <= FULL_GRAD_RTOL}
    if not (np.isfinite(ref_loss) and parity["loss_rel"] <= FULL_LOSS_RTOL
            and not bad):
        raise AssertionError(f"vla-full-train-fp32 parity against the plain "
                             f"step (loss rel tol {FULL_LOSS_RTOL}, grad "
                             f"tol {FULL_GRAD_RTOL}): {parity}")
    log(f"vla-full-train-fp32 parity against the plain step (loss "
        f"{ref_loss:.6f}): {json.dumps(parity)}")

    tx, _ = make_optimizer(params, learning_rate=2e-5, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=FULL_STEPS, stage=stage)
    state = create_train_state(params, tx)
    step = make_train_step(cfg, tx, attn_impl="cuda", **common)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.reset_counts()
    times, losses = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        vals = {k: v.item() for k, v in m.items()}   # ends in a sync
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(vals["loss"])
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"vla-full-train-fp32: non-finite metrics "
                                 f"{vals}")
        if i == 0:       # the first step's launches, by dtype
            launches = {k.name: dict(k.launches_by) for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_ms = float(np.median(times[1:]))
    profile = profile_step(lambda: step(state, batches[-1])[1]["loss"].item(),
                           step_ms)
    log("vla-full-train-fp32 profile " + json.dumps(profile))
    tower_blocks = sum(v.depth - 1 for _, v in cfg.vision)
    # towers once (not rematerialized), each decoder layer twice (its
    # forward and full remat's rerun); one dQ and one dK/dV each
    expected = {"flash_fwd": {"float32": 2 * VLA_LAYERS + tower_blocks},
                "flash_bwd_dq": {"float32": VLA_LAYERS + tower_blocks},
                "flash_bwd_dkv": {"float32": VLA_LAYERS + tower_blocks},
                "int4_matmul": {}}
    if launches != expected:
        raise AssertionError(f"vla-full-train-fp32 launches per step by "
                             f"dtype {launches} != {expected}")
    out = {"phase": "vla-full-train-fp32", "stage": stage,
           "decoder_layers": VLA_LAYERS, "params_b": _count(params) / 1e9,
           "trainable_b": n_train / 1e9, "batch": VLA_B,
           "fused_seq": int(batches[0]["input_ids"].shape[1]
                            + cfg.num_patches - 1),
           "parity": parity, "loss_fp32_plain": ref_loss,
           "launches_per_step": launches, "losses": losses,
           "step_ms": times, "step_ms_after_first": step_ms,
           "peak_gb": peak_gb, "profile": profile}
    log("vla-full-train-fp32 " + json.dumps(out))
    del state, step, params, tx, batches, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- eval --

class _Metered:
    """A VLA whose ``generate_actions`` calls are timed on the host clock
    (a sync on each side) and whose flash-forward launches by dtype and
    int4 launches are read just before and just after each call; keeps
    each decode's text, actions and the engine's CUDA-event timings."""

    def __init__(self, vla, fa_kernel, int4_kernel):
        self.vla, self.fa, self.i4 = vla, fa_kernel, int4_kernel
        self.rows = []

    def get_prompt(self, *args):
        return self.vla.get_prompt(*args)

    def generate_actions(self, image, prompt, **kw):
        before, before_i4 = dict(self.fa.launches_by), self.i4.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions, text = self.vla.generate_actions(image, prompt, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = dict(self.fa.launches_by)
        self.rows.append({
            "ms": ms, "n_actions": len(actions), "text": text,
            "actions": [np.asarray(x).tolist() for x in actions],
            "launches": {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("float32", "bfloat16")},
            "int4_launches": self.i4.launches - before_i4,
            "timings": dict(self.vla.engine.last_timings)})
        return actions, text


def eval_tiny_parity(dev) -> dict:
    """(a) The tiny Emma-X (fp32, vocab 1024), weights drawn once on the
    host and moved, through ``evaluate_policy(VLAEnvPolicy)`` on the card
    (the kernels) and on the CPU (the plain versions): the same texts,
    actions, frames and report."""
    from emmax_torch.eval_success_rate import VLAEnvPolicy, build_tiny_vla
    from emmax_torch.experiments.kinematic_sim import TASKS, evaluate_policy
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops import int4_matmul as i4

    generator = torch.Generator("cpu")
    generator.manual_seed(0)
    params = init_vlm_params(generator, tiny_vlm_config(vocab_size=1024))
    task = next(iter(TASKS))
    runs = []
    for device, p in (("cpu", params), (dev, _tree_to(params, dev))):
        meter = _Metered(build_tiny_vla(device, params=p), fa.KERNEL,
                         i4.KERNEL)
        frames = []
        report = evaluate_policy(
            VLAEnvPolicy(meter, max_new_tokens=EVAL_TINY_NEW), tasks=[task],
            episodes_per_task=1, max_steps=EVAL_TINY_STEPS,
            on_frame=lambda n, ep, img, frames=frames: frames.append(
                img.tobytes()))
        runs.append((report, [(r["text"], r["actions"]) for r in meter.rows],
                     frames))
    if runs[0] != runs[1]:
        raise AssertionError(f"eval tiny: card {runs[1][:2]} != CPU "
                             f"{runs[0][:2]}")
    out = {"task": task, "steps": len(runs[1][2]),
           "decodes": len(runs[1][1]),
           "tokens_equal": True, "frames_equal": True}
    log("eval tiny card == CPU " + json.dumps(out))
    return out


def paged_modes_full(cfg, params, tok, pixels, prompt, kernels):
    """(d) The paged engine's ``gather2`` / ``pagescan`` / ``poolmask`` at
    full width on the int4 model, int8 pages: each mode's first decode
    step on one admitted pool against ``gather``'s (logits rel-RMSE within
    the mode's ``EVAL_PAGED_RMSE``; the kernel's distance printed beside
    it), then one batch of the six requests, ``EVAL_PAGED_NEW`` new tokens
    each, in one burst: aggregate tok/s, admission and burst ms, launches."""
    from emmax_torch.serving.paged import (PagedServingEngine,
                                           _paged_decode_step)

    kw = {**PAGED_KW, "burst": EVAL_PAGED_NEW}
    # admission is the same in every mode; poolmask's engine also hands
    # out its page ownership (``_ownership``)
    eng = PagedServingEngine(cfg, params, tok, paged_attn="poolmask",
                             quantized_cache=True, device="cuda", **kw)
    for px in pixels:
        eng.submit(prompt, px, max_new_tokens=EVAL_PAGED_NEW)
    eng._admit()
    eng._ensure_pages()
    steps = {}
    for mode in ("gather", "kernel") + EVAL_PAGED_MODES:
        _, nxt, logits = _paged_decode_step(
            params["llm"], cfg.llm, eng.pool, page_size=kw["page_size"],
            n_pages=kw["n_pages"], paged_attn=mode, **eng._ownership())
        steps[mode] = (nxt, logits)
    first = {}
    for mode in ("kernel",) + EVAL_PAGED_MODES:
        rmse = _rel_rmse(steps[mode][1], steps["gather"][1])
        agree = int((steps[mode][0] == steps["gather"][0]).sum())
        first[mode] = {"logit_rel_rmse": rmse, "argmax_agree": agree}
        if mode != "kernel" and not rmse <= EVAL_PAGED_RMSE[mode]:
            raise AssertionError(f"{mode} first decode step: logits "
                                 f"rel-RMSE {rmse:.3g} from gather's "
                                 f"(limit {EVAL_PAGED_RMSE[mode]})")
    del eng
    runs = {}
    for mode in EVAL_PAGED_MODES:
        for k in kernels:
            k.reset_counts()
        make = (lambda mode=mode, **o: PagedServingEngine(
            cfg, params, tok, paged_attn=mode, quantized_cache=True,
            device="cuda", **{**kw, **o}))
        _, out, rec = serve(make, lambda e: [
            e.submit(prompt, px, max_new_tokens=EVAL_PAGED_NEW)
            for px in pixels])
        rec["launches"] = {k.name: k.launches for k in kernels}
        for o in out:
            if len(o) == 0 or any(not (0 <= t < cfg.llm.vocab_size)
                                  for t in o):
                raise AssertionError(f"paged {mode}: bad tokens {o[:8]}")
        for kname in ("flash_fwd", "int4_matmul"):
            if rec["launches"][kname] == 0:
                raise AssertionError(f"paged {mode}: launched no {kname}")
        runs[mode] = rec
    out = {"first_step_vs_gather": first, "runs": runs,
           "requests": len(pixels), "new_tokens": EVAL_PAGED_NEW,
           "rmse_limit": EVAL_PAGED_RMSE}
    log("paged new modes " + json.dumps(out))
    return out


def eval_phase(dev, kernels) -> dict:
    """Robot evaluation on the card: (a) ``eval_tiny_parity``; (b)
    full-width Emma-X (bf16, phase 5's seed) through
    ``evaluate_policy(VLAEnvPolicy)`` on every task of the kinematic world,
    then one ``run_closed_loop`` episode on ``DummyEnv``'s 256x256 frames
    with the ``GripperLocator``; (c) ``eval_success_rate``'s scripted mode
    and its fixture -> gt_replay round trip, host only. Between (b) and
    (c), one int4 episode: the first task's loop on int4 weights. (d)
    lives in ``tiny_batched_parity`` and ``batched_phase``."""
    import contextlib
    import io
    import tempfile

    import emmax_torch
    from emmax_torch.bridge_eval import DummyEnv
    from emmax_torch.eval_success_rate import VLAEnvPolicy
    from emmax_torch.eval_success_rate import main as esr_main
    from emmax_torch.experiments.gripper import GripperLocator
    from emmax_torch.experiments.kinematic_sim import TASKS, evaluate_policy
    from emmax_torch.experiments.policy import run_closed_loop
    from emmax_torch.ops import flash_attention as fa
    from emmax_torch.ops import int4_matmul as i4

    t_phase = time.perf_counter()
    out = {"phase": "eval", "tiny": eval_tiny_parity(dev)}
    tiny_s = time.perf_counter() - t_phase

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vla = emmax_torch.load_vla(MODEL_ID, device="cuda", seed=0)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    blocks = sum(v.depth - 1 for _, v in vla.cfg.vision)
    layers = vla.cfg.llm.n_layers
    want = {"float32": blocks, "bfloat16": layers}
    for k in kernels:
        k.reset_counts()
    meter = _Metered(vla, fa.KERNEL, i4.KERNEL)
    stepped = []
    t0 = time.perf_counter()
    report = evaluate_policy(
        VLAEnvPolicy(meter, max_new_tokens=EVAL_NEW), tasks=list(TASKS),
        episodes_per_task=1, max_steps=EVAL_TASK_STEPS,
        on_frame=lambda n, ep, img: stepped.append(n))
    torch.cuda.synchronize(dev)
    sim_s = time.perf_counter() - t0
    sim_launches = {k.name: k.launches for k in kernels}
    if len(stepped) != len(TASKS) * EVAL_TASK_STEPS:
        raise AssertionError(f"evaluate_policy took {len(stepped)} env "
                             f"steps, not {len(TASKS) * EVAL_TASK_STEPS}")
    # (c) host work outside the decode: the env's step and render, the
    # prompt, the policy's bookkeeping; the Solver's parse of one text
    t0 = time.perf_counter()
    vla.solver.extract_action_policies(meter.rows[0]["text"])
    parse_ms = (time.perf_counter() - t0) * 1e3
    decode_ms = [r["ms"] for r in meter.rows]
    host_ms_per_step = (sim_s * 1e3 - sum(decode_ms)) / len(stepped)

    env = DummyEnv(seed=0)
    loop_meter = _Metered(vla, fa.KERNEL, i4.KERNEL)
    t0 = time.perf_counter()
    log_ep = run_closed_loop(loop_meter, env, TASK,
                             gripper_locator=GripperLocator(),
                             max_steps=EVAL_LOOP_STEPS,
                             max_new_tokens=EVAL_NEW)
    torch.cuda.synchronize(dev)
    loop_s = time.perf_counter() - t0
    if len(env.executed) != EVAL_LOOP_STEPS or len(log_ep.actions) != \
            EVAL_LOOP_STEPS:
        raise AssertionError(f"run_closed_loop executed "
                             f"{len(env.executed)} actions, not "
                             f"{EVAL_LOOP_STEPS}")
    for r in meter.rows + loop_meter.rows:
        if r["launches"] != want or r["int4_launches"] != 0:
            raise AssertionError(f"eval decode launched {r['launches']} "
                                 f"flash_fwd by dtype, not {want}, and "
                                 f"{r['int4_launches']} int4")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    one = meter.rows[-1]["timings"]
    loop_ms = [r["ms"] for r in loop_meter.rows]
    out["full"] = {
        "model": MODEL_ID, "dtype": "bfloat16", "load_s": load_s,
        "tasks": len(TASKS), "steps_per_task": EVAL_TASK_STEPS,
        "new_tokens": EVAL_NEW, "frame_px": 128, "report": report,
        "env_steps": len(stepped), "decodes": len(meter.rows),
        "actions_per_decode": [r["n_actions"] for r in meter.rows],
        "decode_ms_median": float(np.median(decode_ms)),
        "decode_ms_max": float(np.max(decode_ms)),
        "one_decode_events_ms": {k: one.get(k) for k in (
            "encode_ms", "prefill_ms", "decode_ms", "decode_forwards")},
        "host_ms_per_step": host_ms_per_step, "parse_ms": parse_ms,
        "actions_per_s": len(stepped) / sim_s, "sim_s": sim_s,
        "launches_per_decode_by_dtype": want,
        "launches": sim_launches,
        "closed_loop": {"frame_px": 256, "steps": EVAL_LOOP_STEPS,
                        "decodes": len(loop_meter.rows),
                        "decode_ms": loop_ms, "wall_s": loop_s,
                        "actions_per_s_amortized":
                            len(log_ep.actions) / loop_s},
        "peak_gb": peak_gb}
    decodes = len(meter.rows) + len(loop_meter.rows)
    del vla, meter, loop_meter
    gc.collect()
    torch.cuda.empty_cache()

    # the int4 episode: one task of the same loop on int4 weights (the
    # int4 kernel on 7 weights a layer and the lm_head, every forward)
    t0 = time.perf_counter()
    vla = emmax_torch.load_vla(MODEL_ID, quantize="int4", device="cuda",
                               seed=0)
    torch.cuda.synchronize(dev)
    load4_s = time.perf_counter() - t0
    meter = _Metered(vla, fa.KERNEL, i4.KERNEL)
    t0 = time.perf_counter()
    report4 = evaluate_policy(
        VLAEnvPolicy(meter, max_new_tokens=EVAL_NEW),
        tasks=[next(iter(TASKS))], episodes_per_task=1,
        max_steps=EVAL_TASK_STEPS)
    torch.cuda.synchronize(dev)
    sim4_s = time.perf_counter() - t0
    for r in meter.rows:
        forwards = 1 + r["timings"]["decode_forwards"]
        int4 = (7 * layers + 1) * forwards
        if r["launches"] != want or r["int4_launches"] != int4:
            raise AssertionError(f"int4 eval decode launched "
                                 f"{r['launches']} flash_fwd, "
                                 f"{r['int4_launches']} int4 (want {want}, "
                                 f"{int4} in {forwards} forwards)")
    ms4 = [r["ms"] for r in meter.rows]
    out["int4"] = {
        "load_s": load4_s, "report": report4, "decodes": len(meter.rows),
        "decode_ms_median": float(np.median(ms4)),
        "decode_ms_max": float(np.max(ms4)),
        "one_decode_events_ms": {k: meter.rows[-1]["timings"].get(k) for k
                                 in ("encode_ms", "prefill_ms", "decode_ms",
                                     "decode_forwards")},
        "int4_launches_per_decode": [r["int4_launches"] for r in meter.rows],
        "actions_per_s": EVAL_TASK_STEPS / sim4_s, "sim_s": sim4_s,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    out["launches_eval"] = {
        "per_decode_by_dtype": want,
        "phase": {"float32": fa.KERNEL.launches_by.get("float32", 0),
                  "bfloat16": fa.KERNEL.launches_by.get("bfloat16", 0)},
        "decodes": decodes + len(meter.rows)}
    out["int4_launches_eval"] = {
        "per_decode": out["int4"]["int4_launches_per_decode"],
        "phase": i4.KERNEL.launches, "decodes": len(meter.rows)}
    del vla, meter
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    host = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in (
                ("scripted", ["--mode", "scripted", "--episodes_per_task",
                              "1"]),
                ("fixture", ["--mode", "fixture", "--data", tmp,
                             "--episodes_per_task", "1"]),
                ("gt_replay", ["--mode", "gt_replay", "--data", tmp])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = esr_main(argv)
            if json.loads(buf.getvalue().strip().splitlines()[-1]) != res:
                raise AssertionError(f"eval_success_rate {name}: its JSON "
                                     "line differs from its result")
            host[name] = res
    rates = [host["scripted"]["overall_success_rate"],
             *host["scripted"]["per_task"].values(),
             host["fixture"]["expert_success_rate"],
             host["gt_replay"]["overall_success_rate"]]
    if rates != [1.0] * len(rates) or host["gt_replay"]["episodes"] != \
            len(TASKS):
        raise AssertionError(f"eval_success_rate host modes: {host}")
    out["host"] = {"scripted": host["scripted"]["per_task"],
                   "fixture_episodes": host["fixture"]["episodes"],
                   "gt_replay": host["gt_replay"]["overall_success_rate"],
                   "host_s": time.perf_counter() - t0}
    out["tiny_s"] = tiny_s
    out["phase_s"] = time.perf_counter() - t_phase
    log("eval " + json.dumps(out))
    return out


def _mesh_gate(what: str, got: float, want: float) -> float:
    """The relative distance of a wrapped value from the unwrapped one,
    held at MESH_RTOL (the same kernels on the same tensors: 0 expected)."""
    err = abs(got - want) / max(abs(want), 1e-30)
    if not (np.isfinite(got) and err <= MESH_RTOL):
        raise AssertionError(f"multigpu {what}: {got} against unwrapped "
                             f"{want} (rel {err})")
    return err


def _counted(kernels, run):
    """``run()`` with every kernel's counts set to 0 just before and read
    just after: (result, launches, launches by dtype)."""
    for k in kernels:
        k.reset_counts()
    out = run()
    torch.cuda.synchronize()
    return (out, {k.name: k.launches for k in kernels},
            {k.name: dict(k.launches_by) for k in kernels})


def _mesh_align7b(dev, kernels, mesh) -> dict:
    """The full 7B align step through ``make_train_step(..., mesh=mesh)`` on
    ``shard_params`` of the params, against the unwrapped step from the
    same state: loss, grad norm, projector gradient and updated projector,
    launches per step, the wrapped step's device peak minus the unwrapped
    one's, step times in turns."""
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.parallel import shard_params
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    from emmax_torch.training.train_step import (make_grad_fn,
                                                  make_train_step)

    cfg = emma_x_vlm_config()
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    sharded = shard_params(params, mesh)
    # gather-at-use at size 1: every block is the leaf itself
    if not all(a.data_ptr() == b.data_ptr() for a, b in
               zip(_leaves(params), _leaves(sharded))):
        raise AssertionError("multigpu: shard_params copied a leaf at "
                             "world size 1")
    tx, _ = make_optimizer(params, learning_rate=2e-5, weight_decay=0.01,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=100, stage="align")
    batch = align_batch(dev, 32000)
    common = dict(attn_impl="cuda", remat=True, stop_vision_gradient=True,
                  compute_dtype=torch.bfloat16,
                  transforms=get_image_transforms("dinosiglip-vit-so-224px",
                                                  "resize-naive"),
                  freeze_mask=trainable_mask(params, "align"),
                  action_vocab_size=32000)
    grads = {}
    for key, tree, m in (("unwrapped", params, None),
                         ("mesh", sharded, mesh)):
        loss, _, g = make_grad_fn(cfg, mesh=m, **common)(tree, batch)
        grads[key] = (loss.item(), [t.float() for t in
                                    _leaves(g["projector"])])
        del g
    g_scale = max(t.abs().max().item() for t in grads["unwrapped"][1])
    g_err = max((a - b).abs().max().item() for a, b in
                zip(grads["mesh"][1], grads["unwrapped"][1])) / g_scale
    if not g_err <= MESH_RTOL:
        raise AssertionError(f"multigpu align7b projector gradient err "
                             f"{g_err} of its max")
    out = {"loss_rel_err": _mesh_gate("align7b loss", grads["mesh"][0],
                                      grads["unwrapped"][0]),
           "proj_grad_err_of_max": g_err,
           "grad_bit_equal": grads["mesh"][0] == grads["unwrapped"][0]
           and all(torch.equal(a, b) for a, b in
                   zip(grads["mesh"][1], grads["unwrapped"][1]))}
    del grads

    # one step each from the same state (the projector put back between)
    proj = _leaves(params["projector"])
    snap = [t.clone() for t in proj]
    steps, states, after, peaks, counts = {}, {}, {}, {}, {}
    for key, tree, m in (("unwrapped", params, None),
                         ("mesh", sharded, mesh)):
        for t, s in zip(proj, snap):
            t.copy_(s)
        states[key] = create_train_state(tree, tx)
        steps[key] = make_train_step(cfg, tx, mesh=m, **common)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        (states[key], metrics), counts[key], by_dtype = _counted(
            kernels, lambda: steps[key](states[key], batch))
        peaks[key] = torch.cuda.max_memory_allocated(dev) - base
        after[key] = ({k: v.item() for k, v in metrics.items()},
                      [t.clone() for t in proj])
        expected = {"flash_fwd": 2 * cfg.llm.n_layers + sum(
            v.depth - 1 for _, v in cfg.vision),
            "flash_bwd_dq": cfg.llm.n_layers,
            "flash_bwd_dkv": cfg.llm.n_layers, "int4_matmul": 0}
        if counts[key] != expected or by_dtype != {
                k: ({"bfloat16": n} if n else {})
                for k, n in expected.items()}:
            raise AssertionError(f"multigpu align7b {key} launches "
                                 f"{counts[key]} ({by_dtype}) != "
                                 f"{expected}, all bf16")
    m_u, p_u = after["unwrapped"]
    m_m, p_m = after["mesh"]
    for k in ("loss", "grad_norm"):
        out[f"step_{k}_rel_err"] = _mesh_gate(f"align7b step {k}", m_m[k],
                                              m_u[k])
    upd = max((a - b).abs().max().item() for a, b in zip(p_m, p_u))
    if not upd <= MESH_RTOL * max(t.abs().max().item() for t in p_u):
        raise AssertionError(f"multigpu align7b updated projector differs "
                             f"by {upd}")
    out["step_bit_equal"] = m_m == m_u and upd == 0.0
    out["launches_per_step"] = counts["mesh"]
    out["peak_step_bytes"] = peaks
    out["mesh_minus_unwrapped_peak_bytes"] = peaks["mesh"] - peaks["unwrapped"]
    times = {"unwrapped": [], "mesh": []}
    for key in ["unwrapped", "mesh", "mesh", "unwrapped"] * 2:
        t0 = time.perf_counter()
        states[key], metrics = steps[key](states[key], batch)
        metrics["loss"].item()
        times[key].append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = times
    out["step_ms_median"] = {k: float(np.median(v))
                             for k, v in times.items()}
    del states, steps, params, sharded, tx, batch, snap, after
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_vla_train(dev, kernels, mesh) -> dict:
    """vla-train's ``VLA_LAYERS`` cut through ``run_discrete_vla_training``:
    ``MESH_VLA_STEPS`` steps unwrapped, then on the mesh with the mesh's
    checkpoint save (rank 0 writes the gathered tree) and restore (each
    rank its blocks), against the unwrapped losses and the live state."""
    import dataclasses
    import shutil
    import tempfile

    from emmax_torch.data.collators import BatchLoader, collate_train
    from emmax_torch.data.gcot import (GCOTDataset, SyntheticFrameSource,
                                       make_dummy_gcot_items)
    from emmax_torch.data.prefetch import PrefetchingLoader
    from emmax_torch.models.materialize import get_image_transforms
    from emmax_torch.models.vlm import emma_x_vlm_config, init_vlm_params
    from emmax_torch.parallel import shard_params
    from emmax_torch.parallel.sharding import data_extent, data_index
    from emmax_torch.training.checkpointing import CheckpointManager
    from emmax_torch.training.loop import (LoopConfig,
                                           run_discrete_vla_training)
    from emmax_torch.training.metrics import VLADiscreteMetrics
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  stage_from_flags,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.tokenizer import load_tokenizer

    base = emma_x_vlm_config()
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, n_layers=VLA_LAYERS))
    tokenizer = load_tokenizer(None)
    dataset = GCOTDataset(make_dummy_gcot_items(4 * VLA_B),
                          ActionTokenizer(tokenizer), tokenizer,
                          SyntheticFrameSource(256),
                          data_mix="movement_policy", mask_inst=True)
    transforms = get_image_transforms("dinosiglip-vit-so-224px",
                                      "resize-naive")
    stage = stage_from_flags(True, False, False)
    tmp = tempfile.mkdtemp(prefix="emmax_multigpu_")
    runs = {}
    try:
        for key, m in (("unwrapped", None), ("mesh", mesh)):
            # the trainer's per-rank loader: this data rank's rows
            n_data = data_extent(m) if m is not None else 1
            loader = BatchLoader(
                dataset, VLA_B // n_data, lambda s: collate_train(
                    s, tokenizer.pad_id, max_length=cfg.llm.max_seq_len),
                seed=7, num_shards=n_data,
                shard_index=data_index(m) if m is not None else 0)
            gen = torch.Generator(dev)
            gen.manual_seed(1)
            params = init_vlm_params(gen, cfg, torch.float32, dev)
            tx, schedule = make_optimizer(
                params, learning_rate=2e-5, weight_decay=0.0,
                max_grad_norm=1.0, lr_scheduler_type="constant",
                total_steps=MESH_VLA_STEPS, stage=stage)
            freeze = trainable_mask(params, stage)
            if m is not None:
                params = shard_params(params, m)
            state = create_train_state(params, tx)
            step_fn = make_train_step(
                cfg, tx, attn_impl="cuda", remat=True,
                compute_dtype=torch.bfloat16, transforms=transforms,
                stop_vision_gradient=True, freeze_mask=freeze,
                action_vocab_size=tokenizer.vocab_size, mesh=m)
            ckpt = CheckpointManager(tmp, mesh=m) if m is not None else None
            metrics = VLADiscreteMetrics([])
            t0 = time.perf_counter()
            state, launches, _ = _counted(kernels, lambda: (
                run_discrete_vla_training(
                    vlm_cfg=cfg, state=state, train_step=step_fn,
                    loader=PrefetchingLoader(loader, dev, mesh=m),
                    metrics=metrics,
                    loop_cfg=LoopConfig(epochs=1, max_steps=MESH_VLA_STEPS,
                                        eval_every=10 ** 6,
                                        save_every=10 ** 6, log_every=1),
                    device=dev, mesh=m, ckpt_manager=ckpt,
                    lr_fn=schedule)))
            loop_s = time.perf_counter() - t0
            runs[key] = {"losses": list(metrics.deques["loss"]),
                         "launches": launches, "loop_s": loop_s}
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                if launches[name] == 0:
                    raise AssertionError(f"multigpu vla-train {key} "
                                         f"launched no {name}")
            if key == "unwrapped":
                del state, params, tx, step_fn
                gc.collect()
                torch.cuda.empty_cache()
        u, w = runs["unwrapped"], runs["mesh"]
        if len(w["losses"]) != MESH_VLA_STEPS or w["launches"] != u[
                "launches"]:
            raise AssertionError(f"multigpu vla-train: {runs}")
        errs = [_mesh_gate(f"vla-train loss {i}", a, b)
                for i, (a, b) in enumerate(zip(w["losses"], u["losses"]))]
        path = ckpt.latest()
        t0 = time.perf_counter()
        restored = ckpt.restore(path)
        restore_s = time.perf_counter() - t0
        same = restored.step == state.step == MESH_VLA_STEPS and all(
            torch.equal(a, b) for a, b in zip(_leaves(state.params),
                                              _leaves(restored.params)))
        for key in ("mu", "nu"):
            same = same and all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(state.opt_state[key],
                                restored.opt_state[key]))
        if not same:
            raise AssertionError(f"multigpu vla-train: checkpoint "
                                 f"{path.name} does not restore the state")
        ckpt_gb = sum(f.stat().st_size for f in path.iterdir()) / 1e9
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"steps": MESH_VLA_STEPS, "runs": runs, "loss_rel_errs": errs,
           "checkpoint_gb": ckpt_gb, "restore_s": restore_s,
           "restored_equal": True}
    del state, restored, params, tx, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_serving(dev, kernels, mesh) -> dict:
    """``ServingEngine(cfg, shard_params(bf16 params, mesh), tok,
    mesh=mesh)``: one 64-token request against the unsharded engine on the
    same params: the same tokens and launches (fp32 flash forward depth -
    1 per tower, bf16 once per decoder layer)."""
    from emmax_torch.models.load import load
    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.ops.image import preprocess_for_towers
    from emmax_torch.parallel import shard_params
    from emmax_torch.serving.engine import GenerateOptions, ServingEngine

    cfg, params, tok, transforms, family = load(
        MODEL_ID, dtype=torch.bfloat16, device="cuda", seed=0)
    prompt = EmmaXVLA(cfg, params, tok, transforms, llm_family=family,
                      device=dev).get_prompt(TASK, gripper_position=(128, 96))
    frame = np.random.default_rng(7).integers(0, 256, (1, 256, 256, 3),
                                              dtype=np.uint8)
    pixels = preprocess_for_towers(torch.from_numpy(frame).to(dev),
                                   transforms)
    opts = GenerateOptions(eos_id=tok.eos_id, max_new_tokens=MAX_NEW)
    out = {}
    for key, tree, m in (("unwrapped", params, None),
                         ("mesh", shard_params(params, mesh), mesh)):
        engine = ServingEngine(cfg, tree, tok, options=opts, device=dev,
                               mesh=m)
        engine.generate_ids([prompt], pixels)          # warm-up
        t0 = time.perf_counter()
        ids, launches, by_dtype = _counted(
            kernels, lambda: engine.generate_ids([prompt], pixels))
        out[key] = {"ids": ids[0].tolist(), "launches": launches,
                    "flash_fwd_by_dtype": by_dtype["flash_fwd"],
                    "request_ms": (time.perf_counter() - t0) * 1e3}
    tower_blocks = sum(v.depth - 1 for _, v in cfg.vision)
    want = {"float32": tower_blocks, "bfloat16": cfg.llm.n_layers}
    if (out["mesh"]["ids"] != out["unwrapped"]["ids"]
            or out["mesh"]["launches"] != out["unwrapped"]["launches"]
            or out["mesh"]["flash_fwd_by_dtype"] != want):
        raise AssertionError(f"multigpu serving: {out} (flash forwards "
                             f"by dtype wanted {want})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def multigpu_phase(dev, kernels) -> dict:
    """The multi-GPU path at world size 1: a NCCL process group joined
    in-process (``initialize_distributed``), the (1, 1, 1) mesh on
    "cuda", and the full-width align7b step, vla-train's cut trainer
    with a checkpoint, and a served request through it, each against the
    unwrapped path."""
    import socket

    import torch.distributed as dist

    from emmax_torch.parallel import initialize_distributed, make_mesh

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t0 = time.perf_counter()
    rank = initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = make_mesh((1, 1, 1), device_type="cuda")
        out = {"rank": rank, "backend": dist.get_backend(),
               "world_size": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        if out["backend"] != "nccl" or out["world_size"] != 1:
            raise AssertionError(f"multigpu: {out}")
        out["align7b"] = _mesh_align7b(dev, kernels, mesh)
        log("multigpu align7b " + json.dumps(out["align7b"]))
        out["vla_train"] = _mesh_vla_train(dev, kernels, mesh)
        log("multigpu vla-train " + json.dumps(out["vla_train"]))
        out["serving"] = _mesh_serving(dev, kernels, mesh)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------------- zoo --

def zoo_towers(dev, fa_kernel) -> list:
    """(a) Each new vision backbone id at full width and depth, seeded
    random bf16 weights: one preprocessed 256x256 frame encoded in fp32
    (as the engines encode) through the kernels and through the plain path
    on the same params; the features' error against ``ZOO_TOWER_RTOL``,
    the patch count, the fp32 forward's launches per encode (depth - 1 a
    tower) and the encode's device ms (CUDA events, after a warm-up)."""
    from emmax_torch.models.materialize import (get_image_transforms,
                                                get_vision_config)
    from emmax_torch.models.vit import init_vit_params, vit_forward
    from emmax_torch.ops.image import preprocess_for_towers

    frame = torch.from_numpy(np.random.default_rng(17).integers(
        0, 256, (1, 256, 256, 3), dtype=np.uint8)).to(dev)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    rows = []
    for vid in ZOO_TOWERS:
        towers = get_vision_config(vid)
        pixels = preprocess_for_towers(frame, get_image_transforms(
            vid, "resize-naive"))
        params = {n: init_vit_params(gen, v, torch.bfloat16, dev)
                  for n, v in towers}

        def encode(impl):
            with torch.inference_mode():
                return torch.cat([vit_forward(params[n], v, pixels[n],
                                              attn_impl=impl)
                                  for n, v in towers], dim=-1)

        encode("cuda")                                    # warm-up
        fa_kernel.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = encode("cuda")
        end.record()
        end.synchronize()
        launches = dict(fa_kernel.launches_by)
        want = encode("torch")
        blocks = sum(v.depth - 1 for _, v in towers)
        P = towers[0][1].num_patches
        err, rel = rel_err(got, want)
        shape = (1, P, sum(v.dim for _, v in towers))
        if (tuple(got.shape) != shape or not bool(got.isfinite().all())
                or not rel <= ZOO_TOWER_RTOL or launches != {"float32":
                                                             blocks}):
            raise AssertionError(
                f"zoo tower {vid}: shape {tuple(got.shape)} (want {shape}),"
                f" rel err {rel:.3g} (tol {ZOO_TOWER_RTOL}), launches "
                f"{launches} (want {blocks} fp32)")
        rows.append({"vision_backbone": vid, "patches": P,
                     "tokens": [v.num_patches + v.num_prefix
                                for _, v in towers],
                     "head_dims": [v.head_dim for _, v in towers],
                     "launches_fp32_per_encode": blocks,
                     "max_abs_err": err, "rel_err": rel,
                     "tolerance": ZOO_TOWER_RTOL,
                     "encode_ms": start.elapsed_time(end)})
        del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def zoo_request(dev, kernels, model_id, quantize) -> dict:
    """One request of ``ZOO_NEW`` new tokens through ``load_vla(model_id)``
    -> ``generate_actions`` (a warm-up request first), seeded random
    weights at full width and depth: its timings, launches by kernel and
    dtype (gated: the towers' fp32 forward depth - 1 a tower, the bf16
    forward once per decoder layer in the prefill, int4 on every quantized
    weight of every layer and the lm_head in every forward), the load's
    seconds and the device peak. Returns (record, the VLA, the frame, the
    prompt)."""
    import emmax_torch
    from emmax_torch.serving.quant import QUANT_KEYS

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vla = emmax_torch.load_vla(model_id, quantize=quantize, device="cuda",
                               seed=0)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    frame = np.random.default_rng(19).integers(0, 256, (256, 256, 3),
                                               dtype=np.uint8)
    prompt = vla.get_prompt(TASK, gripper_position=(128, 96))
    vla.generate_actions(frame, prompt, type="act", max_new_tokens=ZOO_NEW)
    for k in kernels:
        k.reset_counts()
    t0 = time.perf_counter()
    actions, text = vla.generate_actions(frame, prompt, type="act",
                                         max_new_tokens=ZOO_NEW)
    request_ms = (time.perf_counter() - t0) * 1e3
    for a in actions:
        if a.shape != (7,) or not np.isfinite(a).all():
            raise AssertionError(f"zoo {model_id}: bad action {a!r}")
    if not isinstance(text, str):
        raise AssertionError(f"zoo {model_id}: no text")
    tm = dict(vla.engine.last_timings)
    cfg = vla.cfg
    forwards = int(tm["decode_forwards"]) + 1
    L = cfg.llm.n_layers
    blocks = sum(v.depth - 1 for _, v in cfg.vision)
    layers = vla.engine.model.tree()["llm"]["layers"]
    weights = [k for k in QUANT_KEYS if k in layers]
    quantized = [k for k in weights if isinstance(layers[k], dict)]
    launches = {k.name: dict(k.launches_by) for k in kernels}
    counts = {k.name: k.launches for k in kernels}
    want = {"flash_fwd": {"float32": blocks, "bfloat16": L},
            "int4_matmul": forwards * (len(weights) * L + 1)
            if quantize else 0}
    if (launches["flash_fwd"] != want["flash_fwd"]
            or counts["int4_matmul"] != want["int4_matmul"]
            or quantized != (weights if quantize else [])
            or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]):
        raise AssertionError(f"zoo {model_id} {quantize or 'bf16'}: "
                             f"launches {launches} / {counts}, want {want} "
                             f"({forwards} forwards; quantized "
                             f"{quantized} of {weights})")
    rec = {"model_id": model_id, "path": quantize or "bf16",
           "load_s": load_s, "request_ms": request_ms,
           "encode_ms": tm["encode_ms"], "prefill_ms": tm["prefill_ms"],
           "decode_ms": tm["decode_ms"], "decode_forwards": forwards - 1,
           "decode_tok_s": ((forwards - 1) / tm["decode_ms"] * 1e3
                            if forwards > 1 else None),
           "prefill_tokens": tm["prefill_tokens"],
           "launches_by_dtype": launches, "launches": counts,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return rec, vla, frame, prompt


def zoo_kernel_vs_plain(vla, frame, prompt) -> dict:
    """(b) The served bf16 model through the kernels and through the plain
    path on the same patches: the prefill's last fp32 logits within
    ``BF16_RTOL`` of the largest |plain logit|; each bf16 path's distance
    from the plain path run in fp32 on the same weights (cast up), the
    kernels' no more than twice the plain path's (``align_parity``'s
    rule: the two bf16 paths round differently through every layer, and
    the fp32 run says how far a sound bf16 path lands); and ``ZOO_NEW``
    greedy tokens equal up to the first position where the plain path's
    logits hold the two paths' tokens within ``BF16_RTOL`` of each other
    (a near-tie, reported)."""
    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.serving.engine import (_prefill_last_logits, _round_up,
                                            encode_frame)
    from emmax_torch.training.train_step import cast_params

    eng = vla.engine
    params, cfg = eng.model.tree(), eng.cfg
    plain = EmmaXVLA(cfg, params, vla.tokenizer, vla.transforms,
                     llm_family=vla.llm_family, attn_impl="torch",
                     device="cuda")
    patches = encode_frame(params, cfg, vla._pixels(frame))
    ids, mask = eng._prepare([prompt])
    cache_len = _round_up(cfg.num_patches + ids.shape[1] + 8)
    logits = {impl: _prefill_last_logits(params, cfg, ids, mask,
                                         {"patches": patches},
                                         cache_len=cache_len, attn_impl=impl)
              for impl in ("cuda", "torch")}
    params32 = {**params, "llm": cast_params(params["llm"], torch.float32)}
    fp32 = _prefill_last_logits(params32, cfg, ids, mask,
                                {"patches": patches.float()},
                                cache_len=cache_len, attn_impl="torch")
    del params32
    err, rel = rel_err(logits["cuda"], logits["torch"])
    from_fp32 = {impl: rel_err(lg, fp32)[1] for impl, lg in logits.items()}
    if not (rel <= BF16_RTOL
            and from_fp32["cuda"] <= 2 * from_fp32["torch"]):
        raise AssertionError(
            f"zoo prefill logits: kernel vs plain rel err {rel:.3g} (tol "
            f"{BF16_RTOL}); from the fp32 plain run kernel "
            f"{from_fp32['cuda']:.3g}, plain bf16 {from_fp32['torch']:.3g} "
            f"(the kernel's at most twice the plain path's)")
    toks = {name: e.generate_ids([prompt], {"patches": patches},
                                 max_new_tokens=ZOO_NEW)[0].tolist()
            for name, e in (("kernel", eng), ("plain", plain.engine))}
    rec = {"prefill_logits_max_abs_err": err, "prefill_logits_rel_err": rel,
           "tolerance": BF16_RTOL,
           "prefill_logits_rel_err_from_fp32": {
               "kernel_bf16": from_fp32["cuda"],
               "plain_bf16": from_fp32["torch"]},
           "tokens": ZOO_NEW,
           "tokens_equal": toks["kernel"] == toks["plain"],
           "first_difference": None}
    if not rec["tokens_equal"]:
        a, b = toks["kernel"], toks["plain"]
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        one, _ = logits_both_ways(plain, frame, prompt, b, p)
        gap = abs(one[a[p]] - one[b[p]]).item() / one.abs().max().item()
        rec.update(first_difference=p, kernel_token=a[p], plain_token=b[p],
                   plain_gap=gap)
        if not gap <= BF16_RTOL:
            raise AssertionError(f"zoo tokens differ at {p}, not a "
                                 f"near-tie of the plain path: {rec}")
    del plain
    return rec


def zoo_phi_align(dev, kernels) -> dict:
    """(b) ``phi-2+3b`` in the align stage (CLIP-L/336 and Phi-2 frozen,
    the projector trained; fp32 masters, bf16 compute, full remat; B2,
    text 192 -> fused 768): one step's loss and projector gradient
    through the kernels against the plain path from the same state (the
    align7b phase's gate), then one counted step (the bf16 forward 2 per
    decoder layer + 23 tower blocks, the D 80 dQ and dK/dV once a layer)
    and one timed step."""
    from emmax_torch.models.materialize import (get_image_transforms,
                                                get_vlm_config)
    from emmax_torch.models.vlm import init_vlm_params
    from emmax_torch.training.train_state import (create_train_state,
                                                  make_optimizer,
                                                  trainable_mask)
    from emmax_torch.training.train_step import make_train_step

    cfg = get_vlm_config(ZOO_PHI)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    params = init_vlm_params(gen, cfg, torch.float32, dev)
    tx, _ = make_optimizer(params, learning_rate=2e-5, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=10, stage="align")
    state = create_train_state(params, tx)
    batch = align_batch(dev, 50256)
    common = dict(remat=True, stop_vision_gradient=True,
                  compute_dtype=torch.bfloat16,
                  transforms=get_image_transforms("clip-vit-l-336px",
                                                  "letterbox"),
                  freeze_mask=trainable_mask(params, "align"),
                  action_vocab_size=32000)
    ref_loss, _, parity = align_parity(cfg, params, batch, common,
                                       "zoo phi align")
    step = make_train_step(cfg, tx, attn_impl="cuda", **common)
    for k in kernels:
        k.reset_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize(dev)
    launches = {k.name: dict(k.launches_by) for k in kernels}
    L = cfg.llm.n_layers
    blocks = sum(v.depth - 1 for _, v in cfg.vision)
    want = {"flash_fwd": {"bfloat16": 2 * L + blocks},
            "flash_bwd_dq": {"bfloat16": L},
            "flash_bwd_dkv": {"bfloat16": L}, "int4_matmul": {}}
    if launches != want:
        raise AssertionError(f"zoo phi align launches per step {launches}, "
                             f"want {want}")
    t0 = time.perf_counter()
    state, m = step(state, batch)
    loss = m["loss"].item()
    step_ms = (time.perf_counter() - t0) * 1e3
    if not np.isfinite(loss):
        raise AssertionError(f"zoo phi align: loss {loss}")
    out = {"model_id": ZOO_PHI, "batch": ALIGN_B, "text_len": ALIGN_TEXT,
           "fused_seq": ALIGN_TEXT + cfg.num_patches,
           "loss_fp32_plain": ref_loss, "parity": parity,
           "launches_per_step": launches, "step_ms": step_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del state, step, params, tx, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_kernel_checks(dev) -> dict:
    """Each kernel against its plain version at the zoo's shapes, timed:
    the 3xTF32 forward over the CLIP-336 (577 tokens, D 64), SigLIP-384
    (729, D 72) and DINOv2-384 (734, D 64) towers; the bf16 forward at
    Phi-2's prefill (H 32, D 80, into the request's cache) and the
    training kernels at its align step (B2, fused 768, D 80); int4 at
    every int4 weight of Phi-2 and Mistral-7B (``zoo_int4_weights``), at
    M 1 (decode) and at the prefill's rows."""
    from emmax_torch.models.materialize import get_vlm_config
    from emmax_torch.serving.engine import _round_up, pick_bucket
    from emmax_torch.vla.prompting import build_emma_x_task_prompt
    from emmax_torch.vla.tokenizer import load_tokenizer

    gen = torch.Generator(dev)
    gen.manual_seed(2)
    phi = get_vlm_config(ZOO_PHI)
    llm = phi.llm
    n_tok = len(load_tokenizer(None).encode(build_emma_x_task_prompt(
        TASK, (128, 96))))
    bucket = pick_bucket(n_tok)
    Lq = phi.num_patches + bucket
    S = _round_up(Lq + ZOO_NEW)
    flash = [check_flash(dev, gen, f"{n} B1 L{L} H16 D{D}", 1, L, L, 16, D,
                         False, 0, torch.float32)
             for n, L, D in (("clip-336", 577, 64), ("siglip-384", 729, 72),
                             ("dinov2-384", 734, 64))]
    flash.append(check_flash(
        dev, gen, f"phi prefill B1 Lq{Lq} S{S} H{llm.n_heads} "
        f"D{llm.head_dim} causal pad{bucket - n_tok}", 1, Lq, S,
        llm.n_heads, llm.head_dim, True, bucket - n_tok, torch.bfloat16))
    F = phi.num_patches + ALIGN_TEXT
    train = check_flash_bwd(dev, gen, f"phi train B{ALIGN_B} L{F} "
                            f"H{llm.n_heads} D{llm.head_dim} causal "
                            f"rpad{ALIGN_PAD}", ALIGN_B, F, llm.n_heads,
                            llm.head_dim, True, ALIGN_PAD, torch.bfloat16)
    int4 = [check_int4(dev, gen, f"{n} M{M} D{d} F{f}", M, d, f,
                       layers=zoo_int4_layers(d, f))
            for n, d, f, Lq_n in zoo_int4_weights(bucket)
            for M in (1, Lq_n)]
    return {"flash_fwd": flash, "train": train, "int4": int4}


def zoo_int4_weights(bucket: int) -> list:
    """(name, D, F, prefill rows) of every distinct int4 weight the zoo's
    int4 requests run (``QUANT_KEYS`` and the lm_head): Phi-2's and
    Mistral-7B's, the prefill rows being the model's patches plus the
    prompt's bucket (the lm_head runs on every prefill row)."""
    from emmax_torch.models.materialize import get_vlm_config

    out = []
    for model_id, name, ffn in ((ZOO_PHI, "phi", ("w1", "w2")),
                                (ZOO_MISTRAL, "mistral",
                                 ("w_gate/w_up", "w_down"))):
        cfg = get_vlm_config(model_id)
        c, Lq = cfg.llm, cfg.num_patches + bucket
        q, kv = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        shapes = {}
        for shape, w in (((c.dim, q), "wq"), ((c.dim, kv), "wk/wv"),
                         ((q, c.dim), "wo"), ((c.dim, c.hidden_dim), ffn[0]),
                         ((c.hidden_dim, c.dim), ffn[1]),
                         ((c.dim, c.vocab_size), "lm_head")):
            shapes.setdefault(shape, []).append(w)
        out += [(f"{name} {'/'.join(w)}", d, f, Lq)
                for (d, f), w in shapes.items()]
    return out


def zoo_int4_layers(D: int, F: int) -> int:
    """Stacked layers for ``check_int4``'s timing: at least 8, and enough
    that the stack's codes fill twice the H100's 50 MB L2, so each call
    reads its weight from HBM as the decode loop does."""
    return max(8, -(-100_000_000 // (D // 2 * F)))


def zoo_entries(zoo: dict) -> dict:
    """The zoo phase's launches and kernel checks for each kernel's entry
    of the ``kernels`` line, by kernel name."""
    zk = zoo["kernels"]
    zreq = {f"{r['model_id']} {r['path']}": r for r in zoo["requests"]}
    zstep = zoo["phi_align"]["launches_per_step"]
    keys = ("shape", "dtype", "ms", "eager_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")
    out = {kname: {"launches_phi_align_step": zstep[kname],
                   **{k: zk["train"][i][k] for k in keys}}
           for i, kname in ((1, "flash_bwd_dq"), (2, "flash_bwd_dkv"))}
    out["flash_fwd"] = {
        "towers": [{k: t[k] for k in ("vision_backbone", "tokens",
                                      "launches_fp32_per_encode", "rel_err",
                                      "encode_ms")} for t in zoo["towers"]],
        "launches_per_request": {n: r["launches_by_dtype"]["flash_fwd"]
                                 for n, r in zreq.items()},
        "launches_phi_align_step": zstep["flash_fwd"],
        "shapes": [{k: r[k] for k in keys}
                   for r in zk["flash_fwd"] + zk["train"][:1]]}
    out["int4_matmul"] = {
        "launches_per_request": {n: r["launches"]["int4_matmul"]
                                 for n, r in zreq.items()
                                 if r["path"] == "int4"},
        "shapes": [{k: r[k] for k in keys} for r in zk["int4"]]}
    return out


def zoo_phase(dev, kernels) -> dict:
    """``zoo``: the Prismatic backbones beyond Emma-X's at full width and
    depth on seeded random weights made on the card, each model freed
    before the next is built: (a) ``zoo_towers``; (b) ``phi-2+3b`` (CLIP-L
    /336 + Phi-2) served in bf16 (``zoo_kernel_vs_plain``) and int4, and
    its align step (``zoo_phi_align``); (c) ``llama2+13b`` served in bf16;
    (d) ``mistral-v0.1+7b`` served in bf16 and int4; then the kernels at
    the zoo's shapes (``zoo_kernel_checks``)."""
    from emmax_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    out = {"phase": "zoo", "towers": zoo_towers(dev, fa.KERNEL)}
    requests = []
    for model_id, quantize in ((ZOO_PHI, None), (ZOO_PHI, "int4"),
                               (ZOO_13B, None), (ZOO_MISTRAL, None),
                               (ZOO_MISTRAL, "int4")):
        rec, vla, frame, prompt = zoo_request(dev, kernels, model_id,
                                              quantize)
        if model_id == ZOO_PHI and quantize is None:
            rec["kernel_vs_plain"] = zoo_kernel_vs_plain(vla, frame, prompt)
        requests.append(rec)
        del vla
        gc.collect()
        torch.cuda.empty_cache()
    out["requests"] = requests
    out["phi_align"] = zoo_phi_align(dev, kernels)
    out["kernels"] = zoo_kernel_checks(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log("zoo " + json.dumps(out))
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
    # the bf16 tensor-core kernels at D 128 (the training shape) and the
    # int4 kernels as built (<columns a lane, x tiles, stages, vector
    # copies>; 8 rows of x per warp for one x tile, else 32)
    # (dkv, fused, D, dtype code): bf16 at the training shape, 3xTF32 at
    # every padding
    bwd_res = kernel_resources(fa.DQ_KERNEL, "emmax_flash_bwd_smem_bytes", {
        "tc::dq_kernel<128>": (0, 0, 128, 1),
        "tc::dkv_kernel<128, false>": (1, 0, 128, 1),
        "tc::dkv_kernel<128, true>": (1, 1, 128, 1),
        **{f"tf32::dq_kernel<{dp}>": (0, 0, dp, 0) for dp in (64, 72, 128)},
        **{f"tf32::dkv_kernel<{dp}, {f}>": (1, int(f == "true"), dp, 0)
           for dp in (64, 72, 128) for f in ("false", "true")}})
    log("flash_bwd resources " + json.dumps(bwd_res))
    # (D, dtype code): bf16 at the training shape, 3xTF32 at every padding
    fwd_res = kernel_resources(fa.KERNEL, "emmax_flash_fwd_smem_bytes",
                               {"tc::fwd_kernel<128>": (128, 1),
                                "tf32::fwd_kernel<64>": (64, 0),
                                "tf32::fwd_kernel<72>": (72, 0),
                                "tf32::fwd_kernel<128>": (128, 0)})
    log("flash_fwd resources " + json.dumps(fwd_res))
    paged_res = ptxas_usage(pa.KERNEL.build_log)     # static shared only
    log("paged_attention resources " + json.dumps(paged_res))
    int4_res = kernel_resources(
        int4_matmul.KERNEL, "emmax_int4_matmul_smem_bytes",
        {name: (8 * int(name.split(", ")[1]),)
         for name in ptxas_usage(int4_matmul.KERNEL.build_log)
         if name.startswith("tc::int4_tc_kernel<")})
    log("int4_matmul bf16 resources " + json.dumps(int4_res))
    flash, int4 = kernel_phase(dev)
    train_kernels = training_kernel_phase(dev)
    paged_kernels = paged_kernel_phase(dev)
    if "--kernels-only" in argv:
        return 0
    log_phase("tiny_parity")
    tiny_parity(dev)
    tiny_steps = tiny_batched_parity(dev)
    tiny_spec = tiny_spec_parity(dev)
    log_phase("hub")
    hub_step(dev, serving_kernels)
    log_phase("run_path")
    bf16 = run_path(dev, None, kernels)
    if bf16["launches"]["flash_fwd"] == 0:
        raise AssertionError("bf16 path launched no flash_fwd kernel")
    q4 = run_path(dev, "int4", kernels)
    for name in ("flash_fwd", "int4_matmul"):
        if q4["launches"][name] == 0:
            raise AssertionError(f"int4 path launched no {name} kernel")
    log_phase("checkpoint_phase")
    ckpt = checkpoint_phase(dev, kernels)
    log("checkpoint " + json.dumps(ckpt))
    log_phase("batched_phase")
    batched = batched_phase(dev, serving_kernels)
    log("batched serving " + json.dumps({"tiny_steps": tiny_steps,
                                         "runs": batched}))
    log_phase("speculative_phase")
    spec = speculative_phase(dev, serving_kernels)
    log("speculative " + json.dumps({"tiny_steps": tiny_spec, **spec}))
    log_phase("align7b_phase")
    align = align7b_phase(dev, kernels)
    log_phase("pretrain_phase")
    pre = pretrain_phase(dev, kernels)
    log_phase("vla_train_phase")
    vla = vla_train_phase(dev, kernels)
    log_phase("vla_full_train_fp32_phase")
    full = vla_full_train_fp32_phase(dev, kernels)
    log_phase("rlds_phase")
    rl = rlds_phase(dev, kernels)
    log_phase("eval_phase")
    ev = eval_phase(dev, serving_kernels)
    log("training " + json.dumps({"align7b": align, "pretrain": pre,
                                  "vla_train": vla,
                                  "vla_full_train_fp32": full, "rlds": rl}))
    log("eval summary " + json.dumps({k: ev[k] for k in (
        "tiny_s", "phase_s", "launches_eval")}))
    log_phase("multigpu_phase")
    multi = multigpu_phase(dev, kernels)
    log("multigpu " + json.dumps(multi))
    log_phase("zoo_phase")
    zoo = zoo_phase(dev, kernels)
    mstep = multi["align7b"]["launches_per_step"]
    # bf16 launches per pretrain align step: (uncached, cached)
    pstep = {k: (pre["align"]["launches_per_step_uncached"][k]["bfloat16"],
                 pre["align"]["launches_per_step_cached"][k]["bfloat16"])
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def entry(rec, kernel, replaces, launches, **extra):
        return {"name": extra.pop("name", kernel.name), "route": "cuda",
                "source": f"emmax_torch/csrc/{kernel.source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], **extra}

    by_name = {r["name"]: r for r in train_kernels[:4]}   # Llama training
    # the fp32 backward: DINOv2 B2 first, then SigLIP B2, the towers at
    # VLA_B and the Llama
    by_name32 = {}
    for r in (train_kernels[8:16] + train_kernels[24:32]
              + train_kernels[4:8]):
        by_name32.setdefault(r["name"], []).append(r)
    full_step = full["launches_per_step"]
    step = align["launches_per_step"]
    prefill = flash[2]                        # the Llama prefill shape
    tail = flash[-1]                          # the tail-refresh shape
    episode = spec["episode"]
    phases = bf16["profile"].get("phases", {})
    towers = {
        "launches_per_encode": bf16["flash_fwd_launches_per_encode"],
        "launches": bf16["launches_by"]["flash_fwd"],
        "encode_busy_ms": phases.get("encode", {}).get("busy_ms"),
        "profiled_request_ms": bf16["profile"].get("flash_fwd_fp32_ms"),
        "resources": {n: r for n, r in fwd_res.items()
                      if n.startswith("tf32::")},
        "shapes": [{k: r[k] for k in ("shape", "ms", "eager_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "bound_fp32_fma_ms", "max_abs_err",
                                      "fp32_rel_err")}
                   for r in flash if r["dtype"] == "float32"]}
    zoo_of = zoo_entries(zoo)

    def rlds_launches(name):
        """(GCOT loop, RLDS loop) launches of the ``rlds`` phase."""
        return [rl["gcot"]["launches"][name], rl["vla"]["launches"][name]]

    entries = [
        entry(by_name["flash_fwd_lse"], fa.KERNEL,
              "emmax_tpu/ops/flash_attention.py:202", step["flash_fwd"],
              launches_path="align7b train step",
              launches_multigpu_align7b_step=mstep["flash_fwd"],
              launches_pretrain_align_step_uncached_cached=pstep[
                  "flash_fwd"],
              launches_multigpu_request_by_dtype=multi["serving"]["mesh"][
                  "flash_fwd_by_dtype"],
              **fwd_res["tc::fwd_kernel<128>"],
              serving={"shape": prefill["shape"], "ms": prefill["ms"],
                       "plain_ms": prefill["plain_ms"],
                       "library_ms": prefill["library_ms"],
                       "bound_ms": prefill["bound_ms"],
                       "launches_int4_path": q4["launches"]["flash_fwd"]},
              closed_loop={**{k: tail[k] for k in (
                  "shape", "ms", "eager_ms", "plain_ms", "library_ms",
                  "bound_ms", "bound_by", "max_abs_err")},
                  "launches_timed_episode":
                  episode["launches_by"]["flash_fwd"],
                  "frames": SPEC_FRAMES},
              towers_fp32={**towers, "launches_vla_full_train_fp32_step":
                           full_step["flash_fwd"]["float32"]},
              launches_checkpoint_request_by_dtype=ckpt["hf_int4"][
                  "request"]["flash_fwd_by_dtype"],
              launches_rlds_gcot_vla=rlds_launches("flash_fwd"),
              launches_eval=ev["launches_eval"],
              zoo=zoo_of["flash_fwd"]),
        entry(by_name["flash_bwd_dq"], fa.DQ_KERNEL,
              "emmax_tpu/ops/flash_attention.py:395", step["flash_bwd_dq"],
              launches_path="align7b train step",
              launches_multigpu_align7b_step=mstep["flash_bwd_dq"],
              launches_pretrain_align_step_uncached_cached=pstep[
                  "flash_bwd_dq"],
              **bwd_res["tc::dq_kernel<128>"],
              launches_rlds_gcot_vla=rlds_launches("flash_bwd_dq"),
              zoo=zoo_of["flash_bwd_dq"]),
        entry(by_name["flash_bwd_dkv"], fa.DKV_KERNEL,
              "emmax_tpu/ops/flash_attention.py:445",
              step["flash_bwd_dkv"], launches_path="align7b train step",
              launches_multigpu_align7b_step=mstep["flash_bwd_dkv"],
              launches_pretrain_align_step_uncached_cached=pstep[
                  "flash_bwd_dkv"],
              **bwd_res["tc::dkv_kernel<128, false>"],
              fused={**{k: by_name["flash_bwd_dkv_fused"][k] for k in
                        ("ms", "eager_ms", "max_abs_err", "bound_ms",
                         "bound_by", "dq_partial_sum_ms")},
                     **bwd_res["tc::dkv_kernel<128, true>"]},
              launches_rlds_gcot_vla=rlds_launches("flash_bwd_dkv"),
              zoo=zoo_of["flash_bwd_dkv"]),
        *[entry(by_name32[kname][0], kernel,
                f"emmax_tpu/ops/flash_attention.py:{line}",
                full_step[kernel.name]["float32"], name=f"{kernel.name}_fp32",
                dtype="float32", launches_path="vla-full-train-fp32 train "
                f"step ({VLA_LAYERS} decoder layers + 49 tower blocks)",
                bound_fp32_fma_ms=by_name32[kname][0]["bound_fp32_fma_ms"],
                resources={n: r for n, r in bwd_res.items()
                           if n.startswith(f"tf32::{kind}_kernel<")},
                shapes=[{k: r[k] for k in ("shape", "ms", "eager_ms",
                                           "plain_ms", "library_ms",
                                           "bound_ms", "bound_by",
                                           "bound_fp32_fma_ms",
                                           "max_abs_err", "rel_err")}
                        for r in by_name32[kname]
                        + by_name32.get(f"{kname}_fused", [])])
          for kname, kernel, line, kind in (
              ("flash_bwd_dq", fa.DQ_KERNEL, 395, "dq"),
              ("flash_bwd_dkv", fa.DKV_KERNEL, 445, "dkv"))],
        entry(int4[1], int4_matmul.KERNEL,
              "emmax_tpu/ops/int4_matmul.py:404",
              q4["launches"]["int4_matmul"],
              launches_path="int4 serving requests",
              launches_closed_loop_episode=episode["launches"]["int4_matmul"],
              launches_checkpoint_int4_request=ckpt["hf_int4"]["request"][
                  "launches"]["int4_matmul"],
              launches_eval=ev["int4_launches_eval"],
              resources=int4_res,
              shapes=[{k: r[k] for k in ("shape", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
                      for r in int4], zoo=zoo_of["int4_matmul"]),
        entry(paged_kernels[1], pa.KERNEL, "emmax_tpu/serving/paged.py:362",
              batched["paged kernel int8"]["launches"]["paged_attention"],
              launches_path="full-width paged kernel run (int8 pages), "
                            "one burst of 64 steps",
              library_note=paged_kernels[1]["library_note"],
              n_split=paged_kernels[1]["n_split"], resources=paged_res,
              launch_note="one counted call launches split_kernel and "
                          "merge_kernel",
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
