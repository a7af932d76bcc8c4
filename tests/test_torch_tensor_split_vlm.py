"""The towers, the projector, Phi-2's attention and the chunked loss split
over ``tensor`` (``emmax_torch/parallel/tensor.py``) on gloo ranks against
``emmax_tpu``'s GSPMD run on JAX-sharded params (the test process's 8
virtual CPU devices) and the port's unsharded run.

Every bias, norm and layer scale is jittered away from its init, so a
bias added on every rank instead of once, or a slice of the wrong rank,
shows. fp32 throughout; values within ``TOL`` of the largest |value| of
JAX's and of the unsharded port's, the same bits on every rank.

- ``encode_images`` of the tiny VLM (DINOv2 and SigLIP towers of 2 heads,
  the fused-GELU projector): at (1, 1, 2) and (1, 2, 2) both towers and
  the projector split (2 sums and 1 exchange a block, 1 sum a tower and a
  projector layer; no weight byte gathered over ``tensor``); at (1, 1, 4)
  the towers' 2 heads do not divide and they run whole, the projector
  still split. At (1, 1, 2) every tower and projector leaf's gradient is
  the unsharded one's (the head exchange's backward sums the ranks'
  parts).
- A tiny CLIP + Phi-2 VLM: the decoder's logits, cached prefill and
  decode step at (1, 1, 2), (1, 1, 4), (1, 2, 2) split, (1, 1, 8) whole;
  each rank's cache holds ``n_kv_heads / t`` heads; every decoder leaf's
  gradient at (1, 1, 2); the engine's greedy tokens equal JAX's.
- The vocab-parallel chunked CE on integer-valued hidden states and
  lm_head, so the logits are exact integers, full of ties inside and
  across the ranks' vocab blocks: the loss, JAX's preds (first index),
  no lm_head byte gathered; the align and vla-full-train steps with the
  chunked loss at (1, 1, 2) and (1, 2, 2) against JAX's step, within
  ``tests/test_torch_sharded_training.py``'s tolerances.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.phi import PhiConfig as TPhi
from emmax_torch.models.tree import leaves_with_path
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import phi as j_phi
from emmax_tpu.models import vit as j_vit
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.parallel.sharding import shard_batch
from emmax_tpu.serving.engine import GenerateOptions, ServingEngine
from emmax_tpu.training.train_state import (create_train_state,
                                             make_optimizer, trainable_mask)
from emmax_tpu.training.train_step import jit_train_step, make_train_step
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer
from torch_gloo_pool import GlooPool

VOCAB = 512
TOL = 1e-5       # of the largest |value| (fp32; sums over ranks reorder)
LOSS_ATOL = 5e-5
GNORM_RTOL, GNORM_ATOL = 2e-4, 1e-5
CLIP = dict(img_size=28, patch_size=14, dim=32, depth=3, n_heads=2,
            hidden_dim=64, class_token=True, pre_norm=True, quick_gelu=True,
            norm_eps=1e-5)
PHI = dict(vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
           hidden_dim=128, max_seq_len=256)
PHI_VLM = {"vision": [("clip", CLIP)], "phi": PHI}
PROMPT = "In: pick up the cup\nOut:"
_JITTER = re.compile(r"(^b|bias|scale|norm|^ls\d)")


def _jittered(tree, rng):
    """``tree`` (numpy) with every bias, norm and layer scale moved off
    its init."""
    if isinstance(tree, dict):
        return {k: (_jittered(v, rng) if isinstance(v, (dict, list))
                    else v + rng.normal(0, 0.05, v.shape).astype(v.dtype)
                    if _JITTER.search(k) else v)
                for k, v in tree.items()}
    return [_jittered(v, rng) for v in tree]


def _jax_mesh(shape):
    return make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} of {scale}"


def _same_bits(results, key):
    for r in results[1:]:
        if isinstance(r[key], dict):
            for k in r[key]:
                np.testing.assert_array_equal(r[key][k], results[0][key][k])
        else:
            np.testing.assert_array_equal(r[key], results[0][key])


def _pixels(cfg, rng, B):
    return {name: rng.normal(size=(B, v.img_size, v.img_size, 3))
            .astype(np.float32) for name, v in cfg.vision}


def _port_grads(tree, fn, grad_w):
    """(``fn(tree)``, {path: gradient of ``sum(fn(tree) * grad_w)``}) over
    every leaf of the torch ``tree`` that ``fn`` reads."""
    leaves = {p: t.requires_grad_() for p, t in leaves_with_path(tree)}
    out = fn(tree)
    (out * torch.from_numpy(grad_w)).sum().backward()
    return out.detach().numpy(), {p: t.grad.numpy()
                                  for p, t in leaves.items()
                                  if t.grad is not None}


@pytest.fixture(scope="module")
def pool():
    p = GlooPool()
    yield p
    p.close()


@pytest.fixture(scope="module")
def llama_vlm():
    """The tiny Llama VLM (jittered), its pixels and a cotangent for the
    features."""
    cfg = j_vlm.tiny_vlm_config(vocab_size=VOCAB)
    rng = np.random.default_rng(0)
    host = _jittered(jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg)), rng)
    pixels = _pixels(cfg, rng, 2)
    grad_w = rng.normal(size=(2, cfg.num_patches, cfg.llm.dim)).astype(
        np.float32)
    tcfg = t_vlm.tiny_vlm_config(vocab_size=VOCAB)
    tree = params_from_numpy(host)

    feats, grads = _port_grads(
        {"vision": tree["vision"], "projector": tree["projector"]},
        lambda t: t_vlm.encode_images({**t, "llm": tree["llm"]}, tcfg,
                                      params_from_numpy(pixels),
                                      attn_impl="torch"), grad_w)
    return cfg, host, pixels, grad_w, feats, grads


@pytest.mark.parametrize("mesh_shape", [(1, 1, 2), (1, 2, 2), (1, 1, 4)],
                         ids=str)
def test_split_encode_matches_jax_and_unsharded(pool, llama_vlm, mesh_shape):
    cfg, host, pixels, grad_w, feats, grads = llama_vlm
    t = mesh_shape[2]
    results = pool.run("split_encode", params=host, pixels=pixels,
                       grad_w=grad_w, mesh_shape=mesh_shape)
    mesh = _jax_mesh(mesh_shape)
    want = np.asarray(jax.jit(lambda p, x: j_vlm.encode_images(p, cfg, x))(
        shard_params(jax.tree_util.tree_map(jnp.asarray, host), mesh),
        {k: jnp.asarray(v) for k, v in pixels.items()}))
    _same_bits(results, "feats")
    r = results[0]
    _close(r["feats"], want, "features vs JAX")
    _close(r["feats"], feats, "features vs unsharded")
    split = all(v.n_heads % t == 0 for _, v in cfg.vision)
    blocks = sum(v.depth - 1 for _, v in cfg.vision)
    layers = 3                                   # fused-gelu-mlp
    assert r["towers_t"] == [t if split else 1] * len(cfg.vision)
    c = r["counts"]
    if split:
        assert c == {"sums": 2 * blocks + len(cfg.vision) + layers,
                     "exchanges": blocks, "gathered_bytes": 0}
    else:
        assert c["sums"] == layers and c["exchanges"] == 0
        assert c["gathered_bytes"] > 0           # the towers run whole
    if r["grads"] is not None:
        _same_bits(results, "grads")
        assert set(r["grads"]) == set(grads)
        for path, g in grads.items():
            _close(r["grads"][path], g, f"grad {path}")


@pytest.fixture(scope="module")
def phi_vlm():
    """A tiny CLIP + Phi-2 VLM (jittered), token ids with left padding
    and an id past the table, and the unsharded decoder's outputs."""
    jcfg = j_vlm.VLMConfig(vision=(("clip", j_vit.ViTConfig(**CLIP)),),
                           llm=j_phi.PhiConfig(**PHI))
    rng = np.random.default_rng(1)
    host = _jittered(jax.tree_util.tree_map(np.asarray, jax.jit(
        j_vlm.init_vlm_params, static_argnums=1)(jax.random.PRNGKey(1),
                                                 jcfg)), rng)
    ids = rng.integers(3, VOCAB, size=(2, 12)).astype(np.int64)
    mask = np.ones(ids.shape, bool)
    ids[1, :3], mask[1, :3] = VOCAB, False
    ids[0, -1] = VOCAB
    grad_w = rng.normal(size=(2, 12, VOCAB)).astype(np.float32)
    tcfg = TPhi(**PHI)
    llm = params_from_numpy(host)["llm"]
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)

    logits, grads = _port_grads(
        llm, lambda p: t_vlm.llm_apply(p, tcfg, t_llama.embed_tokens(p, ids_t),
                                       mask=mask_t, attn_impl="torch")[0],
        grad_w)
    with torch.inference_mode():
        cache = t_llama.init_kv_cache(tcfg, 2, 32, dtype=torch.float32)
        cached, _ = t_vlm.llm_apply(llm, tcfg,
                                    t_llama.embed_tokens(llm, ids_t),
                                    mask=mask_t, kv_cache=cache,
                                    attn_impl="torch")
        step, _ = t_vlm.llm_apply(llm, tcfg, t_llama.embed_tokens(
            llm, cached[:, -1].argmax(-1)[:, None]), kv_cache=cache,
            attn_impl="torch")
    ref = {"logits": logits, "grads": grads, "cached": cached.numpy(),
           "step": step.numpy()}
    return jcfg, host, ids, mask, grad_w, ref


@pytest.mark.parametrize("mesh_shape",
                         [(1, 1, 2), (1, 1, 4), (1, 2, 2), (1, 1, 8)],
                         ids=str)
def test_phi_split_attention_matches_jax_and_unsharded(pool, phi_vlm,
                                                       mesh_shape):
    jcfg, host, ids, mask, grad_w, ref = phi_vlm
    t = mesh_shape[2]
    split = jcfg.llm.n_heads % t == 0
    results = pool.run("split_forward", params=host, ids=ids, mask=mask,
                       grad_w=grad_w, mesh_shape=mesh_shape, cfg=PHI_VLM)
    llm = shard_params(jax.tree_util.tree_map(jnp.asarray, host),
                       _jax_mesh(mesh_shape))["llm"]
    want = np.asarray(jax.jit(lambda p, i, m: j_phi.phi_forward(
        p, jcfg.llm, j_llama.embed_tokens(p, i), mask=m)[0])(
            llm, jnp.asarray(ids), jnp.asarray(mask)))
    for key in ("logits", "cached", "step"):
        _same_bits(results, key)
    r = results[0]
    assert r["t"] == (t if split else 1)
    assert r["cache_heads"] == jcfg.llm.n_kv_heads // r["t"]
    _close(r["logits"], want, "logits vs JAX")
    for key in ("logits", "cached", "step"):
        _close(r[key], ref[key], f"{key} vs unsharded")
    if split:
        assert r["tensor_gathers"] == 0
        assert r["sums"] == jcfg.llm.n_layers + 1    # wo a layer, embed
    else:
        assert r["tensor_gathers"] > 0
    if r["grads"] is not None:
        _same_bits(results, "grads")
        for path, g in ref["grads"].items():
            _close(r["grads"][path], g, f"grad {path}")


def test_phi_split_engine_gives_jax_tokens(pool, phi_vlm):
    """The CLIP + Phi-2 VLM's ``ServingEngine`` at (1, 1, 2), towers,
    projector and attention split: JAX's greedy tokens on the same
    mesh."""
    jcfg, host, _, _, _, _ = phi_vlm
    pixels = _pixels(jcfg, np.random.default_rng(2), 1)
    tok = ByteLevelTokenizer(VOCAB)
    engine = ServingEngine(
        jcfg, shard_params(jax.tree_util.tree_map(jnp.asarray, host),
                           _jax_mesh((1, 1, 2))),
        tok, options=GenerateOptions(eos_id=tok.eos_id))
    want = np.asarray(engine.generate_ids(
        [PROMPT], {k: jnp.asarray(v) for k, v in pixels.items()},
        max_new_tokens=8)[0])
    for out in pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                        mesh_shape=(1, 1, 2), max_new=8, cfg=PHI_VLM):
        np.testing.assert_array_equal(out, want)


@pytest.fixture(scope="module")
def ce_case():
    """Integer-valued ``h`` [4, 13, 64] and lm_head [64, VOCAB] (exact
    integer logits: ties inside and across the vocab blocks, the same
    bits in any summation order), labels with ignored positions, and the
    unsharded chunked loss, preds and gradients."""
    rng = np.random.default_rng(5)
    h = rng.integers(-2, 3, size=(4, 13, 64)).astype(np.float32)
    head = rng.integers(-2, 3, size=(64, VOCAB)).astype(np.float32)
    h[0] = np.abs(h[0])
    head[:, 7] = head[:, 263] = 2.0    # tied across blocks at t = 2 and 4
    labels = rng.integers(0, VOCAB, size=(4, 13)).astype(np.int64)
    labels[:, :3] = -100
    labels[1, 5] = 263
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(head).requires_grad_()
    loss, preds = t_llama.chunked_ce_loss_and_preds(
        ht, wt, torch.from_numpy(labels), chunk=5)
    loss.backward()
    return h, head, labels, {"loss": float(loss.detach()),
                             "preds": preds.numpy(),
                             "h": ht.grad.numpy(), "lm_head": wt.grad.numpy()}


@pytest.mark.parametrize("mesh_shape", [(1, 1, 2), (1, 1, 4), (1, 2, 2)],
                         ids=str)
def test_vocab_parallel_ce_matches_jax(pool, ce_case, mesh_shape):
    h, head, labels, ref = ce_case
    mesh = _jax_mesh(mesh_shape)
    sharded = shard_params({"llm": {"lm_head": jnp.asarray(head)}},
                           mesh)["llm"]["lm_head"]
    loss, preds = jax.jit(lambda a, w, y: j_llama.chunked_ce_loss_and_preds(
        a, w, y, chunk=5))(jnp.asarray(h), sharded, jnp.asarray(labels))
    preds = np.asarray(preds)
    assert (preds[0] == 7).any()        # the planted tie: the lower index
    results = pool.run("split_ce", h=h, lm_head=head, labels=labels,
                       mesh_shape=mesh_shape)
    rows = h.shape[0] // mesh_shape[1]
    for i, r in enumerate(results):
        assert r["loss"] == results[0]["loss"]
        assert r["gathered_bytes"] == 0
        assert r["sums"] == 2 * 3                # 2 a chunk of 5, 13 -> 15
        block = (i // mesh_shape[2]) * rows
        np.testing.assert_array_equal(r["preds"], preds[block:block + rows])
    assert abs(results[0]["loss"] - float(loss)) <= TOL * abs(float(loss))
    assert abs(results[0]["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    if mesh_shape[1] == 1:
        _same_bits(results, "grads")
        for key in ("h", "lm_head"):
            _close(results[0]["grads"][key], ref[key], f"grad {key}")


def _train_batch(cfg, rng, B=8, L=12):
    ids = rng.integers(3, cfg.llm.vocab_size, size=(B, L))
    ids[:, 0] = 1
    labels = ids.copy()
    for b in range(B):
        labels[b, :2 + b % 7] = -100
    return {"input_ids": ids, "attention_mask": np.ones((B, L), bool),
            "labels": labels, "pixel_values": _pixels(cfg, rng, B)}


@pytest.mark.parametrize("stage", ["align", "vla-full-train"])
@pytest.mark.parametrize("mesh_shape", [(1, 1, 2), (1, 2, 2)], ids=str)
def test_split_train_step_with_chunked_ce_matches_jax(pool, llama_vlm,
                                                      mesh_shape, stage):
    """One step with the chunked loss (chunk 5): the vocab-parallel CE,
    and in vla-full-train the split towers' and projector's backward,
    give JAX's sharded step's loss and gradient norm."""
    cfg, host, _, _, _, _ = llama_vlm
    batch = _train_batch(cfg, np.random.default_rng(6))
    mesh = _jax_mesh(mesh_shape)
    params = shard_params(jax.tree_util.tree_map(jnp.asarray, host), mesh)
    tx, _ = make_optimizer(params, learning_rate=1e-3, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=10, stage=stage)
    step = jit_train_step(make_train_step(
        cfg, tx, remat=True, compute_dtype=jnp.float32, ce_chunk=5,
        freeze_mask=trainable_mask(params, stage)), mesh=mesh, donate=False)
    _, m = step(create_train_state(params, tx), shard_batch(batch, mesh))
    got = pool.run("train_steps", params=host, batch=batch,
                   mesh_shape=mesh_shape, stage=stage, ce_chunk=5)
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    g = got[0]["metrics"][0]
    np.testing.assert_allclose(g["loss"], float(m["loss"]), rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(g["grad_norm"], float(m["grad_norm"]),
                               rtol=GNORM_RTOL, atol=GNORM_ATOL)
