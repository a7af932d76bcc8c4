"""Port parity for training a Phi-backed VLM and for placing the zoo's
trees on a mesh, against ``emmax_tpu`` in fp32 on the CPU.

- One batch through a tiny CLIP + Phi VLM: the port's ``make_grad_fn``
  (the step's loss and gradients; flash path, full remat) against
  ``jax.value_and_grad`` of ``vlm_forward``'s loss, in the align stage,
  vla-train with chunked CE through the biased lm_head, and
  vla-full-train (the CLIP tower trained); then one optimizer step of
  both packages' ``make_train_step`` (metrics and updated params).
  Tolerances are ``tests/test_torch_training.py``'s: rtol 1e-4, atol
  1e-6, a share ``OUTLIERS`` of a leaf's entries allowed off them, each
  still within 1e-4 of the leaf's largest entry (gradients) or one step's
  lr (params).
- ``param_partition_specs`` of the tiny CLIP + Phi tree, dense and int4,
  at three mesh shapes, and of the full-width ``phi-2+3b``,
  ``mistral-v0.1+7b`` and ``llama2+13b`` trees by shapes (the port's on
  the meta device, JAX's by ``jax.eval_shape``): JAX's specs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import materialize as t_mat
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.phi import PhiConfig as TPhi
from emmax_torch.models.tree import leaves_with_path
from emmax_torch.models.vit import ViTConfig as TViT
from emmax_torch.parallel import sharding as t_sharding
from emmax_torch.serving.quant import quantize_vlm_params as t_quantize
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_tpu.models import materialize as j_mat
from emmax_tpu.models import phi as j_phi
from emmax_tpu.models import vit as j_vit
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.parallel import make_mesh, param_partition_specs
from emmax_tpu.serving.quant import quantize_vlm_params as j_quantize
from emmax_tpu.training import train_state as j_state
from emmax_tpu.training import train_step as j_step

RTOL, ATOL, OUTLIERS = 1e-4, 1e-6, 5e-4
LR = 1e-3
VOCAB = 512
CLIP = dict(img_size=28, patch_size=14, dim=32, depth=3, n_heads=2,
            hidden_dim=64, class_token=True, pre_norm=True, quick_gelu=True,
            norm_eps=1e-5)
PHI = dict(vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
           hidden_dim=128, max_seq_len=256)
AXES = ("replica", "fsdp", "tensor")


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_vlm.VLMConfig(vision=(("clip", j_vit.ViTConfig(**CLIP)),),
                           llm=j_phi.PhiConfig(**PHI))
    tcfg = t_vlm.VLMConfig(vision=(("clip", TViT(**CLIP)),), llm=TPhi(**PHI))
    params = _host(jax.jit(j_vlm.init_vlm_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    B, T = 2, 24
    ids = rng.integers(3, 500, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    labels = ids.copy()
    labels[:, :6] = -100
    mask = np.ones((B, T), bool)
    ids[-1, T - 5:], labels[-1, T - 5:], mask[-1, T - 5:] = 0, -100, False
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask,
             "pixel_values": {"clip": rng.standard_normal(
                 (B, 28, 28, 3)).astype(np.float32)}}
    return jcfg, tcfg, params, batch


def _to(batch, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def _close(got, want, scale_tol, what):
    off = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert off.mean() <= OUTLIERS, (what, off.sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol,
                               err_msg=what)


# (stage, ce_chunk)
STAGES = [("align", None), ("vla-train", 8), ("vla-full-train", None)]


@pytest.mark.parametrize("stage,ce_chunk", STAGES,
                         ids=[s for s, _ in STAGES])
def test_phi_vlm_loss_and_gradients_match_jax(setup, stage, ce_chunk):
    jcfg, tcfg, host, batch = setup
    stop = stage != "vla-full-train"
    jmask = j_state.trainable_mask(host, stage)
    jb = _to(batch, jnp.asarray)

    def jloss(p):
        return j_vlm.vlm_forward(
            p, jcfg, jb["input_ids"], jb["pixel_values"],
            jb["attention_mask"], jb["labels"], remat=True,
            stop_vision_gradient=stop, ce_chunk=ce_chunk)[1]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, host))
    tparams = params_from_numpy(host)
    grad_fn = t_step.make_grad_fn(
        tcfg, attn_impl="cuda", remat=True, stop_vision_gradient=stop,
        compute_dtype=torch.float32, ce_chunk=ce_chunk,
        freeze_mask=t_state.trainable_mask(tparams, stage),
        action_vocab_size=VOCAB)
    tl, aux, tg = grad_fn(tparams, _to(batch, torch.from_numpy))
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    want = dict(zip([p for p, _ in leaves_with_path(tg)],
                    jax.tree_util.tree_leaves(_host(jg))))
    masks = dict(zip([p for p, _ in leaves_with_path(tg)],
                     jax.tree_util.tree_leaves(jmask)))
    trained = 0
    for path, g in leaves_with_path(tg):
        if not np.any(masks[path]):
            assert g.dim() == 0 and float(g) == 0.0, path
            continue
        trained += 1
        w = want[path]
        _close(g.numpy(), w, 1e-4 * max(np.abs(w).max(), 1e-12), path)
    n_proj = len(tg["projector"]["layers"]) * 2
    assert trained == {"align": n_proj,
                       "vla-train": n_proj + 19,
                       "vla-full-train": len(leaves_with_path(tg))}[stage]


def test_phi_vlm_train_step_matches_jax(setup):
    """One AdamW step of vla-train with chunked CE in both packages."""
    jcfg, tcfg, host, batch = setup
    kw = dict(learning_rate=LR, weight_decay=0.1, max_grad_norm=1.0,
              lr_scheduler_type="constant", total_steps=4, stage="vla-train")
    step_kw = dict(remat=True, stop_vision_gradient=True,
                   action_vocab_size=VOCAB, ce_chunk=8)
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    jtx, _ = j_state.make_optimizer(jparams, **kw)
    jfn = jax.jit(j_step.make_train_step(
        jcfg, jtx, attn_impl="xla", compute_dtype=jnp.float32,
        freeze_mask=j_state.trainable_mask(jparams, "vla-train"), **step_kw))
    jstate, jm = jfn(j_state.create_train_state(jparams, jtx),
                     _to(batch, jnp.asarray))
    tparams = params_from_numpy(host)
    ttx, _ = t_state.make_optimizer(tparams, **kw)
    tfn = t_step.make_train_step(
        tcfg, ttx, attn_impl="cuda", compute_dtype=torch.float32,
        freeze_mask=t_state.trainable_mask(tparams, "vla-train"), **step_kw)
    tstate, tm = tfn(t_state.create_train_state(tparams, ttx),
                     _to(batch, torch.from_numpy))
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want = jax.tree_util.tree_leaves(_host(jstate.params))
    for (path, got), w in zip(leaves_with_path(tstate.params), want):
        got = got.numpy()
        if path == "llm/layers/bk":
            # a key bias on the channels RoPE leaves alone shifts every
            # key's logit by the same amount: its gradient is zero up to
            # fp32 noise, which Adam scales to ~lr either way, so those
            # channels are held only to one step's lr (below)
            r = tcfg.llm.rotary_dim
            sl = (slice(None), slice(None), slice(r))
            shape = (got.shape[0], tcfg.llm.n_kv_heads, -1)
            _close(got.reshape(shape)[sl], w.reshape(shape)[sl], LR, path)
        else:
            _close(got, w, LR, path)
        np.testing.assert_allclose(got, w, rtol=0, atol=LR, err_msg=path)


def _spec_table(jparams, shape):
    specs = param_partition_specs(jparams, make_mesh(shape))
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
    return out


@pytest.mark.parametrize("bits", [None, 4], ids=["dense", "int4"])
@pytest.mark.parametrize("shape", [(1, 8, 1), (1, 4, 2), (2, 2, 2)], ids=str)
def test_phi_vlm_partition_specs_match_jax(setup, shape, bits):
    _, tcfg, host, _ = setup
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    # shapes decide the specs: the int4 trees are traced (JAX) and built on
    # the meta device (the port), not quantized
    tparams = t_vlm.init_vlm_params(torch.Generator(), tcfg, torch.float32,
                                    "meta")
    if bits:
        jparams = jax.eval_shape(lambda: j_quantize(jparams, bits=4))
        tparams = t_quantize(tparams, bits=4)
    want = _spec_table(jparams, shape)
    got = t_sharding.param_partition_specs(tparams, dict(zip(AXES, shape)))
    assert got == want
    # Phi's leaves off the Llama rules and CLIP's pre-norm are replicated
    for path in ("llm/layers/w1", "llm/layers/bq", "llm/lm_head/bias",
                 "vision/clip/pre_norm/scale"):
        if path in got:
            assert got[path] == (None,) * len(got[path]), path


@pytest.mark.parametrize("model_id", ["phi-2+3b", "mistral-v0.1+7b",
                                      "llama2+13b"])
def test_full_width_zoo_specs_match_jax_by_shapes(model_id):
    jcfg, tcfg = j_mat.get_vlm_config(model_id), \
        t_mat.get_vlm_config(model_id)
    # float32 shapes (JAX's bf16 init samples large leaves slice by slice,
    # which takes a minute to trace at 13B)
    jtree = jax.eval_shape(lambda: j_vlm.init_vlm_params(
        jax.random.PRNGKey(0), jcfg))
    ttree = t_vlm.init_vlm_params(torch.Generator(), tcfg, torch.float32,
                                  "meta")
    shapes = {p: tuple(t.shape) for p, t in leaves_with_path(ttree)}
    assert shapes == {
        "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                 for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    shape = (1, 4, 2)
    assert t_sharding.param_partition_specs(
        ttree, dict(zip(AXES, shape))) == _spec_table(jtree, shape)
    assert dataclasses.asdict(tcfg.llm) == dataclasses.asdict(jcfg.llm)
