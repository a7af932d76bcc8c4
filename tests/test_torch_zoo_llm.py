"""Port parity for the Llama family at ``n_kv_heads < n_heads`` (Mistral's
grouped-query attention, 32 query heads on 8 KV heads, at tiny size)
against ``emmax_tpu.models.llama`` with the same weights (bridged) in
fp32 on the CPU: the uncached forward through both attention paths (the
plain one, and the flash path with K/V repeated per query head before the
kernel, whose CPU version the CPU runs), the cached prefill and decode
(bf16-layout and int8 caches, shared and per-row cursors) and a
tree-verification chunk. Also the 13B and Mistral configs.

Tolerances: logits 1e-4 (rtol and atol, as ``test_torch_serving.py``);
caches 1e-5; int8 cache scales 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_tpu.models import llama as j_llama

CFG_KW = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              hidden_dim=128, max_seq_len=64)
JCFG, TCFG = j_llama.LlamaConfig(**CFG_KW), t_llama.LlamaConfig(**CFG_KW)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    return j_llama.init_llama_params(jax.random.PRNGKey(13), JCFG)


@pytest.fixture(scope="module")
def weights():
    params = _jax_weights()
    host = jax.tree_util.tree_map(np.asarray, params)
    assert host["layers"]["wk"].shape == (2, 64, 32)     # 2 KV heads of 16
    return params, params_from_numpy(host)


def _cached_inputs():
    """A left-padded prefill of two rows, then three decode steps."""
    rng = np.random.default_rng(2)
    B, L = 2, 9
    x = _x(rng, B, L)
    mask = np.ones((B, L), bool)
    mask[1, :3] = False
    steps = [(_x(rng, B, 1), np.array([[L + i], [L - 3 + i]], np.int32))
             for i in range(3)]
    return x, mask, steps


@functools.lru_cache(maxsize=None)
def _jax_cached_run(quantized):
    """JAX's logits of ``_cached_inputs`` (prefill, then each step) and
    its final cache, as numpy; shared by both attention paths' cases."""
    jp = _jax_weights()
    x, mask, steps = _cached_inputs()
    jc = j_llama.init_kv_cache(JCFG, x.shape[0], 24, dtype=jnp.float32,
                               quantized=quantized)
    jl, jc = j_llama.llama_forward(jp, JCFG, jnp.asarray(x),
                                   mask=jnp.asarray(mask), kv_cache=jc)
    logits = [np.asarray(jl)]
    for tok, pos in steps:
        jl, jc = j_llama.llama_forward(jp, JCFG, jnp.asarray(tok),
                                       positions=jnp.asarray(pos),
                                       kv_cache=jc)
        logits.append(np.asarray(jl))
    return logits, {k: np.asarray(v) for k, v in jc.items()}


def _x(rng, B, L):
    return rng.standard_normal((B, L, JCFG.dim)).astype(np.float32)


@pytest.mark.parametrize("name", ["LLAMA2_7B", "LLAMA2_13B", "MISTRAL_7B"])
def test_configs_match_jax(name):
    got, want = getattr(t_llama, name), getattr(j_llama, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == 128
    assert (got.n_heads // got.n_kv_heads) == (4 if name == "MISTRAL_7B"
                                               else 1)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_gqa_uncached_matches_jax(weights, impl):
    jp, tp = weights
    rng = np.random.default_rng(1)
    x = _x(rng, 2, 11)
    mask = np.ones((2, 11), bool)
    mask[0, :3] = False
    want, _ = j_llama.llama_forward(jp, JCFG, jnp.asarray(x),
                                    mask=jnp.asarray(mask))
    got, _ = t_llama.llama_forward(tp, TCFG, torch.from_numpy(x),
                                   mask=torch.from_numpy(mask),
                                   attn_impl=impl)
    np.testing.assert_allclose(got.numpy()[1], np.asarray(want)[1],
                               **LOGITS_TOL)
    np.testing.assert_allclose(got.numpy()[0, 3:], np.asarray(want)[0, 3:],
                               **LOGITS_TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_gqa_cached_prefill_and_decode_match_jax(weights, quantized, impl):
    _, tp = weights
    x, mask, steps = _cached_inputs()
    want, jc = _jax_cached_run(quantized)
    B, S = x.shape[0], 24
    tc = t_llama.init_kv_cache(TCFG, B, S, dtype=torch.float32,
                               quantized=quantized)
    assert tuple(tc["k"].shape) == (2, B, S, 2, 16)
    tl, tc = t_llama.llama_forward(tp, TCFG, torch.from_numpy(x),
                                   mask=torch.from_numpy(mask), kv_cache=tc,
                                   attn_impl=impl)
    np.testing.assert_allclose(tl.numpy()[0], want[0][0], **LOGITS_TOL)
    np.testing.assert_allclose(tl.numpy()[1, 3:], want[0][1, 3:],
                               **LOGITS_TOL)
    for (tok, pos), jl in zip(steps, want[1:]):
        tl, tc = t_llama.llama_forward(tp, TCFG, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       kv_cache=tc, attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), jl, **LOGITS_TOL)
    np.testing.assert_array_equal(tc["mask"].numpy(), jc["mask"])
    # the valid slots: a padding query sees no key, and the flash path
    # gives it exact zeros where JAX's plain path averages v, so a padding
    # slot's K/V past the first layer differ by design
    live = tc["mask"].numpy()
    if quantized:
        assert tc["k"].dtype == torch.int8
        np.testing.assert_allclose(tc["v_scale"].numpy()[:, live],
                                   jc["v_scale"][:, live], rtol=1e-5)
    else:
        np.testing.assert_allclose(tc["k"].numpy()[:, live],
                                   jc["k"][:, live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_gqa_per_row_cursors_match_jax(weights, quantized):
    jp, tp = weights
    rng = np.random.default_rng(3)
    B, L, S = 3, 6, 16
    x = _x(rng, B, L)
    jc = j_llama.init_kv_cache(JCFG, B, S, dtype=jnp.float32,
                               quantized=quantized)
    tc = t_llama.init_kv_cache(TCFG, B, S, dtype=torch.float32,
                               quantized=quantized)
    _, jc = j_llama.llama_forward(jp, JCFG, jnp.asarray(x), kv_cache=jc)
    t_llama.llama_forward(tp, TCFG, torch.from_numpy(x), kv_cache=tc)
    cursors = np.array([6, 2, 4], np.int32)
    for step in range(2):
        tok = _x(rng, B, 1)
        jc = dict(jc, len=jnp.asarray(cursors + step))
        tc["len"] = torch.from_numpy(cursors + step)
        pos = cursors[:, None] + step
        jl, jc = j_llama.llama_forward(jp, JCFG, jnp.asarray(tok),
                                       positions=jnp.asarray(pos),
                                       kv_cache=jc)
        tl, tc = t_llama.llama_forward(tp, TCFG, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       kv_cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_array_equal(tc["mask"].numpy(), np.asarray(jc["mask"]))


def test_gqa_chunk_attn_mask_matches_jax(weights):
    """A (root, two siblings) verification chunk over a GQA cache."""
    jp, tp = weights
    rng = np.random.default_rng(4)
    x = _x(rng, 1, 7)
    jc = j_llama.init_kv_cache(JCFG, 1, 32, dtype=jnp.float32)
    tc = t_llama.init_kv_cache(TCFG, 1, 32, dtype=torch.float32)
    _, jc = j_llama.llama_forward(jp, JCFG, jnp.asarray(x), kv_cache=jc)
    t_llama.llama_forward(tp, TCFG, torch.from_numpy(x), kv_cache=tc)
    chunk = _x(rng, 1, 3)
    pos = np.array([[7, 8, 8]], np.int32)
    anc = np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool)
    jl, _ = j_llama.llama_forward(jp, JCFG, jnp.asarray(chunk), kv_cache=jc,
                                  positions=jnp.asarray(pos),
                                  chunk_attn_mask=jnp.asarray(anc))
    tl, _ = t_llama.llama_forward(tp, TCFG, torch.from_numpy(chunk),
                                  kv_cache=tc, positions=torch.from_numpy(pos),
                                  chunk_attn_mask=torch.from_numpy(anc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
