"""Port parity for the Phi-2 decoder (``emmax_torch.models.phi``) against
``emmax_tpu.models.phi`` with the same weights (bridged) in fp32 on the
CPU: partial RoPE and ``gelu_new``, the uncached forward (left padding),
the cached prefill and decode (bf16-layout and int8 caches, shared and
per-row cursors), ``return_hidden`` with chunked CE through the biased
lm_head, tree-verification chunks, and ``convert_hf_phi``.

Tolerances: logits 1e-4 (rtol and atol; fp32 through a whole model, sums
in another order, as ``test_torch_serving.py``); caches 1e-5; the
chunked loss 1e-6 relative and its gradients 1e-5 (as
``test_torch_training.py::test_chunked_ce_matches_jax``); converted
weights bit for bit; int8 cache scales 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.models import phi as t_phi
from emmax_torch.ops import rope as t_rope
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import phi as j_phi

# head_dim 20, rotary_dim 8: both halves of the head are exercised
CFG_KW = dict(vocab_size=256, dim=80, n_layers=2, n_heads=4, n_kv_heads=4,
              hidden_dim=160, max_seq_len=64)
JCFG, TCFG = j_phi.PhiConfig(**CFG_KW), t_phi.PhiConfig(**CFG_KW)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params = j_phi.init_phi_params(jax.random.PRNGKey(11), JCFG)
    # non-zero biases and norms, so every bias and the norms' affine parts
    # show in the outputs
    rng = np.random.default_rng(0)
    host = _host(params)

    def jitter(tree):
        return {k: jitter(v) if isinstance(v, dict) else
                (v + rng.normal(0, 0.05, v.shape).astype(np.float32))
                for k, v in tree.items()}

    host = jitter(host)
    return jax.tree_util.tree_map(jnp.asarray, host), params_from_numpy(host)


def _embeds(rng, B, L):
    return rng.standard_normal((B, L, JCFG.dim)).astype(np.float32)


def test_config_and_rotary_dim_match_jax():
    assert t_phi.PHI_2.__dict__ == j_phi.PHI_2.__dict__
    assert (TCFG.head_dim, TCFG.rotary_dim) == (JCFG.head_dim,
                                                JCFG.rotary_dim) == (20, 8)
    assert (t_phi.PHI_2.head_dim, t_phi.PHI_2.rotary_dim) == (80, 32)


def test_partial_rope_and_gelu_new_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 20)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = j_phi.rope_cos_sin(jnp.asarray(pos), 8, 10000.0)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(pos), 8, 10000.0)
    want = j_phi._apply_partial_rope(jnp.asarray(x), jc, js, 8)
    got = t_rope.apply_partial_rope(torch.from_numpy(x), tc, ts, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[..., 8:], x[..., 8:])
    y = rng.standard_normal((3, 50)).astype(np.float32) * 3
    np.testing.assert_allclose(
        t_phi.gelu_new(torch.from_numpy(y)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(y), approximate=True)),
        rtol=1e-6, atol=1e-6)


def test_phi_uncached_matches(weights):
    jp, tp = weights
    rng = np.random.default_rng(2)
    x = _embeds(rng, 2, 9)
    mask = np.ones((2, 9), bool)
    mask[0, :3] = False                          # left padding
    want, _ = j_phi.phi_forward(jp, JCFG, jnp.asarray(x),
                                mask=jnp.asarray(mask))
    got, cache = t_phi.phi_forward(tp, TCFG, torch.from_numpy(x),
                                   mask=torch.from_numpy(mask))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[1], np.asarray(want)[1],
                               **LOGITS_TOL)
    np.testing.assert_allclose(got.numpy()[0, 3:], np.asarray(want)[0, 3:],
                               **LOGITS_TOL)
    # the module holds the same weights and gives the same logits
    mod, _ = t_phi.Phi(TCFG, tp)(torch.from_numpy(x),
                                 mask=torch.from_numpy(mask))
    torch.testing.assert_close(mod, got, rtol=0, atol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_phi_cached_prefill_and_decode_match(weights, quantized):
    jp, tp = weights
    rng = np.random.default_rng(3)
    B, L, S = 2, 7, 16
    x = _embeds(rng, B, L)
    mask = np.ones((B, L), bool)
    mask[1, :2] = False
    jc = j_llama.init_kv_cache(JCFG, B, S, dtype=jnp.float32,
                               quantized=quantized)
    tc = t_llama.init_kv_cache(TCFG, B, S, dtype=torch.float32,
                               quantized=quantized)
    jl, jc = j_phi.phi_forward(jp, JCFG, jnp.asarray(x),
                               mask=jnp.asarray(mask), kv_cache=jc)
    tl, tc2 = t_phi.phi_forward(tp, TCFG, torch.from_numpy(x),
                                mask=torch.from_numpy(mask), kv_cache=tc)
    assert tc2 is tc and tc["len"] == L
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                               **LOGITS_TOL)
    np.testing.assert_allclose(tl.numpy()[1, 2:], np.asarray(jl)[1, 2:],
                               **LOGITS_TOL)
    for step in range(3):
        tok = _embeds(rng, B, 1)
        pos = np.array([[L + step], [L - 2 + step]], np.int32)
        jl, jc = j_phi.phi_forward(jp, JCFG, jnp.asarray(tok),
                                   positions=jnp.asarray(pos), kv_cache=jc)
        tl, tc = t_phi.phi_forward(tp, TCFG, torch.from_numpy(tok),
                                   positions=torch.from_numpy(pos),
                                   kv_cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_array_equal(tc["mask"].numpy(), np.asarray(jc["mask"]))
    assert tc["len"] == int(jc["len"]) == L + 3
    if quantized:
        assert tc["k"].dtype == torch.int8
        np.testing.assert_allclose(tc["k_scale"].numpy(),
                                   np.asarray(jc["k_scale"]), rtol=1e-5)
    else:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_phi_per_row_cursors_match_jax(weights, quantized):
    """A prefill of three rows, then decode steps with a [B] cursor
    vector: per-row writes, RoPE positions and causal masks."""
    jp, tp = weights
    rng = np.random.default_rng(4)
    B, L, S = 3, 6, 16
    x = _embeds(rng, B, L)
    jc = j_llama.init_kv_cache(JCFG, B, S, dtype=jnp.float32,
                               quantized=quantized)
    tc = t_llama.init_kv_cache(TCFG, B, S, dtype=torch.float32,
                               quantized=quantized)
    _, jc = j_phi.phi_forward(jp, JCFG, jnp.asarray(x), kv_cache=jc)
    t_phi.phi_forward(tp, TCFG, torch.from_numpy(x), kv_cache=tc)
    cursors = np.array([6, 3, 5], np.int32)
    for step in range(2):
        tok = _embeds(rng, B, 1)
        pos = cursors[:, None] + step
        jc = dict(jc, len=jnp.asarray(cursors + step))
        tc["len"] = torch.from_numpy(cursors + step)
        jl, jc = j_phi.phi_forward(jp, JCFG, jnp.asarray(tok),
                                   positions=jnp.asarray(pos), kv_cache=jc)
        tl, tc = t_phi.phi_forward(tp, TCFG, torch.from_numpy(tok),
                                   positions=torch.from_numpy(pos),
                                   kv_cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_array_equal(tc["mask"].numpy(), np.asarray(jc["mask"]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_phi_cached_default_positions_start_at_the_cursor(weights):
    """Without ``positions`` a cached call takes RoPE positions from the
    cache's cursor (``llama_forward``'s rule): the same logits as passing
    them. The JAX package's Phi starts them at 0; its engines always pass
    positions, so the engines agree (``test_torch_zoo_serving.py``)."""
    _, tp = weights
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_embeds(rng, 1, 5))
    step = torch.from_numpy(_embeds(rng, 1, 2))
    got = []
    for pos in (None, torch.tensor([[5, 6]])):
        cache = t_llama.init_kv_cache(TCFG, 1, 16, dtype=torch.float32)
        t_phi.phi_forward(tp, TCFG, x, kv_cache=cache)
        got.append(t_phi.phi_forward(tp, TCFG, step, positions=pos,
                                     kv_cache=cache)[0])
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)


def test_phi_return_hidden_and_chunked_ce_with_bias(weights):
    jp, tp = weights
    rng = np.random.default_rng(6)
    x = _embeds(rng, 2, 11)
    labels = rng.integers(0, JCFG.vocab_size, (2, 11)).astype(np.int32)
    labels[rng.random((2, 11)) < 0.2] = j_llama.IGNORE_INDEX
    jh, _ = j_phi.phi_forward(jp, JCFG, jnp.asarray(x), return_hidden=True)
    th, _ = t_phi.phi_forward(tp, TCFG, torch.from_numpy(x),
                              return_hidden=True)
    assert th.shape == (2, 11, JCFG.dim)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    head_np = {k: np.array(v) for k, v in jp["lm_head"].items()}
    h = np.asarray(jh)
    jl, jpred = j_llama.chunked_ce_loss_and_preds(
        jnp.asarray(h), jax.tree_util.tree_map(jnp.asarray, head_np),
        jnp.asarray(labels), chunk=4)
    hin = torch.from_numpy(h.copy()).requires_grad_()
    bias = torch.from_numpy(head_np["bias"].copy()).requires_grad_()
    tl, tpred = t_llama.chunked_ce_loss_and_preds(
        hin, {"kernel": torch.from_numpy(head_np["kernel"]), "bias": bias},
        torch.from_numpy(labels), chunk=4)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    # the same loss as the plain logits path of the port
    logits, _ = t_phi.phi_forward(tp, TCFG, torch.from_numpy(x))
    full = t_llama.cross_entropy_loss(logits, torch.from_numpy(labels))
    np.testing.assert_allclose(tl.item(), full.item(), rtol=1e-5)
    tl.backward()

    def jloss(hh, b):
        return j_llama.chunked_ce_loss_and_preds(
            hh, {"kernel": jnp.asarray(head_np["kernel"]), "bias": b},
            jnp.asarray(labels), chunk=4)[0]

    gh, gb = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(head_np["bias"]))
    np.testing.assert_allclose(hin.grad.numpy(), np.asarray(gh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(gb), rtol=1e-5,
                               atol=1e-7)


def test_phi_chunk_attn_mask_matches_jax(weights):
    """A tree-verification chunk (root + two siblings at depth 1) over a
    per-row cursor, against JAX's; and the mask raises without a cache."""
    jp, tp = weights
    rng = np.random.default_rng(7)
    x = _embeds(rng, 1, 6)
    with pytest.raises(ValueError, match="kv_cache"):
        t_phi.phi_forward(tp, TCFG, torch.from_numpy(x),
                          chunk_attn_mask=torch.ones(6, 6, dtype=torch.bool))
    jc = j_llama.init_kv_cache(JCFG, 1, 32, dtype=jnp.float32)
    tc = t_llama.init_kv_cache(TCFG, 1, 32, dtype=torch.float32)
    _, jc = j_phi.phi_forward(jp, JCFG, jnp.asarray(x), kv_cache=jc)
    t_phi.phi_forward(tp, TCFG, torch.from_numpy(x), kv_cache=tc)
    chunk = _embeds(rng, 1, 3)
    pos = np.array([[6, 7, 7]], np.int32)
    anc = np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool)
    jl, _ = j_phi.phi_forward(jp, JCFG, jnp.asarray(chunk),
                              kv_cache=dict(jc, len=jnp.asarray([6],
                                                                jnp.int32)),
                              positions=jnp.asarray(pos),
                              chunk_attn_mask=jnp.asarray(anc))
    tc["len"] = torch.tensor([6], dtype=torch.int32)
    tl, _ = t_phi.phi_forward(tp, TCFG, torch.from_numpy(chunk), kv_cache=tc,
                              positions=torch.from_numpy(pos),
                              chunk_attn_mask=torch.from_numpy(anc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)


def _hf_phi_state_dict(rng, cfg):
    """A random Hugging Face ``PhiForCausalLM`` state dict as numpy."""
    D, F, V = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    sd = {"model.embed_tokens.weight": (V, D),
          "model.final_layernorm.weight": (D,),
          "model.final_layernorm.bias": (D,),
          "lm_head.weight": (V, D), "lm_head.bias": (V,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": (D,),
                   p + "input_layernorm.bias": (D,),
                   p + "mlp.fc1.weight": (F, D), p + "mlp.fc1.bias": (F,),
                   p + "mlp.fc2.weight": (D, F), p + "mlp.fc2.bias": (D,)})
        for name in ("q_proj", "k_proj", "v_proj", "dense"):
            sd[p + f"self_attn.{name}.weight"] = (D, D)
            sd[p + f"self_attn.{name}.bias"] = (D,)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sd.items()}


def test_convert_hf_phi_matches_jax():
    sd = _hf_phi_state_dict(np.random.default_rng(8), JCFG)
    want = j_phi.convert_hf_phi(sd, JCFG)
    got = t_phi.convert_hf_phi({k: torch.from_numpy(v) for k, v in
                                sd.items()}, TCFG)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = {tuple(jax.tree_util.DictKey(k) for k in path): v
              for path, v in _paths(got)}
    assert {jax.tree_util.keystr(k) for k in flat_w} == \
        {jax.tree_util.keystr(k) for k in flat_g}
    for path, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[path].numpy(), np.asarray(w))
    # the converted weights run: the port's forward equals JAX's on them
    x = _embeds(np.random.default_rng(9), 1, 5)
    jl, _ = j_phi.phi_forward(jax.tree_util.tree_map(jnp.asarray, want),
                              JCFG, jnp.asarray(x))
    tl, _ = t_phi.phi_forward(got, TCFG, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v
