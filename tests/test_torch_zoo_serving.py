"""Port parity for serving the zoo's decoders: a tiny CLIP + Phi VLM and a
tiny CLIP + grouped-query Llama VLM (Mistral's layout), on the same
weights (bridged) in fp32 on the CPU against ``emmax_tpu``.

- ``quantize_vlm_params`` int8 and int4 of the Phi VLM (its ``w1`` /
  ``w2`` and the ``{"kernel", "bias"}`` lm_head): codes and scales equal
  to JAX's, on the host route and on the load's per-layer route
  (``load.place_params``);
- greedy tokens equal to JAX's engines from ``ServingEngine`` (bf16-layout
  and int8 caches, dense and int4 weights), ``ContinuousServingEngine``
  and ``SpeculativeEngine`` (plain and int8 cache), and the speculative
  engine's steps and prefill kind equal to JAX's;
- the paged engine stays Llama-only, as in JAX.

Greedy tokens must be identical (the JAX package's own requirement for
engines on one model); codes and scales bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import load as t_load
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.llama import LlamaConfig as TLlama
from emmax_torch.models.phi import PhiConfig as TPhi
from emmax_torch.models.vit import ViTConfig as TViT
from emmax_torch.serving import continuous as t_cont
from emmax_torch.serving import paged as t_paged
from emmax_torch.serving import quant as t_quant
from emmax_torch.serving.engine import GenerateOptions as TOpts
from emmax_torch.serving.engine import ServingEngine as TEngine
from emmax_torch.serving.speculative import SpeculativeEngine as TSpec
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import phi as j_phi
from emmax_tpu.models import vit as j_vit
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.serving import continuous as j_cont
from emmax_tpu.serving import quant as j_quant
from emmax_tpu.serving.engine import GenerateOptions as JOpts
from emmax_tpu.serving.engine import ServingEngine as JEngine
from emmax_tpu.serving.engine import encode_frame
from emmax_tpu.serving.speculative import SpeculativeEngine as JSpec
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

VOCAB = 512
CLIP = dict(img_size=28, patch_size=14, dim=32, depth=3, n_heads=2,
            hidden_dim=64, class_token=True, pre_norm=True, quick_gelu=True,
            norm_eps=1e-5)
DECODERS = {
    "phi": (j_phi.PhiConfig, TPhi, dict(
        vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
        hidden_dim=128, max_seq_len=256)),
    "gqa": (j_llama.LlamaConfig, TLlama, dict(
        vocab_size=VOCAB, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        hidden_dim=128, max_seq_len=256)),
}
PROMPTS = ["In: pick up the cup\nOut:",
           "In: a much longer instruction goes right here\nOut:"]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(kind):
    jllm, tllm, kw = DECODERS[kind]
    jcfg = j_vlm.VLMConfig(vision=(("clip", j_vit.ViTConfig(**CLIP)),),
                           llm=jllm(**kw))
    tcfg = t_vlm.VLMConfig(vision=(("clip", TViT(**CLIP)),), llm=tllm(**kw))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _weights(kind):
    """The JAX init of a tiny VLM with ``kind``'s decoder, as numpy (one
    init per decoder for the whole file)."""
    return _host(jax.jit(j_vlm.init_vlm_params, static_argnums=1)(
        jax.random.PRNGKey(5), _cfgs(kind)[0]))


@pytest.fixture(scope="module", params=sorted(DECODERS))
def vlm(request):
    jcfg, tcfg = _cfgs(request.param)
    return request.param, jcfg, tcfg, _weights(request.param)


def _pixels(cfg, seed, B):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(B, v.img_size, v.img_size, 3))
            .astype(np.float32) for n, v in cfg.vision}


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_equal(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
            g = got.view(torch.int16).numpy().view(np.uint16)
        else:
            g = got.numpy()
        np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_phi_vlm_matches_jax(bits):
    host = _weights("phi")
    # int8: the on-device quantizer; int4: the host one JAX's load runs
    # (the same bytes as its device one, and seconds faster on the CPU)
    want = (j_quant.quantize_vlm_params_np(host, bits=4) if bits == 4 else
            j_quant.quantize_vlm_params(
                jax.tree_util.tree_map(jnp.asarray, host), bits=8))
    got = t_quant.quantize_vlm_params(params_from_numpy(host), bits=bits)
    layers = got["llm"]["layers"]
    for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
        assert ("q4" if bits == 4 else "q8") in layers[key], key
    for key in ("bq", "b1", "b2", "ln_scale"):
        assert isinstance(layers[key], torch.Tensor), key
    head = got["llm"]["lm_head"]
    assert isinstance(head["bias"], torch.Tensor) and isinstance(
        head["kernel"], dict)
    _tree_equal(got["llm"], want["llm"])
    # the load's route: the host tree moved and quantized layer by layer
    placed = t_load.place_params(params_from_numpy(host), "cpu",
                                 "int4" if bits == 4 else "int8")
    _tree_equal(placed["llm"], want["llm"])
    # quantizing again leaves a quantized head as it is
    again = t_quant.quantize_vlm_params(got, bits=bits)
    assert again["llm"]["lm_head"]["kernel"] is head["kernel"]


def _engines(vlm, cls_j, cls_t, host=None, **kw):
    kind, jcfg, tcfg, host0 = vlm
    host = host0 if host is None else host
    tok = ByteLevelTokenizer(vocab_size=VOCAB)
    j = cls_j(jcfg, jax.tree_util.tree_map(jnp.asarray, host), tok,
              options=JOpts(eos_id=tok.eos_id), **kw)
    t = cls_t(tcfg, params_from_numpy(host), tok,
              options=TOpts(eos_id=tok.eos_id), device="cpu", **kw)
    return j, t


def _same_tokens(j, t, px, n=16, prompts=PROMPTS):
    want = np.asarray(j.generate_ids(prompts, {k: jnp.asarray(v) for k, v
                                               in px.items()},
                                     max_new_tokens=n))
    got = t.generate_ids(prompts, {k: torch.from_numpy(v) for k, v in
                                   px.items()}, max_new_tokens=n)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("quantized_cache", [False, True],
                         ids=["cache", "int8-cache"])
def test_serving_engine_matches_jax(vlm, quantized_cache):
    j, t = _engines(vlm, JEngine, TEngine, quantized_cache=quantized_cache)
    got = _same_tokens(j, t, _pixels(vlm[1], 0, 2))
    assert got.shape == (2, 16)
    # the module holds the decoder the config names
    assert type(t.model.llm).__name__ == ("Phi" if vlm[0] == "phi"
                                          else "Llama")


def test_serving_engine_int4_weights_match_jax(vlm):
    """int4 weights (the Phi VLM's biased lm_head and w1 / w2 among them)
    quantized by JAX: the same tokens from both engines."""
    kind, jcfg, _, host = vlm
    q = j_quant.quantize_vlm_params_np(host, bits=4)
    j, t = _engines(vlm, JEngine, TEngine, host=q)
    _same_tokens(j, t, _pixels(jcfg, 1, 1), prompts=PROMPTS[:1])


@pytest.mark.parametrize("kw", [dict(draft_k=4), dict(draft_k=3,
                                                       quantized_cache=True)],
                         ids=["linear", "int8-cache"])
def test_speculative_engine_matches_jax(vlm, kw):
    j, t = _engines(vlm, JSpec, TSpec, **kw)
    px = _pixels(vlm[1], 2, 2)
    got = _same_tokens(j, t, px)
    for attr in ("last_steps", "last_prefill"):
        assert getattr(t, attr) == getattr(j, attr), attr
    # and the plain engine's tokens, as JAX's Phi speculative tests hold
    plain = TEngine(t.cfg, t.model.tree(), t.tokenizer,
                    options=t.options, device="cpu",
                    quantized_cache=kw.get("quantized_cache", False))
    np.testing.assert_array_equal(plain.generate_ids(
        PROMPTS, {k: torch.from_numpy(v) for k, v in px.items()},
        max_new_tokens=16), got)


# the slot pool: Phi on the int8 cache, grouped-query Llama on the plain
# one (tests/test_torch_continuous.py covers the Llama's int8 cache)
@pytest.mark.parametrize("kind,quantized", [("phi", True), ("gqa", False)])
def test_continuous_engine_matches_jax(kind, quantized):
    jcfg, tcfg = _cfgs(kind)
    host = _weights(kind)
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    patches = [np.array(encode_frame(jparams, jcfg, {
        k: jnp.asarray(v) for k, v in _pixels(jcfg, 10 + i, 1).items()}))
        for i in range(3)]
    tok = ByteLevelTokenizer(vocab_size=VOCAB)
    requests = [(PROMPTS[0], 0, 5), (PROMPTS[1], 1, 11), (PROMPTS[0], 2, 7)]
    kw = dict(num_slots=2, cache_len=96, burst=4, quantized_cache=quantized)
    jeng = j_cont.ContinuousServingEngine(jcfg, jparams, tok, **kw)
    teng = t_cont.ContinuousServingEngine(tcfg, params_from_numpy(host),
                                          tok, device="cpu", **kw)
    jr = [jeng.submit(p, {"patches": jnp.asarray(patches[i])}, n)
          for p, i, n in requests]
    tr = [teng.submit(p, {"patches": torch.from_numpy(patches[i])}, n)
          for p, i, n in requests]
    jdone, tdone = jeng.run_until_complete(), teng.run_until_complete()
    assert [tdone[r] for r in tr] == [jdone[r] for r in jr]


def test_paged_engine_stays_llama_only():
    _, tcfg = _cfgs("phi")
    with pytest.raises(TypeError, match="Llama family only"):
        t_paged.PagedServingEngine(tcfg, params_from_numpy(_weights("phi")),
                                   ByteLevelTokenizer(vocab_size=VOCAB),
                                   device="cpu")
    # a GQA Llama builds
    _, gcfg = _cfgs("gqa")
    t_paged.PagedServingEngine(gcfg, params_from_numpy(_weights("gqa")),
                               ByteLevelTokenizer(vocab_size=VOCAB),
                               num_slots=1, n_pages=4, page_size=16,
                               max_pages_per_slot=4, device="cpu")


def test_vlm_module_and_init_follow_the_decoder_config():
    for kind in DECODERS:
        _, tcfg = _cfgs(kind)
        params = t_vlm.init_vlm_params(torch.Generator().manual_seed(0),
                                       tcfg)
        jparams = _weights(kind)
        assert jax.tree_util.tree_structure(params) == \
            jax.tree_util.tree_structure(jparams)
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree_util.tree_flatten_with_path(jparams)[0]):
            assert tuple(a.shape) == b.shape, p
