"""Port parity for the serving slice: multimodal fusion, the Llama decoder
(cached and uncached), greedy generation and the VLA API, against
``emmax_tpu`` with the same weights (bridged) in fp32 on the CPU.

Greedy tokens, generated text and actions must be identical; logits are
held to 1e-4 (fp32 through a whole model, sums in another order).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.vla import EmmaXVLA as TorchVLA
from emmax_torch.ops.image import ImageTransformConfig as TorchTransform
from emmax_torch.serving import quant as t_quant
from emmax_torch.serving.engine import GenerateOptions as TorchOptions
from emmax_torch.serving.engine import ServingEngine as TorchEngine
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.models.vla import EmmaXVLA as JaxVLA
from emmax_tpu.ops.image import ImageTransformConfig as JaxTransform
from emmax_tpu.serving import quant as j_quant
from emmax_tpu.serving.engine import GenerateOptions as JaxOptions
from emmax_tpu.serving.engine import ServingEngine as JaxEngine
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

GOLDEN = Path(__file__).parent / "fixtures" / "golden_tiny.json"
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(tree):
    return params_from_numpy(_host(tree))


def test_fuse_multimodal_matches_left_padded_and_all_pad_rows():
    rng = np.random.default_rng(0)
    B, L, P, D = 3, 6, 4, 8
    patches = rng.standard_normal((B, P, D)).astype(np.float32)
    text = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.array([[0, 0, 1, 1, 1, 1],      # left-padded
                     [1, 1, 1, 1, 1, 1],      # unpadded
                     [0, 0, 0, 0, 0, 0]],     # all padding: no BOS
                    bool)
    je, jm, _, jp = j_vlm.fuse_multimodal(jnp.asarray(patches),
                                          jnp.asarray(text),
                                          jnp.asarray(mask))
    te, tm, tp = t_vlm.fuse_multimodal(torch.from_numpy(patches),
                                       torch.from_numpy(text),
                                       torch.from_numpy(mask))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert not tm[2].any()                    # the all-pad row stays dead


@pytest.fixture(scope="module")
def llama_setup():
    cfg = j_vlm.tiny_vlm_config(vocab_size=256).llm
    params = j_llama.init_llama_params(jax.random.PRNGKey(7), cfg)
    return cfg, params, _bridge(params)


def test_llama_uncached_matches(llama_setup):
    cfg, jparams, tparams = llama_setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.dim)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[0, :3] = False
    want, _ = j_llama.llama_forward(jparams, cfg, jnp.asarray(x),
                                    mask=jnp.asarray(mask))
    got, cache = t_llama.llama_forward(tparams, cfg, torch.from_numpy(x),
                                       mask=torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(got.numpy()[1], np.asarray(want)[1],
                               **LOGITS_TOL)
    np.testing.assert_allclose(got.numpy()[0, 3:], np.asarray(want)[0, 3:],
                               **LOGITS_TOL)


def test_llama_cached_prefill_and_decode_match(llama_setup):
    cfg, jparams, tparams = llama_setup
    rng = np.random.default_rng(2)
    B, L, S = 2, 7, 16
    x = rng.standard_normal((B, L, cfg.dim)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, :2] = False                        # left padding
    step = rng.standard_normal((B, 1, cfg.dim)).astype(np.float32)
    jc = j_llama.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    tc = t_llama.init_kv_cache(cfg, B, S, dtype=torch.float32)
    jl, jc = j_llama.llama_forward(jparams, cfg, jnp.asarray(x),
                                   mask=jnp.asarray(mask), kv_cache=jc)
    tl, tc2 = t_llama.llama_forward(tparams, cfg, torch.from_numpy(x),
                                    mask=torch.from_numpy(mask), kv_cache=tc)
    assert tc2 is tc and tc["len"] == L        # updated in place
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                               **LOGITS_TOL)
    np.testing.assert_allclose(tl.numpy()[1, 2:], np.asarray(jl)[1, 2:],
                               **LOGITS_TOL)
    pos = np.array([[L], [L - 2]], np.int32)
    jl, jc = j_llama.llama_forward(jparams, cfg, jnp.asarray(step),
                                   positions=jnp.asarray(pos), kv_cache=jc)
    tl, tc = t_llama.llama_forward(tparams, cfg, torch.from_numpy(step),
                                   positions=torch.from_numpy(pos),
                                   kv_cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS_TOL)
    np.testing.assert_array_equal(tc["mask"].numpy(), np.asarray(jc["mask"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)
    assert tc["len"] == int(jc["len"]) == L + 1


def test_cache_overflow_raises(llama_setup):
    cfg, _, tparams = llama_setup
    cache = t_llama.init_kv_cache(cfg, 1, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="overflow"):
        t_llama.llama_forward(tparams, cfg, torch.zeros(1, 5, cfg.dim),
                              kv_cache=cache)


def _golden_setup():
    """tests/test_golden.py::_compute's engine inputs."""
    cfg = j_vlm.tiny_vlm_config(vocab_size=1024)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(1234), cfg)
    tok = ByteLevelTokenizer(1024)
    rng = np.random.default_rng(99)
    pixels = {n: rng.normal(size=(1, v.img_size, v.img_size, 3))
              .astype(np.float32) for n, v in cfg.vision}
    return cfg, params, tok, pixels, "In: golden fixture prompt\nOut:"


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_greedy_tokens_match_golden_and_jax_engine(impl):
    cfg, params, tok, pixels, prompt = _golden_setup()
    engine = TorchEngine(t_vlm.tiny_vlm_config(vocab_size=1024),
                         _bridge(params), tok,
                         options=TorchOptions(eos_id=tok.eos_id),
                         attn_impl=impl, device="cpu")
    got = engine.generate_ids([prompt], {k: torch.from_numpy(v)
                                         for k, v in pixels.items()},
                              max_new_tokens=16)[0].tolist()
    assert got == json.loads(GOLDEN.read_text())["greedy_tokens"]
    # the JAX engine with the matching attention path
    jimpl = {"torch": "xla", "cuda": "pallas"}[impl]
    jengine = JaxEngine(cfg, params, tok,
                        options=JaxOptions(eos_id=tok.eos_id),
                        attn_impl=jimpl)
    want = jengine.generate_ids([prompt], {k: jnp.asarray(v)
                                           for k, v in pixels.items()},
                                max_new_tokens=16)[0].tolist()
    assert got == want
    assert engine.last_timings["prefill_tokens"] == 32 + cfg.num_patches


def test_batched_left_padded_generation_matches_jax():
    cfg, params, tok, _, _ = _golden_setup()
    rng = np.random.default_rng(5)
    pixels = {n: rng.normal(size=(2, v.img_size, v.img_size, 3))
              .astype(np.float32) for n, v in cfg.vision}
    prompts = ["In: a much longer prompt than the other one\nOut:", "In: x"]
    engine = TorchEngine(t_vlm.tiny_vlm_config(vocab_size=1024),
                         _bridge(params), tok,
                         options=TorchOptions(eos_id=tok.eos_id),
                         device="cpu")
    got = engine.generate_ids(prompts, {k: torch.from_numpy(v)
                                        for k, v in pixels.items()},
                              max_new_tokens=10)
    want = JaxEngine(cfg, params, tok, options=JaxOptions(
        eos_id=tok.eos_id)).generate_ids(
        prompts, {k: jnp.asarray(v) for k, v in pixels.items()},
        max_new_tokens=10)
    np.testing.assert_array_equal(got, want)


STATS = {"bridge_orig": {"action": {
    "q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
PROPRIO = {"Q1": [-1.0] * 7, "Q99": [1.0] * 7}


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_vla_api_matches_jax(quantize):
    jcfg = j_vlm.tiny_vlm_config(vocab_size=2048)
    tcfg = t_vlm.tiny_vlm_config(vocab_size=2048)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg)
    tparams = _bridge(params)
    if quantize is not None:
        bits = 4 if quantize == "int4" else 8
        host = j_quant.quantize_vlm_params_np(_host(params), bits=bits)
        params = jax.tree_util.tree_map(jnp.asarray, host)
        tparams = t_quant.quantize_vlm_params(tparams, bits=bits)
        # both quantizers give the same bytes
        wq = tparams["llm"]["layers"]["wq"]
        key = "q4" if bits == 4 else "q8"
        np.testing.assert_array_equal(
            wq[key].numpy(), host["llm"]["layers"]["wq"][key])
    tok = ByteLevelTokenizer(vocab_size=2048)
    jvla = JaxVLA(jcfg, params, tok,
                  {n: JaxTransform(size=v.img_size) for n, v in jcfg.vision},
                  norm_stats=STATS, proprio_stats=PROPRIO)
    tvla = TorchVLA(tcfg, tparams, tok,
                    {n: TorchTransform(size=v.img_size)
                     for n, v in tcfg.vision},
                    norm_stats=STATS, proprio_stats=PROPRIO, device="cpu")
    frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    prompt = tvla.get_prompt("pick the cup", gripper_position=(10, 10))
    assert prompt == jvla.get_prompt("pick the cup", gripper_position=(10, 10))
    for kind in ("act", "pos"):
        ta, tt = tvla.generate_actions(frame, prompt, type=kind,
                                       max_new_tokens=12)
        ja, jt = jvla.generate_actions(frame, prompt, type=kind,
                                       max_new_tokens=12)
        assert tt == jt
        assert len(ta) == len(ja) >= 1
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tvla.predict_action(frame, "Pick Up The Fork",
                            unnorm_key="bridge_orig"),
        jvla.predict_action(frame, "Pick Up The Fork",
                            unnorm_key="bridge_orig"))


def test_select_token_greedy_nucleus_and_temperature():
    from emmax_torch.serving.engine import _select_token

    logits = torch.tensor([[0.0, 3.0, 1.0, 2.9, -1.0],
                           [2.0, 2.0, 0.0, -5.0, 1.0]])
    torch.testing.assert_close(_select_token(logits, None, 0.0, 1.0),
                               torch.tensor([1, 0]))
    gen = torch.Generator().manual_seed(0)
    # a nucleus this small keeps only the top-ranked token
    for _ in range(20):
        assert _select_token(logits[:1], gen, 1.0, 0.01).item() == 1
    # temperature sampling follows softmax(logits / T)
    probs = torch.softmax(logits[1] / 0.7, dim=-1)
    draws = torch.stack([_select_token(logits[1:], gen, 0.7, 1.0)
                         for _ in range(4000)])[:, 0]
    freq = torch.bincount(draws, minlength=5).float() / 4000
    torch.testing.assert_close(freq, probs, rtol=0, atol=0.03)
    # a seeded generator repeats its draws
    a = _select_token(logits, torch.Generator().manual_seed(3), 1.0, 0.9)
    b = _select_token(logits, torch.Generator().manual_seed(3), 1.0, 0.9)
    torch.testing.assert_close(a, b)


def test_modules_hold_the_weights_and_match_the_functions(llama_setup):
    from emmax_torch.models.projector import Projector, projector_forward

    cfg, _, tparams = llama_setup
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 5, cfg.dim)).astype(np.float32))
    module = t_llama.Llama(cfg, tparams)
    names = dict(module.named_buffers())
    assert "params.layers.wq" in names and len(names) == 12
    got, _ = module(x)
    want, _ = t_llama.llama_forward(tparams, cfg, x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    proj = {"layers": [{"kernel": torch.randn(5, 7), "bias": torch.randn(7)}]}
    torch.testing.assert_close(Projector(proj)(torch.ones(2, 5)),
                               projector_forward(proj, torch.ones(2, 5)))
