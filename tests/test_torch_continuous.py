"""Port parity for the slot-pool engine and what it stands on: attention
at per-row cursors, the dense int8 KV cache, the decoder's cached path
with per-row cursors, ``ContinuousServingEngine`` and
``EmmaXVLA.generate_batch``, against ``emmax_tpu`` with the same weights
(bridged), in fp32 on the CPU.

Greedy tokens and texts must be identical, int8 cache bytes too; logits
and attention outputs are held to 1e-4 / 1e-5 (fp32, sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.vla import EmmaXVLA as TorchVLA
from emmax_torch.ops import attention as t_attn
from emmax_torch.ops.image import ImageTransformConfig as TorchTransform
from emmax_torch.serving import continuous as t_cont
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.models.vla import EmmaXVLA as JaxVLA
from emmax_tpu.ops import attention as j_attn
from emmax_tpu.ops.image import ImageTransformConfig as JaxTransform
from emmax_tpu.serving import continuous as j_cont
from emmax_tpu.serving.engine import encode_frame
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("Lq,gqa,masked", [(1, 1, False), (1, 2, True),
                                           (3, 1, True), (3, 2, False)])
def test_per_row_q_offset_attention_matches_jax(Lq, gqa, masked):
    rng = np.random.default_rng(0)
    B, S, H, D = 3, 12, 4, 16
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, H // gqa, D)).astype(np.float32)
            for _ in range(2))
    offsets = np.array([0, 5, 9], np.int32)
    kv_mask = None
    if masked:
        kv_mask = np.ones((B, S), bool)
        kv_mask[1, :2] = False
    want = np.asarray(j_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
        causal=True, q_offset=jnp.asarray(offsets)))
    for impl in ("torch", "cuda"):     # a per-row offset takes the plain path
        got = t_attn.multi_head_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask),
            causal=True, q_offset=torch.from_numpy(offsets), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_quantize_kv_bytes_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 3, 16)) * 4).astype(np.float32)
    x[0, 0, 0] = np.linspace(-1.0, 2.0, 16)    # positive absmax
    x[1, 2, 1] = 0.0                           # zero row: scale 1
    x[1, 3, 2, :8] = 0.5                       # ties on .5 steps
    jq, js = j_llama._quantize_kv(jnp.asarray(x))
    tq, ts = t_llama._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_llama_per_row_cached_decode_matches_jax(quantized):
    """A left-aligned prefill of three rows, then two decode steps with a
    [B] cursor vector: per-row writes, RoPE positions and causal masks."""
    cfg = j_vlm.tiny_vlm_config(vocab_size=256).llm
    params = j_llama.init_llama_params(jax.random.PRNGKey(7), cfg)
    tparams = _bridge(params)
    rng = np.random.default_rng(2)
    B, L, S = 3, 6, 16
    x = rng.standard_normal((B, L, cfg.dim)).astype(np.float32)
    jc = j_llama.init_kv_cache(cfg, B, S, dtype=jnp.float32,
                               quantized=quantized)
    tc = t_llama.init_kv_cache(cfg, B, S, dtype=torch.float32,
                               quantized=quantized)
    _, jc = j_llama.llama_forward(params, cfg, jnp.asarray(x), kv_cache=jc)
    t_llama.llama_forward(tparams, cfg, torch.from_numpy(x), kv_cache=tc)
    cursors = np.array([6, 3, 5], np.int32)    # rows at their own lengths
    for step in range(2):
        tok = rng.standard_normal((B, 1, cfg.dim)).astype(np.float32)
        pos = cursors[:, None] + step
        jc = dict(jc, len=jnp.asarray(cursors + step))
        tc["len"] = torch.from_numpy(cursors + step)
        jl, jc = j_llama.llama_forward(params, cfg, jnp.asarray(tok),
                                       positions=jnp.asarray(pos),
                                       kv_cache=jc)
        tl, tc = t_llama.llama_forward(tparams, cfg, torch.from_numpy(tok),
                                       positions=torch.from_numpy(pos),
                                       kv_cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(tc["mask"].numpy(), np.asarray(jc["mask"]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if quantized:
        assert tc["k"].dtype == torch.int8
        np.testing.assert_allclose(tc["k_scale"].numpy(),
                                   np.asarray(jc["k_scale"]), rtol=1e-5)
    else:
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = j_vlm.tiny_vlm_config(vocab_size=1024)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg)
    patches = []
    for seed in range(3):
        r = np.random.default_rng(20 + seed)
        raw = {n: jnp.asarray(r.normal(size=(1, v.img_size, v.img_size, 3))
                              .astype(np.float32)) for n, v in cfg.vision}
        patches.append(np.array(encode_frame(params, cfg, raw)))
    return cfg, params, _bridge(params), ByteLevelTokenizer(1024), patches


# two equal-length prompts (one batched admission) and a longer one, with
# budgets that retire slots mid-burst; three requests through two slots
REQUESTS = [("In: pick up the cup\nOut:", 0, 5),
            ("In: pick up the pot\nOut:", 1, 11),
            ("In: close that drawer now\nOut:", 2, 7)]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_continuous_engine_matches_jax(tiny, quantized):
    cfg, params, tparams, tok, patches = tiny
    kw = dict(num_slots=2, cache_len=64, burst=4, quantized_cache=quantized)
    jeng = j_cont.ContinuousServingEngine(cfg, params, tok, **kw)
    teng = t_cont.ContinuousServingEngine(
        t_vlm.tiny_vlm_config(vocab_size=1024), tparams, tok, device="cpu",
        **kw)
    jr = [jeng.submit(p, {"patches": jnp.asarray(patches[i])}, n)
          for p, i, n in REQUESTS]
    tr = [teng.submit(p, {"patches": torch.from_numpy(patches[i])}, n)
          for p, i, n in REQUESTS]
    jdone, tdone = jeng.run_until_complete(), teng.run_until_complete()
    got = [tdone[r] for r in tr]
    assert got == [jdone[r] for r in jr]
    assert [len(g) for g in got] == [n for _, _, n in REQUESTS]
    assert teng.decode_text(got[0]) == jeng.decode_text(got[0])


def test_continuous_engine_rejects_oversized_request(tiny):
    cfg, _, tparams, tok, patches = tiny
    eng = t_cont.ContinuousServingEngine(
        t_vlm.tiny_vlm_config(vocab_size=1024), tparams, tok, num_slots=1,
        cache_len=32, device="cpu")
    with pytest.raises(ValueError, match="cache_len=32"):
        eng.submit("In: x\nOut:", {"patches": torch.from_numpy(patches[0])},
                   max_new_tokens=64)
    assert not eng.queue


def test_generate_batch_matches_jax():
    jcfg = j_vlm.tiny_vlm_config(vocab_size=1024)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg)
    tok = ByteLevelTokenizer(1024)
    jvla = JaxVLA(jcfg, params, tok,
                  {n: JaxTransform(size=v.img_size) for n, v in jcfg.vision})
    tcfg = t_vlm.tiny_vlm_config(vocab_size=1024)
    tvla = TorchVLA(tcfg, _bridge(params), tok,
                    {n: TorchTransform(size=v.img_size)
                     for n, v in tcfg.vision}, device="cpu")
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            for _ in range(2)]
    prompts = ["In: is there a cup?\nOut:", "In: b\nOut:"]
    assert (tvla.generate_batch(imgs, prompts, max_new_tokens=6)
            == jvla.generate_batch(imgs, prompts, max_new_tokens=6))
    want = jvla.generate_batch(imgs, prompts,
                               return_string_probabilities=["True", "False"])
    got = tvla.generate_batch(imgs, prompts,
                              return_string_probabilities=["True", "False"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert all(abs(sum(row) - 1.0) < 1e-5 for row in got)
