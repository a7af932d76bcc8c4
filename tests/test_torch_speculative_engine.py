"""Port parity for ``SpeculativeEngine`` on the tiny config (vocab 512):
the port and ``emmax_tpu``'s engine on the same weights (bridged) and the
same fp32 inputs give identical greedy tokens and equal ``last_steps`` /
``last_prefill``, and the port's plain engine gives the same tokens.

Cases: linear drafts, the int8 cache, forced streams, the draft context,
the vision cache, the prefix-KV tail refresh across frames, LayerSkip
drafts, the bf16 fence and warmup.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models.vlm import tiny_vlm_config as t_tiny
from emmax_torch.serving import speculative as t_spec
from emmax_torch.serving.engine import GenerateOptions as TOpts
from emmax_torch.serving.engine import ServingEngine as TEngine
from emmax_torch.serving.engine import VisionCache as TVisionCache
from emmax_torch.serving.speculative import SpeculativeEngine as TSpec
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.serving.engine import GenerateOptions as JOpts
from emmax_tpu.serving.engine import ServingEngine as JEngine
from emmax_tpu.serving.engine import VisionCache as JVisionCache
from emmax_tpu.serving.speculative import SpeculativeEngine as JSpec
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config(vocab_size=512)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, host, ByteLevelTokenizer(vocab_size=512)


def _pixels(cfg, seed, B=1):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(B, v.img_size, v.img_size, 3))
            .astype(np.float32) for n, v in cfg.vision}


def _j(px):
    return {k: jnp.asarray(v) for k, v in px.items()}


def _t(px):
    return {k: torch.from_numpy(v) for k, v in px.items()}


class Pair:
    """One JAX and one port engine of the same kind and settings."""

    def __init__(self, setup, spec=True, host=None, **kw):
        cfg, params, host0, tok = setup
        host = host0 if host is None else host
        jkw = {k: (JVisionCache(**v) if k == "vision_cache" else v)
               for k, v in kw.items()}
        tkw = {k: (TVisionCache(**v) if k == "vision_cache" else v)
               for k, v in kw.items()}
        opts = jkw.pop("options", {})
        tkw.pop("options", None)
        jparams = jax.tree_util.tree_map(jnp.asarray, host)
        self.j = (JSpec if spec else JEngine)(
            cfg, jparams, tok, options=JOpts(**{"eos_id": tok.eos_id,
                                                **opts}), **jkw)
        self.t = (TSpec if spec else TEngine)(
            t_tiny(cfg.llm.vocab_size), params_from_numpy(host), tok,
            options=TOpts(**{"eos_id": tok.eos_id, **opts}), device="cpu",
            **tkw)

    def run(self, prompts, px, **kw):
        """Both engines' tokens, asserted equal (with the same steps)."""
        want = np.asarray(self.j.generate_ids(prompts, _j(px), **kw))
        got = self.t.generate_ids(prompts, _t(px), **kw)
        np.testing.assert_array_equal(got, want)
        for attr in ("last_steps", "last_prefill", "last_tree"):
            assert getattr(self.t, attr, None) == getattr(self.j, attr, None)
        return got


PROMPTS = ["In: do the thing\nOut:",
           "In: a much longer instruction goes right here\nOut:"]


@pytest.mark.parametrize("kw", [dict(draft_k=4), dict(draft_k=3,
                                                       quantized_cache=True)],
                         ids=["linear", "int8-cache"])
def test_matches_jax_and_plain_greedy(setup, kw):
    px = _pixels(setup[0], 0, B=2)
    pair = Pair(setup, **kw)
    got = pair.run(PROMPTS, px, max_new_tokens=24)
    plain = Pair(setup, spec=False,
                 quantized_cache=kw.get("quantized_cache", False))
    np.testing.assert_array_equal(plain.run(PROMPTS, px, max_new_tokens=24),
                                  got)
    # the one-call runner gives the engine's tokens and steps
    ids, mask = pair.t._prepare_host(PROMPTS)
    out, steps, _ = t_spec._generate_speculative(
        pair.t.model.tree(), pair.t.cfg, ids, mask, _t(px), None,
        max_new=24, cache_len=pair.t._last_cache_len,
        eos_id=setup[3].eos_id, k=kw["draft_k"],
        quantized_cache=kw.get("quantized_cache", False))
    np.testing.assert_array_equal(out, got)
    assert steps == pair.t.last_steps


def test_forced_stream_and_draft_context(setup):
    """Teacher forcing reproduces the stream with fewer verifier steps
    than tokens; the previous output as draft context collapses them."""
    tok = setup[3]
    px = _pixels(setup[0], 7)
    pair = Pair(setup, draft_k=4)
    base = tok.encode("NEXT MOVEMENT: move left; NEXT MOVEMENT: move left; "
                      "NEXT MOVEMENT: move left; NEXT MOVEMENT: move left;")
    out = pair.run(["In: go\nOut:"], px, max_new_tokens=24,
                   forced_tokens=base)
    np.testing.assert_array_equal(out[0], base[:24])
    assert pair.t.last_steps < 24
    stream = tok.encode("REASONING: reach the cup\nSUBTASK: approach\n"
                        "NEXT GRIPPER: [104, 98]\nMOVEMENT: xq zj rk vv")
    cold = pair.run(["In: go\nOut:"], px, max_new_tokens=32,
                    forced_tokens=stream)
    steps_cold = pair.t.last_steps
    pair.run(["In: go\nOut:"], px, max_new_tokens=32, forced_tokens=stream,
             draft_context=cold[0])
    assert pair.t.last_steps <= (32 + 4) // 5 + 2 < steps_cold


def test_periodic_output_accepts_full_drafts(setup):
    """Zeroed decoder layers and one-hot embed / lm_head make the greedy
    output the cycle 5 -> 6 -> 7 -> 5: lookup then accepts whole drafts."""
    cfg, _, host, tok = setup
    D, V = cfg.llm.dim, cfg.llm.vocab_size

    def nxt(t):
        return {5: 6, 6: 7, 7: 5}.get(t % D, 5)

    embed = np.zeros((V, D), np.float32)
    embed[np.arange(V), np.arange(V) % D] = 10.0
    lm_head = np.zeros((D, V), np.float32)
    lm_head[np.arange(D), [nxt(d) for d in range(D)]] = 100.0
    llm = jax.tree_util.tree_map(np.zeros_like, host["llm"])
    llm.update(embed=embed, lm_head=lm_head,
               final_norm=host["llm"]["final_norm"])
    for key in ("attn_norm", "mlp_norm"):
        llm["layers"][key] = host["llm"]["layers"][key]
    out = Pair(setup, host=dict(host, llm=llm), draft_k=4).run(
        ["In: loop\nOut:"], _pixels(cfg, 2), max_new_tokens=24)
    cur, want = tok.encode("In: loop\nOut:")[-1], []
    for _ in range(24):
        cur = nxt(cur)
        want.append(cur)
    np.testing.assert_array_equal(out[0], want)


def test_rejects_sampling(setup):
    cfg, _, host, tok = setup
    with pytest.raises(ValueError, match="greedy-only"):
        TSpec(t_tiny(512), params_from_numpy(host), tok,
              options=TOpts(temperature=0.7), device="cpu")


def test_vision_cache_hit_reuses_patches(setup):
    px = _pixels(setup[0], 8)
    pair = Pair(setup, spec=False, vision_cache=dict(threshold=0.0))
    first = pair.run(["In: go\nOut:"], px, max_new_tokens=8)
    np.testing.assert_array_equal(
        pair.run(["In: go\nOut:"], px, max_new_tokens=8), first)
    other = {k: v + 0.5 for k, v in px.items()}
    pair.run(["In: go\nOut:"], other, max_new_tokens=8)
    for vc in (pair.t.vision_cache, pair.j.vision_cache):
        assert (vc.hits, vc.misses) == (1, 2)


def _prompt(x, y, task="pick up the cup"):
    return ("In: What action should the robot take\nINSTRUCTION: \n"
            f"{task}\nCURRENT GRIPPER: [{x:03d}, {y:03d}]\nOut:")


@pytest.mark.parametrize("quantized", [False, True])
def test_prefix_tail_across_frames(setup, quantized):
    """Three frames on one image, the coordinates moving: frame 0 prefills
    in full, frames 1 and 2 refresh the tail of the cache the frame before
    left (a tail after a tail), each giving the full prefill's tokens; a
    frame whose prefix differs prefills in full again."""
    px = _pixels(setup[0], 11)
    frame = np.zeros((64, 64, 3), np.uint8)
    ref = Pair(setup, draft_k=4, quantized_cache=quantized)
    pair = Pair(setup, draft_k=4, quantized_cache=quantized, prefix_tail=16,
                vision_cache=dict(threshold=0.0))
    for f, (x, y) in enumerate([(104, 98), (112, 96), (120, 94)]):
        want = ref.run([_prompt(x, y)], px, max_new_tokens=16)
        got = pair.run([_prompt(x, y)], px, max_new_tokens=16,
                       frame_key=frame)
        np.testing.assert_array_equal(got, want)
        assert pair.t.last_prefill == ("full" if f == 0 else "tail")
    task = "wipe the table please"
    got = pair.run([_prompt(104, 98, task)], px, max_new_tokens=16,
                   frame_key=frame)
    assert pair.t.last_prefill == "full"
    np.testing.assert_array_equal(
        got, ref.run([_prompt(104, 98, task)], px, max_new_tokens=16))


def test_layer_drafts(setup):
    """draft_layers=1: the first layer drafts where lookup has nothing;
    exact on random weights, with the int8 cache too, and a hybrid that
    keeps lookup's accepts on a repetitive forced stream."""
    tok = setup[3]
    px = _pixels(setup[0], 5, B=2)
    pair = Pair(setup, draft_k=4, draft_layers=1)
    got = pair.run(PROMPTS, px, max_new_tokens=20)
    plain = Pair(setup, spec=False).run(PROMPTS, px, max_new_tokens=20)
    np.testing.assert_array_equal(got, plain)
    Pair(setup, draft_k=3, draft_layers=1, quantized_cache=True).run(
        ["In: q\nOut:"], _pixels(setup[0], 6), max_new_tokens=10)
    base = tok.encode("NEXT MOVEMENT: move left; " * 8)
    out = pair.run(["In: go\nOut:"], _pixels(setup[0], 11),
                   max_new_tokens=72, forced_tokens=base)
    np.testing.assert_array_equal(out[0], base[:72])
    assert pair.t.last_steps <= 48


def test_layer_draft_depth_validation(setup):
    cfg = setup[0]
    pair = Pair(setup, draft_k=2, draft_layers=cfg.llm.n_layers)
    with pytest.raises(ValueError, match="draft_layers"):
        pair.t.generate_ids(["In: x\nOut:"], _t(_pixels(cfg, 8)),
                            max_new_tokens=4)


def test_bf16_fence_falls_back_to_plain_decode(setup, monkeypatch):
    """Fenced: the plain engine's tokens, ``last_prefill`` records it,
    teacher forcing is refused and the vision cache is still used."""
    cfg, _, host, tok = setup
    px = _t(_pixels(cfg, 5))
    opts = TOpts(max_new_tokens=10, eos_id=-1)
    want = TEngine(t_tiny(512), params_from_numpy(host), tok, options=opts,
                   device="cpu").generate_ids(["In: do it\nOut: "], px)
    monkeypatch.setattr(t_spec, "_spec_bf16_oom_risk", lambda p: True)
    fenced = TSpec(t_tiny(512), params_from_numpy(host), tok, options=opts,
                   draft_k=4, vision_cache=TVisionCache(threshold=0.02),
                   device="cpu")
    assert fenced._bf16_fallback
    frame = np.zeros((32, 32, 3), np.uint8)
    for _ in range(2):
        got = fenced.generate_ids(["In: do it\nOut: "], px, frame_key=frame)
        np.testing.assert_array_equal(got, want)
        assert fenced.last_prefill == "plain-fallback"
        assert fenced.last_steps is None
    assert (fenced.vision_cache.hits, fenced.vision_cache.misses) == (1, 1)
    with pytest.raises(ValueError, match="forced_tokens"):
        fenced.generate_ids(["In: x\nOut: "], px,
                            forced_tokens=np.arange(32))
    forced = TSpec(t_tiny(512), params_from_numpy(host), tok, options=opts,
                   draft_k=4, force_bf16_spec=True, device="cpu")
    assert not forced._bf16_fallback
    np.testing.assert_array_equal(
        forced.generate_ids(["In: do it\nOut: "], px), want)


def test_warmup_runs_full_and_tail_then_frame_zero_is_full(setup):
    cfg, _, host, tok = setup
    eng = TSpec(t_tiny(512), params_from_numpy(host), tok,
                options=TOpts(eos_id=tok.eos_id), draft_k=3, prefix_tail=4,
                device="cpu")
    warmed = eng.warmup(["In: do the long thing now\nOut:"],
                        max_new_tokens=6, draft_context_len=16)
    assert [w[2] for w in warmed] == ["full", "tail"]
    assert eng._prefix is None
    out = eng.generate_ids(["In: do the long thing now\nOut:"],
                           _t(_pixels(cfg, 12)), max_new_tokens=6)
    assert eng.last_prefill == "full" and out.shape == (1, 6)
    plain = TEngine(t_tiny(512), params_from_numpy(host), tok,
                    options=TOpts(eos_id=tok.eos_id), device="cpu")
    warmed = plain.warmup(["In: a\nOut:", "In: " + "x " * 40 + "\nOut:"],
                          max_new_tokens=4, batch_sizes=(1, 2))
    assert len(warmed) == 4 and {b for b, _ in warmed} == {1, 2}
    assert len({bk for _, bk in warmed}) == 2
