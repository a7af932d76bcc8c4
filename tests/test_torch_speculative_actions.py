"""Port parity for ``SpeculativeEngine``'s action drafts on the tiny config
with an action-bin region (vocab 2048): stride drafts, product trees
(5, 3) and (7, 5), adaptive demotion, ``warmup``'s state, the closed-loop
``EmmaXVLA`` and the step counts of ``scripts/sim_spec_drafts.py``.

The port and ``emmax_tpu`` run the same weights (bridged) and fp32 inputs
and must give identical tokens and equal ``last_steps`` /
``last_prefill`` / ``last_tree``. Teacher-forced step counts depend only
on the drafts and the accept rule, so they equal the simulator's exactly.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models.vla import EmmaXVLA as TVLA
from emmax_torch.models.vlm import tiny_vlm_config as t_tiny
from emmax_torch.ops.image import ImageTransformConfig as TTransform
from emmax_torch.serving.engine import GenerateOptions as TOpts
from emmax_torch.serving.engine import ServingEngine as TEngine
from emmax_torch.serving.engine import VisionCache as TVisionCache
from emmax_torch.serving.speculative import SpeculativeEngine as TSpec
from emmax_tpu.models.vla import EmmaXVLA as JVLA
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.ops.image import ImageTransformConfig as JTransform
from emmax_tpu.serving.engine import GenerateOptions as JOpts
from emmax_tpu.serving.engine import VisionCache as JVisionCache
from emmax_tpu.serving.speculative import SpeculativeEngine as JSpec
from emmax_tpu.vla.action_tokenizer import ActionTokenizer
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

from sim_spec_drafts import simulate_steps  # noqa: E402

V = 2048


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config(vocab_size=V)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, params_from_numpy(host), ByteLevelTokenizer(
        vocab_size=V)


def _pixels(cfg, rng):
    return {n: rng.normal(size=(1, v.img_size, v.img_size, 3))
            .astype(np.float32) for n, v in cfg.vision}


def _engines(setup, n, **kw):
    cfg, params, tparams, tok = setup
    jkw = {k: (JVisionCache(**v) if k == "vision_cache" else v)
           for k, v in kw.items()}
    tkw = {k: (TVisionCache(**v) if k == "vision_cache" else v)
           for k, v in kw.items()}
    return (JSpec(cfg, params, tok, options=JOpts(eos_id=tok.eos_id,
                                                  max_new_tokens=n), **jkw),
            TSpec(t_tiny(V), tparams, tok, options=TOpts(
                eos_id=tok.eos_id, max_new_tokens=n), device="cpu", **tkw))


def _run(engines, prompts, px, **kw):
    j, t = engines
    want = np.asarray(j.generate_ids(
        prompts, {k: jnp.asarray(v) for k, v in px.items()}, **kw))
    got = t.generate_ids(prompts, {k: torch.from_numpy(v)
                                   for k, v in px.items()}, **kw)
    np.testing.assert_array_equal(got, want)
    for attr in ("last_steps", "last_prefill", "last_tree", "_tree_live"):
        assert getattr(t, attr) == getattr(j, attr), attr
    return got


def _gcot_stream(tok, rng, n_actions=6):
    """Scaffold text + consecutive 7-bin actions drifting by <= 1 bin per
    dim (the BridgeV2 smoothness the stride and tree drafts exploit)."""
    atok = ActionTokenizer(tok)
    ids = tok.encode("MOVEMENT:\nmove forward 3 steps;\nPOLICIES: ",
                     add_special_tokens=False)
    a = rng.uniform(-0.5, 0.5, size=7)
    width = 2.0 / (atok.n_bins - 1)
    for _ in range(n_actions):
        ids.extend(int(t) for t in atok.encode_to_ids(a))
        a = np.clip(a + rng.integers(-1, 2, 7) * width, -1, 1)
    return np.asarray(ids, np.int64)


MODES = {"lookup": dict(action_drafts=False), "stride": {},
         "tree53": dict(action_tree=(5, 3)),
         "tree75": dict(action_tree=(7, 5)),
         "tree53-int8": dict(action_tree=(5, 3), quantized_cache=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_forced_bin_stream_steps_match_jax_and_simulator(setup, mode):
    cfg, _, _, tok = setup
    rng = np.random.default_rng(3)
    stream = _gcot_stream(tok, rng)
    n = len(stream)
    engines = _engines(setup, n, draft_k=12, **MODES[mode])
    out = _run(engines, ["In: act\nOut:"], _pixels(cfg, rng),
               max_new_tokens=n, forced_tokens=stream)
    np.testing.assert_array_equal(out[0], stream)
    t = engines[1]
    kw = dict(k=12, max_new=n, vocab_size=V, bin_lo=0, bin_hi=-1)
    if t.action_bins is not None:
        kw.update(stride=True, bin_lo=t.action_bins[0],
                  bin_hi=t.action_bins[1], tree=t.action_tree)
    ids, mask = t._prepare_host(["In: act\nOut:"])
    assert simulate_steps(stream, ids[0][mask[0]], **kw) == t.last_steps
    # measured on this stream: 81 undrafted, 75 stride, 62 with a tree
    assert t.last_steps <= {"lookup": 81, "stride": 75}.get(mode, 62)


def test_closed_loop_steps_match_simulator_with_draft_context(setup):
    """Three forced frames, each drafting from the previous output: the
    context the simulator needs is the engine's history, [prompt tail |
    previous output | prompt]."""
    cfg, _, _, tok = setup
    rng = np.random.default_rng(5)
    streams = [_gcot_stream(tok, np.random.default_rng(5 + min(f, 1)))
               for f in range(3)]
    n = len(streams[0])
    engines = _engines(setup, n, draft_k=12, action_tree=(7, 5))
    px = _pixels(cfg, rng)
    t = engines[1]
    ids, mask = t._prepare_host(["In: act\nOut:"])
    prompt = ids[0][mask[0]]
    prev = None
    for stream in streams:
        out = _run(engines, ["In: act\nOut:"], px, max_new_tokens=n,
                   forced_tokens=stream, draft_context=prev)
        ctx = (prompt if prev is None else
               np.concatenate([ids[0, -8:], prev, prompt]))
        assert simulate_steps(stream, ctx, k=12, max_new=n, vocab_size=V,
                              stride=True, bin_lo=t.action_bins[0],
                              bin_hi=t.action_bins[1],
                              tree=(7, 5)) == t.last_steps
        prev = out[0]


def test_tree_free_run_matches_plain_greedy(setup):
    """The prompt ends in a 7-bin run, so the first step is a tree step
    with real argmax targets: tokens (decoded from the compacted cache
    afterwards too) equal plain greedy decode's."""
    cfg, _, tparams, tok = setup
    rng = np.random.default_rng(2)
    px = _pixels(cfg, rng)
    suffix = [int(t) for t in ActionTokenizer(tok).encode_to_ids(
        rng.uniform(-0.5, 0.5, 7))]
    plain = TEngine(t_tiny(V), tparams, tok, options=TOpts(
        eos_id=tok.eos_id), device="cpu").generate_ids(
        ["In: POLICIES:"], {k: torch.from_numpy(v) for k, v in px.items()},
        max_new_tokens=24, suffix_ids=suffix)
    for widths in ((5,), (3, 2), (7, 5)):
        out = _run(_engines(setup, 24, draft_k=12, action_tree=widths),
                   ["In: POLICIES:"], px, max_new_tokens=24,
                   suffix_ids=suffix)
        np.testing.assert_array_equal(out, plain)


def test_adaptive_tree_switches_like_jax(setup):
    """A random stream demotes the next frame to the linear variant, a
    draftable one with its own context promotes it back; tokens stay
    exact throughout and both variants give the static engine's tokens."""
    cfg, _, _, tok = setup
    rng = np.random.default_rng(9)
    px = _pixels(cfg, rng)
    n = 64
    engines = _engines(setup, n, draft_k=8, action_tree=(5, 3),
                       adaptive_tree=True)
    junk = rng.integers(4, 200, size=n)
    for live_after in (False, False):
        out = _run(engines, ["In: act\nOut:"], px, max_new_tokens=n,
                   forced_tokens=junk)
        np.testing.assert_array_equal(out[0], junk)
        assert engines[1]._tree_live is live_after
    stream = _gcot_stream(tok, rng)
    _run(engines, ["In: act\nOut:"], px, max_new_tokens=len(stream),
         forced_tokens=stream, draft_context=stream)
    assert engines[1]._tree_live is True and engines[1].last_tree is False
    ref = _run(_engines(setup, 24, draft_k=8), ["In: POLICIES:"], px,
               max_new_tokens=24)
    engines[1]._tree_live = engines[0]._tree_live = False
    np.testing.assert_array_equal(
        _run(engines, ["In: POLICIES:"], px, max_new_tokens=24), ref)


def test_warmup_restores_tree_state_after_a_failure(setup, monkeypatch):
    """The port restores ``_tree_live`` / ``adaptive_tree`` in ``finally``
    (the JAX package restores them only when warmup succeeds)."""
    t = _engines(setup, 8, draft_k=8, action_tree=(5, 3),
                 adaptive_tree=True, prefix_tail=4)[1]
    t._tree_live = False
    calls = []

    def boom(*a, **kw):
        calls.append((t._tree_live, t.adaptive_tree))
        raise RuntimeError("injected")

    monkeypatch.setattr(t, "generate_ids", boom)
    with pytest.raises(RuntimeError, match="injected"):
        t.warmup(["In: act now please\nOut:"], max_new_tokens=4)
    assert calls == [(True, False)]           # inside: tree on, not adaptive
    assert (t._tree_live, t.adaptive_tree, t._prefix) == (False, True, None)
    monkeypatch.undo()
    warmed = t.warmup(["In: act now please\nOut:"], max_new_tokens=4)
    assert [w[2] for w in warmed] == ["full", "tail", "full", "tail"]
    assert (t._tree_live, t.adaptive_tree) == (False, True)


def test_bench_frames_tail_refresh_follows_the_vision_cache(setup):
    """``bench.py``'s closed loop at this size: 256x256 host frames that
    brighten by one level a frame key the vision cache (threshold 0.05 =
    6.4 levels, newest entry first). A frame prefills in full when its
    patches change and refreshes the tail otherwise. Episode 1: frames 0
    and 7 miss. Episode 2: frame 0 hits its own entry (not the prefix's
    frame-7 patches), frame 1 is within 6 levels of frame 7's entry, then
    every frame keeps those patches."""
    cfg, _, _, tok = setup
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
    px = _pixels(cfg, rng)
    stream = _gcot_stream(tok, rng, n_actions=2)
    engines = _engines(setup, len(stream), draft_k=12, prefix_tail=24,
                       quantized_cache=True, action_tree=(7, 5),
                       vision_cache=dict(capacity=4, threshold=0.05))
    full_at = ({0, 7}, {0, 1})
    for episode in range(2):
        kinds, prev = [], None
        for f in range(12):
            frame = np.clip(img.astype(np.int32) + f, 0, 255).astype(np.uint8)
            prompt = ("In: What action should the robot take to achieve the "
                      "instruction\nINSTRUCTION: \nPut the eggplant in the "
                      f"pot\nCURRENT GRIPPER: [{104 + 2 * f:03d}, "
                      f"{98 + f:03d}]\nOut:")
            prev = _run(engines, [prompt], px, max_new_tokens=len(stream),
                        forced_tokens=stream, draft_context=prev,
                        frame_key=frame)[0]
            kinds.append(engines[1].last_prefill)
        assert kinds == ["full" if f in full_at[episode] else "tail"
                         for f in range(12)]
    for vc in (engines[0].vision_cache, engines[1].vision_cache):
        assert (vc.hits, vc.misses) == (22, 2)


def test_vla_closed_loop_generate_actions_matches_jax(setup):
    """``EmmaXVLA(speculative=True)``: two closed-loop frames of one image
    with the gripper moving (the second a vision-cache hit and a tail
    refresh drafting from the first's output) give JAX's text and
    actions, and the plain VLA's."""
    cfg, params, tparams, tok = setup
    kw = dict(speculative=True, draft_k=12, prefix_tail=24)
    jvla = JVLA(cfg, params, tok, {n: JTransform(size=v.img_size)
                                   for n, v in cfg.vision}, **kw)
    tvla = TVLA(t_tiny(V), tparams, tok, {n: TTransform(size=v.img_size)
                                          for n, v in cfg.vision},
                device="cpu", **kw)
    plain = TVLA(t_tiny(V), tparams, tok, {n: TTransform(size=v.img_size)
                                           for n, v in cfg.vision},
                 device="cpu")
    frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    for f, xy in enumerate([(100, 90), (104, 92)]):
        prompt = tvla.get_prompt("put the cup away", gripper_position=xy)
        ta, tt = tvla.generate_actions(frame, prompt, max_new_tokens=16)
        ja, jt = jvla.generate_actions(frame, prompt, max_new_tokens=16)
        assert tt == jt == plain.generate_actions(frame, prompt,
                                                  max_new_tokens=16)[1]
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)
        assert (tvla.engine.last_prefill == jvla.engine.last_prefill
                == ("full" if f == 0 else "tail"))
        assert tvla.engine.last_steps == jvla.engine.last_steps


def test_load_vla_speculative_builds_the_closed_loop_engine():
    import emmax_torch

    vla = emmax_torch.load_vla("tiny", dtype=torch.float32, device="cpu",
                               speculative=True)
    eng = vla.engine
    assert isinstance(eng, TSpec) and vla._closed_loop
    assert (eng.draft_k, eng.prefix_tail, eng.vision_cache.capacity,
            eng.vision_cache.threshold) == (12, 24, 4, 0.0)
    frame = np.zeros((32, 32, 3), np.uint8)
    for xy in ((10, 20), (12, 20)):
        vla.generate_actions(frame, vla.get_prompt("go", xy),
                             max_new_tokens=8)
    assert eng.last_prefill == "tail" and vla._last_output_ids.shape == (8,)
