"""The port's serving engines beyond the dense one on sharded params,
mirroring ``tests/test_serving_sharded_engines.py``: on 8 gloo ranks,
``SpeculativeEngine``, ``PagedServingEngine``, ``ContinuousServingEngine``
and ``EmmaXVLA``, each given ``shard_params(params, mesh)`` and
``mesh=mesh``, return on every rank the greedy tokens (and the verifier
steps) of ``emmax_tpu``'s engine on the same weights. Tolerance 0: greedy
tokens and step counts are integers.

The weights are JAX's tiny configs' trees filled from a seeded numpy
generator (``_init``). JAX's references are its unsharded engines, run
once per module; their equality with JAX's sharded engines is what
``tests/test_serving_sharded_engines.py`` pins, and the speculative case
at (1, 4, 2) runs JAX's sharded engine here too. As there, patches are
encoded once by JAX and fed to every engine (``{"patches": ...}``), except
for ``EmmaXVLA``, which takes camera frames. The paged engine's
``"kernel"`` mode takes the kernel's plain version on the CPU and is held
to JAX's ``"gather"``; so is ``"poolmask"`` beside an empty slot, where
JAX's turns NaN (ROADMAP Queue 3).

At (1, 4, 2) and (1, 1, 2) (the first two ranks) the tiny decoder is split
over ``tensor`` (``emmax_torch/parallel/tensor.py``): each rank's cache
and page pool hold half the KV heads, and the tokens and steps are still
JAX's. The speculative and paged engines' split cases run the
grouped-query decoder too (2 KV heads for the 4 query heads,
``dataclasses.replace`` on both sides): 1 KV head in each rank's cache or
page pool, which the kernel mode reads at the unsplit group of 2.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models.vla import EmmaXVLA as TVLA
from emmax_torch.models.vlm import tiny_vlm_config as t_tiny
from emmax_torch.ops.image import ImageTransformConfig as TTransform
from emmax_torch.serving import continuous as t_cont
from emmax_torch.serving import paged as t_paged
from emmax_torch.serving.engine import GenerateOptions as TOpts
from emmax_torch.serving.engine import ServingEngine as TEngine
from emmax_torch.serving.quant import quantize_vlm_params as t_quantize
from emmax_torch.serving.speculative import SpeculativeEngine as TSpec
from emmax_torch.vla.tokenizer import ByteLevelTokenizer as TTok
from emmax_tpu.models.vla import EmmaXVLA as JVLA
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.ops.image import ImageTransformConfig as JTransform
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.serving.continuous import ContinuousServingEngine
from emmax_tpu.serving.engine import GenerateOptions, encode_frame
from emmax_tpu.serving.paged import PagedServingEngine
from emmax_tpu.serving.speculative import SpeculativeEngine
from emmax_tpu.vla.action_tokenizer import ActionTokenizer
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer
from torch_gloo_pool import GlooPool

PROMPT = "In: pick up the cup\nOut:"
PAGED_KW = dict(num_slots=3, n_pages=24, page_size=64, max_pages_per_slot=4,
                burst=6)
PAGED_NEW = 6
# two frames of one prompt whose last tokens change (the gripper's
# position): the second refreshes the first's last TAIL fused slots
TAIL_PROMPTS = ["In: move the gripper to 12\nOut:",
                "In: move the gripper to 47\nOut:"]
TAIL = 8
# the LayerSkip case: 2 draft tokens a step, 8 new tokens a frame (each
# step runs draft_k one-layer forwards, each a round of gathers)
SKIP_KW = dict(draft_k=2, draft_layers=1, prefix_tail=TAIL)
SKIP_NEW = 8
VLA_NEW = 8         # new tokens a generate_actions frame


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _init(vocab_size, seed, n_kv_heads=None):
    """JAX's tiny config (``n_kv_heads`` KV heads in its decoder where
    given) and its parameter tree (the initializer's shapes, from
    ``eval_shape``: nothing compiles) filled from a seeded numpy
    generator, ones for the norms' scales and N(0, 0.02) elsewhere; the
    same tree feeds JAX and the port."""
    cfg = tiny_vlm_config(vocab_size=vocab_size)
    if n_kv_heads is not None:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, n_kv_heads=n_kv_heads))
    shapes = jax.eval_shape(functools.partial(init_vlm_params, cfg=cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "bias" not in name:
            return jnp.ones(leaf.shape, leaf.dtype)
        return jnp.asarray(rng.normal(0.0, 0.02, leaf.shape), leaf.dtype)

    return cfg, jax.tree_util.tree_map_with_path(fill, shapes)


def _patches(params, cfg, seed):
    """JAX's patch embeddings of one seeded frame, as numpy."""
    rng = np.random.default_rng(seed)
    pixels = {n: jnp.asarray(rng.normal(size=(1, v.img_size, v.img_size, 3))
                             .astype(np.float32)) for n, v in cfg.vision}
    return np.array(encode_frame(params, cfg, pixels))


@pytest.fixture(scope="module")
def pool():
    p = GlooPool()
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _vocab512(n_kv_heads=None):
    cfg, params = _init(512, 0, n_kv_heads)
    return types.SimpleNamespace(cfg=cfg, params=params, host=_host(params),
                                 tok=ByteLevelTokenizer(512),
                                 patches=_patches(params, cfg, 0))


def _jax_spec(params, s, **kw):
    eng = SpeculativeEngine(s.cfg, params, s.tok,
                            options=GenerateOptions(eos_id=s.tok.eos_id),
                            **kw)
    return eng, {"patches": jnp.asarray(s.patches)}


@functools.lru_cache(maxsize=None)
def _jax_spec_tokens(mesh_shape=None, n_kv_heads=None):
    """JAX's ``tests/test_serving_sharded_engines.py`` speculative run
    (draft_k 4, 12 new tokens; the decoder's ``n_kv_heads`` where given):
    (tokens, steps)."""
    s = _vocab512(n_kv_heads)
    params = (s.params if mesh_shape is None
              else shard_params(s.params, make_mesh(
                  mesh_shape,
                  devices=jax.devices()[:int(np.prod(mesh_shape))])))
    eng, vision = _jax_spec(params, s, draft_k=4)
    out = eng.generate_ids([PROMPT], vision, max_new_tokens=12)
    return np.asarray(out), eng.last_steps


def _check_ranks(results, want_tokens, want_steps=None, want_prefill=None):
    for rank, calls in enumerate(results):
        for c, (call, want) in enumerate(zip(calls, want_tokens)):
            np.testing.assert_array_equal(call["tokens"], want,
                                          err_msg=f"rank {rank} call {c}")
            if want_steps is not None:
                assert call["steps"] == want_steps[c], (rank, c)
            if want_prefill is not None:
                assert call["prefill"] == want_prefill[c], (rank, c)


# the tiny decoder's 4 KV heads at three meshes (the ids they had before
# the grouped-query case came) and the GQA decoder's 2 split at (1, 1, 2)
SPEC_CASES = [pytest.param(s, None, id=str(s))
              for s in [(1, 1, 8), (1, 4, 2), (1, 1, 2)]] + [
    pytest.param((1, 1, 2), 2, id="gqa-(1, 1, 2)")]


@pytest.mark.parametrize("mesh_shape,n_kv_heads", SPEC_CASES)
def test_speculative_sharded_gives_jax_tokens(pool, mesh_shape, n_kv_heads):
    s = _vocab512(n_kv_heads)
    want, steps = _jax_spec_tokens(n_kv_heads=n_kv_heads)
    if mesh_shape == (1, 4, 2):
        got, got_steps = _jax_spec_tokens(mesh_shape)
        np.testing.assert_array_equal(got, want)
        assert got_steps == steps
    results = pool.run("speculative", params=s.host, patches=s.patches,
                       calls=[{"prompts": [PROMPT], "max_new": 12}],
                       mesh_shape=mesh_shape, engine_kw={"draft_k": 4},
                       n_kv_heads=n_kv_heads)
    _check_ranks(results, [want], [steps], ["full"])


@functools.lru_cache(maxsize=None)
def _tree_case():
    """JAX's product-tree case (vocab 2048, the (5, 3) tree, a forced
    stream of 4 drifting actions, after "POLICIES: " only: JAX's
    "MOVEMENT" text before it adds one-token steps, each a round of
    gathers on the ranks, and no tree step) and JAX's unsharded tokens
    and steps."""
    cfg, params = _init(2048, 1)
    tok = ByteLevelTokenizer(2048)
    atok = ActionTokenizer(tok)
    rng = np.random.default_rng(5)
    pixels = {n: jnp.asarray(rng.normal(size=(1, v.img_size, v.img_size, 3))
                             .astype(np.float32)) for n, v in cfg.vision}
    patches = np.array(encode_frame(params, cfg, pixels))
    ids = tok.encode("POLICIES: ", add_special_tokens=False)
    a = rng.uniform(-0.5, 0.5, size=7)
    width = 2.0 / (atok.n_bins - 1)
    for _ in range(4):
        ids.extend(int(t) for t in atok.encode_to_ids(a))
        a = np.clip(a + rng.integers(-1, 2, 7) * width, -1, 1)
    stream = np.asarray(ids, np.int64)
    n = len(stream)
    eng = SpeculativeEngine(cfg, params, tok,
                            options=GenerateOptions(eos_id=tok.eos_id,
                                                    max_new_tokens=n),
                            draft_k=12, action_tree=(5, 3))
    out = eng.generate_ids([PROMPT], {"patches": jnp.asarray(patches)},
                           max_new_tokens=n, forced_tokens=stream)
    return (_host(params), patches, stream, np.asarray(out),
            eng.last_steps)


@pytest.mark.parametrize("mesh_shape", [(1, 1, 8), (1, 4, 2), (1, 1, 2)],
                         ids=str)
def test_tree_engine_sharded_same_tokens_and_steps(pool, mesh_shape):
    """The tree's ancestor-mask forward and the accepted path's K/V
    compaction on the ranks' whole caches, with sharded weights: JAX's
    stream, step for step (teacher forcing makes the steps independent
    of the weights' rounding)."""
    host, patches, stream, want, steps = _tree_case()
    results = pool.run("speculative", params=host, patches=patches,
                       calls=[{"prompts": [PROMPT], "max_new": len(stream),
                               "forced": stream}],
                       mesh_shape=mesh_shape, vocab_size=2048,
                       engine_kw={"draft_k": 12, "action_tree": (5, 3)})
    np.testing.assert_array_equal(want[0], stream)
    _check_ranks(results, [want], [steps], ["full"])


def test_layerskip_draft_and_tail_refresh_sharded(pool):
    """``draft_layers=1`` (the truncated stack's blocks keep their specs)
    and two frames on one patch tensor, the second refreshing the
    first's prompt tail, at (1, 4, 2): JAX's tokens, steps and prefill
    kinds."""
    s = _vocab512()
    eng, vision = _jax_spec(s.params, s, **SKIP_KW)
    want, steps, kinds = [], [], []
    for prompt in TAIL_PROMPTS:
        want.append(np.asarray(eng.generate_ids([prompt], vision,
                                                max_new_tokens=SKIP_NEW)))
        steps.append(eng.last_steps)
        kinds.append(eng.last_prefill)
    assert kinds == ["full", "tail"]
    results = pool.run("speculative", params=s.host, patches=s.patches,
                       calls=[{"prompts": [p], "max_new": SKIP_NEW}
                              for p in TAIL_PROMPTS],
                       mesh_shape=(1, 4, 2), engine_kw=SKIP_KW)
    _check_ranks(results, want, steps, kinds)


def _paged_requests(n):
    return [(PROMPT + " " * i, 0, PAGED_NEW) for i in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_paged(mode, n_requests, n_kv_heads=None):
    s = _vocab512(n_kv_heads)
    eng = PagedServingEngine(s.cfg, s.params, s.tok, paged_attn=mode,
                             **PAGED_KW)
    vision = {"patches": jnp.asarray(s.patches)}
    rids = [eng.submit(p, vision, max_new_tokens=n)
            for p, _, n in _paged_requests(n_requests)]
    done = eng.run_until_complete()
    return [list(done[r]) for r in rids]


# (port mode, requests on the 3-slot engine, JAX's mode it is held to)
PAGED_CASES = [("burstdense", 3, "burstdense"), ("kernel", 3, "gather"),
               ("poolmask", 2, "gather")]


@pytest.mark.parametrize("mode,n_requests,jax_mode", PAGED_CASES,
                         ids=[c[0] for c in PAGED_CASES])
def test_paged_sharded_gives_jax_tokens(pool, mode, n_requests, jax_mode):
    s = _vocab512()
    want = _jax_paged(jax_mode, n_requests)
    assert [len(w) for w in want] == [PAGED_NEW] * n_requests
    results = pool.run("batched", params=s.host, patches=[s.patches],
                       requests=_paged_requests(n_requests),
                       mesh_shape=(1, 1, 8), engine="paged",
                       engine_kw={**PAGED_KW, "paged_attn": mode})
    for rank, r in enumerate(results):
        assert r["tokens"] == want, (rank, r["tokens"], want)
        assert r["pages_back"], rank


# (KV heads, the cases' id prefix): the tiny decoder's 4 (the ids the
# cases had before the grouped-query ones came) and the GQA decoder's 2
SPLIT_PAGED = [pytest.param(mode, n, jax_mode, kv, id=f"{prefix}{mode}")
               for kv, prefix in ((None, ""), (2, "gqa-"))
               for mode, n, jax_mode in PAGED_CASES]


@pytest.mark.parametrize("mode,n_requests,jax_mode,n_kv_heads", SPLIT_PAGED)
def test_paged_tensor_split_gives_jax_tokens(pool, mode, n_requests,
                                             jax_mode, n_kv_heads):
    """The paged engine with the decoder split over ``tensor`` at (1, 1,
    2): each rank's page pool holds half the KV heads (2 of 4, or 1 of
    the GQA decoder's 2), the kernel mode reads those; JAX's tokens,
    every page back."""
    s = _vocab512(n_kv_heads)
    want = _jax_paged(jax_mode, n_requests, n_kv_heads)
    results = pool.run("batched", params=s.host, patches=[s.patches],
                       requests=_paged_requests(n_requests),
                       mesh_shape=(1, 1, 2), engine="paged",
                       engine_kw={**PAGED_KW, "paged_attn": mode},
                       n_kv_heads=n_kv_heads)
    assert len(results) == 2
    for rank, r in enumerate(results):
        assert r["tokens"] == want, (rank, r["tokens"], want)
        assert r["pages_back"], rank
        assert r["kv_heads"] == s.cfg.llm.n_kv_heads // 2, rank


def test_slot_pool_sharded_gives_jax_tokens(pool):
    """Two requests of different lengths and budgets on the 2-slot pool at
    (1, 4, 2)."""
    s = _vocab512()
    kw = dict(num_slots=2, cache_len=128, burst=4)
    requests = [(PROMPT, 0, 9), ("In: wipe that big table\nOut:", 0, 6)]
    eng = ContinuousServingEngine(s.cfg, s.params, s.tok, **kw)
    vision = {"patches": jnp.asarray(s.patches)}
    rids = [eng.submit(p, vision, max_new_tokens=n) for p, _, n in requests]
    done = eng.run_until_complete()
    want = [list(done[r]) for r in rids]
    results = pool.run("batched", params=s.host, patches=[s.patches],
                       requests=requests, mesh_shape=(1, 4, 2),
                       engine="continuous", engine_kw=kw)
    for rank, r in enumerate(results):
        assert r["tokens"] == want, (rank, r["tokens"], want)


def test_int4_tree_speculative_sharded(pool):
    """An int4 tree (its ``q4`` / ``scale`` leaves replicated, the towers,
    projector, norms and embedding sharded) through the speculative engine
    at (1, 4, 2): the port's unsharded engine's tokens and steps."""
    s = _vocab512()
    tok = TTok(512)
    eng = TSpec(t_tiny(512), t_quantize(params_from_numpy(s.host), bits=4),
                tok, options=TOpts(eos_id=tok.eos_id), draft_k=4,
                device="cpu")
    want = eng.generate_ids([PROMPT], {"patches": torch.from_numpy(
        s.patches)}, max_new_tokens=12)
    results = pool.run("speculative", params=s.host, patches=s.patches,
                       calls=[{"prompts": [PROMPT], "max_new": 12}],
                       mesh_shape=(1, 4, 2), quantize=4,
                       engine_kw={"draft_k": 4})
    _check_ranks(results, [want], [eng.last_steps], ["full"])


def test_vla_closed_loop_actions_sharded(pool):
    """``EmmaXVLA(cfg, shard_params(params, mesh), ..., speculative=True,
    mesh=mesh).generate_actions`` over two closed-loop frames at (1, 4, 2)
    against JAX's ``EmmaXVLA`` on JAX-sharded params: the same text, steps
    and prefill kinds, and the same actions. Tolerance 0: the actions are
    the same action bins un-normalized by the same host code."""
    cfg, params = _init(2048, 1)
    tok = ByteLevelTokenizer(2048)
    kw = dict(speculative=True, draft_k=12, prefix_tail=24)
    jvla = JVLA(cfg, shard_params(params, make_mesh((1, 4, 2))), tok,
                {n: JTransform(size=v.img_size) for n, v in cfg.vision},
                **kw)
    frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    prompts = [jvla.get_prompt("put the cup away", gripper_position=xy)
               for xy in ((100, 90), (104, 92))]
    want = []
    for prompt in prompts:
        actions, text = jvla.generate_actions(frame, prompt,
                                              max_new_tokens=VLA_NEW)
        want.append((actions, text, jvla.engine.last_steps,
                     jvla.engine.last_prefill))
    assert [w[3] for w in want] == ["full", "tail"]
    results = pool.run("vla_actions", params=_host(params),
                       frames=[frame, frame], prompts=prompts,
                       mesh_shape=(1, 4, 2), vocab_size=2048, max_new=VLA_NEW,
                       vla_kw=kw)
    for rank, frames in enumerate(results):
        for got, (actions, text, steps, prefill) in zip(frames, want):
            assert (got["text"], got["steps"], got["prefill"]) == (
                text, steps, prefill), rank
            assert len(got["actions"]) == len(actions)
            for a, b in zip(got["actions"], actions):
                np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_speculative_guard_gone_and_greedy_fence_kept(pool):
    s = _vocab512()
    for r in pool.run("speculative_guards", params=s.host,
                      mesh_shape=(1, 4, 2)):
        assert r["built_on_mesh"]
        assert "greedy-only" in r["sampling_raises"]


def _tiny_tree():
    return params_from_numpy(_vocab512().host)


ENGINES = {
    "serving": lambda p, m: TEngine(t_tiny(512), p, TTok(512),
                                    device="cpu", mesh=m),
    "speculative": lambda p, m: TSpec(t_tiny(512), p, TTok(512),
                                      device="cpu", mesh=m),
    "continuous": lambda p, m: t_cont.ContinuousServingEngine(
        t_tiny(512), p, TTok(512), device="cpu", mesh=m),
    "paged": lambda p, m: t_paged.PagedServingEngine(
        t_tiny(512), p, TTok(512), device="cpu", mesh=m),
    "vla": lambda p, m: TVLA(t_tiny(512), p, TTok(512),
                             {n: TTransform(size=v.img_size)
                              for n, v in t_tiny(512).vision},
                             speculative=True, device="cpu", mesh=m),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_mesh_on_another_device_raises(name):
    """A mesh on CUDA handed to a CPU engine raises: its collectives
    would run on another device than the engine's tensors."""
    with pytest.raises(ValueError, match="the mesh is on 'cuda'"):
        ENGINES[name](_tiny_tree(), types.SimpleNamespace(device_type="cuda"))
