"""Port parity for the rest of the serving API: int8 ``quantize_llm_params``
/ ``dequantize_weight``, the slot pool's ``_release_slot`` and the paged
engine's ``"gather2"`` / ``"pagescan"`` / ``"poolmask"`` decode modes,
against ``emmax_tpu`` on the CPU in fp32.

Quantization must give JAX's codes and scales bit for bit. The three
attention functions are held to JAX's within 1e-5 of the largest
|reference| (only the summation order differs), on bf16 and int8 pages.
Engine tokens equal JAX's run of the same mode, every one: both sides
compute in fp32 on the CPU, so ``poolmask`` needs no more room than the
others (JAX's own test, ``tests/test_paged_serving.py:152-160``, lets it
drift after 4 tokens for its bf16 operands on the TPU). Where a slot sits
empty JAX's ``poolmask`` turns NaN; the port's gives ``gather``'s tokens
there.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import vlm as t_vlm
from emmax_torch.serving import continuous as t_cont
from emmax_torch.serving import paged as t_paged
from emmax_torch.serving import quant as t_quant
from emmax_tpu.models.llama import LlamaConfig, init_llama_params
from emmax_tpu.models.phi import PhiConfig, init_phi_params
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.serving import continuous as j_cont
from emmax_tpu.serving import paged as j_paged
from emmax_tpu.serving import quant as j_quant
from emmax_tpu.serving.engine import encode_frame
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer


# the attention references jitted: one compile each instead of one per
# op. Quantization stays eager, as JAX calls it: under jit XLA turns the
# division by 127 into a product with its reciprocal, another rounding
_J_ATTENTION = {
    "gather2": jax.jit(j_paged._gather2_attention,
                       static_argnames=("page_size",)),
    "pagescan": jax.jit(j_paged._pagescan_attention,
                        static_argnames=("page_size",)),
    "poolmask": jax.jit(j_paged._poolmask_attention,
                        static_argnames=("page_size",),
                        static_argnums=(5, 6))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_bits_equal(got, want, path="llm"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_bits_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, path
    np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8),
                                  err_msg=path)


# ------------------------------------------------------------ quantization --

def _llm_tree(family):
    """The JAX initializer's tree (shapes by ``eval_shape``), filled from a
    seeded numpy generator."""
    if family == "llama":
        init, cfg = init_llama_params, LlamaConfig(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
            hidden_dim=128, max_seq_len=64)
    else:
        init, cfg = init_phi_params, PhiConfig(
            vocab_size=256, dim=80, n_layers=2, n_heads=4, n_kv_heads=4,
            hidden_dim=160)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.eval_shape(lambda: init(jax.random.PRNGKey(4), cfg)))
    # edges: an all-zero output channel (scale 1, codes 0) and codes that
    # sit on .5 after scaling (round half to even on both sides)
    wq = np.array(tree["layers"]["wq"])
    wq[0, :, 3] = 0.0
    wq[1, :4, 5] = [0.5, 1.5, -2.5, 127.0]
    wq[1, 4:, 5] = 0.0
    tree["layers"]["wq"] = wq
    return tree


@pytest.mark.parametrize("family", ["llama", "phi"])
def test_quantize_llm_params_bits_match_jax(family):
    tree = _llm_tree(family)
    want = _np(j_quant.quantize_llm_params(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = t_quant.quantize_llm_params(params_from_numpy(tree))
    _assert_tree_bits_equal(got, want)
    head = got["lm_head"]
    if family == "phi":        # {"kernel", "bias"}: the kernel quantized
        assert set(head) == {"kernel", "bias"} and "q8" in head["kernel"]
    else:
        assert set(head) == {"q8", "scale"}
    for key, leaf in got["layers"].items():     # norms and biases stay
        assert isinstance(leaf, dict) == (key in t_quant.QUANT_KEYS), key
    assert not isinstance(got["embed"], dict)
    # a second pass leaves the quantized leaves as they are, as in JAX
    again = t_quant.quantize_llm_params(got)
    _assert_tree_bits_equal(again, _np(j_quant.quantize_llm_params(
        jax.tree_util.tree_map(jnp.asarray, want))))
    # no lm_head: None stays None
    no_head = {**params_from_numpy(tree), "lm_head": None}
    assert t_quant.quantize_llm_params(no_head)["lm_head"] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weight_bits_match_jax(dtype):
    rng = np.random.default_rng(2)
    w = rng.normal(scale=0.02, size=(3, 64, 96)).astype(np.float32)
    jq = j_quant.quantize_weight(jnp.asarray(w))
    tq = t_quant.quantize_weight(torch.from_numpy(w))
    _assert_tree_bits_equal(tq, _np(jq))
    want = np.asarray(j_quant.dequantize_weight(jq, getattr(jnp, dtype)))
    got = t_quant.dequantize_weight(tq, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.view(torch.int16 if dtype ==
                                           "bfloat16" else torch.int32)
                                  .numpy(),
                                  want.view(np.int16 if dtype == "bfloat16"
                                            else np.int32))
    # per-channel int8: the error is at most half a step
    back = t_quant.dequantize_weight(tq).numpy()
    assert (np.abs(back - w) <= tq["scale"].numpy() / 2 + 1e-8).all()


# ---------------------------------------------------------- release slot --

def test_release_slot_in_place_as_jax():
    active = np.array([True, True, False, True])
    rest = np.arange(4, dtype=np.int32)
    want = j_cont._release_slot({"active": jnp.asarray(active),
                                 "len": jnp.asarray(rest)}, slot=1)
    pool = {"active": torch.from_numpy(active.copy()),
            "len": torch.from_numpy(rest.copy())}
    keep = pool["active"]
    out = t_cont._release_slot(pool, 1)
    assert out is pool and pool["active"] is keep        # in place
    np.testing.assert_array_equal(pool["active"].numpy(),
                                  np.asarray(want["active"]))
    np.testing.assert_array_equal(pool["len"].numpy(), rest)


def test_release_slot_retires_a_running_request():
    """Released mid-run, the slot's request ends at the next burst with
    the tokens it had, and the slot admits the next request."""
    from emmax_torch.models.load import load

    cfg, params, tok, _, _ = load("tiny", dtype=torch.float32, device="cpu",
                                  seed=1)
    eng = t_cont.ContinuousServingEngine(cfg, params, tok, num_slots=1,
                                         cache_len=128, burst=4,
                                         device="cpu")
    pix = {"patches": torch.zeros(1, cfg.num_patches, cfg.llm.dim)}
    first = eng.submit("In: a\nOut:", pix, max_new_tokens=40)
    second = eng.submit("In: b\nOut:", pix, max_new_tokens=4)
    eng.step()
    n = len(eng.running[0].tokens)
    t_cont._release_slot(eng.pool, 0)
    done = eng.run_until_complete()
    assert len(done[first]) <= n + 1 < 40
    assert len(done[second]) <= 4 and not eng.running


# ------------------------------------------------ the attention functions --

N_PAGES, PS, MP, B = 9, 8, 3, 4
STRIDE = N_PAGES + 1
# each row's own pages (disjoint, as poolmask needs); the table pads with
# the trash page, which lies past every row's length
OWN = ([3, 0, 7], [5, 1], [8, 6, 4], [2])
LENGTHS = np.array([1 + 2 * PS, PS, PS + 1, 3], np.int32)


@functools.lru_cache(maxsize=None)
def _pool(pages, kv_heads):
    llm = types.SimpleNamespace(n_kv_heads=kv_heads, n_layers=2, head_dim=16)
    quantized = pages == "int8"
    pool = j_paged.init_paged_pool(
        types.SimpleNamespace(llm=llm), n_pages=N_PAGES, page_size=PS,
        num_slots=B, max_pages_per_slot=MP, dtype=jnp.float32,
        quantized=quantized)
    rng = np.random.default_rng(3)
    k = rng.standard_normal(pool["k"].shape).astype(np.float32)
    v = rng.standard_normal(pool["v"].shape).astype(np.float32)
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = (j_paged._row_quantize(jnp.asarray(a))
                            for a in (k, v))
        ks, vs = np.array(ks), np.array(vs)
    elif pages == "bfloat16":
        k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (k, v))
    table = np.full((B, MP), N_PAGES, np.int32)
    owner = np.full(N_PAGES + 1, -1, np.int32)
    pos = np.zeros(N_PAGES + 1, np.int32)
    for b, ids in enumerate(OWN):
        table[b, :len(ids)] = ids
        owner[ids] = b
        pos[ids] = np.arange(len(ids))
    q = rng.standard_normal((B, 1, 4, llm.head_dim)).astype(np.float32)
    return q, np.array(k), np.array(v), ks, vs, table, owner, pos


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":          # exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["G1", "G2"])
@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["gather2", "pagescan", "poolmask"])
def test_attention_matches_jax(mode, pages, kv_heads):
    q, k, v, ks, vs, table, owner, pos = _pool(pages, kv_heads)
    layer = 1
    table_l = layer * STRIDE + table
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else _torch(a))
    if mode == "poolmask":
        want = _J_ATTENTION[mode](
            j(q), j(k), j(v), j(ks), j(vs), layer, STRIDE, j(owner), j(pos),
            j(LENGTHS), page_size=PS)
        got = t_paged._poolmask_attention(
            t(q), t(k), t(v), t(ks), t(vs), layer, STRIDE, t(owner), t(pos),
            t(LENGTHS), page_size=PS)
    else:
        tfn = getattr(t_paged, f"_{mode}_attention")
        want = _J_ATTENTION[mode](j(q), j(k), j(v), j(ks), j(vs), j(table_l), j(LENGTHS),
                   page_size=PS)
        got = tfn(t(q), t(k), t(v), t(ks), t(vs), t(table_l), t(LENGTHS),
                  page_size=PS)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["G1", "G2"])
@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_poolmask_row_without_pages_stays_finite(pages, kv_heads):
    """Row 3 (an empty slot) owns no page: JAX's row is NaN, the port's
    zero; the other rows are JAX's within 1e-5."""
    q, k, v, ks, vs, _, owner, pos = _pool(pages, kv_heads)
    owner = np.where(owner == 3, -1, owner)
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else _torch(a))
    want = np.asarray(_J_ATTENTION["poolmask"](
        j(q), j(k), j(v), j(ks), j(vs), 1, STRIDE, j(owner), j(pos),
        j(LENGTHS), page_size=PS))
    got = t_paged._poolmask_attention(
        t(q), t(k), t(v), t(ks), t(vs), 1, STRIDE, t(owner), t(pos),
        t(LENGTHS), page_size=PS).numpy()
    assert np.isnan(want[3]).all()
    assert (got[3] == 0).all()
    err = np.abs(got[:3] - want[:3]).max()
    assert err <= 1e-5 * np.abs(want[:3]).max(), err


# ---------------------------------------------------------------- engine --

PROMPTS = ["In: pick up the cup\nOut:", "In: wipe that big table\nOut:"]
ENGINE_KW = dict(num_slots=2, n_pages=16, page_size=32, max_pages_per_slot=8,
                 burst=4)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = tiny_vlm_config(vocab_size=1024)
    # jitted: one compile instead of one per op; the same tree feeds both
    params = jax.jit(init_vlm_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)
    patches = []
    for i in range(len(PROMPTS)):
        r = np.random.default_rng(40 + i)
        raw = {n: jnp.asarray(r.normal(size=(1, v.img_size, v.img_size, 3))
                              .astype(np.float32)) for n, v in cfg.vision}
        patches.append(np.array(encode_frame(params, cfg, raw)))
    return (cfg, params, params_from_numpy(_np(params)),
            ByteLevelTokenizer(1024), patches)


def _run_both(mode, quantized):
    """Both engines stepped in turn; poolmask's page ownership compared
    after each step (a free page's rank is left stale in JAX)."""
    cfg, params, tparams, tok, patches = _setup()
    jeng = j_paged.PagedServingEngine(cfg, params, tok, paged_attn=mode,
                                      quantized_cache=quantized, **ENGINE_KW)
    teng = t_paged.PagedServingEngine(
        t_vlm.tiny_vlm_config(vocab_size=1024), tparams, tok,
        paged_attn=mode, quantized_cache=quantized, device="cpu",
        **ENGINE_KW)
    jr = [jeng.submit(p, {"patches": jnp.asarray(patches[i])},
                      max_new_tokens=6 + 3 * i)
          for i, p in enumerate(PROMPTS)]
    tr = [teng.submit(p, {"patches": torch.from_numpy(patches[i])},
                      max_new_tokens=6 + 3 * i)
          for i, p in enumerate(PROMPTS)]
    while jeng.queue or jeng.running:
        jeng.step()
        teng.step()
        if mode == "poolmask":
            own = {k: v.numpy() for k, v in teng._ownership().items()}
            np.testing.assert_array_equal(own["page_owner"],
                                          jeng._page_owner)
            held = jeng._page_owner >= 0
            np.testing.assert_array_equal(own["page_pos"][held],
                                          jeng._page_pos[held])
    assert not teng.queue and not teng.running
    assert sorted(teng.free_pages) == list(range(ENGINE_KW["n_pages"]))
    return ([jeng.finished[r] for r in jr], [teng.finished[r] for r in tr])


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mode", ["gather2", "pagescan", "poolmask"])
def test_engine_tokens_match_jax_same_mode(mode, quantized):
    want, got = _run_both(mode, quantized)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert got == want, (mode, quantized, want, got)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("budgets", [(9,), (5, 5, 9)],
                         ids=["one_request", "third_alone"])
def test_poolmask_with_an_empty_slot_gives_gather_tokens(budgets, quantized):
    """Bursts with an empty slot: one request on the 2-slot engine, and a
    third request that runs alone after the first two retire. poolmask
    gives gather's tokens, every one (gather is held to JAX in
    ``tests/test_torch_paged.py``)."""
    _, _, tparams, tok, patches = _setup()

    def run(mode):
        eng = t_paged.PagedServingEngine(
            t_vlm.tiny_vlm_config(vocab_size=1024), tparams, tok,
            paged_attn=mode, quantized_cache=quantized, device="cpu",
            **ENGINE_KW)
        rids = [eng.submit(PROMPTS[i % 2], {"patches": torch.from_numpy(
            patches[i % 2])}, max_new_tokens=n)
            for i, n in enumerate(budgets)]
        done = eng.run_until_complete()
        return [done[r] for r in rids]

    want, got = run("gather"), run("poolmask")
    assert [len(w) for w in want] == list(budgets)
    assert got == want, (want, got)


def test_poolmask_refuses_shared_prefixes_as_jax():
    cfg, _, tparams, tok, patches = _setup()
    eng = t_paged.PagedServingEngine(
        t_vlm.tiny_vlm_config(vocab_size=1024), tparams, tok,
        paged_attn="poolmask", device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="shared pages"):
        eng.submit_shared(PROMPTS, {"patches": torch.from_numpy(
            patches[0])}, max_new_tokens=4)
    assert not eng.queue and eng.free_pages == list(range(16))
