"""Port parity for paged serving: the page-pool int8 rows, the plain
paged-attention function and ``PagedServingEngine`` against
``emmax_tpu`` with the same weights (bridged), in fp32 on the CPU.

Greedy tokens must be identical to the JAX package's paged engine under
the same mode (the JAX "kernel" mode runs the TPU kernel only, so the
port's "kernel" mode, which takes the kernel's plain version on the CPU,
is held to JAX's "gather") and, with fp32 pages, to the plain
``ServingEngine``. Every engine is fed the same pre-encoded patches. The
plain paged attention is held to JAX's ``_gather2_attention`` and
``_pagescan_attention`` within 1e-5 of the largest |reference| (fp32:
only the summation order differs).
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
from emmax_torch.ops import paged_attention as t_pa
from emmax_torch.serving import paged as t_paged
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.serving import paged as j_paged
from emmax_tpu.serving.engine import (GenerateOptions, ServingEngine,
                                      encode_frame)
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

MAX_NEW = 12          # reference generations run this long; requests less


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config(vocab_size=1024)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tok = ByteLevelTokenizer(1024)
    tcfg = t_vlm.tiny_vlm_config(vocab_size=1024)

    @functools.lru_cache(maxsize=None)
    def patches(seed):
        # the same patch values for every engine compared (two encodes of
        # one frame may round differently; greedy decode on random weights
        # amplifies that)
        r = np.random.default_rng(seed)
        raw = {name: jnp.asarray(r.normal(size=(1, v.img_size, v.img_size,
                                                3)).astype(np.float32))
               for name, v in cfg.vision}
        return np.array(encode_frame(params, cfg, raw))

    def jpix(seed):
        return {"patches": jnp.asarray(patches(seed))}

    def tpix(seed):
        return {"patches": torch.from_numpy(patches(seed))}

    @functools.lru_cache(maxsize=None)
    def reference(prompt, seed):
        engine = ServingEngine(cfg, params, tok,
                               options=GenerateOptions(eos_id=tok.eos_id))
        out = list(engine.generate_ids([prompt], jpix(seed),
                                       max_new_tokens=MAX_NEW)[0])
        return out[:out.index(tok.eos_id)] if tok.eos_id in out else out

    def engine(**kw):
        return t_paged.PagedServingEngine(tcfg, tparams, tok, device="cpu",
                                          **kw)

    return types.SimpleNamespace(cfg=cfg, params=params, tparams=tparams,
                                 tok=tok, tcfg=tcfg, jpix=jpix, tpix=tpix,
                                 reference=reference, engine=engine)


def _check_solo(s, done, rids, prompts, seeds, max_new):
    """Each request's tokens equal its prompt's solo run on the plain JAX
    ``ServingEngine`` (``max_new``: one budget, or one per request)."""
    budgets = ([max_new] * len(rids) if isinstance(max_new, int)
               else max_new)
    for rid, p, seed, n in zip(rids, prompts, seeds, budgets):
        ref = s.reference(p, seed)[:n]
        assert done[rid][:len(ref)] == ref, (p, done[rid], ref)


# ------------------------------------------------------------ int8 rows --

def test_row_quantize_bytes_match_jax_at_the_127_5_edge():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0] = np.linspace(-1.0, 2.0, 16)       # positive absmax -> +127.5
    x[0, 1] = -np.linspace(-1.0, 2.0, 16)      # negative absmax -> -127.5
    x[1, 2] = 0.0                              # zero row: scale 0, codes 0
    jq, js = j_paged._row_quantize(jnp.asarray(x))
    tq, ts = t_paged._row_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0].max().item() == 127 and tq[0, 1].min().item() == -128
    np.testing.assert_array_equal(
        t_paged._row_dequantize(tq, ts, torch.float32).numpy(),
        np.asarray(j_paged._row_dequantize(jq, js, jnp.float32)))


# ------------------------------------------------ plain paged attention --

@pytest.mark.parametrize("kv_heads", [4, 2], ids=["G1", "G2"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("reference", ["gather2", "pagescan"])
def test_plain_paged_attention_matches_jax(reference, quantized, kv_heads):
    llm = types.SimpleNamespace(n_kv_heads=kv_heads, n_layers=2,
                                head_dim=16)
    n_pages, ps, B, MP, H = 9, 8, 4, 3, 4
    pool = j_paged.init_paged_pool(
        types.SimpleNamespace(llm=llm), n_pages=n_pages, page_size=ps,
        num_slots=B, max_pages_per_slot=MP, dtype=jnp.float32,
        quantized=quantized)
    rng = np.random.default_rng(1)
    k = rng.standard_normal(pool["k"].shape).astype(np.float32)
    v = rng.standard_normal(pool["v"].shape).astype(np.float32)
    if quantized:
        (k, ks), (v, vs) = (j_paged._row_quantize(jnp.asarray(a))
                            for a in (k, v))
        ks, vs = np.array(ks), np.array(vs)
    else:
        ks = vs = None
    k, v = np.array(k), np.array(v)
    # layer 1's pages, out of order, ragged lengths (one past a page edge)
    table = (n_pages + 1) + np.array([[3, 0, 7], [5, 1, 2], [8, 6, 4],
                                      [2, 2, 2]], np.int32)
    lengths = np.array([1, ps, ps + 1, MP * ps], np.int32)
    q = rng.standard_normal((B, 1, H, llm.head_dim)).astype(np.float32)
    jfn = getattr(j_paged, f"_{reference}_attention")
    want = np.asarray(jfn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), jnp.asarray(table),
        jnp.asarray(lengths), page_size=ps))[:, 0]
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = t_pa.paged_attention(
        torch.from_numpy(q[:, 0] * llm.head_dim ** -0.5), t(k), t(v),
        t(lengths), t(table), k_scale=t(ks), v_scale=t(vs))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_plain_paged_attention_zero_length_and_clamped_ids():
    rng = np.random.default_rng(2)
    kp = torch.from_numpy(rng.standard_normal((2, 5, 4, 8))
                          .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 2, 8)).astype(np.float32))
    lengths = torch.tensor([0, 3], dtype=torch.int32)
    table = torch.tensor([[-1, 9], [-1, 9]], dtype=torch.int32)
    out = t_pa.paged_attention(q, kp, kp, lengths, table)
    assert not out[0].any()                          # length 0 -> zeros
    # id -1 clamps to page 0 (as an XLA gather clamps), not to the last
    want = t_pa.paged_attention(q, kp, kp, lengths,
                                torch.zeros_like(table))
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# --------------------------------------------------------------- engine --

PROMPTS = ["In: pick up the cup\nOut:", "In: wipe that big table\nOut:"]


@functools.lru_cache(maxsize=None)
def _jax_variant_tokens(mode, quantized):
    """tests/test_paged_serving.py::test_paged_attn_variants_token_parity's
    run on the JAX engine (module-level cache: one compile per variant)."""
    cfg = tiny_vlm_config(vocab_size=1024)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    tok = ByteLevelTokenizer(1024)
    eng = j_paged.PagedServingEngine(cfg, params, tok, num_slots=2,
                                     n_pages=16, page_size=32,
                                     max_pages_per_slot=8, burst=4,
                                     paged_attn=mode,
                                     quantized_cache=quantized)
    patches = []
    for i in range(len(PROMPTS)):
        r = np.random.default_rng(40 + i)
        raw = {n: jnp.asarray(r.normal(size=(1, v.img_size, v.img_size, 3))
                              .astype(np.float32)) for n, v in cfg.vision}
        patches.append({"patches": encode_frame(params, cfg, raw)})
    rids = [eng.submit(p, patches[i], max_new_tokens=6 + 3 * i)
            for i, p in enumerate(PROMPTS)]
    done = eng.run_until_complete()
    return [done[r] for r in rids]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mode", ["kernel", "gather", "burstdense"])
def test_paged_engine_tokens_match_jax(setup, mode, quantized):
    """Mixed-length slots, so page walks and length masks all bite."""
    eng = setup.engine(num_slots=2, n_pages=16, page_size=32,
                       max_pages_per_slot=8, burst=4, paged_attn=mode,
                       quantized_cache=quantized)
    rids = [eng.submit(p, setup.tpix(40 + i), max_new_tokens=6 + 3 * i)
            for i, p in enumerate(PROMPTS)]
    done = eng.run_until_complete()
    got = [done[r] for r in rids]
    assert got == _jax_variant_tokens(
        "gather" if mode == "kernel" else mode, quantized)
    if not quantized:
        _check_solo(setup, done, rids, PROMPTS, (40, 41), (6, 9))
    assert sorted(eng.free_pages) == list(range(16))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_kernel_step_matches_gather_step(setup, quantized):
    """One decode step of each mode on the same admitted pool after two
    real bursts (the TPU check in scripts/tpu_checks.py): on the CPU both
    are plain fp32, so the logits agree to summation order."""
    eng = setup.engine(num_slots=3, n_pages=16, page_size=32,
                       max_pages_per_slot=8, burst=4, paged_attn="gather",
                       quantized_cache=quantized)
    for i, w in enumerate(("red", "blue", "green")):
        eng.submit(f"In: stack the {w} cups\nOut:", setup.tpix(i),
                   max_new_tokens=24)
    eng.step()
    eng.step()
    outs = {}
    for mode in ("gather", "kernel"):
        _, nxt, logits = t_paged._paged_decode_step(
            setup.tparams["llm"], setup.tcfg.llm, eng.pool, page_size=32,
            n_pages=16, paged_attn=mode)
        outs[mode] = (nxt, logits)
    torch.testing.assert_close(outs["kernel"][1], outs["gather"][1],
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(outs["kernel"][0], outs["gather"][0])


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_burstdense_uniform_write_fast_path_exact(setup, quantized):
    """The uniform-write fast path emits exactly the per-row path's tokens;
    unequal budgets retire one row mid-burst, and the next burst takes the
    per-row path (tests/test_paged_serving.py:165-188)."""
    prompts = ["In: pick up the cup\nOut:", "In: wipe the tables\nOut:"]

    def run(uniform):
        eng = setup.engine(num_slots=2, n_pages=16, page_size=32,
                           max_pages_per_slot=8, burst=8,
                           paged_attn="burstdense", quantized_cache=quantized,
                           uniform_burst_writes=uniform)
        rids = [eng.submit(p, setup.tpix(60 + i), max_new_tokens=4 + 8 * i)
                for i, p in enumerate(prompts)]
        done = eng.run_until_complete()
        return [done[r] for r in rids]

    assert run(True) == run(False)


def test_warmup_reports_the_burst_variants(setup):
    assert setup.engine(paged_attn="burstdense").warmup() == [True, False]
    assert setup.engine(paged_attn="kernel").warmup() == [False]


# ------------------------------------------------------ shared prefixes --

@pytest.mark.parametrize("page_size,quantized,mode", [
    (4, False, "burstdense"), (32, False, "kernel"), (5, False, "gather"),
    (4, True, "burstdense")])
def test_shared_prefix_admission_matches_solo(setup, page_size, quantized,
                                              mode):
    """submit_shared across page geometries (ps=4: boundary rows copied;
    ps=32: prefix inside one page; ps=5: page-aligned prefix) and modes:
    tokens equal each prompt's solo run, every page comes back, and equal
    tails admit in one batched tail prefill
    (tests/test_paged_serving.py:218-251,305-385)."""
    prefix_len = 1 + setup.cfg.num_patches
    if page_size == 5:
        assert prefix_len % page_size == 0
    prompts = ["In: pick up the cup\nOut:", "In: pick up the pot\nOut:",
               "In: close that drawer now\nOut:"]   # two equal tails
    eng = setup.engine(num_slots=3, n_pages=64, page_size=page_size,
                       max_pages_per_slot=32, burst=4, paged_attn=mode,
                       quantized_cache=quantized)
    calls = []
    orig = eng._admit_shared_tails

    def spy(reqs, slots):
        calls.append(len(reqs))
        return orig(reqs, slots)

    eng._admit_shared_tails = spy
    rids = eng.submit_shared(prompts, setup.tpix(7), max_new_tokens=6)
    shared_ids = list(eng._shared_refs.values())[0]["ids"]
    assert len(shared_ids) == -(-prefix_len // page_size)
    eng._admit()
    assert calls == [2, 1]
    own = set()
    for req in eng.running.values():
        assert req.n_pages >= prefix_len // page_size
        own.update(req.page_ids)
    assert own.isdisjoint(shared_ids)
    done = eng.run_until_complete()
    if quantized:   # int8 pages: the early tokens track the fp32 run
        for rid, p in zip(rids, prompts):
            assert done[rid][:3] == setup.reference(p, 7)[:3]
    else:
        _check_solo(setup, done, rids, prompts, (7, 7, 7), 6)
    assert sorted(eng.free_pages) == list(range(64))


def test_shared_prefix_refcount_holds_until_last(setup):
    """With one slot, group members run one after another; the shared pages
    stay allocated until the last member retires
    (tests/test_paged_serving.py:254-282)."""
    prompts = ["In: lift the box\nOut:", "In: push the plate\nOut:"]
    eng = setup.engine(num_slots=1, n_pages=32, page_size=4,
                       max_pages_per_slot=16, burst=4, paged_attn="gather")
    rids = eng.submit_shared(prompts, setup.tpix(9), max_new_tokens=4)
    key = next(iter(eng._shared_refs))
    shared_ids = set(eng._shared_refs[key]["ids"])
    saw_mid = False
    for _ in range(200):
        eng.step()
        if eng.finished and (eng.running or eng.queue):
            assert key in eng._shared_refs
            assert shared_ids.isdisjoint(eng.free_pages)
            saw_mid = True
        if not eng.queue and not eng.running:
            break
    assert saw_mid and key not in eng._shared_refs
    assert sorted(eng.free_pages) == list(range(32))
    _check_solo(setup, eng.finished, rids, prompts, (9, 9), 4)


def test_freed_page_reuse_not_corrupted_by_stale_slot(setup):
    """A finished slot keeps its stale page-table row; when its freed pages
    go to a still-running request, the inactive slot's burstdense
    writeback must not clobber them (tests/test_paged_serving.py:285-316:
    the long request sits in the lower slot and grows into the short
    one's old cursor page)."""
    prompt_b = "In: wipe the table !\nOut:"     # slot 0, keeps growing
    prompt_a = "In: pick up the cup\nOut:"      # slot 1, finishes fast
    eng = setup.engine(num_slots=2, n_pages=4, page_size=32,
                       max_pages_per_slot=5, burst=4,
                       paged_attn="burstdense")
    rid_b = eng.submit(prompt_b, setup.tpix(55), max_new_tokens=90)
    rid_a = eng.submit(prompt_a, setup.tpix(55), max_new_tokens=4)
    done = eng.run_until_complete()
    engine = ServingEngine(setup.cfg, setup.params, setup.tok,
                           options=GenerateOptions(eos_id=setup.tok.eos_id))
    ref_b = list(engine.generate_ids([prompt_b], setup.jpix(55),
                                     max_new_tokens=90)[0])
    if setup.tok.eos_id in ref_b:
        ref_b = ref_b[:ref_b.index(setup.tok.eos_id)]
    assert done[rid_b][:len(ref_b)] == ref_b, (done[rid_b][:12], ref_b[:12])
    _check_solo(setup, done, [rid_a], [prompt_a], (55,), 4)
    assert sorted(eng.free_pages) == list(range(4))


# ------------------------------------------------------------ rejections --

def test_oversized_requests_are_rejected(setup):
    eng = setup.engine(num_slots=1, n_pages=8, page_size=32,
                       max_pages_per_slot=4)
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        eng.submit("In: x\nOut:", setup.tpix(0), max_new_tokens=512)
    small = setup.engine(num_slots=1, n_pages=2, page_size=32,
                         max_pages_per_slot=8)
    with pytest.raises(ValueError, match="only holds 2"):
        small.submit("In: x\nOut:", setup.tpix(0), max_new_tokens=100)
    with pytest.raises(ValueError, match="page-table entries"):
        eng.submit_shared(["In: x\nOut:"], setup.tpix(0),
                          max_new_tokens=512)
    assert not eng.queue and not small.queue


@pytest.mark.parametrize("mode", ["flash"])
def test_unported_paged_attn_modes_raise(setup, mode):
    with pytest.raises(ValueError, match=repr(mode)):
        setup.engine(paged_attn=mode)


def test_engine_refuses_weights_on_another_device(setup):
    with pytest.raises(ValueError, match="weights are on cpu"):
        t_paged.PagedServingEngine(setup.tcfg, setup.tparams, setup.tok,
                                   device="meta")
