"""Port parity for the speculative engine's parts: the drafts, the tree,
chunk-masked attention, the tree cache compaction, the bf16 fence and the
vision cache, against ``emmax_tpu`` on the same inputs (numpy in, the
JAX side on the CPU).

Integer results (drafts, topology, fingerprints' cache decisions) must be
identical; tree-chunk logits are held to the linear path at 1e-5 (fp32,
the same sums over other masks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.ops import attention as t_attn
from emmax_torch.serving import speculative as t_spec
from emmax_torch.serving.engine import VisionCache as TorchVisionCache
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.ops import attention as j_attn
from emmax_tpu.serving import speculative as j_spec
from emmax_tpu.serving.engine import VisionCache as JaxVisionCache


def _hist(rows, H=24):
    hist = np.full((len(rows), H), -1, np.int64)
    for i, r in enumerate(rows):
        hist[i, :len(r)] = r
    return hist, np.asarray([len(r) for r in rows], np.int64)


def _both_lookup(hist, hlen, k):
    want = np.asarray(j_spec.lookup_draft(jnp.asarray(hist, jnp.int32),
                                          jnp.asarray(hlen, jnp.int32), k))
    got = t_spec.lookup_draft(hist, hlen, k)
    np.testing.assert_array_equal(got, want)
    return got


# ------------------------------------------------------------------ drafts

@pytest.mark.parametrize("rows,k,expect", [
    ([[1, 7, 8, 9, 10, 11, 3, 7, 8]], 4, [9, 10, 11, 3]),   # continuation
    ([[5, 5, 1, 9, 5, 5, 2, 9, 5, 5]], 2, [2, 9]),          # most recent
    ([[1, 2, 3, 7, 8, 5, 2, 3, 9, 4, 1, 2, 3]], 2, [7, 8]),  # longest n
    ([[1, 2, 3, 4], [1]], 3, None),                        # no match
])
def test_lookup_draft_cases_match_jax(rows, k, expect):
    hist, hlen = _hist(rows)
    got = _both_lookup(hist, hlen, k)
    if expect is None:
        assert (got == -1).all()
    else:
        np.testing.assert_array_equal(got[0], expect)


def test_lookup_draft_ignores_stale_region_beyond_hlen():
    row = [4, 6, 1, 2, 3, 4, 6]
    hist, _ = _hist([row + [4, 6, 9, 9, 9]])     # rejected targets past hlen
    got = _both_lookup(hist, np.asarray([len(row)]), 2)
    np.testing.assert_array_equal(got[0], [1, 2])


@pytest.mark.parametrize("seed", range(4))
def test_drafts_match_jax_on_random_histories(seed):
    """Small alphabets so n-grams repeat; ragged lengths, stale tails."""
    rng = np.random.default_rng(seed)
    B, H = 5, 40
    hist = rng.integers(100, 100 + 4 + seed, (B, H)).astype(np.int64)
    hlen = rng.integers(0, H - 2, B).astype(np.int64)
    for k in (1, 4, 12):
        _both_lookup(hist, hlen, k)
    for k in (3, 10):
        want = j_spec.action_stride_draft(
            jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32), k,
            bin_lo=101, bin_hi=103, period=3)
        got = t_spec.action_stride_draft(hist, hlen, k, bin_lo=101,
                                         bin_hi=103, period=3)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_action_stride_draft_gating_and_tiling():
    bins = [101, 102, 103, 104, 105, 106, 107]
    hist, hlen = _hist([[9, 8] + bins,
                        [9, 8, 101, 102, 7, 104, 105, 106, 107],
                        [101, 102, 103]], H=16)
    got = t_spec.action_stride_draft(hist, hlen, 10, bin_lo=100, bin_hi=110)
    np.testing.assert_array_equal(got[0], bins + bins[:3])
    assert (got[1:] == -1).all()
    np.testing.assert_array_equal(got, np.asarray(j_spec.action_stride_draft(
        jnp.asarray(hist, jnp.int32), jnp.asarray(hlen, jnp.int32), 10,
        bin_lo=100, bin_hi=110)))


# -------------------------------------------------------------------- tree

@pytest.mark.parametrize("widths", [(3, 2), (5,), (5, 3), (7, 5), (2, 2, 2)])
def test_tree_meta_matches_jax(widths):
    got, want = t_spec._tree_meta(widths), j_spec._tree_meta(widths)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] == 1 + int(np.sum(np.cumprod(widths)))
    depth, anc, base, n1 = got
    assert anc.diagonal().all() and anc[:, 0].all()
    if widths == (3, 2):
        np.testing.assert_array_equal(depth, [0, 1, 1, 1, 2, 2, 2, 2, 2, 2])
        np.testing.assert_array_equal(base, [1, 4])


def test_tree_meta_rejects_bad_widths():
    for widths in ((), (8,)):
        with pytest.raises(ValueError, match="tree widths"):
            t_spec._tree_meta(widths)


@pytest.mark.parametrize("per_row", [False, True])
def test_chunk_mask_attention_matches_jax(per_row):
    rng = np.random.default_rng(5)
    B, Lq, S, H, D = 2, 7, 16, 2, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Lq, H, D), (B, S, H, D), (B, S, H, D)))
    kv_mask = rng.random((B, S)) > 0.2
    _, anc, _, _ = t_spec._tree_meta((2, 2))
    q_offset = np.asarray([3, 6]) if per_row else 5
    want = j_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(kv_mask), causal=True,
        q_offset=jnp.asarray(q_offset), chunk_mask=jnp.asarray(anc))
    got = t_attn.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=torch.from_numpy(kv_mask), causal=True,
        q_offset=torch.from_numpy(q_offset) if per_row else q_offset,
        impl="cuda", chunk_mask=torch.from_numpy(anc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    dense = t_attn._dense_mask(Lq, S, None, True, q_offset if not per_row
                               else torch.from_numpy(q_offset),
                               torch.device("cpu"), torch.from_numpy(anc))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(
        j_attn._dense_mask(Lq, S, None, True, jnp.asarray(q_offset),
                           jnp.asarray(anc))))


@pytest.fixture(scope="module")
def llama_2048():
    cfg = tiny_vlm_config(vocab_size=2048)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)["llm"]
    return cfg.llm, params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))


def test_chunk_attn_mask_requires_a_cache(llama_2048):
    cfg, _, tparams = llama_2048
    with pytest.raises(ValueError, match="requires a kv_cache"):
        t_llama.llama_forward(tparams, cfg, torch.zeros(1, 3, cfg.dim),
                              chunk_attn_mask=torch.ones(3, 3, dtype=bool))


def test_tree_chunk_logits_match_linear_path(llama_2048):
    """The logits at a tree node equal a linear cached run of its
    ancestor path (same cache, same positions), and the JAX package's."""
    cfg, jparams, tparams = llama_2048
    B, S = 1, 64
    ctx = np.random.default_rng(1).integers(4, 200, (B, 5))

    def cached(prefill):
        cache = t_llama.init_kv_cache(cfg, B, S, dtype=torch.float32)
        cache["len"] = torch.zeros((B,), dtype=torch.int64)
        t_llama.llama_forward(
            tparams, cfg, t_llama.embed_tokens(tparams, torch.from_numpy(
                prefill)), positions=torch.arange(5)[None], kv_cache=cache)
        return cache

    depth, anc, _, _ = t_spec._tree_meta((2, 2))
    toks = torch.tensor([[10, 20, 30, 40, 50, 60, 70]])
    pos_tree = torch.from_numpy(depth)[None] + 5
    lg_tree, _ = t_llama.llama_forward(
        tparams, cfg, t_llama.embed_tokens(tparams, toks),
        positions=pos_tree, kv_cache=cached(ctx),
        chunk_attn_mask=torch.from_numpy(anc))
    # the path root -> b -> f (chunk slots 0, 2, 6), linearly
    lg_lin, _ = t_llama.llama_forward(
        tparams, cfg, t_llama.embed_tokens(tparams,
                                           torch.tensor([[10, 30, 70]])),
        positions=torch.tensor([[5, 6, 7]]), kv_cache=cached(ctx))
    np.testing.assert_allclose(lg_tree[0, [0, 2, 6]].numpy(),
                               lg_lin[0].numpy(), rtol=1e-5, atol=1e-5)
    jcache = j_llama.init_kv_cache(cfg, B, S, dtype=jnp.float32)
    jcache = dict(jcache, len=jnp.zeros((B,), jnp.int32))
    _, jcache = j_llama.llama_forward(
        jparams, cfg, j_llama.embed_tokens(jparams, jnp.asarray(ctx)),
        positions=jnp.arange(5)[None], kv_cache=jcache)
    want, _ = j_llama.llama_forward(
        jparams, cfg, j_llama.embed_tokens(jparams, jnp.asarray(toks)),
        positions=jnp.asarray(pos_tree), kv_cache=jcache,
        chunk_attn_mask=jnp.asarray(anc))
    np.testing.assert_allclose(lg_tree.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("quantized", [False, True])
def test_compact_tree_cache_matches_jax(quantized):
    rng = np.random.default_rng(2)
    L, B, S, KV, hd, D = 2, 3, 32, 2, 4, 2
    if quantized:
        cache = {"k": rng.integers(-127, 128, (L, B, S, KV, hd), np.int8),
                 "v": rng.integers(-127, 128, (L, B, S, KV, hd), np.int8),
                 "k_scale": rng.random((L, B, S, KV, 1), np.float32),
                 "v_scale": rng.random((L, B, S, KV, 1), np.float32)}
    else:
        cache = {"k": rng.standard_normal((L, B, S, KV, hd), np.float32),
                 "v": rng.standard_normal((L, B, S, KV, hd), np.float32)}
    t0 = np.asarray([4, 10, 20])
    abs_src = t0[:, None] + np.asarray([[2, 5], [1, 4], [3, 9]])
    want = j_spec._compact_tree_cache(
        {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(abs_src, jnp.int32), jnp.asarray(t0, jnp.int32))
    got = t_spec._compact_tree_cache(
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()},
        torch.from_numpy(abs_src), torch.from_numpy(t0))
    for key in cache:
        assert got[key].dtype == torch.from_numpy(cache[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# -------------------------------------------------------------- bf16 fence

class FakeLeaf:
    def __init__(self, nbytes):
        self.size = nbytes // 2
        self.dtype = np.dtype(np.float16)


def _fake_tree(qkv_gb, rest_gb, quantized=False):
    per = FakeLeaf(int(qkv_gb / 3 * 1e9))
    layers = {"wq": {"q8": 0, "scale": 0} if quantized else per,
              "wk": per, "wv": per, "wo": FakeLeaf(int(rest_gb * 1e9))}
    return {"llm": {"layers": layers}}


@pytest.mark.parametrize("tree,fenced", [
    (_fake_tree(3.2, 10.3), True),             # bf16 7B on 16 GB
    (_fake_tree(3.2, 10.3, quantized=True), False),
    (_fake_tree(0.5, 1.0), False),
    ({}, False),
    ({"llm": {"layers": {}}}, False),
])
def test_bf16_oom_risk_matches_jax(tree, fenced):
    assert t_spec._spec_bf16_oom_risk(tree) is fenced
    assert j_spec._spec_bf16_oom_risk(tree, hbm_bytes=16e9) is fenced


def test_bf16_oom_risk_counts_tensors_and_takes_the_device_size():
    layers = {k: torch.zeros(2, 8, 8, dtype=torch.bfloat16)
              for k in ("wq", "wk", "wv", "wo")}
    tree = {"llm": {"layers": layers, "embed": torch.zeros(16, 8)}}
    # 4 x 256 + 3 x 256 + 512 bytes = 2304; 0.95 * 2400 = 2280
    assert t_spec._spec_bf16_oom_risk(tree, hbm_bytes=2400)
    assert not t_spec._spec_bf16_oom_risk(tree, hbm_bytes=2500)
    assert not t_spec._spec_bf16_oom_risk(tree)   # CPU tensors: 16e9


# ------------------------------------------------------------ vision cache

def test_vision_cache_fingerprints_and_decisions_match_jax():
    rng = np.random.default_rng(4)
    pix = {n: rng.standard_normal((1, 40, 40, 3)).astype(np.float32)
           for n in ("siglip", "dino")}
    caches = (TorchVisionCache(capacity=2, threshold=0.05),
              JaxVisionCache(capacity=2, threshold=0.05))
    np.testing.assert_array_equal(
        caches[0].fingerprint({n: torch.from_numpy(p)
                               for n, p in pix.items()}),
        caches[1].fingerprint({n: jnp.asarray(p) for n, p in pix.items()}))
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    seen = []
    for vc in caches:
        got = []
        for f in (0, 3, 7, 9, 0, 20, 21, 30, 3):
            frame = np.clip(img.astype(np.int32) + f, 0, 255).astype(np.uint8)
            fp = vc.fingerprint_host(frame)
            hit = vc.lookup(fp)
            if hit is None:
                vc.store(fp, f)
            got.append(hit)
        seen.append((got, vc.hits, vc.misses,
                     [[p for _, p in ring] for ring in vc.entries.values()]))
    assert seen[0] == seen[1]
    # a hit is within 0.05 * 127.5 = 6.4 levels of a cached frame, newest
    # first; capacity 2: storing 20 evicts 0, so 3 misses at the end
    assert seen[0][0] == [None, 0, None, 7, 0, None, 20, None, None]


def test_vision_cache_keeps_a_ring_per_fingerprint_kind():
    vc = TorchVisionCache(capacity=1, threshold=0.0)
    frame = np.zeros((32, 32, 3), np.uint8)
    pix = {"dino": torch.zeros(1, 48, 48, 3)}
    vc.store(vc.fingerprint_host(frame), "host")
    vc.store(vc.fingerprint(pix), "pixels")        # another shape, no evict
    assert vc.lookup(vc.fingerprint_host(frame)) == "host"
    assert vc.lookup(vc.fingerprint(pix)) == "pixels"
    assert (vc.hits, vc.misses, len(vc.entries)) == (2, 0, 2)
