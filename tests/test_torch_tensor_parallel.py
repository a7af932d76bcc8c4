"""The decoder split over ``tensor`` (``emmax_torch/parallel/tensor.py``) on
gloo ranks against ``emmax_tpu``'s GSPMD run on JAX-sharded params (the
test process's 8 virtual CPU devices) and the port's unsharded decoder.

Two tiny decoders (hidden 128, vocab 512, 4 heads): ``mha`` with 4 KV
heads, and ``gqa`` with 2 (grouped-query attention, 2 query heads a KV
head, as Mistral's 32 on 8), both built with ``dataclasses.replace`` from
the tiny config on both sides. Where ``t`` divides the heads and the KV
heads (``mha`` at (1, 1, 2), (1, 1, 4), (1, 2, 2); ``gqa`` at (1, 1, 2)
and (1, 2, 2)) each rank computes its heads and MLP columns: fp32 logits,
the cached prefill's and one decode step's within ``TOL`` of the largest
logit of JAX's and of the unsharded port's, the same bits on every rank,
no decoder block gathered over ``tensor``, ``2 n_layers + 2`` collectives
over ``tensor`` a forward, ``n_kv_heads / t`` cache heads on each rank,
and (without data axes) every leaf's gradient, ``wk`` / ``wv`` included,
the unsharded one's. Elsewhere (``mha`` at (1, 1, 8), ``gqa`` at (1, 1, 4)
and (1, 1, 8)) the layers run whole: the same logits and a whole cache.
Greedy tokens through ``ServingEngine`` are JAX's at (1, 1, 8) and, for
``gqa``, split at (1, 1, 2) with 1 KV head a rank. The batch's last id
is past the table (the byte-level pad id), which reads the last row; ids
past either end read JAX's rows, split and whole.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import llama as t_llama
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.tree import leaves_with_path
from emmax_tpu.models.llama import embed_tokens, llama_forward
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.serving.engine import GenerateOptions, ServingEngine
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer
from torch_gloo_pool import GlooPool

VOCAB = 512
TOL = 1e-5       # of the largest |logit| (fp32; sums over ranks reorder)
SPLIT = [(1, 1, 2), (1, 1, 4), (1, 2, 2)]
PROMPT = "In: pick up the cup\nOut:"
KV_HEADS = {"mha": 4, "gqa": 2}


def _kv(cfg, n_kv_heads):
    """``cfg`` (either package's VLM config) with ``n_kv_heads`` KV heads
    in its decoder."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, n_kv_heads=n_kv_heads))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX config, params, their numpy tree) of the ``name`` decoder."""
    cfg = _kv(tiny_vlm_config(vocab_size=VOCAB), KV_HEADS[name])
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, VOCAB, size=(2, 12)).astype(np.int64)
    mask = np.ones(ids.shape, bool)
    ids[1, :3], mask[1, :3] = VOCAB, False     # left pad: the pad id
    ids[0, -1] = VOCAB                         # past the table
    grad_w = rng.normal(size=(2, 12, VOCAB)).astype(np.float32)
    pool = GlooPool()
    yield ids, mask, grad_w, pool
    pool.close()


def _jax_mesh(shape):
    return make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


def _jax_logits(setup, name, shape):
    """JAX's uncached logits of the ``name`` decoder on the params sharded
    over ``shape``."""
    cfg, params, _ = _case(name)
    ids, mask, _, _ = setup
    llm = shard_params(params, _jax_mesh(shape))["llm"]
    fwd = jax.jit(lambda p, i, m: llama_forward(
        p, cfg.llm, embed_tokens(p, i), mask=m)[0])
    return np.asarray(fwd(llm, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.fixture(scope="module")
def unsharded(setup):
    """{decoder name: the port's unsharded run}, each computed once."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _unsharded(setup, name)
        return runs[name]

    return get


def _unsharded(setup, name):
    """The port's unsharded ``name`` decoder: uncached logits and every
    leaf's gradient of ``sum(logits * grad_w)``, the cached prefill's and
    one decode step's logits."""
    ids, mask, grad_w, _ = setup
    _, _, host = _case(name)
    tcfg = _kv(t_vlm.tiny_vlm_config(vocab_size=VOCAB), KV_HEADS[name]).llm
    llm = params_from_numpy(host)["llm"]
    leaves = {p: t.requires_grad_() for p, t in leaves_with_path(llm)}
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    logits, _ = t_llama.llama_forward(
        llm, tcfg, t_llama.embed_tokens(llm, ids_t), mask=mask_t,
        attn_impl="torch")
    (logits * torch.from_numpy(grad_w)).sum().backward()
    with torch.inference_mode():
        cache = t_llama.init_kv_cache(tcfg, 2, 32, dtype=torch.float32)
        cached, _ = t_llama.llama_forward(
            llm, tcfg, t_llama.embed_tokens(llm, ids_t), mask=mask_t,
            kv_cache=cache, attn_impl="torch")
        step, _ = t_llama.llama_forward(
            llm, tcfg, t_llama.embed_tokens(
                llm, cached[:, -1].argmax(-1)[:, None]),
            kv_cache=cache, attn_impl="torch")
    return {"logits": logits.detach().numpy(), "cached": cached.numpy(),
            "step": step.numpy(),
            "grads": {p: t.grad.numpy() for p, t in leaves.items()}}


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} of {scale}"


def _same_bits(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])


# the mha cases keep the ids they had before the gqa cases came
CASES = [pytest.param("mha", s, id=str(s)) for s in SPLIT + [(1, 1, 8)]] + [
    pytest.param("gqa", s, id=f"gqa-{s}") for s in SPLIT + [(1, 1, 8)]]


@pytest.mark.parametrize("name,mesh_shape", CASES)
def test_split_logits_match_jax_and_unsharded(setup, unsharded, name,
                                              mesh_shape):
    cfg, _, host = _case(name)
    ids, mask, grad_w, pool = setup
    unsharded = unsharded(name)
    t = mesh_shape[2]
    split = cfg.llm.n_heads % t == 0 and cfg.llm.n_kv_heads % t == 0
    results = pool.run("split_forward", params=host, ids=ids, mask=mask,
                       grad_w=grad_w, mesh_shape=mesh_shape,
                       n_kv_heads=cfg.llm.n_kv_heads)
    want_jax = _jax_logits(setup, name, mesh_shape)
    for key in ("embeds", "logits", "cached", "step"):
        _same_bits(results, key)
    r = results[0]
    assert r["t"] == (t if split else 1)
    assert r["cache_heads"] == cfg.llm.n_kv_heads // r["t"]
    _close(r["logits"], want_jax, "logits vs JAX")
    _close(r["logits"], unsharded["logits"], "logits vs unsharded")
    _close(r["cached"], unsharded["cached"], "cached prefill")
    _close(r["step"], unsharded["step"], "decode step")
    if split:
        assert r["tensor_gathers"] == 0
        assert r["sums"] == 2 * cfg.llm.n_layers + 2
    else:
        assert r["tensor_gathers"] > 0
    if mesh_shape[1] == 1:
        for path, g in unsharded["grads"].items():
            _close(r["grads"][path], g, f"grad {path}")
            _same_bits([x["grads"] for x in results], path)


def test_vocab_parallel_embedding_reads_last_row(setup):
    """An id past the table reads the last row (on the last rank), on
    every rank and bit for bit."""
    _, _, host = _case("mha")
    ids, mask, grad_w, pool = setup
    table = host["llm"]["embed"]
    for r in pool.run("split_forward", params=host, ids=ids, mask=mask,
                      grad_w=grad_w, mesh_shape=(1, 1, 4)):
        np.testing.assert_array_equal(r["embeds"][0, -1], table[-1])
        np.testing.assert_array_equal(r["embeds"][1, :3],
                                      np.broadcast_to(table[-1], (3, 64)))
        np.testing.assert_array_equal(r["embeds"][0, :-1],
                                      table[ids[0, :-1]])


NEGATIVE_IDS = np.array([[-1, -VOCAB, -VOCAB - 1, VOCAB, VOCAB + 2, 7]])


@pytest.mark.parametrize("mesh_shape", [None, (1, 1, 1), (1, 1, 4)],
                         ids=str)
def test_embedding_reads_ids_past_either_end_as_jax(setup, mesh_shape):
    """Ids past either end of the table (-1, -V, -V - 1, V, V + 2) read
    JAX's rows bit for bit (a negative id counts from the end, then
    clamps), unsharded, on a one-rank mesh and vocab-parallel over 4
    ranks."""
    _, params, host = _case("mha")
    pool = setup[3]
    want = np.asarray(embed_tokens(params["llm"], jnp.asarray(NEGATIVE_IDS)))
    np.testing.assert_array_equal(
        want[0, :5], host["llm"]["embed"][[VOCAB - 1, 0, 0, VOCAB - 1,
                                           VOCAB - 1]])
    if mesh_shape is None:
        got = [t_llama.embed_tokens(params_from_numpy(host)["llm"],
                                    torch.from_numpy(NEGATIVE_IDS)).numpy()]
    else:
        runs = pool.run("embed_rows", params=host, ids=NEGATIVE_IDS,
                        mesh_shape=mesh_shape)
        assert all(r["split"] == (mesh_shape[2] > 1) for r in runs)
        got = [r["rows"] for r in runs]
    for rows in got:
        np.testing.assert_array_equal(rows, want)


@functools.lru_cache(maxsize=None)
def _jax_tokens(name, mesh_shape):
    """JAX's greedy tokens of the ``name`` VLM's engine on the params
    sharded over ``mesh_shape``, and the pixels they saw."""
    cfg, params, _ = _case(name)
    rng = np.random.default_rng(1)
    pixels = {n: rng.normal(size=(1, v.img_size, v.img_size, 3))
              .astype(np.float32) for n, v in cfg.vision}
    tok = ByteLevelTokenizer(VOCAB)
    engine = ServingEngine(cfg, shard_params(params, _jax_mesh(mesh_shape)),
                           tok, options=GenerateOptions(eos_id=tok.eos_id))
    want = np.asarray(engine.generate_ids(
        [PROMPT], {k: jnp.asarray(v) for k, v in pixels.items()},
        max_new_tokens=8)[0])
    return want, pixels


def test_whole_layers_at_tensor_8_give_jax_tokens(setup):
    """At (1, 1, 8) the tiny config's 4 heads run whole: the engine's
    greedy tokens are JAX's on the same mesh."""
    _, _, host = _case("mha")
    pool = setup[3]
    want, pixels = _jax_tokens("mha", (1, 1, 8))
    for out in pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                        mesh_shape=(1, 1, 8), max_new=8):
        np.testing.assert_array_equal(out, want)


def test_gqa_split_engine_gives_jax_tokens(setup):
    """The grouped-query decoder split at (1, 1, 2): each rank's cache
    holds 1 of the 2 KV heads, read by its 2 query heads, and
    ``ServingEngine``'s greedy tokens are JAX's on the same mesh."""
    _, _, host = _case("gqa")
    pool = setup[3]
    want, pixels = _jax_tokens("gqa", (1, 1, 2))
    runs = pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                    mesh_shape=(1, 1, 2), max_new=8,
                    n_kv_heads=KV_HEADS["gqa"], cache_heads=True)
    assert len(runs) == 2
    for r in runs:
        assert r["cache_heads"] == [1]
        np.testing.assert_array_equal(r["tokens"], want)
