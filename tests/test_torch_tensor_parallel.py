"""The decoder split over ``tensor`` (``emmax_torch/parallel/tensor.py``) on
gloo ranks against ``emmax_tpu``'s GSPMD run on JAX-sharded params (the
test process's 8 virtual CPU devices) and the port's unsharded decoder.

At (1, 1, 2), (1, 1, 4) and (1, 2, 2) the tiny decoder (4 heads, 4 KV
heads, hidden 128, vocab 512) computes each rank's heads and MLP columns:
fp32 logits within ``TOL`` of the largest logit of JAX's and of the
unsharded port's, the same bits on every rank, no decoder block gathered
over ``tensor``, ``2 n_layers + 2`` collectives over ``tensor`` a
forward, ``n_kv_heads / t`` cache heads on each rank, and (without data
axes) every leaf's gradient the unsharded one's. At (1, 1, 8) the 4
heads do not divide and the layers run whole: the same logits, a whole
cache and JAX's greedy tokens. The batch's last id is past the table
(the byte-level pad id), which reads the last row.
"""

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


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config(vocab_size=VOCAB)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, VOCAB, size=(2, 12)).astype(np.int64)
    mask = np.ones(ids.shape, bool)
    ids[1, :3], mask[1, :3] = VOCAB, False     # left pad: the pad id
    ids[0, -1] = VOCAB                         # past the table
    grad_w = rng.normal(size=(2, 12, VOCAB)).astype(np.float32)
    pool = GlooPool()
    yield (cfg, params, jax.tree_util.tree_map(np.asarray, params), ids,
           mask, grad_w, pool)
    pool.close()


def _jax_mesh(shape):
    return make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


def _jax_logits(setup, shape):
    """JAX's uncached logits on the params sharded over ``shape``."""
    cfg, params, _, ids, mask, _, _ = setup
    llm = shard_params(params, _jax_mesh(shape))["llm"]
    fwd = jax.jit(lambda p, i, m: llama_forward(
        p, cfg.llm, embed_tokens(p, i), mask=m)[0])
    return np.asarray(fwd(llm, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.fixture(scope="module")
def unsharded(setup):
    """The port's unsharded decoder: uncached logits and every leaf's
    gradient of ``sum(logits * grad_w)``, the cached prefill's and one
    decode step's logits."""
    _, _, host, ids, mask, grad_w, _ = setup
    tcfg = t_vlm.tiny_vlm_config(vocab_size=VOCAB).llm
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


@pytest.mark.parametrize("mesh_shape", SPLIT + [(1, 1, 8)], ids=str)
def test_split_logits_match_jax_and_unsharded(setup, unsharded, mesh_shape):
    cfg, _, host, ids, mask, grad_w, pool = setup
    t = mesh_shape[2]
    split = cfg.llm.n_heads % t == 0
    results = pool.run("split_forward", params=host, ids=ids, mask=mask,
                       grad_w=grad_w, mesh_shape=mesh_shape)
    want_jax = _jax_logits(setup, mesh_shape)
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
    _, _, host, ids, mask, grad_w, pool = setup
    table = host["llm"]["embed"]
    for r in pool.run("split_forward", params=host, ids=ids, mask=mask,
                      grad_w=grad_w, mesh_shape=(1, 1, 4)):
        np.testing.assert_array_equal(r["embeds"][0, -1], table[-1])
        np.testing.assert_array_equal(r["embeds"][1, :3],
                                      np.broadcast_to(table[-1], (3, 64)))
        np.testing.assert_array_equal(r["embeds"][0, :-1],
                                      table[ids[0, :-1]])


def test_whole_layers_at_tensor_8_give_jax_tokens(setup):
    """At (1, 1, 8) the tiny config's 4 heads run whole: the engine's
    greedy tokens are JAX's on the same mesh."""
    cfg, params, host, _, _, _, pool = setup
    rng = np.random.default_rng(1)
    pixels = {name: rng.normal(size=(1, v.img_size, v.img_size, 3))
              .astype(np.float32) for name, v in cfg.vision}
    tok = ByteLevelTokenizer(VOCAB)
    engine = ServingEngine(cfg, shard_params(params, _jax_mesh((1, 1, 8))),
                           tok, options=GenerateOptions(eos_id=tok.eos_id))
    want = np.asarray(engine.generate_ids(
        [PROMPT], {k: jnp.asarray(v) for k, v in pixels.items()},
        max_new_tokens=8)[0])
    for out in pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                        mesh_shape=(1, 1, 8), max_new=8):
        np.testing.assert_array_equal(out, want)
