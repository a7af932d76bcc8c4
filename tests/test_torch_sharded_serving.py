"""Sharded serving in the port against ``emmax_tpu``, mirroring
``tests/test_serving_sharded.py``: ``ServingEngine(cfg,
shard_params(params, mesh), tok, mesh=mesh)`` on 8 gloo ranks gives, on
every rank, the greedy tokens of JAX's engine on JAX-sharded params and
of the port's unsharded engine, at (1,1,8), (1,4,2), (1,8,1) and (1,1,2)
(the decoder split over ``tensor``, ``parallel/tensor.py``, on the first
two ranks; (1,4,2) splits it too). A
quantized tree (its ``q8`` / ``q4`` / ``scale`` leaves replicated)
serves the tokens of its unsharded engine. The speculative engine's
memory fence counts one rank's bytes of a sharded tree, as JAX counts one
device's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import vlm as t_vlm
from emmax_torch.serving import engine as t_engine
from emmax_torch.serving.quant import quantize_vlm_params as t_quantize
from emmax_torch.vla.tokenizer import ByteLevelTokenizer as TorchTok
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.serving.engine import GenerateOptions, ServingEngine
from emmax_tpu.serving.speculative import _spec_bf16_oom_risk
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer
from torch_gloo_pool import GlooPool

PROMPT = "In: pick up the cup\nOut:"
MAX_NEW = 8


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config(vocab_size=512)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    pixels = {name: rng.normal(size=(1, v.img_size, v.img_size, 3))
              .astype(np.float32) for name, v in cfg.vision}
    pool = GlooPool()
    yield cfg, params, jax.tree_util.tree_map(np.asarray, params), pixels, \
        pool
    pool.close()


def _jax_tokens(cfg, params, pixels):
    tok = ByteLevelTokenizer(512)
    engine = ServingEngine(cfg, params, tok,
                           options=GenerateOptions(eos_id=tok.eos_id))
    return np.asarray(engine.generate_ids(
        [PROMPT], {k: jnp.asarray(v) for k, v in pixels.items()},
        max_new_tokens=MAX_NEW)[0])


def _port_tokens(host, pixels, quantize=None):
    tparams = params_from_numpy(host)
    if quantize is not None:
        tparams = t_quantize(tparams, bits=quantize)
    tok = TorchTok(512)
    engine = t_engine.ServingEngine(
        t_vlm.tiny_vlm_config(vocab_size=512), tparams, tok,
        options=t_engine.GenerateOptions(eos_id=tok.eos_id), device="cpu")
    return engine.generate_ids([PROMPT], {k: torch.from_numpy(v)
                                          for k, v in pixels.items()},
                               max_new_tokens=MAX_NEW)[0]


@pytest.fixture(scope="module")
def unsharded(setup):
    """JAX's and the port's single-device tokens."""
    cfg, params, host, pixels, _ = setup
    return {"jax": _jax_tokens(cfg, params, pixels),
            "port": _port_tokens(host, pixels)}


@pytest.mark.parametrize("mesh_shape", [(1, 1, 8), (1, 4, 2), (1, 8, 1),
                                        (1, 1, 2)], ids=str)
def test_sharded_engine_gives_jax_tokens(setup, unsharded, mesh_shape):
    cfg, params, host, pixels, pool = setup
    mesh = make_mesh(mesh_shape,
                     devices=jax.devices()[:int(np.prod(mesh_shape))])
    want = _jax_tokens(cfg, shard_params(params, mesh), pixels)
    np.testing.assert_array_equal(want, unsharded["jax"])
    np.testing.assert_array_equal(unsharded["port"], want)
    for out in pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                        mesh_shape=mesh_shape, max_new=MAX_NEW):
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_serves_replicated(setup, bits):
    """int8 / int4 trees on (1,4,2): the quantized sub-leaves are
    replicated and the tokens are the unsharded engine's."""
    _, _, host, pixels, pool = setup
    want = _port_tokens(host, pixels, quantize=bits)
    for out in pool.run("serve", params=host, pixels=pixels, prompt=PROMPT,
                        mesh_shape=(1, 4, 2), max_new=MAX_NEW,
                        quantize=bits):
        np.testing.assert_array_equal(out, want)


def test_spec_fence_counts_one_ranks_bytes(setup):
    """A memory size the whole tree exceeds but one rank's (1,8,1) blocks
    fit: the fence trips on the whole tree and not on the sharded one, in
    JAX (one device's shard) and in the port (one rank's blocks)."""
    _, params, host, _, pool = setup
    layers = host["llm"]["layers"]
    whole = (sum(a.nbytes for a in jax.tree_util.tree_leaves(host["llm"]))
             + sum(layers[k].nbytes for k in ("wq", "wk", "wv")))
    hbm = whole / 0.95 / 2
    assert _spec_bf16_oom_risk(params, hbm_bytes=hbm)
    assert not _spec_bf16_oom_risk(
        shard_params(params, make_mesh((1, 8, 1))), hbm_bytes=hbm)
    from emmax_torch.serving.speculative import _spec_bf16_oom_risk as t_risk

    assert t_risk(params_from_numpy(host), hbm_bytes=hbm)
    assert pool.run("oom_risk", params=host, mesh_shape=(1, 8, 1),
                    hbm_bytes=hbm) == [False] * 8
