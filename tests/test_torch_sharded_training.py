"""The port's sharded train step on 8 gloo ranks against ``emmax_tpu``'s
sharded step on the same mesh (JAX's 8 virtual CPU devices), mirroring
``tests/test_sharding_training.py``.

The tolerance is JAX's own for its sharded-vs-single-device parity: loss
``atol 5e-5``, grad norm ``rtol 2e-4, atol 1e-5``. The main batch gives
each row its own number of labels, so a loss that averaged the ranks'
means instead of dividing the global sum by the global count would miss.
Params come from the ``emmax_tpu`` initializer, bridged; fp32; the port's
workers import no JAX (``torch_gloo_pool``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import vlm as t_vlm
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_tpu.models.llama import IGNORE_INDEX
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from emmax_tpu.parallel import make_mesh, shard_params
from emmax_tpu.parallel.sharding import shard_batch
from emmax_tpu.training.train_state import create_train_state, make_optimizer
from emmax_tpu.training.train_step import jit_train_step, make_train_step
from torch_gloo_pool import GlooPool

LOSS_ATOL = 5e-5
GNORM_RTOL, GNORM_ATOL = 2e-4, 1e-5
MESHES = [(1, 8, 1), (1, 4, 2), (2, 2, 2), (2, 4, 1)]
OUTLIERS = 5e-4   # share of a leaf's entries that may sit off 1e-4 / 1e-6


def _make_batch(cfg, rng, B=8, L=12, ragged=False):
    """``tests/test_sharding_training.py``'s batch as numpy; ``ragged``
    masks a different number of leading labels in each row."""
    ids = rng.integers(3, cfg.llm.vocab_size, size=(B, L))
    ids[:, 0] = 1
    labels = ids.copy()
    for b in range(B):
        labels[b, :(2 + b % 7) if ragged else 4] = IGNORE_INDEX
    pixels = {name: rng.normal(size=(B, v.img_size, v.img_size, 3))
              .astype(np.float32) for name, v in cfg.vision}
    return {"input_ids": ids, "attention_mask": np.ones((B, L), bool),
            "labels": labels, "pixel_values": pixels}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_vlm_config()
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    pool = GlooPool()
    yield cfg, params, jax.tree_util.tree_map(np.asarray, params), pool
    pool.close()


@pytest.fixture(scope="module")
def unwrapped(setup):
    """The port's unwrapped step on the main (ragged) batch, per remat
    policy, shared by the mesh cases."""
    _, _, host, _ = setup
    batch = _make_batch(tiny_vlm_config(), np.random.default_rng(0),
                        ragged=True)
    return batch, {remat: _port_unwrapped(host, batch, remat)[0][0]
                   for remat in (True, "dots")}


def _jax_step(cfg, params, host_batch, mesh_shape, remat, accum=1):
    """``tests/test_sharding_training.py``'s ``one_step``."""
    mesh = make_mesh(mesh_shape,
                     devices=jax.devices()[:int(np.prod(mesh_shape))])
    sparams = shard_params(params, mesh)
    tx, _ = make_optimizer(sparams, learning_rate=1e-3, weight_decay=0.0,
                           max_grad_norm=1.0, lr_scheduler_type="constant",
                           total_steps=10, stage="vla-full-train")
    step = jit_train_step(make_train_step(cfg, tx, remat=remat,
                                          compute_dtype=jnp.float32,
                                          grad_accum_steps=accum),
                          mesh=mesh, donate=False)
    _, m = step(create_train_state(sparams, tx), shard_batch(host_batch,
                                                             mesh))
    return float(m["loss"]), float(m["grad_norm"])


def _port_unwrapped(host, batch, remat, accum=1, steps=1,
                    stage="vla-full-train", ce_chunk=None):
    """The port's single-process step (no mesh), in the test process."""
    cfg = t_vlm.tiny_vlm_config()
    params = params_from_numpy(host)
    tx, _ = t_state.make_optimizer(params, learning_rate=1e-3,
                                   weight_decay=0.0, max_grad_norm=1.0,
                                   lr_scheduler_type="constant",
                                   total_steps=10, stage=stage)
    step = t_step.make_train_step(
        cfg, tx, remat=remat, compute_dtype=torch.float32,
        grad_accum_steps=accum, ce_chunk=ce_chunk,
        freeze_mask=t_state.trainable_mask(params, stage))
    state = t_state.create_train_state(params, tx)
    b = {k: ({n: torch.from_numpy(a) for n, a in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in batch.items()}
    out = []
    for _ in range(steps):
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return out, state.params


def _same_on_every_rank(results):
    first = results[0]["metrics"]
    for r in results[1:]:
        assert r["metrics"] == first
    return first


@pytest.mark.parametrize("remat", [True, "dots"], ids=["full", "dots"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_sharded_step_matches_jax_sharded_step(setup, unwrapped, mesh_shape,
                                               remat):
    """One step on the mesh: every rank reports the global loss and grad
    norm, equal to JAX's sharded step on the same mesh and to the port's
    unwrapped step, within JAX's tolerance."""
    cfg, params, host, pool = setup
    batch, refs = unwrapped
    jax_loss, jax_gnorm = _jax_step(cfg, params, batch, mesh_shape, remat)
    m = _same_on_every_rank(pool.run("train_steps", params=host, batch=batch,
                                     mesh_shape=mesh_shape, remat=remat))[0]
    ref = refs[remat]
    for want_loss, want_gnorm in ((jax_loss, jax_gnorm),
                                  (ref["loss"], ref["grad_norm"])):
        np.testing.assert_allclose(m["loss"], want_loss, rtol=0,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(m["grad_norm"], want_gnorm,
                                   rtol=GNORM_RTOL, atol=GNORM_ATOL)
    for k in ("action_accuracy", "action_l1"):
        assert m[k] == pytest.approx(ref[k], abs=1e-6)


def test_grad_accum_under_mesh_matches_full_batch(setup):
    """Two accumulated micro-batches on (1,4,2) against the full batch in
    one step (JAX's single-device step and the port's unwrapped one).
    Each rank takes its micro-batches from its own rows, so the batch has
    8 rows (2 a data rank) where JAX's test has 4, and every row the same
    number of labels, as in JAX's test: the micro-batch split then cannot
    change the step."""
    cfg, params, host, pool = setup
    batch = _make_batch(cfg, np.random.default_rng(3))
    jax_loss, jax_gnorm = _jax_step(cfg, params, batch, (1, 1, 1), True)
    m = _same_on_every_rank(pool.run("train_steps", params=host, batch=batch,
                                     mesh_shape=(1, 4, 2), accum=2))[0]
    ref = _port_unwrapped(host, batch, True)[0][0]
    for want_loss, want_gnorm in ((jax_loss, jax_gnorm),
                                  (ref["loss"], ref["grad_norm"])):
        np.testing.assert_allclose(m["loss"], want_loss, rtol=0,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(m["grad_norm"], want_gnorm,
                                   rtol=GNORM_RTOL, atol=GNORM_ATOL)


@pytest.mark.parametrize("stage", ["vla-train", "vla-last-layer-train"])
def test_frozen_leaves_unchanged_and_updates_match_unwrapped(setup, stage):
    """On (2,2,2), with weight decay: frozen leaves (the towers; every
    decoder layer but the last) come back bit for bit, trainable ones
    move, and the updated params equal the port's unwrapped step's."""
    cfg, params, host, pool = setup
    batch = _make_batch(cfg, np.random.default_rng(2), ragged=True)
    res = pool.run("train_steps", params=host, batch=batch,
                   mesh_shape=(2, 2, 2), stage=stage, weight_decay=0.1,
                   return_params=True)
    got = res[0]["params"]
    wqkv = host["vision"]["dino"]["blocks"]["wqkv"]
    np.testing.assert_array_equal(got["vision"]["dino"]["blocks"]["wqkv"],
                                  wqkv)
    wq0, wq1 = host["llm"]["layers"]["wq"], got["llm"]["layers"]["wq"]
    if stage == "vla-last-layer-train":
        np.testing.assert_array_equal(wq1[:-1], wq0[:-1])
    assert not np.array_equal(wq1[-1], wq0[-1])
    cfg_t = t_vlm.tiny_vlm_config()
    params_t = params_from_numpy(host)
    tx, _ = t_state.make_optimizer(params_t, learning_rate=1e-3,
                                   weight_decay=0.1, max_grad_norm=1.0,
                                   lr_scheduler_type="constant",
                                   total_steps=10, stage=stage)
    step = t_step.make_train_step(
        cfg_t, tx, remat=True, compute_dtype=torch.float32,
        freeze_mask=t_state.trainable_mask(params_t, stage))
    state = t_state.create_train_state(params_t, tx)
    state, _ = step(state, {k: ({n: torch.from_numpy(a)
                                 for n, a in v.items()}
                                if isinstance(v, dict)
                                else torch.from_numpy(v))
                            for k, v in batch.items()})
    want = jax.tree_util.tree_map(lambda t: t.numpy(), state.params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        # Adam's first step is about lr * sign(g): an entry whose gradient
        # is near 0 turns the gradients' ~1e-7 difference (sums in another
        # order) into up to one lr, as in test_torch_training.py; a fault
        # would move most entries
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.sum() <= max(1, OUTLIERS * off.size), off.sum()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_sharded_steps_learn_and_chunked_ce_matches(setup):
    """Three steps on one batch on (1,8,1): the loss falls and each step
    equals the port's unwrapped step; the chunked CE path (chunk 5, not a
    divisor of the fused length) gives the full-logits loss on (1,4,2)."""
    cfg, params, host, pool = setup
    batch = _make_batch(cfg, np.random.default_rng(1), ragged=True)
    got = _same_on_every_rank(pool.run("train_steps", params=host,
                                       batch=batch, mesh_shape=(1, 8, 1),
                                       steps=3))
    ref = _port_unwrapped(host, batch, True, steps=3)[0]
    assert got[2]["loss"] < got[1]["loss"] < got[0]["loss"]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=0,
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=GNORM_RTOL, atol=GNORM_ATOL)
    chunked = _same_on_every_rank(pool.run(
        "train_steps", params=host, batch=batch, mesh_shape=(1, 4, 2),
        ce_chunk=5))[0]
    assert chunked["loss"] == pytest.approx(got[0]["loss"], rel=1e-6)
    for k in ("action_accuracy", "action_l1", "grad_norm"):
        assert chunked[k] == pytest.approx(ref[0][k], rel=1e-5, abs=1e-7)


def test_checkpoint_save_and_restore_under_mesh(setup, tmp_path):
    """On (2,2,2): rank 0 writes the gathered tree, every rank restores
    its blocks; both equal the live state exactly."""
    cfg, params, host, pool = setup
    batch = _make_batch(cfg, np.random.default_rng(4))
    res = pool.run("checkpoint_round_trip", params=host, batch=batch,
                   mesh_shape=(2, 2, 2), run_dir=str(tmp_path))
    for r in res:
        assert r["restore_absdiff"] == 0.0 and r["file_absdiff"] == 0.0
        assert r["step"] == 1 and r["loss"] == res[0]["loss"]
    assert len(list((tmp_path / "checkpoints").iterdir())) == 1
