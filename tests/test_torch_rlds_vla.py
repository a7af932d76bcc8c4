"""The port's OpenVLA RLDS path and frame store against the JAX package's
(TensorFlow here): ``RLDSBatchTransform`` tokens, ``StreamingBatcher``
shards, the ``get_vla_dataset_and_collator`` stream, the EFS1 store both
ways, ``run_vla_training`` losses on the same batches (rtol 1e-4, fp32
sums in another order) and the trainer's ``--rlds_data_dir``."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorflow as tf
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.data import codec, framestore, rlds, rlds_vla
from emmax_torch.data.collators import collate_train
from emmax_torch.models import vlm as t_vlm
from emmax_torch.training import loop as t_loop
from emmax_torch.training import metrics as t_metrics
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_torch.vla import materialize
from emmax_torch.vla.action_tokenizer import ActionTokenizer
from emmax_torch.vla.solver import Solver
from emmax_torch.vla.tokenizer import ByteLevelTokenizer
from emmax_tpu.data import framestore as jframestore
from emmax_tpu.data import rlds as jrlds
from emmax_tpu.data import rlds_vla as jrlds_vla
from emmax_tpu.data.collators import collate_train as jcollate_train
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.ops.image import ImageTransformConfig as JaxTransform
from emmax_tpu.ops.image import preprocess_for_towers as j_preprocess
from emmax_tpu.training import loop as j_loop
from emmax_tpu.training import metrics as j_metrics
from emmax_tpu.training import train_state as j_state
from emmax_tpu.training import train_step as j_step
from emmax_tpu.vla import materialize as jmaterialize
from emmax_tpu.vla.action_tokenizer import ActionTokenizer as JaxAT
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer as JaxTok

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rlds_vla")
    rng = np.random.default_rng(0)
    eps = []
    for i in range(5):
        T = int(rng.integers(5, 9))
        frames = [rng.integers(0, 256, (32, 36, 3), np.uint8)
                  for _ in range(T)]
        eps.append({
            "image_bytes": [tf.io.encode_jpeg(f, quality=95).numpy()
                            for f in frames],
            "proprio": rng.normal(size=(T, 7)).astype(np.float32),
            "action": np.concatenate(
                [rng.normal(size=(T, 6)),
                 rng.choice([0.0, 1.0], size=(T, 1))], 1).astype(np.float32),
            "language": f"Put Block {i}",
            "file_path": f"bridge/raw/t{i}", "episode_id": i})
    jrlds.write_episodes(root / "bridge_orig-train-0.tfrecord", eps[:4])
    jrlds.write_episodes(root / "bridge_orig-val-0.tfrecord", eps[4:])
    return root


@pytest.fixture(scope="module")
def toks():
    jtok, ttok = JaxTok(vocab_size=1024), ByteLevelTokenizer(vocab_size=1024)
    return jtok, ttok, JaxAT(jtok), ActionTokenizer(ttok)


def _take(it, n):
    out = []
    for x in it:
        out.append(x)
        if len(out) == n:
            break
    return out


def test_batch_transform_tokens(toks):
    jtok, ttok, jat, tat = toks
    frame = {"action": np.float32([[0.1, -0.2, 0.3, 0.0, 0.5, -0.9, 1.0]]),
             "observation": {"image_primary": np.zeros((1, 4, 4, 3),
                                                       np.uint8)},
             "task": {"language_instruction": b"Open The Drawer"}}
    for stop in (True, False):
        ours = rlds_vla.RLDSBatchTransform(tat, ttok,
                                           predict_stop_token=stop)(frame)
        theirs = jrlds_vla.RLDSBatchTransform(jat, jtok,
                                              predict_stop_token=stop)(frame)
        assert ours["input_ids"] == theirs["input_ids"]
        assert ours["labels"] == theirs["labels"]
        assert ours["image"].shape == (4, 4, 3)


def test_streaming_batcher_shards():
    data = [{"i": i} for i in range(23)]
    collate = lambda s: [x["i"] for x in s]  # noqa: E731
    for n, k in ((1, 0), (3, 1), (4, 3)):
        ours = list(rlds_vla.StreamingBatcher(data, 2, collate,
                                              num_shards=n, shard_index=k))
        theirs = list(jrlds_vla.StreamingBatcher(data, 2, collate,
                                                 num_shards=n,
                                                 shard_index=k))
        assert ours == theirs and ours


def test_vla_stream_equals_jax_with_a_buffer_of_one(data_dir, toks):
    """Tokens equal; the resized frames within 1 level (the lanczos3
    weights summed in another order)."""
    jtok, ttok, jat, tat = toks
    kw = dict(shuffle_buffer_size=1, resize_resolution=(28, 28))
    ours, collate = materialize.get_vla_dataset_and_collator(
        data_dir, "bridge_orig", tat, ttok, **kw)
    theirs, _ = jmaterialize.get_vla_dataset_and_collator(
        data_dir, "bridge_orig", jat, jtok, **kw)
    n = 30                                # more than one pass (25 frames)
    o, t = _take(ours, n), _take(theirs, n)
    for a, b in zip(o, t):
        assert a["input_ids"] == b["input_ids"] and a["labels"] == b["labels"]
        assert a["dataset_name"] == b["dataset_name"] == "bridge_orig"
        assert np.abs(a["image"].astype(int) - b["image"]).max() <= 1
    batch = collate(o[:4])
    assert batch["images"].shape == (4, 28, 28, 3)
    assert ours.dataset_statistics["bridge_orig"]["num_trajectories"] == 5


def test_augmented_stream_is_seeded(data_dir, toks):
    _, ttok, _, tat = toks
    ds, _ = materialize.get_vla_dataset_and_collator(
        data_dir, "bridge_orig", tat, ttok, shuffle_buffer_size=8,
        resize_resolution=(28, 28), image_aug=True)
    plain, _ = materialize.get_vla_dataset_and_collator(
        data_dir, "bridge_orig", tat, ttok, shuffle_buffer_size=8,
        resize_resolution=(28, 28))
    a, b = _take(ds, 6), _take(ds, 6)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["image"], y["image"])
        assert x["input_ids"] == y["input_ids"]
    c = _take(plain, 6)
    assert [x["input_ids"] for x in a] == [x["input_ids"] for x in c]
    assert any(not np.array_equal(x["image"], y["image"])
               for x, y in zip(a, c))


def test_frame_store_both_ways(data_dir, tmp_path):
    ours = framestore.pack_rlds_to_framestore(data_dir, tmp_path / "o.efs")
    theirs = jframestore.pack_rlds_to_framestore(data_dir,
                                                 tmp_path / "j.efs")
    assert ours.read_bytes() == theirs.read_bytes()
    src = rlds.RLDSFrameSource(data_dir)
    store, jstore = framestore.FrameStore(ours), jframestore.FrameStore(ours)
    assert store.keys() == jstore.keys() and store.num_trajectories == 5
    for key in store.keys():
        n, w, h = store.traj_info(key)
        assert (n, w, h) == jstore.traj_info(key) and (w, h) == (36, 32)
        for i in range(n):
            got = store.get_frame(key, i)
            np.testing.assert_array_equal(got, jstore.get_frame(key, i))
            np.testing.assert_array_equal(
                got, codec.decode_jpeg(src.index[key][i], "islow"))
    keys = store.keys()[:3]
    np.testing.assert_array_equal(store.get_batch(keys, [0, 1, 2]),
                                  jstore.get_batch(keys, [0, 1, 2]))
    # a store the port writes from arrays opens in the JAX package
    w = framestore.FrameStoreWriter(tmp_path / "a.efs")
    img = np.random.default_rng(1).integers(0, 256, (24, 40, 3), np.uint8)
    w.add_trajectory_arrays("x|1", [img, img[::-1]])
    j = jframestore.FrameStore(w.finalize())
    np.testing.assert_array_equal(
        j.get_frame("x|1", 1),
        framestore.FrameStore(tmp_path / "a.efs").get_frame("x|1", 1))
    with pytest.raises(KeyError):
        store.get_frame("nope", 0)


def test_run_vla_training_matches_jax(data_dir, toks):
    jtok, ttok, jat, tat = toks
    ds, _ = materialize.get_vla_dataset_and_collator(
        data_dir, "bridge_orig", tat, ttok, shuffle_buffer_size=4,
        resize_resolution=(28, 28))
    samples = _take(ds, 12)
    batches = [collate_train(samples[i:i + 4], ttok.pad_id, pad_multiple=32)
               for i in range(0, 12, 4)]
    jbatch = jcollate_train(samples[:4], jtok.pad_id, pad_multiple=32)
    np.testing.assert_array_equal(jbatch["input_ids"],
                                  batches[0]["input_ids"])


    jcfg = j_vlm.tiny_vlm_config(vocab_size=jtok.padded_vocab_size)
    transforms = {n: JaxTransform(size=v.img_size) for n, v in jcfg.vision}
    pixel_batches = []
    for b in batches:
        out = {k: v for k, v in b.items() if k != "images"}
        out["pixel_values"] = {k: np.array(v) for k, v in j_preprocess(
            jnp.asarray(b["images"]), transforms).items()}
        pixel_batches.append(out)
    params = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg))
    kw = dict(learning_rate=1e-3, weight_decay=0.0, max_grad_norm=1.0,
              lr_scheduler_type="constant", total_steps=3,
              stage="vla-train")

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jtx, _ = j_state.make_optimizer(jparams, **kw)
    jfn = jax.jit(j_step.make_train_step(
        jcfg, jtx, attn_impl="xla", compute_dtype=jnp.float32,
        remat=True, stop_vision_gradient=True,
        action_vocab_size=jtok.vocab_size,
        freeze_mask=j_state.trainable_mask(jparams, "vla-train")))
    jm = j_metrics.VLADiscreteMetrics([])
    jstate = j_loop.run_vla_training(
        vlm_cfg=jcfg, state=j_state.create_train_state(jparams, jtx),
        train_step=jfn,
        batch_iter=iter([{k: (jax.tree_util.tree_map(jnp.asarray, v))
                          for k, v in b.items()} for b in pixel_batches]),
        metrics=jm, max_steps=3,
        loop_cfg=j_loop.LoopConfig(log_every=1))

    tcfg = t_vlm.tiny_vlm_config(vocab_size=ttok.padded_vocab_size)
    tparams = params_from_numpy(params)
    ttx, _ = t_state.make_optimizer(tparams, **kw)
    tfn = t_step.make_train_step(
        tcfg, ttx, attn_impl="cuda", compute_dtype=torch.float32,
        remat=True, stop_vision_gradient=True,
        action_vocab_size=ttok.vocab_size,
        freeze_mask=t_state.trainable_mask(tparams, "vla-train"))
    tm = t_metrics.VLADiscreteMetrics([])
    eval_fn = t_loop.make_eval_fn(tcfg, attn_impl="cuda",
                                  compute_dtype=torch.float32)
    stream = iter(pixel_batches + pixel_batches)       # more than needed
    tstate = t_loop.run_vla_training(
        vlm_cfg=tcfg, state=t_state.create_train_state(tparams, ttx),
        train_step=tfn, batch_iter=stream, metrics=tm, max_steps=3,
        loop_cfg=t_loop.LoopConfig(log_every=1, eval_every=2),
        tokenizer=ttok, solver=Solver(tat), eval_fn=eval_fn)
    assert tstate.step == int(jstate.step) == 3
    assert len(next(stream)["input_ids"]) == 4         # took 3, no more
    for key in ("loss", "grad_norm", "action_accuracy"):
        np.testing.assert_allclose(list(tm.deques[key]),
                                   list(jm.deques[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert len(tm.deques["solver_action_accuracy"]) == 1


def test_train_cli_with_rlds_frames(data_dir, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "emmax_torch.train", "--smoke_test", "true",
         "--device", "cpu", "--vla.max_steps", "2", "--eval_interval", "2",
         "--save_interval", "100", "--rlds_data_dir", str(data_dir),
         "--run_root_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = next(tmp_path.iterdir())
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert ckpts and ckpts[-1].startswith("step-000002-epoch-00-loss=")
    assert "[solver eval @ 2]" in out.stderr
