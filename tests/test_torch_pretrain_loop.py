"""Port parity: the VLM pretraining loop (``run_training``,
``run_validation``, ``CachedVisionLoader``) and the entry point
``python -m emmax_torch.pretrain`` against ``emmax_tpu`` and
``scripts/pretrain.py``, in fp32 on the CPU.

Both packages start from the same ``init_vlm_params`` weights (bridged)
and read the same split-modality batches of a mixed chat JSON (every 2nd
example text-only). Where both sides' steps compare, their frames are
JAX's normalized pixels (the two resizes differ by ~4e-5); the losses and
gradient norms are held at ``tests/test_torch_training.py``'s RTOL /
ATOL, the updated params with its OUTLIERS allowance. The JAX step runs
its XLA attention, the port's the ``FlashAttention`` path (plain on the
CPU).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import ATOL, OUTLIERS, RTOL

from emmax_torch import pretrain as t_entry
from emmax_torch.bridge import params_from_numpy
from emmax_torch.conf import parse_config as t_parse
from emmax_torch.data import collators as t_coll
from emmax_torch.data import gcot as t_gcot
from emmax_torch.data import pretrain as t_pre
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.tree import leaves_with_path
from emmax_torch.ops.image import ImageTransformConfig as TorchTransform
from emmax_torch.training import loop as t_loop
from emmax_torch.training import metrics as t_metrics
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_torch.training import vision_cache as t_vc
from emmax_torch.vla.action_tokenizer import ActionTokenizer as TorchAT
from emmax_torch.vla.solver import Solver as TorchSolver
from emmax_torch.vla.tokenizer import ByteLevelTokenizer as TorchTok
from emmax_tpu.data import collators as j_coll
from emmax_tpu.data import gcot as j_gcot
from emmax_tpu.data import pretrain as j_pre
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.ops.image import ImageTransformConfig as JaxTransform
from emmax_tpu.ops.image import preprocess_for_towers as j_preprocess
from emmax_tpu.training import loop as j_loop
from emmax_tpu.training import metrics as j_metrics
from emmax_tpu.training import train_state as j_state
from emmax_tpu.training import train_step as j_step
from emmax_tpu.training import vision_cache as j_vc
from emmax_tpu.vla.action_tokenizer import ActionTokenizer as JaxAT
from emmax_tpu.vla.solver import Solver as JaxSolver
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer as JaxTok

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
BATCH = 4       # 8 examples: one multimodal and one text-only batch an epoch


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("llava")
    j_pre.make_synthetic_chat_json(root / "chat.json", 8,
                                   image_dir=root / "img", text_only_every=2)
    tok = JaxTok(vocab_size=1024)
    cfg = j_vlm.tiny_vlm_config(vocab_size=tok.padded_vocab_size)
    params = _host(j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg))
    return root, tok, cfg, params


def _loaders(root, stage):
    """The same split-modality loader in both packages."""
    kind = "AlignDataset" if stage == "align" else "FinetuneDataset"
    out = []
    for pre, coll, tok in ((j_pre, j_coll, JaxTok(vocab_size=1024)),
                           (t_pre, t_coll, TorchTok(vocab_size=1024))):
        ds = getattr(pre, kind)(root / "chat.json", root / "img", tok)
        out.append(coll.SplitModalityLoader(
            ds, BATCH, lambda s, c=coll, t=tok: c.collate_lm(
                s, t.pad_id, pad_multiple=32), seed=3))
    return out


class _Pixels:
    """A loader's batches with the uint8 frames replaced by JAX's
    normalized pixels, as numpy."""

    def __init__(self, loader, cfg):
        self.loader = loader
        self.transforms = {n: JaxTransform(size=v.img_size)
                           for n, v in cfg.vision}

    def epoch(self, epoch=0):
        for batch in self.loader.epoch(epoch):
            out = {k: v for k, v in batch.items() if k != "images"}
            out["pixel_values"] = {k: np.array(v) for k, v in j_preprocess(
                jnp.asarray(batch["images"]), self.transforms).items()}
            yield out

    def __len__(self):
        return len(self.loader)


def _jax_run(cfg, params, stage, loader, epochs=1):
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx, schedule = j_state.make_optimizer(
        jparams, learning_rate=LR, weight_decay=0.1, max_grad_norm=1.0,
        lr_scheduler_type="linear-warmup+cosine-decay", warmup_ratio=0.34,
        total_steps=2 * epochs, stage=stage)
    step = jax.jit(j_step.make_train_step(
        cfg, tx, attn_impl="xla", remat=True, compute_dtype=jnp.float32,
        transforms={n: JaxTransform(size=v.img_size) for n, v in cfg.vision},
        stop_vision_gradient=stage == "align",
        freeze_mask=j_state.trainable_mask(jparams, stage)))
    metrics = j_metrics.Metrics([])
    state = j_loop.run_training(
        vlm_cfg=cfg, state=j_state.create_train_state(jparams, tx),
        train_step=step, loader=loader, metrics=metrics,
        loop_cfg=j_loop.LoopConfig(epochs=epochs, log_every=1),
        lr_fn=schedule)
    return state, metrics


def _port_state(cfg, params, stage, epochs=1):
    tparams = params_from_numpy(params)
    tx, schedule = t_state.make_optimizer(
        tparams, learning_rate=LR, weight_decay=0.1, max_grad_norm=1.0,
        lr_scheduler_type="linear-warmup+cosine-decay", warmup_ratio=0.34,
        total_steps=2 * epochs, stage=stage)
    tcfg = t_vlm.tiny_vlm_config(vocab_size=cfg.llm.vocab_size)
    step = t_step.make_train_step(
        tcfg, tx, attn_impl="cuda", remat=True, compute_dtype=torch.float32,
        transforms={n: TorchTransform(size=v.img_size)
                    for n, v in tcfg.vision},
        stop_vision_gradient=stage == "align",
        freeze_mask=t_state.trainable_mask(tparams, stage))
    return tcfg, t_state.create_train_state(tparams, tx), step, schedule


def _port_run(cfg, params, stage, loader, epochs=1, state=None):
    tcfg, fresh, step, schedule = _port_state(cfg, params, stage, epochs)
    metrics = t_metrics.Metrics([])
    state = t_loop.run_training(
        vlm_cfg=tcfg, state=state or fresh, train_step=step, loader=loader,
        metrics=metrics,
        loop_cfg=t_loop.LoopConfig(epochs=epochs, log_every=1),
        device="cpu", lr_fn=schedule)
    return state, metrics


def _series(metrics, key):
    return np.asarray(metrics.deques[key], np.float64)


@pytest.mark.parametrize("stage", ["align", "finetune"])
def test_run_training_matches_jax(setup, stage):
    root, _, cfg, params = setup
    jloader, tloader = _loaders(root, stage)
    jstate, jm = _jax_run(cfg, params, stage, _Pixels(jloader, cfg))
    tstate, tm = _port_run(cfg, params, stage, _Pixels(tloader, cfg))
    assert tstate.step == int(jstate.step) == 2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_series(tm, key), _series(jm, key),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    initial = dict(leaves_with_path(params_from_numpy(params)))
    want = dict(zip([p for p, _ in leaves_with_path(tstate.params)],
                    jax.tree_util.tree_leaves(_host(jstate.params))))
    for path, leaf in leaves_with_path(tstate.params):
        got = leaf.numpy()
        off = ~np.isclose(got, want[path], rtol=RTOL, atol=ATOL)
        assert off.mean() <= OUTLIERS, (path, off.sum())
        np.testing.assert_allclose(got, want[path], rtol=0, atol=2 * LR,
                                   err_msg=path)
        trained = path.startswith("projector") or (
            stage == "finetune" and path.startswith("llm"))
        assert torch.equal(leaf, initial[path]) != trained, path


def _content_misses(loader, epochs):
    """The batches that hold an image the earlier ones did not: the
    encodes a content-keyed cache makes."""
    seen, misses = set(), 0
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            keys = {t_vc.CachedVisionLoader.key(r) for r in batch["images"]}
            misses += bool(keys - seen)
            seen |= keys
    return misses


def test_cached_vision_loader_matches_uncached_and_jax(setup):
    root, _, cfg, params = setup
    jloader, tloader = _loaders(root, "align")
    transforms = {n: TorchTransform(size=v.img_size) for n, v in cfg.vision}
    tcfg = t_vlm.tiny_vlm_config(vocab_size=cfg.llm.vocab_size)
    # uncached: the step runs the towers on the uint8 frames
    _, plain = _port_run(cfg, params, "align", tloader, epochs=2)

    _, state, _, _ = _port_state(cfg, params, "align", epochs=2)
    cached = t_vc.CachedVisionLoader(tloader, state.params, tcfg, transforms,
                                     attn_impl="cuda",
                                     compute_dtype=torch.float32)
    for (_, a), (_, b) in zip(leaves_with_path(cached.vision),
                              leaves_with_path(state.params["vision"])):
        assert a.data_ptr() == b.data_ptr()       # no copy of the towers
    state, got = _port_run(cfg, params, "align", cached, epochs=2,
                           state=state)
    np.testing.assert_array_equal(_series(got, "loss"),
                                  _series(plain, "loss"))
    np.testing.assert_array_equal(_series(got, "grad_norm"),
                                  _series(plain, "grad_norm"))
    # one encode per batch with a new image (the text-only rows' zero
    # frames share one key); epoch 1 hits only
    assert cached.encodes == _content_misses(tloader, 1) == \
        _content_misses(tloader, 2) == 2
    assert len(cached._store) == 5
    assert cached.nbytes == 5 * tcfg.num_patches * tcfg.vision_dim * 4

    jcached = j_vc.CachedVisionLoader(
        jloader, jax.tree_util.tree_map(jnp.asarray, params), cfg,
        {n: JaxTransform(size=v.img_size) for n, v in cfg.vision},
        compute_dtype=jnp.float32)
    _, jm = _jax_run(cfg, params, "align", jcached, epochs=2)
    assert jcached.encodes == cached.encodes
    assert list(jcached._store) == list(cached._store)
    np.testing.assert_allclose(_series(got, "loss"), _series(jm, "loss"),
                               rtol=RTOL, atol=ATOL)

    cached.release_towers()
    for _ in cached.epoch(2):                      # hits only: no towers
        pass
    assert cached.encodes == 2

    class Perturbed:
        def epoch(self, epoch):
            batch = next(iter(tloader.epoch(0)))
            batch["images"] = batch["images"].copy()
            batch["images"][0, 0, 0, 0] ^= 1
            yield batch

    cached.loader = Perturbed()
    with pytest.raises(RuntimeError, match="release_towers"):
        list(cached.epoch(0))


def test_cached_vision_loader_evicts_oldest_as_jax(setup):
    root, _, cfg, params = setup
    jloader, tloader = _loaders(root, "align")
    transforms = {n: TorchTransform(size=v.img_size) for n, v in cfg.vision}
    got = t_vc.CachedVisionLoader(
        tloader, params_from_numpy(params),
        t_vlm.tiny_vlm_config(vocab_size=cfg.llm.vocab_size), transforms,
        attn_impl="cuda", compute_dtype=torch.float32, capacity=2)
    want = j_vc.CachedVisionLoader(
        jloader, jax.tree_util.tree_map(jnp.asarray, params), cfg,
        {n: JaxTransform(size=v.img_size) for n, v in cfg.vision},
        compute_dtype=jnp.float32, capacity=2)
    for epoch in (0, 1):
        for g, w in zip(got.epoch(epoch), want.epoch(epoch)):
            np.testing.assert_allclose(
                g["pixel_values"]["tower_features"].numpy(),
                np.asarray(w["pixel_values"]["tower_features"]),
                rtol=1e-3, atol=1e-4)
            assert list(got._store) == list(want._store)
            assert len(got._store) <= 2
        assert got.encodes == want.encodes
    assert got.evicted > 0 and got.encodes > 2     # epoch 1 missed again


def test_run_validation_matches_jax(setup, tmp_path):
    _, _, _, _ = setup
    tok, ttok = JaxTok(2048), TorchTok(2048)
    cfg = j_vlm.tiny_vlm_config(2112)
    params = _host(j_vlm.init_vlm_params(jax.random.PRNGKey(1), cfg))
    items = j_gcot.make_dummy_gcot_items(4)
    loaders = []
    for gcot, coll, at, tk in ((j_gcot, j_coll, JaxAT(tok), tok),
                               (t_gcot, t_coll, TorchAT(ttok), ttok)):
        ds = gcot.GCOTDataset(items, at, tk, gcot.SyntheticFrameSource(32),
                              data_mix="movement_policy", mask_inst=True)
        loaders.append(_Pixels(coll.BatchLoader(
            ds, 2, lambda s, c=coll, t=tk: c.collate_train(
                s, t.pad_id, pad_multiple=32), shuffle=False), cfg))
    want = j_loop.run_validation(
        vlm_cfg=cfg, params=jax.tree_util.tree_map(jnp.asarray, params),
        eval_fn=j_loop.make_eval_fn(cfg, compute_dtype=jnp.float32),
        loader=loaders[0], tokenizer=tok, solver=JaxSolver(JaxAT(tok)),
        run_dir=tmp_path / "jax", epoch=3)
    tcfg = t_vlm.tiny_vlm_config(2112)
    got = t_loop.run_validation(
        vlm_cfg=tcfg, params=params_from_numpy(params),
        eval_fn=t_loop.make_eval_fn(tcfg, attn_impl="cuda",
                                    compute_dtype=torch.float32),
        loader=loaders[1], tokenizer=ttok, solver=TorchSolver(TorchAT(ttok)),
        run_dir=tmp_path / "port", epoch=3)
    assert got == want and got["n"] == 4
    name = Path("validation_results") / "epoch_3_0.json"
    blob = json.loads((tmp_path / "port" / name).read_text())
    assert blob == json.loads((tmp_path / "jax" / name).read_text())
    assert "POLICIES" in blob["records"][0]["ground_truth"]


@pytest.fixture(scope="module", autouse=True)
def jax_script_run(tmp_path_factory):
    """``scripts/pretrain.py --smoke_test true --stage align``, started in
    the background when the module begins (its JAX compiles take most of
    a minute) and awaited by the entry test."""
    root = tmp_path_factory.mktemp("jax_pretrain")
    with open(root / "log.txt", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "scripts/pretrain.py", "--smoke_test", "true",
             "--stage", "align", "--run_root_dir", str(root / "runs")],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    try:
        yield proc, root
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _layout(run_dir):
    """Top-level names and checkpoint names without the loss."""
    return (sorted(p.name for p in run_dir.iterdir()),
            sorted(p.name.split("-loss=")[0]
                   for p in (run_dir / "checkpoints").iterdir()))


def test_pretrain_entry_runs_both_stages_like_the_jax_script(
        tmp_path, jax_script_run):
    from emmax_torch.models.load import load_run_params


    out = subprocess.run(
        [sys.executable, "-m", "emmax_torch.pretrain", "--smoke_test", "true",
         "--device", "cpu", "--stage", "align", "--run_root_dir",
         str(tmp_path / "port")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    proc, jax_root = jax_script_run
    assert proc.wait(timeout=600) == 0, (jax_root / "log.txt").read_text()
    want_dir = jax_root / "runs" / "prism-dinosiglip-224px+7b+stage-align+x7"
    align_dir = tmp_path / "port" / want_dir.name
    assert _layout(align_dir) == _layout(want_dir) == (
        ["checkpoints", "config.json"], ["step-000002-epoch-00"])
    got, want = (json.loads((d / "config.json").read_text())
                 for d in (align_dir, want_dir))
    assert got.keys() == want.keys()
    assert (got["stage"], got["run_id"]) == (want["stage"], want["run_id"])
    assert (got["model"]["vision_backbone_id"],
            want["model"]["model_id"]) == ("tiny", "prism-dinosiglip-224px+7b")
    assert "examples seen: 16 multimodal / 0 text-only" in out.stderr

    # the finetune stage from the align run dir, in process
    cfg = t_parse(t_entry.PretrainConfig,
                  ["--smoke_test", "true", "--device", "cpu", "--stage",
                   "finetune", "--run_root_dir", str(tmp_path / "port"),
                   "--pretrained_checkpoint", str(align_dir)],
                  choice_fields={"model": t_entry.ModelConfig,
                                 "dataset": t_entry.DatasetConfig})
    built = t_entry.build(cfg)
    (ckpt,) = (align_dir / "checkpoints").iterdir()
    for (p, a), (_, b) in zip(leaves_with_path(built.state.params),
                              leaves_with_path(load_run_params(ckpt))):
        assert torch.equal(a, b), p
    state = t_entry.run(built)
    assert state.step == 2
    assert _layout(tmp_path / "port" / "prism-dinosiglip-224px+7b+stage-"
                   "finetune+x7")[1] == ["step-000002-epoch-00"]


def test_pretrain_entry_cache_vision_and_device(tmp_path, monkeypatch):
    """``--cache_vision`` changes no value of the align stage and lets go of
    the towers after an epoch that encoded every sample; without
    ``--device cpu`` the entry raises on a machine with no card."""
    states = []
    for cache in (False, True):
        built = t_entry.build(t_entry.PretrainConfig(
            stage="align", smoke_test=True, device="cpu",
            cache_vision=cache, run_root_dir=tmp_path / str(cache)))
        states.append(t_entry.run(built))
    assert built.cache.encodes == 2 and built.cache.vision is None
    assert built.cache.evicted == 0
    assert built.cache.capacity == t_entry.VISION_CACHE_HOST_BYTES // (
        built.vlm_cfg.num_patches * built.vlm_cfg.vision_dim * 4)
    for (p, a), (_, b) in zip(leaves_with_path(states[0].params),
                              leaves_with_path(states[1].params)):
        assert torch.equal(a, b), p

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_entry.build(t_entry.PretrainConfig(
            stage="align", smoke_test=True, run_root_dir=tmp_path / "gpu"))
