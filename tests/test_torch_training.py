"""Port parity: the training path (``emmax_torch.training``,
``emmax_torch.data``, ``emmax_torch.train``) against ``emmax_tpu``'s, in
fp32 on the CPU.

Both packages start from the same ``init_vlm_params`` weights (bridged)
and the same GCOT batches, whose frames JAX's ``preprocess_for_towers``
normalizes once for both; each runs its own train step (the decoder under
full remat) for 3 steps of a freeze stage, and the losses, gradient
norms, action metrics and updated params are held together at rtol 1e-4
(atol 1e-6 for entries near zero): fp32, sums in another order. The JAX
step runs its XLA attention; the port's runs the flash ``FlashAttention``
path, whose CPU version is the plain forward and backward. The port's
own uint8-frame path through the step is held to its pre-normalized one
(the port's resize is held to JAX's in ``test_torch_vision.py``).
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

from emmax_torch.bridge import params_from_numpy
from emmax_torch.data import collators as t_coll
from emmax_torch.data import gcot as t_gcot
from emmax_torch.models import llama as t_llama
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.tree import leaves_with_path
from emmax_torch.ops.image import ImageTransformConfig as TorchTransform
from emmax_torch.training import train_state as t_state
from emmax_torch.training import train_step as t_step
from emmax_torch.vla.action_tokenizer import ActionTokenizer as TorchAT
from emmax_torch.vla.tokenizer import ByteLevelTokenizer as TorchTok
from emmax_tpu.data import collators as j_coll
from emmax_tpu.data import gcot as j_gcot
from emmax_tpu.models import llama as j_llama
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.ops.image import ImageTransformConfig as JaxTransform
from emmax_tpu.ops.image import preprocess_for_towers as j_preprocess
from emmax_tpu.training import train_state as j_state
from emmax_tpu.training import train_step as j_step
from emmax_tpu.vla.action_tokenizer import ActionTokenizer as JaxAT
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer as JaxTok

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-6
LR = 1e-3
OUTLIERS = 5e-4   # share of a leaf's entries that may sit off RTOL / ATOL
STEPS = 3
BATCH = 4


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(tree):
    return [(p, leaf.detach().numpy()) for p, leaf in leaves_with_path(tree)]


@pytest.fixture(scope="module")
def setup():
    tok = JaxTok(vocab_size=1024)
    cfg = j_vlm.tiny_vlm_config(vocab_size=tok.padded_vocab_size)
    items = j_gcot.make_dummy_gcot_items(16)
    frames = j_gcot.SyntheticFrameSource(32)
    ds = j_gcot.GCOTDataset(items, JaxAT(tok), tok, frames,
                            data_mix="movement_policy", mask_inst=True)
    loader = j_coll.BatchLoader(
        ds, BATCH, lambda s: j_coll.collate_train(s, tok.pad_id,
                                                  pad_multiple=32), seed=3)
    batches = list(loader.epoch(0))[:STEPS]
    params = _host(j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg))
    return tok, cfg, items, batches, params


def _with_pixels(batch, cfg):
    """The batch with its uint8 frames replaced by the towers' normalized
    pixels (JAX's preprocessing), as numpy."""
    transforms = {n: JaxTransform(size=v.img_size) for n, v in cfg.vision}
    out = {k: v for k, v in batch.items() if k != "images"}
    out["pixel_values"] = {k: np.array(v) for k, v in j_preprocess(
        jnp.asarray(batch["images"]), transforms).items()}
    return out


def _to(batch, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def _torch_cfg(cfg):
    return t_vlm.tiny_vlm_config(vocab_size=cfg.llm.vocab_size)


def test_port_batches_equal_jax_batches(setup):
    tok, cfg, items, batches, _ = setup
    ttok = TorchTok(vocab_size=1024)
    ds = t_gcot.GCOTDataset(items, TorchAT(ttok), ttok,
                            t_gcot.SyntheticFrameSource(32),
                            data_mix="movement_policy", mask_inst=True)
    loader = t_coll.BatchLoader(
        ds, BATCH, lambda s: t_coll.collate_train(s, ttok.pad_id,
                                                  pad_multiple=32), seed=3)
    got = list(loader.epoch(0))[:STEPS]
    assert len(got) == len(batches) == STEPS and len(loader) == 4
    for g, w in zip(got, batches):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    val = [t_gcot.GCOTDataset(items, TorchAT(ttok), ttok,
                              t_gcot.SyntheticFrameSource(32),
                              split="val")[i] for i in range(3)]
    jval = [j_gcot.GCOTDataset(items, JaxAT(tok), tok,
                               j_gcot.SyntheticFrameSource(32),
                               split="val")[i] for i in range(3)]
    g, w = t_coll.collate_val(val, ttok.pad_id), j_coll.collate_val(
        jval, tok.pad_id)
    for k in ("input_ids", "attention_mask", "images"):
        np.testing.assert_array_equal(g[k], w[k])
    assert g["labels"] == w["labels"]
    for mix in t_gcot.DATA_MIXES:
        assert t_gcot.assemble_gcot_text(items[1], mix, TorchAT(ttok)) == \
            j_gcot.assemble_gcot_text(items[1], mix, JaxAT(tok))


@pytest.mark.parametrize("kind,lr,total,warmup", [
    ("constant", 3e-4, 10, 0.03),
    ("linear-warmup+cosine-decay", 1e-3, 20, 0.2),
    ("linear-warmup+cosine-decay", 2e-5, 7, 0.03)])
def test_schedules_match_optax(kind, lr, total, warmup):
    want = j_state.make_schedule(kind, lr, total, warmup)
    got = t_state.make_schedule(kind, lr, total, warmup)
    for step in range(total + 3):   # optax evaluates in fp32
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12)


# (stage, schedule, weight decay, max grad norm, grad accumulation, ce_chunk)
STAGES = [
    ("align", "constant", 0.0, 1.0, 1, None),
    ("vla-train", "linear-warmup+cosine-decay", 0.1, 0.5, 1, 16),
    ("vla-last-layer-train", "constant", 0.1, 1.0, 1, None),
    ("vla-train", "constant", 0.0, 1.0, 2, None),
    ("vla-full-train", "constant", 0.0, 1.0, 1, None),
]


@pytest.mark.parametrize("stage,sched,wd,clip,accum,ce_chunk", STAGES,
                         ids=[f"{s[0]}-accum{s[4]}" for s in STAGES])
def test_train_step_matches_jax(setup, stage, sched, wd, clip, accum,
                                ce_chunk):
    tok, cfg, _, batches, params_np = setup
    freeze_vision = stage != "vla-full-train"
    kw = dict(learning_rate=LR, weight_decay=wd, max_grad_norm=clip,
              lr_scheduler_type=sched, total_steps=6, warmup_ratio=0.34,
              stage=stage)
    step_kw = dict(remat=True, stop_vision_gradient=freeze_vision,
                   action_vocab_size=tok.vocab_size,
                   grad_accum_steps=accum, ce_chunk=ce_chunk)
    pixel_batches = [_with_pixels(b, cfg) for b in batches]

    # --- JAX ---
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jtx, _ = j_state.make_optimizer(jparams, **kw)
    jstate = j_state.create_train_state(jparams, jtx)
    jfn = jax.jit(j_step.make_train_step(
        cfg, jtx, attn_impl="xla", compute_dtype=jnp.float32,
        freeze_mask=j_state.trainable_mask(jparams, stage), **step_kw))
    jmetrics = []
    for b in pixel_batches:
        jstate, m = jfn(jstate, _to(b, jnp.asarray))
        jmetrics.append({k: float(v) for k, v in m.items()})

    # --- port ---
    tparams = params_from_numpy(params_np)
    initial = {p: a.copy() for p, a in _leaves_np(tparams)}
    ttx, _ = t_state.make_optimizer(tparams, **kw)
    tstate = t_state.create_train_state(tparams, ttx)
    tfn = t_step.make_train_step(
        _torch_cfg(cfg), ttx, attn_impl="cuda", compute_dtype=torch.float32,
        freeze_mask=t_state.trainable_mask(tparams, stage), **step_kw)
    for i, b in enumerate(pixel_batches):
        tstate, m = tfn(tstate, _to(b, torch.from_numpy))
        for k, want in jmetrics[i].items():
            np.testing.assert_allclose(float(m[k]), want, rtol=RTOL,
                                       atol=ATOL, err_msg=f"step {i} {k}")
    assert tstate.step == STEPS and tstate.opt_state["count"] == STEPS

    want = dict(zip([p for p, _ in leaves_with_path(tstate.params)],
                    jax.tree_util.tree_leaves(_host(jstate.params))))
    for path, got in _leaves_np(tstate.params):
        # The gradients agree to ~5e-7 of each leaf's largest entry (fp32
        # sums in another order), but Adam moves an entry by about
        # lr * m / sqrt(v) whatever its size: an entry whose gradient sits
        # near that noise (~1e-9) moves by a noisy fraction of lr. So a
        # few entries in 1e4 are held only to the most Adam can move them
        # (lr per step); a fault in the optimizer would move most entries.
        off = ~np.isclose(got, want[path], rtol=RTOL, atol=ATOL)
        assert off.mean() <= OUTLIERS, (path, off.sum())
        np.testing.assert_allclose(got, want[path], rtol=0,
                                   atol=STEPS * LR, err_msg=path)
        if path.startswith("vision") and freeze_vision:
            np.testing.assert_array_equal(got, initial[path])
    if not freeze_vision:
        # the towers are trained: every leaf the features use moves; the
        # final norms stay (the feature contract applies none)
        for path, got in _leaves_np(tstate.params):
            if path.startswith("vision"):
                used = "final_norm" not in path
                assert np.array_equal(got, initial[path]) != used, path
    if stage == "vla-last-layer-train":
        for path, got in _leaves_np(tstate.params):
            if path.startswith("llm/layers"):  # frozen layers: untouched,
                np.testing.assert_array_equal(got[:-1],   # not decayed
                                              initial[path][:-1])
                assert not np.array_equal(got[-1], initial[path][-1])
    if stage == "align":
        for path, got in _leaves_np(tstate.params):
            if not path.startswith("projector"):
                np.testing.assert_array_equal(got, initial[path])


def test_train_step_preprocesses_uint8_frames(setup):
    """uint8 frames with ``transforms`` give the step what the port's own
    preprocessing, cast to the compute dtype, gives it."""
    from emmax_torch.ops.image import preprocess_for_towers

    tok, cfg, _, batches, params_np = setup
    tcfg = _torch_cfg(cfg)
    transforms = {n: TorchTransform(size=v.img_size) for n, v in tcfg.vision}
    batch = _to(batches[0], torch.from_numpy)
    pixels = {k: v for k, v in batch.items() if k != "images"}
    pixels["pixel_values"] = preprocess_for_towers(batch["images"],
                                                   transforms)
    results = []
    for b in (batch, pixels):
        params = params_from_numpy(params_np)
        tx, _ = t_state.make_optimizer(
            params, learning_rate=1e-3, weight_decay=0.1, max_grad_norm=1.0,
            lr_scheduler_type="constant", total_steps=2, stage="vla-train")
        fn = t_step.make_train_step(
            tcfg, tx, attn_impl="cuda", remat="dots",
            compute_dtype=torch.float32, transforms=transforms,
            freeze_mask=t_state.trainable_mask(params, "vla-train"),
            action_vocab_size=tok.vocab_size)
        state, m = fn(t_state.create_train_state(params, tx), b)
        results.append({k: float(v) for k, v in m.items()})
    for k in results[0]:   # the CPU's embedding backward sums in no
        np.testing.assert_allclose(results[0][k], results[1][k],  # set order
                                   rtol=1e-6)


def test_remat_policies_give_the_same_gradients():
    cfg = t_vlm.tiny_vlm_config(vocab_size=256).llm
    params = t_llama.init_llama_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    embeds = torch.from_numpy(
        rng.standard_normal((2, 20, cfg.dim)).astype(np.float32))
    mask = torch.ones(2, 20, dtype=torch.bool)
    mask[1, 15:] = False
    labels = torch.from_numpy(rng.integers(0, 256, (2, 20)))
    grads = []
    for remat in ("none", "full", "dots"):
        w = params["layers"]["wq"].clone().requires_grad_()
        p = {**params, "layers": {**params["layers"], "wq": w}}
        logits, _ = t_llama.llama_forward(p, cfg, embeds, mask=mask,
                                          remat=remat, attn_impl="cuda")
        t_llama.cross_entropy_loss(logits, labels).backward()
        grads.append(w.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grads[2], grads[0], rtol=1e-6, atol=1e-7)


def test_chunked_ce_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 37, 16)).astype(np.float32)
    head = rng.standard_normal((16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 37)).astype(np.int32)
    labels[:, :5] = -100
    jl, jp = j_llama.chunked_ce_loss_and_preds(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(labels), chunk=8)
    th = torch.from_numpy(h).requires_grad_()
    tl, tp = t_llama.chunked_ce_loss_and_preds(
        th, torch.from_numpy(head), torch.from_numpy(labels), chunk=8)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    full = t_llama.cross_entropy_loss(torch.from_numpy(h) @ torch.from_numpy(
        head), torch.from_numpy(labels))
    np.testing.assert_allclose(float(full), float(jl), rtol=1e-6)
    tl.backward()
    jg = jax.grad(lambda x: j_llama.chunked_ce_loss_and_preds(
        x, jnp.asarray(head), jnp.asarray(labels), chunk=8)[0])(
        jnp.asarray(h))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_fuse_multimodal_with_labels_and_text_only_rows():
    rng = np.random.default_rng(2)
    B, L, P, D = 3, 6, 4, 8
    patches = rng.standard_normal((B, P, D)).astype(np.float32)
    text = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1],
                     [1, 1, 1, 0, 0, 0]], bool)
    labels = rng.integers(0, 100, (B, L)).astype(np.int32)
    labels[~mask] = -100
    mm = np.array([True, False, True])
    want = j_vlm.fuse_multimodal(jnp.asarray(patches), jnp.asarray(text),
                                 jnp.asarray(mask), jnp.asarray(labels),
                                 multimodal_mask=jnp.asarray(mm))
    got = t_vlm.fuse_multimodal(torch.from_numpy(patches),
                                torch.from_numpy(text),
                                torch.from_numpy(mask),
                                torch.from_numpy(labels),
                                multimodal_mask=torch.from_numpy(mm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_text_forward_matches_jax(setup):
    tok, cfg, _, _, params_np = setup
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 1024, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    labels = np.where(mask, ids, -100).astype(np.int32)
    jl, jloss = j_vlm.text_forward(
        jax.tree_util.tree_map(jnp.asarray, params_np), cfg,
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
    tl, tloss = t_vlm.text_forward(params_from_numpy(params_np),
                                   _torch_cfg(cfg), torch.from_numpy(ids),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(labels), remat="full")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_prefetching_loader_yields_tensors_in_order(setup):
    from emmax_torch.data.prefetch import PrefetchingLoader

    _, _, _, batches, _ = setup

    class Loader:
        def epoch(self, e):
            yield from batches

        def __len__(self):
            return len(batches)

    got = list(PrefetchingLoader(Loader(), "cpu").epoch(0))
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])

    class Broken:
        def epoch(self, e):
            yield batches[0]
            raise RuntimeError("bad record")

    with pytest.raises(RuntimeError, match="bad record"):
        list(PrefetchingLoader(Broken(), "cpu").epoch(0))


def test_action_token_metrics_match_jax():
    rng = np.random.default_rng(3)
    vocab = 1024
    logits = rng.standard_normal((2, 30, 1088)).astype(np.float32)
    labels = rng.integers(700, 1024, (2, 30)).astype(np.int32)
    labels[:, :8] = -100
    want = j_step.action_token_metrics(jnp.asarray(logits),
                                       jnp.asarray(labels), vocab_size=vocab)
    got = t_step.action_token_metrics(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      vocab_size=vocab)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_trainable_masks_and_decay_masks_match_jax(setup):
    _, _, _, _, params_np = setup
    tparams = params_from_numpy(params_np)
    for stage in ("align", "finetune", "vla-train", "vla-full-train",
                  "vla-last-layer-train", "vla-sandwich-train"):
        want = jax.tree_util.tree_leaves(
            j_state.trainable_mask(params_np, stage))
        got = [m for _, m in leaves_with_path(
            t_state.trainable_mask(tparams, stage))]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, np.float32),
                                          np.asarray(w))
    want = jax.tree_util.tree_leaves(j_state._decay_mask(params_np))
    got = [m for _, m in leaves_with_path(t_state._decay_mask(tparams))]
    assert got == [bool(w) for w in want]
    assert t_state.stage_from_flags(True, True, True) == \
        j_state.stage_from_flags(True, True, True)
    with pytest.raises(ValueError):
        t_state.stage_from_flags(False, True, False)


def test_checkpoint_round_trip(tmp_path):
    from emmax_torch.training.checkpointing import (CheckpointManager,
                                                    write_sidecars)

    params = t_vlm.init_vlm_params(torch.Generator().manual_seed(0),
                                   t_vlm.tiny_vlm_config())
    tx, _ = t_state.make_optimizer(
        params, learning_rate=1e-3, weight_decay=0.0, max_grad_norm=1.0,
        lr_scheduler_type="constant", total_steps=2, stage="vla-train")
    state = t_state.create_train_state(params, tx)
    state.step = 5
    state.opt_state["count"] = 5
    ckpt = CheckpointManager(tmp_path, max_to_keep=1)
    ckpt.save(state, step=4, epoch=0, loss=1.5)
    path = ckpt.save(state, step=5, epoch=1, loss=float("nan"))
    assert path.name == "step-000005-epoch-01-loss=nan"
    assert ckpt.latest() == path and len(ckpt.list_checkpoints()) == 1
    assert CheckpointManager.parse_name(path)[:2] == (5, 1)
    restored = ckpt.restore()
    assert restored.step == 5 and restored.opt_state["count"] == 5
    for (p, a), (_, b) in zip(leaves_with_path(state.params),
                              leaves_with_path(restored.params)):
        assert torch.equal(a, b), p
    for a, b in zip(state.opt_state["mu"], restored.opt_state["mu"]):
        assert (a is None and b is None) or torch.equal(a, b)
    write_sidecars(tmp_path, {"seed": 1}, {"bridge": {"q01": [0.0]}})
    assert json.loads((tmp_path / "config.json").read_text()) == {"seed": 1}


def test_train_cli_smoke_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "emmax_torch.train", "--smoke_test", "true",
         "--device", "cpu", "--vla.max_steps", "2", "--eval_interval", "2",
         "--save_interval", "100", "--run_root_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run_dir = next(tmp_path.iterdir())
    ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    assert ckpts and ckpts[-1].startswith("step-000002-epoch-00-loss=")
    assert (run_dir / "config.json").exists()
    assert "[solver eval @ 2]" in out.stderr


def test_train_cli_raises_without_a_card(monkeypatch, tmp_path):
    from emmax_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train.TrainConfig(smoke_test=True, run_root_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(cfg)
