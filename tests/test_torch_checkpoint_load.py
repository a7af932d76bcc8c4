"""Serving and fine-tuning from checkpoints in the port against
``emmax_tpu``: ``load`` / ``load_vla`` on a reference ``.pt`` dir and a
Hugging Face safetensors dir (params, statistics, greedy tokens), the
three config.json shapes, ``convert_weights`` in every mode (a port
export loads in ``emmax_tpu``), the port's own run directories, the
trainer's ``--pretrained_checkpoint``, the facade and the ``generate``
CLI. Tiny configs, fp32, CPU; params and tokens must be identical.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch

import emmax_torch.generate as t_generate
from emmax_torch import convert_weights as t_cw
from emmax_torch.bridge import params_from_numpy
from emmax_torch.conf import parse_config
from emmax_torch.models import load as t_load
from emmax_torch.train import TrainConfig, initial_params
from emmax_torch.train import main as train_main
from emmax_tpu.conf import VLAConfig
from emmax_tpu.models import convert as j_conv
from emmax_tpu.models import load as j_load
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from test_torch_checkpoint import assert_tree_equal

REPO = Path(__file__).resolve().parent.parent
VOCAB = 1088          # the trainer's smoke vocabulary (1024 + PAD, padded)
STATS = {"bridge_orig": {
    "action": {"q01": [-0.1] * 7, "q99": [0.1] * 7,
               "mask": [True] * 6 + [False]},
    "proprio": {"Q1": [-1.0] * 7, "Q99": [1.0] * 7}}}
PROPRIO = {"Q1": [-2.0] * 7, "Q99": [2.0] * 7}
TINY_IDS = {"vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
            "arch_specifier": "no-align+fused-gelu-mlp",
            "image_resize_strategy": "resize-naive"}


def _frame(seed=3):
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


def write_pt_dir(d: Path, cfg, params):
    """A reference-layout dir: ``checkpoints/latest-checkpoint.pt`` from
    the JAX exporter, ``config.json`` in the pretrain shape, stats."""
    (d / "checkpoints").mkdir(parents=True)
    torch.save({"model": j_conv.params_to_prismatic_sd(params, cfg)},
               d / "checkpoints" / "latest-checkpoint.pt")
    (d / "config.json").write_text(json.dumps(
        {"model": TINY_IDS, "text_config": {"vocab_size":
                                            cfg.llm.vocab_size}}))
    (d / "dataset_statistics.json").write_text(json.dumps(STATS))
    return d


def write_hf_dir(d: Path, cfg, params):
    """A Hugging Face dir from the JAX exporter (``safetensors``' own
    writer), the flat config.json with ``norm_stats`` embedded, and a
    proprio-only ``dataset_statistics.json`` (``Q1`` / ``Q99``)."""
    d.mkdir(parents=True)
    sd = {k: v.contiguous() for k, v in
          j_conv.params_to_hf_sd(params, cfg).items()}
    st.save_file(sd, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(
        {"model_type": "emmax-openvla", **TINY_IDS,
         "text_config": {"vocab_size": cfg.llm.vocab_size},
         "norm_stats": STATS}))
    (d / "dataset_statistics.json").write_text(json.dumps(PROPRIO))
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    cfg = tiny_vlm_config(vocab_size=VOCAB)
    params = init_vlm_params(jax.random.PRNGKey(5), cfg)
    root = tmp_path_factory.mktemp("ckpt")
    return cfg, params, {"pt": write_pt_dir(root / "pt", cfg, params),
                         "hf": write_hf_dir(root / "hf", cfg, params)}


@pytest.mark.parametrize("fmt", ["pt", "hf"])
def test_checkpoint_dirs_load_like_jax(dirs, fmt):
    """Params, norm_stats and proprio_stats of a ``.pt`` dir and an HF dir
    equal ``emmax_tpu``'s load; ``load_vla(...).generate_actions`` gives
    JAX's greedy text and actions."""
    cfg, params, paths = dirs
    d = paths[fmt]
    tcfg, tparams, _, _, family = t_load.load(d, dtype=torch.float32,
                                              device="cpu")
    jcfg, jparams, _, _, jfamily = j_load.load(d, dtype=jnp.float32)
    assert tcfg.llm.vocab_size == jcfg.llm.vocab_size == VOCAB
    assert family == jfamily
    assert_tree_equal(tparams, jparams)
    assert_tree_equal(tparams, params)
    tvla = t_load.load_vla(d, dtype=torch.float32, device="cpu")
    jvla = j_load.load_vla(d, dtype=jnp.float32)
    assert tvla.norm_stats == jvla.norm_stats == STATS
    assert tvla.proprio_stats == jvla.proprio_stats == (
        PROPRIO if fmt == "hf" else None)
    assert tvla.get_action_stats(None) == STATS["bridge_orig"]["action"]
    prompt = tvla.get_prompt("pick the cup", gripper_position=(10, 20))
    ta, tt = tvla.generate_actions(_frame(), prompt, max_new_tokens=12)
    ja, jt = jvla.generate_actions(_frame(), prompt, max_new_tokens=12)
    assert tt == jt and len(ta) == len(ja)


QUANTIZE_KW = [{"quantize": "int8"}, {"quantize": "int4"},
               {"quantize_int8": True},
               {"quantize": "int4", "quantize_int8": True}]


@pytest.mark.parametrize("kw", QUANTIZE_KW,
                         ids=["int8", "int4", "quantize_int8",
                              "explicit_quantize_wins"])
def test_quantized_load_equals_jax_host_quantizer(dirs, kw):
    """``quantize=`` from a checkpoint: the same bytes as JAX's host
    quantizer (int4 scales as bf16 in both). ``quantize_int8=True`` is
    JAX's back-compat spelling of ``quantize="int8"``, and an explicit
    ``quantize`` wins over it, in both packages."""
    _, _, paths = dirs
    _, tparams, _, _, _ = t_load.load(paths["hf"], dtype=torch.float32,
                                      device="cpu", **kw)
    _, jparams, _, _, _ = j_load.load(paths["hf"], dtype=jnp.float32, **kw)
    assert_tree_equal(tparams, jparams)
    key = "q4" if kw.get("quantize") == "int4" else "q8"
    assert key in tparams["llm"]["layers"]["wq"]


def test_load_vla_takes_quantize_int8_as_jax_does(dirs):
    """``load_vla(path, quantize_int8=True)`` (JAX's
    ``tests/test_vla_api.py`` calls it so) loads the int8 tree."""
    _, _, paths = dirs
    tvla = t_load.load_vla(paths["pt"], dtype=torch.float32, device="cpu",
                           quantize_int8=True)
    jvla = j_load.load_vla(paths["pt"], dtype=jnp.float32,
                           quantize_int8=True)
    tparams = tvla.engine.model.tree()
    assert_tree_equal(tparams, jvla.engine.params)
    assert "q8" in tparams["llm"]["layers"]["wq"]


@pytest.mark.parametrize("shape", ["model", "vla", "flat"])
@pytest.mark.parametrize("model_id", ["prism-dinosiglip-224px+7b",
                                      "reproduction-llava-v15+7b",
                                      "phi-2+3b"])
def test_config_json_shapes_resolve_like_jax(shape, model_id):
    from emmax_tpu.conf import ModelConfig

    mc = ModelConfig.get_choice_class(model_id)()
    ids = {"vision_backbone_id": mc.vision_backbone_id,
           "llm_backbone_id": mc.llm_backbone_id,
           "arch_specifier": mc.arch_specifier,
           "image_resize_strategy": mc.image_resize_strategy}
    blob = {"model": {"model": ids},
            "vla": {"vla": {"base_vlm": model_id}},
            "flat": {"model_type": "emmax-openvla", **ids}}[shape]
    assert (t_load._model_cfg_from_json(blob)
            == j_load._model_cfg_from_json(blob))


def test_every_model_id_resolves_and_unbuilt_backbones_raise(tmp_path):
    from emmax_torch.conf.models import ModelConfig as TorchModelConfig
    from emmax_torch.models.registry import MODEL_REGISTRY
    from emmax_tpu.conf import ModelConfig

    known = set(ModelConfig.get_known_choices())
    assert known <= set(MODEL_REGISTRY)
    for mid in known:
        want = ModelConfig.get_choice_class(mid)()
        got = TorchModelConfig.get_choice_class(mid)()
        assert vars(got) == vars(want), mid
        # every id's backbones build (tests/test_torch_zoo_materialize.py
        # holds the configs to JAX's)
        t_load.build_vlm(got.vision_backbone_id, got.llm_backbone_id,
                         got.arch_specifier)
    # a backbone no registry knows still raises, naming it
    (tmp_path / "config.json").write_text(json.dumps({"model": {
        **TINY_IDS, "vision_backbone_id": "clip-vit-h",
        "llm_backbone_id": "llama2-7b-pure"}}))
    with pytest.raises(KeyError, match="clip-vit-h"):
        t_load.load(tmp_path, device="cpu")
    with pytest.raises(KeyError, match="neither a directory"):
        t_load.load("llama2+70b", device="cpu")


def _port_run_dir(d, cfg, params, dtype=torch.float32):
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tparams = jax.tree_util.tree_map(lambda t: t.to(dtype), tparams)
    t_load.save_pretrained(d, {"model": TINY_IDS, "text_config": {
        "vocab_size": cfg.llm.vocab_size}}, tparams,
        dataset_statistics=STATS)
    return d


@pytest.mark.parametrize("shard_gb", [5.0, 2e-4], ids=["one", "sharded"])
def test_port_hf_export_loads_in_emmax_tpu(tmp_path, shard_gb):
    """``python -m emmax_torch.convert_weights --mode export_hf`` on a port
    run dir (one file: the CLI's 5 GB shards), and ``save_hf`` with small
    shards on the same run dir's params: ``emmax_tpu.models.load`` reads
    the dir (one file, or shards with their index) to the same params and
    statistics."""
    cfg = tiny_vlm_config()                   # --base_vlm tiny
    params = init_vlm_params(jax.random.PRNGKey(6), cfg)
    run = _port_run_dir(tmp_path / "run", cfg, params)
    stats = tmp_path / "stats.json"
    stats.write_text(json.dumps(STATS))
    out = tmp_path / "hf"
    if shard_gb == 5.0:
        t_cw.main(["--mode", "export_hf", "--src", str(run), "--dst",
                   str(out), "--base_vlm", "tiny", "--export_dtype",
                   "float32", "--dataset_statistics", str(stats)])
    else:
        t_cw.save_hf(t_cw._run_params(run), cfg, t_cw.vlm_ids("tiny"), out,
                     norm_stats=STATS, dtype=torch.float32,
                     max_shard_bytes=shard_gb * 1e9)
    shards = sorted(p.name for p in out.glob("*.safetensors"))
    assert (shards == ["model.safetensors"]) == (shard_gb == 5.0)
    assert (out / "model.safetensors.index.json").exists() == (len(shards)
                                                               > 1)
    _, jparams, _, _, _ = j_load.load(out, dtype=jnp.float32)
    assert_tree_equal(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jparams)), params)
    assert j_load.load_vla(out, dtype=jnp.float32).norm_stats == STATS
    _, tparams, _, _, _ = t_load.load(out, dtype=torch.float32, device="cpu")
    assert_tree_equal(tparams, params)


def test_convert_weights_import_and_export_pt(dirs, tmp_path):
    """import_pt and import_hf write run dirs holding JAX's bf16
    conversion; export_pt writes a ``.pt`` that JAX's converter reads
    back to the same values."""
    _, _, paths = dirs
    cfg = tiny_vlm_config()
    params = init_vlm_params(jax.random.PRNGKey(7), cfg)
    write_pt_dir(tmp_path / "src_pt", cfg, params)
    write_hf_dir(tmp_path / "src_hf", cfg, params)
    want = j_load._cast_tree(j_conv.convert_hf_openvla_sd(
        j_conv.params_to_hf_sd(params, cfg), cfg), jnp.bfloat16)
    pt = tmp_path / "src_pt" / "checkpoints" / "latest-checkpoint.pt"
    for mode, src in (("import_pt", pt), ("import_hf", tmp_path / "src_hf")):
        run = tmp_path / mode
        t_cw.main(["--mode", mode, "--src", str(src), "--dst", str(run),
                   "--base_vlm", "tiny"])
        ckpt = t_load._latest_checkpoint(run)
        assert ckpt.name == "step-000000"
        assert_tree_equal(t_load.load_run_params(ckpt), want)
    out = tmp_path / "export.pt"
    t_cw.main(["--mode", "export_pt", "--src", str(tmp_path / "import_pt"),
               "--dst", str(out), "--base_vlm", "tiny"])
    back = j_load.convert_prismatic_pt(out, cfg)
    assert_tree_equal(t_load._cast_tree(params_from_numpy(back),
                                        torch.bfloat16), want)


def test_port_run_dir_round_trips(tmp_path):
    """A run dir the port's trainer writes (``--smoke_test``) loads to the
    params of its last checkpoint, exactly, and serves."""
    cfg = parse_config(TrainConfig, [
        "--smoke_test", "true", "--device", "cpu", "--vla.max_steps", "1",
        "--vla.global_batch_size", "2", "--run_root_dir", str(tmp_path),
        "--eval_interval", "100"], choice_fields={"vla": VLAConfig})
    state = train_main(cfg)
    run = next(tmp_path.iterdir())
    blob = json.loads((run / "config.json").read_text())
    assert blob["model"]["vision_backbone_id"] == "tiny"
    saved = torch.load(t_load._latest_checkpoint(run) / "state.pt",
                       weights_only=True)["params"]
    _, params, _, _, _ = t_load.load(run, dtype=torch.float32, device="cpu")
    assert_tree_equal(params, jax.tree_util.tree_map(
        lambda t: t.numpy(), saved))
    assert_tree_equal(params, jax.tree_util.tree_map(
        lambda t: t.numpy(), state.params))
    vla = t_load.load_vla(run, dtype=torch.float32, device="cpu")
    prompt = vla.get_prompt("pick", gripper_position=(3, 4))
    assert isinstance(vla.generate(_frame(), prompt, 6), str)


def test_pretrained_checkpoint_starts_from_jax_conversion(tmp_path):
    """``--pretrained_checkpoint``: the step-0 masters equal JAX's
    ``_cast_tree(convert_prismatic_pt(...), float32)`` (vla-scripts/
    train.py:166-170); a run at learning rate 0 keeps them exactly."""
    cfg = tiny_vlm_config(vocab_size=VOCAB)
    params = init_vlm_params(jax.random.PRNGKey(8), cfg)
    d = write_pt_dir(tmp_path / "base", cfg, params)
    pt = d / "checkpoints" / "latest-checkpoint.pt"
    want = j_load._cast_tree(j_load.convert_prismatic_pt(pt, cfg),
                             jnp.float32)
    tcfg = parse_config(TrainConfig, [
        "--smoke_test", "true", "--device", "cpu",
        "--pretrained_checkpoint", str(pt), "--vla.max_steps", "1",
        "--vla.global_batch_size", "2", "--vla.learning_rate", "0",
        "--run_root_dir", str(tmp_path / "runs"), "--eval_interval", "100"],
        choice_fields={"vla": VLAConfig})
    from emmax_torch.models.vlm import tiny_vlm_config as t_tiny

    assert_tree_equal(initial_params(tcfg, t_tiny(VOCAB), "cpu"), want)
    state = train_main(tcfg)
    assert state.step == 1
    assert_tree_equal(state.params, want)


def test_facade_matches_jax(dirs):
    from emmax_torch.extern.hf_facade import (EmmaXForVision2Seq,
                                              EmmaXProcessor,
                                              extract_instruction)
    from emmax_tpu.extern.hf_facade import EmmaXForVision2Seq as JModel
    from emmax_tpu.extern.hf_facade import EmmaXProcessor as JProc
    from emmax_tpu.extern.hf_processor import \
        extract_instruction as j_extract

    _, _, paths = dirs
    tm = EmmaXForVision2Seq.from_pretrained(paths["hf"], dtype=torch.float32,
                                            device="cpu")
    tp = EmmaXProcessor(tm.vla)
    jm = JModel.from_pretrained(paths["hf"], dtype=jnp.float32)
    jp = JProc(jm.vla)
    prompt, image = tp.get_prompt("Put the carrot in the pot", _frame(4))
    jprompt, jimage = jp.get_prompt("Put the carrot in the pot", _frame(4))
    assert prompt == jprompt and np.array_equal(image, jimage)
    assert tp(prompt, image)["task"] == jp(prompt, image)["task"]
    ta, tt = tm.generate_actions(tp(prompt, image), tp.tokenizer,
                                 max_new_tokens=10)
    ja, jt = jm.generate_actions(jp(prompt, image), jp.tokenizer,
                                 max_new_tokens=10)
    assert tt == jt and len(ta) == len(ja)
    inputs = {"prompt": prompt, "image": image}       # no "task": from prompt
    np.testing.assert_array_equal(tm.predict_action(inputs, "bridge_orig"),
                                  jm.predict_action(inputs, "bridge_orig"))
    for p in (prompt, "In: What action should the robot take to open it?",
              "nothing"):
        assert extract_instruction(p) == j_extract(p)
    with pytest.raises(ValueError, match="greedy"):
        tm.generate_actions(tp(prompt, image), do_sample=True)


def _jax_generate_script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_script", REPO / "scripts" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # its dataclass looks itself up
    spec.loader.exec_module(mod)
    return mod


def test_generate_cli_matches_jax(tmp_path, monkeypatch):
    """``generate --smoke_test`` (the same tiny weights bridged into both)
    writes JAX's texts and reports JAX's metrics; ``--metric_file`` scores
    the file as JAX does. JAX's own smoke config (a 512 vocabulary) fails
    ``ActionTokenizer``'s check, so its side is built here at the port's
    1024."""
    from emmax_tpu.data.gcot import (SyntheticFrameSource,
                                     make_dummy_gcot_items)
    from emmax_tpu.data.pretrain import ValDataset
    from emmax_tpu.models.vla import EmmaXVLA
    from emmax_tpu.ops.image import ImageTransformConfig
    from emmax_tpu.vla.action_tokenizer import ActionTokenizer
    from emmax_tpu.vla.solver import Solver
    from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

    cfg = tiny_vlm_config(VOCAB)
    params = init_vlm_params(jax.random.PRNGKey(0), cfg)
    monkeypatch.setattr(t_generate, "smoke_params", lambda c, d: (
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params), d)))
    out = tmp_path / "results.json"
    got = t_generate.main(t_generate.GenerateConfig(
        smoke_test=True, device="cpu", out=out, max_new_tokens=16,
        batch_size=4))
    results = json.loads(out.read_text())

    tok = ByteLevelTokenizer(vocab_size=1024)
    vla = EmmaXVLA(cfg, params, tok, {n: ImageTransformConfig(size=v.img_size)
                                      for n, v in cfg.vision})
    ds = ValDataset(make_dummy_gcot_items(8), ActionTokenizer(tok),
                    SyntheticFrameSource(64))
    want = []
    for start in (0, 4):
        batch = [ds[i] for i in range(start, start + 4)]
        texts = vla.generate_batch([b["image"] for b in batch],
                                   [b["prompt"] for b in batch],
                                   max_new_tokens=16)
        want += [{"VLM_Response": t, "ground_truth": b["ground_truth"],
                  "prompt": b["prompt"]} for t, b in zip(texts, batch)]
    assert results == want

    script = _jax_generate_script()

    def jax_metrics(tokenizer):
        prf = script.policy_token_prf(want, tokenizer)
        _, acc, l1, _, _, _ = Solver(ActionTokenizer(tokenizer)
                                     ).evaluate_batch(
            [r["ground_truth"] for r in want],
            [r["VLM_Response"] for r in want])
        return {**prf, "solver_acc": float(np.mean(acc)),
                "solver_l1": float(np.mean(l1))}

    assert got == jax_metrics(tok)
    scored = t_generate.main(t_generate.GenerateConfig(metric_file=out))
    assert scored == jax_metrics(ByteLevelTokenizer())


def test_load_raises_on_a_bad_checkpoint_and_without_a_card(dirs, tmp_path,
                                                             monkeypatch):
    """No fallback: a missing tensor, an unreadable shard or an empty dir
    raise, and a checkpoint dir goes to the card unless ``device="cpu"``."""
    import emmax_torch

    _, _, paths = dirs
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "config.json").write_text((paths["hf"] / "config.json")
                                     .read_text())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        t_load.load(bad, device="cpu")
    sd = st.load_file(paths["hf"] / "model.safetensors")
    sd.pop("language_model.model.norm.weight")
    st.save_file(sd, bad / "model.safetensors")
    with pytest.raises(KeyError, match="model.norm.weight"):
        t_load.load(bad, device="cpu")
    (bad / "model.safetensors").write_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="not a safetensors"):
        t_load.load(bad, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        emmax_torch.load_vla(paths["hf"])
