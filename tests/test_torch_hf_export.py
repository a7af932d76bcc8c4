"""The port's Hugging Face export surface against the JAX package's:
``config.json`` (transformers-free) against ``EmmaXVLAConfig``, the image
processor and the processor, ``export_hf``'s six files, the exported
directory through the facades, and the self-contained bundle in a process
where ``emmax_torch`` cannot be imported."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.extern import hf_config as t_cfg
from emmax_torch.extern import hf_processor as t_proc
from emmax_tpu.extern import hf_config as j_cfg
from emmax_tpu.extern import hf_processor as j_proc
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config

REPO = Path(__file__).resolve().parent.parent
STATS = {"bridge_orig": {"action": {
    "q01": [-1.0] * 7, "q99": [1.0] * 7, "mask": [True] * 6 + [False]}}}
CASES = [
    dict(vision_backbone_id="dinosiglip-vit-so-224px",
         llm_backbone_id="llama2-7b-pure",
         arch_specifier="no-align+fused-gelu-mlp",
         image_resize_strategy="resize-naive",
         text_config={"vocab_size": 32064, "pad_token_id": 32000},
         norm_stats=STATS, torch_dtype="bfloat16",
         auto_map=t_cfg.AUTO_MAP),
    dict(vision_backbone_id="clip-vit-l-336px", llm_backbone_id="phi-2-3b",
         arch_specifier="gelu-mlp", text_config={"vocab_size": 51200}),
    dict(vision_backbone_id="siglip-vit-so400m-384px",
         llm_backbone_id="mistral-v0.1-7b-instruct",
         image_resize_strategy="letterbox", torch_dtype="float32",
         llm_max_length=4096, n_action_bins=128),
    {},
]


def _jax_to_dict(kw):
    d = j_cfg.EmmaXVLAConfig(**kw).to_dict()
    d.pop("transformers_version")
    return d


@pytest.mark.parametrize("kw", CASES, ids=["llama", "phi", "mistral",
                                           "defaults"])
def test_config_dict_matches_emmax_vla_config(kw, tmp_path):
    """The transformers-free dict equals ``to_dict()`` of JAX's class key
    for key (``transformers_version`` aside), the port's lazy class gives
    the same, and ``config.json`` equals what ``save_pretrained`` wrote."""
    want = _jax_to_dict(kw)
    got = t_cfg.emmax_vla_config_dict(**kw)
    got.pop("transformers_version")
    assert got == want
    port_cls = t_cfg.EmmaXVLAConfig(**kw).to_dict()
    port_cls.pop("transformers_version")
    assert port_cls == want
    j_cfg.EmmaXVLAConfig(**kw).save_pretrained(tmp_path / "j")
    t_cfg.write_config_json(tmp_path / "t", **kw)
    saved = [json.loads((tmp_path / d / "config.json").read_text())
             for d in ("j", "t")]
    for blob in saved:
        blob.pop("transformers_version")
    assert saved[0] == saved[1]
    back = j_cfg.EmmaXVLAConfig.from_pretrained(tmp_path / "t")
    assert back.to_dict()["text_config"] == want["text_config"]


def test_unknown_backbone_raises():
    for kw in ({"vision_backbone_id": "not-a-backbone"},
               {"llm_backbone_id": "tiny"}):
        with pytest.raises(ValueError):
            t_cfg.emmax_vla_config_dict(**kw)
        with pytest.raises(ValueError):
            t_cfg.EmmaXConfig(**kw)
        with pytest.raises(ValueError):
            j_cfg.EmmaXConfig(**kw)


@pytest.mark.parametrize("backbone", ["dinosiglip-vit-so-224px",
                                      "siglip-vit-so400m-384px"])
def test_image_processor_matches_jax(backbone, tmp_path):
    """The pipeline and the ``ImageProcessingMixin`` class equal the port's
    ``preprocess_for_towers`` exactly and JAX's processor within 1e-6 where
    no resize runs (a frame at the towers' size). Through a resize JAX's
    float32 bicubic is itself 1.2e-5 from the float64 result at these
    shapes (its XLA-computed weights differ by 1.5e-6), the port's 1e-6,
    so there the two are held within 2e-5."""
    from emmax_torch.ops.image import preprocess_for_towers

    want = j_proc.EmmaXImageProcessor.for_backbone(backbone, "resize-naive")
    got = t_proc.EmmaXImagePipeline.for_backbone(backbone, "resize-naive")
    hf = t_proc.EmmaXImageProcessor.for_backbone(backbone, "resize-naive")
    rng = np.random.default_rng(0)
    size = got.input_sizes[0]
    for shape, tol in (((size, size, 3), 1e-6), ((32, 40, 3), 2e-5)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = want(img)
        ops = preprocess_for_towers(torch.from_numpy(img[None]),
                                    got.transform_configs())
        for out in (got(img), hf(img)):
            assert set(out) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(out[k], ops[k].numpy())
                np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=tol)
        np.testing.assert_allclose(got(img, return_stacked=True),
                                   want(img, return_stacked=True), rtol=0,
                                   atol=tol)
    want.save_pretrained(tmp_path / "j")
    got.save_pretrained(tmp_path / "t")
    hf.save_pretrained(tmp_path / "h")
    files = [(tmp_path / d / "preprocessor_config.json").read_bytes()
             for d in "jth"]
    assert files[0] == files[1] == files[2]
    back = t_proc.EmmaXImagePipeline.from_pretrained(tmp_path / "j")
    assert back.to_dict() == got.to_dict()


def test_processor_matches_jax_and_roundtrips(tmp_path):
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer
    from emmax_tpu.vla.tokenizer import ByteLevelTokenizer as JTok

    want = j_proc.EmmaXProcessor(j_proc.EmmaXImageProcessor.for_backbone(
        "dinosiglip-vit-so-224px", "resize-naive"), JTok(512))
    got = t_proc.EmmaXProcessor(t_proc.EmmaXImagePipeline.for_backbone(
        "dinosiglip-vit-so-224px", "resize-naive"), ByteLevelTokenizer(512))
    img = np.random.default_rng(1).integers(0, 256, (32, 32, 3),
                                            dtype=np.uint8)
    for gripper in (None, (3, 29)):
        prompt, image = got.get_prompt("put the eggplant in the pot", img,
                                       gripper)
        assert (prompt, image.tobytes()) == tuple(
            x if i == 0 else x.tobytes() for i, x in enumerate(
                want.get_prompt("put the eggplant in the pot", img, gripper)))
    a, b = got(prompt, image), want(prompt, image)
    assert a["task"] == b["task"] == "put the eggplant in the pot"
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    for k in b["pixel_values"]:        # a 32 px frame: resized
        np.testing.assert_allclose(a["pixel_values"][k], b["pixel_values"][k],
                                   rtol=0, atol=2e-5)
    assert got("x", image, task_label="wipe")["task"] == "wipe"
    got.save_pretrained(tmp_path / "t")
    want.save_pretrained(tmp_path / "j")
    assert (tmp_path / "t" / "preprocessor_config.json").read_bytes() == \
        (tmp_path / "j" / "preprocessor_config.json").read_bytes()
    back = t_proc.EmmaXProcessor.from_pretrained(tmp_path / "j")
    assert back.tokenizer.vocab_size == 512
    assert back.llm_family == "llama2"
    c = back(prompt, image)
    np.testing.assert_array_equal(c["input_ids"], a["input_ids"])
    for k in a["pixel_values"]:
        np.testing.assert_array_equal(c["pixel_values"][k],
                                      a["pixel_values"][k])


# --- export_hf: the port's six files against JAX's ---------------------------

def _jax_convert_weights():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights",
        REPO / "vla-scripts" / "extern" / "convert_weights.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclass resolution needs it
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One tiny VLM (vocab 32064, the hermetic tokenizer's padded size) as
    a JAX run dir and as a port run dir, each exported by its own
    ``export_hf``."""
    from emmax_torch import convert_weights as t_cw
    from emmax_torch.models import load as t_load
    from emmax_tpu.models import load as j_load

    root = tmp_path_factory.mktemp("hub")
    cfg = tiny_vlm_config(vocab_size=32064)
    params = init_vlm_params(jax.random.PRNGKey(3), cfg)
    ids = {"vision_backbone_id": "tiny", "llm_backbone_id": "tiny",
           "arch_specifier": "fused-gelu-mlp"}
    j_load.save_pretrained(root / "j_run", ids, params)
    t_load.save_pretrained(root / "t_run", {**ids, "text_config": {
        "vocab_size": 32064}}, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params)))
    (root / "stats.json").write_text(json.dumps(STATS))
    j_cw = _jax_convert_weights()
    j_cw.export_hf(j_cw.ConvertConfig(
        src=str(root / "j_run"), dst=str(root / "j_out"), mode="export_hf",
        base_vlm="tiny", dataset_statistics=str(root / "stats.json")))
    t_cw.main(["--mode", "export_hf", "--src", str(root / "t_run"), "--dst",
               str(root / "t_out"), "--base_vlm", "tiny",
               "--dataset_statistics", str(root / "stats.json")])
    return root


def test_export_writes_jax_files(exports):
    from emmax_torch.models.safetensors_io import load_dir

    j_out, t_out = exports / "j_out", exports / "t_out"
    six = {"model.safetensors", "config.json", "preprocessor_config.json",
           "modeling_emmax.py", "configuration_emmax.py",
           "processing_emmax.py"}
    assert {p.name for p in j_out.iterdir()} == six
    assert {p.name for p in t_out.iterdir()} == six | {"csrc"}
    assert json.loads((t_out / "config.json").read_text()) == \
        json.loads((j_out / "config.json").read_text())
    for name in ("preprocessor_config.json", "configuration_emmax.py",
                 "processing_emmax.py"):
        assert (t_out / name).read_bytes() == (j_out / name).read_bytes()
    got, want = load_dir(t_out), load_dir(j_out)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sorted(p.name for p in (t_out / "csrc").iterdir()) == sorted(
        p.name for p in (REPO / "emmax_torch" / "csrc").iterdir())


def test_export_loads_through_facades(exports):
    """The port's export dir alone through the port's facade and JAX's
    facade (fp32): the same instruction and action."""
    import jax.numpy as jnp

    from emmax_torch.extern.hf_facade import EmmaXForVision2Seq
    from emmax_tpu.extern.hf_facade import \
        EmmaXForVision2Seq as JEmmaXForVision2Seq

    out = exports / "t_out"
    model = EmmaXForVision2Seq.from_pretrained(out, dtype=torch.float32,
                                               device="cpu")
    proc = t_proc.EmmaXProcessor.from_pretrained(
        out, tokenizer=model.vla.tokenizer)
    image = np.random.default_rng(2).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    prompt, image = proc.get_prompt("stack the cups", image)
    inputs = proc(prompt, image)
    assert inputs["task"] == "stack the cups"
    action = model.predict_action(inputs, unnorm_key="bridge_orig")
    assert action.shape == (7,)
    jmodel = JEmmaXForVision2Seq.from_pretrained(out, dtype=jnp.float32)
    np.testing.assert_allclose(
        action, jmodel.predict_action(inputs, unnorm_key="bridge_orig"),
        rtol=0, atol=1e-6)
    assert model.vla.norm_stats == STATS


def test_standalone_bundle_serves_without_the_package(exports, tmp_path):
    """``modeling_emmax.py`` in a process whose ``sys.path`` holds no
    repository path: ``import emmax_torch`` fails, and the bundle serves
    ``predict_action`` on the CPU with the in-process port's action."""
    from emmax_torch.extern.hf_facade import EmmaXForVision2Seq

    out = exports / "t_out"
    script = tmp_path / "drive_standalone.py"
    script.write_text(f"""
import sys
repo = {str(REPO)!r}
sys.path = [p for p in sys.path if p and p != "." and not p.startswith(repo)]
try:
    import emmax_torch
    raise SystemExit("emmax_torch importable: the check would be vacuous")
except ImportError:
    pass
sys.path.insert(0, {str(out)!r})
import json
import numpy as np
import torch
import modeling_emmax as M
from processing_emmax import EmmaXProcessor
model = M.EmmaXForVision2Seq.from_pretrained({str(out)!r},
                                             dtype=torch.float32,
                                             device="cpu")
proc = EmmaXProcessor.from_pretrained({str(out)!r},
                                      tokenizer=model.vla.tokenizer)
image = np.random.default_rng(2).integers(0, 256, (32, 32, 3),
                                          dtype=np.uint8)
prompt, image = proc.get_prompt("wipe the table", image)
inputs = proc(prompt, image)
assert inputs["task"] == "wipe the table"
action = model.predict_action(inputs, unnorm_key="bridge_orig")
fa = sys.modules["_emmax_bundle.ops.cuda_build"]
print("STANDALONE", json.dumps({{"action": action.tolist(),
      "csrc": str(fa.CSRC), "build": str(fa.BUILD_DIR),
      "emmax_torch": "emmax_torch" in sys.modules}}))
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = [s for s in res.stdout.splitlines() if s.startswith("STANDALONE")]
    got = json.loads(line[-1].split(" ", 1)[1])
    assert got["csrc"] == str(out / "csrc")
    assert got["build"] == str(out / "_build")
    assert not got["emmax_torch"]
    model = EmmaXForVision2Seq.from_pretrained(out, dtype=torch.float32,
                                               device="cpu")
    proc = t_proc.EmmaXProcessor.from_pretrained(
        out, tokenizer=model.vla.tokenizer)
    image = np.random.default_rng(2).integers(0, 256, (32, 32, 3),
                                              dtype=np.uint8)
    prompt, image = proc.get_prompt("wipe the table", image)
    want = model.predict_action(proc(prompt, image), unnorm_key="bridge_orig")
    np.testing.assert_array_equal(np.asarray(got["action"]), want)


def test_registered_backbone_export_config(tmp_path):
    """A registered backbone's ``config.json`` is ``EmmaXVLAConfig``'s
    ``save_pretrained`` output; both loaders read its ids back."""
    from emmax_torch.convert_weights import vlm_ids, write_hf_config
    from emmax_torch.models.load import _model_cfg_from_json
    from emmax_torch.models.materialize import get_vlm_config

    ids = vlm_ids("prism-dinosiglip-224px+7b")
    cfg = get_vlm_config("prism-dinosiglip-224px+7b")
    write_hf_config(tmp_path, cfg, ids, norm_stats=STATS)
    blob = json.loads((tmp_path / "config.json").read_text())
    assert blob["auto_map"] == t_cfg.AUTO_MAP
    assert blob["norm_stats"] == STATS
    assert blob["text_config"]["vocab_size"] == cfg.llm.vocab_size
    assert _model_cfg_from_json(blob) == (
        ids["vision_backbone_id"], ids["llm_backbone_id"],
        ids["arch_specifier"], ids["image_resize_strategy"])
    want = j_cfg.EmmaXVLAConfig(
        **{k: ids[k] for k in ("vision_backbone_id", "llm_backbone_id",
                               "arch_specifier", "image_resize_strategy")},
        text_config={"vocab_size": cfg.llm.vocab_size, "pad_token_id": 32000},
        norm_stats=STATS, torch_dtype="bfloat16",
        auto_map=t_cfg.AUTO_MAP)
    want.save_pretrained(tmp_path / "j")
    jblob = json.loads((tmp_path / "j" / "config.json").read_text())
    assert jblob == blob
