"""The port stands alone: ``emmax_torch`` imports neither JAX nor
``ml_dtypes`` nor anything of ``emmax_tpu``, and importing it loads none
of ``transformers``, ``tensorflow``, OpenCV or PIL (the card machine has
none of them); the weight bridge keeps every byte; nothing silently runs
on the CPU when the card is asked for."""

import re
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "emmax_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))


def test_import_loads_no_jax():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'ml_dtypes', 'emmax_tpu', 'transformers',"
            " 'tensorflow', 'cv2', 'PIL'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "emmax_torch.models.load" in MODULES and len(MODULES) > 20
    assert {"emmax_torch.train", "emmax_torch.training.train_step",
            "emmax_torch.training.train_state", "emmax_torch.training.loop",
            "emmax_torch.training.checkpointing",
            "emmax_torch.training.metrics", "emmax_torch.data.gcot",
            "emmax_torch.data.collators", "emmax_torch.data.prefetch",
            "emmax_torch.conf.vla", "emmax_torch.conf.registry",
            "emmax_torch.serving.continuous", "emmax_torch.serving.paged",
            "emmax_torch.ops.paged_attention",
            "emmax_torch.serving.speculative",
            "emmax_torch.models.safetensors_io", "emmax_torch.models.convert",
            "emmax_torch.conf.models", "emmax_torch.extern.hf_facade",
            "emmax_torch.convert_weights", "emmax_torch.generate",
            "emmax_torch.data.pretrain", "emmax_torch.overwatch",
            "emmax_torch.parallel", "emmax_torch.parallel.mesh",
            "emmax_torch.parallel.distributed",
            "emmax_torch.parallel.sharding",
            "emmax_torch.parallel.constraints",
            "emmax_torch.parallel.gather",
            "emmax_torch.ops.ring_attention", "emmax_torch.pretrain",
            "emmax_torch.training.vision_cache", "emmax_torch.util",
            "emmax_torch.util.batching",
            "emmax_torch.conf.datasets", "emmax_torch.models.phi",
            "emmax_torch.models.materialize", "emmax_torch.models.vit",
            "emmax_torch.models.vlm", "emmax_torch.ops.rope",
            "emmax_torch.data.codec", "emmax_torch.data.tfrecord",
            "emmax_torch.data.normalization", "emmax_torch.data.relabeling",
            "emmax_torch.data.augment", "emmax_torch.data.rlds",
            "emmax_torch.data.oxe", "emmax_torch.data.rlds_vla",
            "emmax_torch.data.framestore",
            "emmax_torch.vla.materialize",
            "emmax_torch.experiments", "emmax_torch.experiments.gripper",
            "emmax_torch.experiments.kinematic_sim",
            "emmax_torch.experiments.policy",
            "emmax_torch.experiments.transforms3d",
            "emmax_torch.experiments.widowx", "emmax_torch.util.seeding",
            "emmax_torch.util.profiling", "emmax_torch.eval_success_rate",
            "emmax_torch.simpler_eval",
            "emmax_torch.bridge_eval"} <= set(MODULES)


def test_pretrain_modules_import_no_opencv():
    """The card has no OpenCV: the pretraining datasets import it only
    when they read or write an image."""
    code = ("import sys\n"
            "import emmax_torch.data.pretrain, emmax_torch.pretrain\n"
            "import emmax_torch.training.vision_cache\n"
            "print('cv2' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_no_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|emmax_tpu)\b", re.M)
    offenders = [str(p) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_bridge_keeps_every_byte():
    rng = np.random.default_rng(0)
    bf16 = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    tree = {"w": bf16, "layers": [{"b": rng.standard_normal(4).astype(
        np.float32)}], "q": {"q8": np.arange(-4, 4, dtype=np.int8),
                             "scale": np.ones((1, 8), np.float32)},
        "m": np.array([True, False])}
    out = params_from_numpy(tree)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["w"].view(torch.uint16).numpy(),
                                  bf16.view(np.uint16))
    assert out["layers"][0]["b"].dtype == torch.float32
    assert out["q"]["q8"].dtype == torch.int8
    assert out["m"].dtype == torch.bool
    # the port's numpy int4 quantizer ships bf16 scales as uint16 bits
    q4 = {"q4": np.zeros((2, 3), np.int8),
          "scale": np.array([[0x3F80, 0x4000, 0x0000]], np.uint16)}
    assert params_from_numpy(q4)["scale"].tolist() == [[1.0, 2.0, 0.0]]


def test_entry_points_raise_without_a_card(monkeypatch):
    import emmax_torch
    from emmax_torch.models.vlm import tiny_vlm_config
    from emmax_torch.serving.engine import ServingEngine
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    from emmax_torch.serving.continuous import ContinuousServingEngine
    from emmax_torch.serving.paged import PagedServingEngine
    from emmax_torch.serving.speculative import SpeculativeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        emmax_torch.load_vla("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        emmax_torch.load_vla("tiny", speculative=True)
    for engine in (ServingEngine, ContinuousServingEngine,
                   PagedServingEngine, SpeculativeEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine(tiny_vlm_config(), {}, ByteLevelTokenizer())


def test_kernel_wrappers_take_no_cpu_tensors():
    from emmax_torch.ops.flash_attention import flash_attention_cuda
    from emmax_torch.ops.int4_matmul import int4_matmul_cuda
    from emmax_torch.ops.paged_attention import paged_attention_cuda

    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        int4_matmul_cuda(torch.zeros(1, 64), torch.zeros(32, 8,
                                                         dtype=torch.int8),
                         torch.zeros(1, 8, dtype=torch.bfloat16))
    pages = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(torch.zeros(1, 2, 16), pages, pages,
                             torch.ones(1, dtype=torch.int32),
                             torch.zeros(1, 2, dtype=torch.int32))


def test_engine_rejects_weights_on_another_device():
    from emmax_torch.models.load import load
    from emmax_torch.serving.engine import ServingEngine

    cfg, params, tok, _, _ = load("tiny", dtype=torch.float32, device="cpu")
    params["llm"]["embed"] = params["llm"]["embed"].to("meta")
    with pytest.raises(ValueError, match="is on meta"):
        ServingEngine(cfg, params, tok, device="cpu")


def test_load_tiny_and_quantized_trees():
    from emmax_torch.models.load import load

    cfg, params, tok, transforms, family = load("tiny", dtype=torch.float32,
                                                device="cpu", quantize="int4")
    wq = params["llm"]["layers"]["wq"]
    assert wq["q4"].shape == (cfg.llm.n_layers, cfg.llm.dim // 2,
                              cfg.llm.dim)
    assert wq["scale"].dtype == torch.bfloat16
    assert isinstance(params["llm"]["lm_head"], dict)
    assert not isinstance(params["llm"]["embed"], dict)
    assert set(transforms) == {"dino", "siglip"} and family == "llama2"
    with pytest.raises(KeyError):
        load("no-such-model", device="cpu")
    with pytest.raises(ValueError):
        load("tiny", device="cpu", quantize="int2")
