"""Checkpoint conversion in the port against ``emmax_tpu``: the converters
(HF Llama, DINOv2, SigLIP, TIMM ViT, the projector), ``resize_pos_embed``,
the exporters, and the port's own safetensors reader and writer against
the ``safetensors`` package.

Converted leaves must equal JAX's exactly (both copy or transpose the same
values; a bf16 source stays bf16 in both). ``resize_pos_embed`` is held
within 1e-5 of the largest |value|: the port applies
``jax.image.resize``'s bicubic weights as two products, JAX as one einsum,
so the sums run in another order.
"""

import json

import jax
import numpy as np
import pytest
import safetensors.torch as st
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import convert as t_conv
from emmax_torch.models import safetensors_io as sio
from emmax_torch.models.llama import LlamaConfig as TorchLlamaConfig
from emmax_torch.models.vit import ViTConfig as TorchViTConfig
from emmax_tpu.models import convert as j_conv
from emmax_tpu.models.llama import LlamaConfig
from emmax_tpu.models.vit import ViTConfig
from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
from test_reference_checkpoint_layout import (expected_prismatic_keys,
                                              reference_remap_to_hf)

LLAMA = dict(vocab_size=96, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
             hidden_dim=64, max_seq_len=64)
DINO = dict(img_size=28, patch_size=14, dim=32, depth=2, n_heads=2,
            hidden_dim=64, class_token=True, num_reg_tokens=4,
            layerscale=True)
SIGLIP = dict(img_size=28, patch_size=14, dim=48, depth=2, n_heads=4,
              hidden_dim=96, class_token=False, gelu_tanh=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def assert_tree_equal(torch_tree, jax_tree):
    """Same paths; every leaf the same dtype and bits."""
    got = _flat(torch_tree)
    want = _flat(params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jax_tree)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def _hf_llama():
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(0)
    return LlamaForCausalLM(HFLlamaConfig(
        vocab_size=LLAMA["vocab_size"], hidden_size=LLAMA["dim"],
        num_hidden_layers=LLAMA["n_layers"],
        num_attention_heads=LLAMA["n_heads"],
        num_key_value_heads=LLAMA["n_kv_heads"],
        intermediate_size=LLAMA["hidden_dim"], max_position_embeddings=64,
        tie_word_embeddings=False)).state_dict()


def _hf_dinov2():
    from transformers import (Dinov2WithRegistersConfig,
                              Dinov2WithRegistersModel)

    torch.manual_seed(1)
    return Dinov2WithRegistersModel(Dinov2WithRegistersConfig(
        hidden_size=DINO["dim"], num_hidden_layers=DINO["depth"],
        num_attention_heads=DINO["n_heads"],
        intermediate_size=DINO["hidden_dim"], image_size=DINO["img_size"],
        patch_size=DINO["patch_size"], num_register_tokens=4,
        layerscale_value=0.5)).state_dict()


def _hf_siglip():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(2)
    return SiglipVisionModel(SiglipVisionConfig(
        hidden_size=SIGLIP["dim"], num_hidden_layers=SIGLIP["depth"],
        num_attention_heads=SIGLIP["n_heads"],
        intermediate_size=SIGLIP["hidden_dim"], image_size=SIGLIP["img_size"],
        patch_size=SIGLIP["patch_size"])).state_dict()


HF_CASES = {
    "llama": (_hf_llama, lambda sd, d: t_conv.convert_hf_llama(
        sd, TorchLlamaConfig(**LLAMA), dtype=d),
        lambda sd: j_conv.convert_hf_llama(sd, LlamaConfig(**LLAMA))),
    "dinov2": (_hf_dinov2, lambda sd, d: t_conv.convert_hf_dinov2(
        sd, TorchViTConfig(**DINO), dtype=d),
        lambda sd: j_conv.convert_hf_dinov2(sd, ViTConfig(**DINO))),
    "siglip": (_hf_siglip, lambda sd, d: t_conv.convert_hf_siglip(
        sd, TorchViTConfig(**SIGLIP), dtype=d),
        lambda sd: j_conv.convert_hf_siglip(sd, ViTConfig(**SIGLIP))),
}


def _jax_cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(a, dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", sorted(HF_CASES))
def test_hf_converters_equal_jax(model, dtype):
    """A tiny random-weight HF module's state dict through both packages'
    converters: every leaf equal. The bf16 case converts a bf16 state dict
    straight to bf16 against JAX's fp32 conversion cast to bf16."""
    make, port, ref = HF_CASES[model]
    sd = make()
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        sd = {k: v.to(tdt) if v.is_floating_point() else v
              for k, v in sd.items()}
    assert_tree_equal(port(sd, tdt),
                      _jax_cast(ref(sd), getattr(jax.numpy, dtype)))


def _timm_sd(cfg: ViTConfig, pos_rows: int, ls_name: str, rng) -> dict:
    """A random TIMM ``VisionTransformer`` state dict."""
    D, H, P = cfg.dim, cfg.hidden_dim, cfg.patch_size

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": r(D, 3, P, P),
          "patch_embed.proj.bias": r(D), "pos_embed": r(1, pos_rows, D),
          "norm.weight": r(D), "norm.bias": r(D)}
    if cfg.class_token:
        sd["cls_token"] = r(1, 1, D)
    if cfg.num_reg_tokens:
        sd["reg_token"] = r(1, cfg.num_reg_tokens, D)
    if cfg.pre_norm:
        sd["norm_pre.weight"], sd["norm_pre.bias"] = r(D), r(D)
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(D), b + "norm1.bias": r(D),
                   b + "attn.qkv.weight": r(3 * D, D),
                   b + "attn.qkv.bias": r(3 * D),
                   b + "attn.proj.weight": r(D, D), b + "attn.proj.bias": r(D),
                   b + "norm2.weight": r(D), b + "norm2.bias": r(D),
                   b + "mlp.fc1.weight": r(H, D), b + "mlp.fc1.bias": r(H),
                   b + "mlp.fc2.weight": r(D, H), b + "mlp.fc2.bias": r(D)})
        if cfg.layerscale:
            sd[b + f"ls1.{ls_name}"], sd[b + f"ls2.{ls_name}"] = r(D), r(D)
    return sd


# (tower, position rows in the checkpoint, LayerScale name, pre_norm)
TIMM_CASES = {
    "dino-cls-row-gamma": (DINO, 5, "gamma", False),
    "dino-no-embed-class-scale-factor": (DINO, 4, "scale_factor", False),
    "siglip-patch-rows": (SIGLIP, 4, None, False),
    "clip-norm-pre": (dict(SIGLIP, class_token=True, gelu_tanh=False),
                      5, None, True),
}


@pytest.mark.parametrize("case", sorted(TIMM_CASES))
def test_timm_vit_converter_equals_jax(case):
    """TIMM naming: a class position row or a zero row prepended
    (``no_embed_class``), LayerScale as ``gamma`` or ``scale_factor``,
    ``norm_pre``. The converter reads the config's fields only, so the
    CLIP case passes JAX's config (the port builds no CLIP tower)."""
    tower, rows, ls_name, pre_norm = TIMM_CASES[case]
    cfg = ViTConfig(**tower, pre_norm=pre_norm)
    sd = _timm_sd(cfg, rows, ls_name, np.random.default_rng(3))
    port_cfg = cfg if pre_norm else TorchViTConfig(**tower)
    got = t_conv.convert_timm_vit(sd, port_cfg)
    assert_tree_equal(got, j_conv.convert_timm_vit(sd, cfg))
    if rows == cfg.num_patches and cfg.class_token:
        assert not got["pos_embed"][0, 0].any()


def test_projector_converter_equals_jax():
    rng = np.random.default_rng(4)
    sd = {f"projector.{i}.{leaf}": torch.from_numpy(
        rng.standard_normal((8, 6) if leaf == "weight" else (8,))
        .astype(np.float32)) for i in (0, 2, 4) for leaf in ("weight", "bias")}
    assert_tree_equal(t_conv.convert_projector(sd),
                      j_conv.convert_projector(sd))


@pytest.mark.parametrize("cls_row", [True, False])
@pytest.mark.parametrize("grids", [(37, 16), (16, 24), (16, 16)],
                         ids=["37to16", "16to24", "16to16"])
def test_resize_pos_embed_matches_jax_image_resize(grids, cls_row):
    """Bicubic with antialiasing (37 -> 16 widens the kernel), upsampling
    and the identity, against ``jax.image.resize`` through JAX's
    converter helper."""
    src, dst = grids
    rng = np.random.default_rng(src * 100 + dst)
    pos = rng.standard_normal((1, src * src + cls_row, 40)).astype(np.float32)
    want = j_conv.resize_pos_embed(pos, src, dst, has_cls_row=cls_row)
    got = t_conv.resize_pos_embed(torch.from_numpy(pos), src, dst,
                                  has_cls_row=cls_row).numpy()
    assert got.shape == want.shape == (1, dst * dst + cls_row, 40)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.fixture(scope="module")
def tree():
    cfg = tiny_vlm_config(vocab_size=128)
    jparams = init_vlm_params(jax.random.PRNGKey(11), cfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    return cfg, jparams, tparams


def test_prismatic_export_equals_jax_and_the_reference_inventory(tree):
    cfg, jparams, tparams = tree
    got = t_conv.params_to_prismatic_sd(tparams, cfg)
    want = j_conv.params_to_prismatic_sd(jparams, cfg)
    expected = expected_prismatic_keys(cfg)
    for part in ("projector", "llm_backbone", "vision_backbone"):
        assert set(got[part]) == set(want[part]) == expected[part], part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype, k
            assert torch.equal(got[part][k], v), k
            # each tensor owns its storage (no row of a stacked leaf drags
            # the whole leaf into the file)
            assert (got[part][k].untyped_storage().nbytes()
                    == v.numel() * v.element_size()), k


def test_hf_export_equals_jax_and_the_reference_remap(tree):
    cfg, jparams, tparams = tree
    got = t_conv.params_to_hf_sd(tparams, cfg)
    want = j_conv.params_to_hf_sd(jparams, cfg)
    ref = reference_remap_to_hf(j_conv.params_to_prismatic_sd(jparams, cfg))
    assert set(got) == set(want) == set(ref)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # and back: the flat dict converts to the same tree in both packages
    assert_tree_equal(t_conv.convert_hf_openvla_sd(got, cfg),
                      j_conv.convert_hf_openvla_sd(want, cfg))


def test_export_keeps_bf16_and_refuses_a_quantized_tree(tree):
    from emmax_torch.serving.quant import quantize_vlm_params

    cfg, _, tparams = tree
    bf16 = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), tparams)
    sd = t_conv.params_to_hf_sd(bf16, cfg)
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="quantized"):
        t_conv.params_to_hf_sd(quantize_vlm_params(tparams, bits=4), cfg)


def _all_dtypes(rng):
    """One tensor per dtype the reader lists, odd shapes and a scalar."""
    out = {}
    for name, dtype in sio.DTYPES.items():
        if dtype == torch.bool:
            t = torch.from_numpy(rng.integers(0, 2, (3, 5)).astype(bool))
        elif dtype.is_floating_point:
            t = torch.from_numpy(rng.standard_normal((7, 3))).to(dtype)
        else:
            info = torch.iinfo(dtype)
            t = torch.from_numpy(rng.integers(max(info.min, -1000),
                                              min(info.max, 1000), (2, 9))
                                 ).to(dtype)
        out[f"t_{name}"] = t
    out["scalar"] = torch.tensor(3.5)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("name", sorted(sio.DTYPES))
def test_reads_library_files_bit_for_bit(name, tmp_path):
    sd = _all_dtypes(np.random.default_rng(5))
    st.save_file(sd, tmp_path / "a.safetensors", metadata={"format": "pt"})
    got = sio.load_file(tmp_path / "a.safetensors")
    assert set(got) == set(sd)
    key = f"t_{name}"
    assert got[key].dtype == sd[key].dtype == sio.DTYPES[name]
    assert got[key].shape == sd[key].shape
    assert torch.equal(_bits(got[key]), _bits(sd[key]))
    assert torch.equal(got["scalar"], sd["scalar"])
    assert got["empty"].shape == (0, 4)


def test_library_reads_port_files_with_metadata(tmp_path):
    sd = _all_dtypes(np.random.default_rng(6))
    sio.save_file(sd, tmp_path / "b.safetensors", metadata={"k": "v"})
    got = st.load_file(tmp_path / "b.safetensors")
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(_bits(got[k]),
                                                       _bits(v)), k
    from safetensors import safe_open

    with safe_open(tmp_path / "b.safetensors", "pt") as f:
        assert f.metadata() == {"k": "v"}
    assert sio.read_header(tmp_path / "b.safetensors")[1] == {"k": "v"}


def test_sharded_dirs_both_ways(tmp_path):
    rng = np.random.default_rng(7)
    sd = {f"w{i}": torch.from_numpy(rng.standard_normal((64, 32))
                                    .astype(np.float32)).to(torch.bfloat16)
          for i in range(5)}
    # the port's shards (4 KiB each at most: two tensors a shard) ...
    paths = sio.save_dir(sd, tmp_path / "port", max_shard_bytes=8192)
    assert [p.name for p in paths] == [
        f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    index = json.loads((tmp_path / "port" / sio.INDEX_FILE).read_text())
    assert set(index["weight_map"]) == set(sd)
    lib = {}
    for p in paths:
        lib.update(st.load_file(p))
    for got in (lib, sio.load_dir(tmp_path / "port")):
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    # ... and the library's shards, with an index, read by the port
    (tmp_path / "lib").mkdir()
    st.save_file({k: sd[k] for k in ("w0", "w1")},
                 tmp_path / "lib" / "model-00001-of-00002.safetensors")
    st.save_file({k: sd[k] for k in ("w2", "w3", "w4")},
                 tmp_path / "lib" / "model-00002-of-00002.safetensors")
    wm = {k: f"model-0000{1 + (k > 'w1')}-of-00002.safetensors" for k in sd}
    (tmp_path / "lib" / sio.INDEX_FILE).write_text(json.dumps(
        {"metadata": {}, "weight_map": wm}))
    got = sio.load_dir(tmp_path / "lib")
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    # an index naming a tensor its shard lacks raises
    wm["w4"] = "model-00001-of-00002.safetensors"
    (tmp_path / "lib" / sio.INDEX_FILE).write_text(json.dumps(
        {"metadata": {}, "weight_map": wm}))
    with pytest.raises(KeyError, match="w4"):
        sio.load_dir(tmp_path / "lib")


def test_loaded_tensors_are_private_maps(tmp_path):
    """Tensors share pages with the file until written; a write stays in
    the process (copy-on-write) and never reaches the file."""
    sd = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    sio.save_file(sd, tmp_path / "c.safetensors")
    got = sio.load_file(tmp_path / "c.safetensors")
    got["w"][0, 0] = 100.0
    assert st.load_file(tmp_path / "c.safetensors")["w"][0, 0] == 0.0
    moved = sio.load_file(tmp_path / "c.safetensors", device="cpu")
    assert torch.equal(moved["w"], sd["w"])
    with open(tmp_path / "bad.safetensors", "wb") as f:
        f.write(b"\x01")
    with pytest.raises(ValueError, match="not a safetensors"):
        sio.load_file(tmp_path / "bad.safetensors")
