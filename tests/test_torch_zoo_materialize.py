"""Port parity for the backbone zoo's configs: every vision and LLM
backbone id of ``emmax_tpu/models/materialize.py`` builds in the port
with the JAX package's config field by field, and so does every
registered ``model_id`` (``get_vlm_config``, ``load.build_vlm``) and the
Phi VLA configs. Image transforms equal JAX's except where the port mends
it: DINO + CLIP-336 takes 336 px images, the size of both its towers.
"""

import dataclasses

import pytest

from emmax_torch.conf import vla as t_vla
from emmax_torch.models import load as t_load
from emmax_torch.models import materialize as t_mat
from emmax_torch.models.llama import LlamaConfig
from emmax_torch.models.phi import PhiConfig
from emmax_torch.ops import image as t_image
from emmax_tpu.conf import ModelConfig as JaxModelConfig
from emmax_tpu.models import load as j_load
from emmax_tpu.models import materialize as j_mat

VISION_IDS = sorted(j_mat.VISION_BACKBONES)
LLM_IDS = sorted(j_mat.LLM_BACKBONES)
MODEL_IDS = sorted(JaxModelConfig._registry[JaxModelConfig])
RESIZES = ("resize-naive", "resize-crop", "letterbox")


def _towers(vision):
    return [(name, type(cfg).__name__, dataclasses.asdict(cfg))
            for name, cfg in vision]


def _llm(cfg):
    return type(cfg).__name__, dataclasses.asdict(cfg)


def test_the_zoo_is_the_jax_zoo():
    assert sorted(t_mat.VISION_BACKBONES) == VISION_IDS and \
        len(VISION_IDS) == 9
    assert sorted(t_mat.LLM_BACKBONES) == LLM_IDS and len(LLM_IDS) == 9
    assert len(MODEL_IDS) > 40
    for kind, fn in (("vision", t_mat.get_vision_config),
                     ("llm", t_mat.get_llm_config)):
        with pytest.raises(KeyError, match=f"unknown {kind} backbone"):
            fn("no-such-backbone")


@pytest.mark.parametrize("vid", VISION_IDS)
def test_vision_backbone_matches_jax(vid):
    got, want = t_mat.get_vision_config(vid), j_mat.get_vision_config(vid)
    assert _towers(got) == _towers(want)
    counts = {cfg.num_patches for _, cfg in got}
    assert len(counts) == 1, "towers must agree on patch count"
    for resize in RESIZES:
        tt = t_mat.get_image_transforms(vid, resize)
        jt = j_mat.get_image_transforms(vid, resize)
        assert tt.keys() == jt.keys() == dict(got).keys()
        for name, cfg in got:
            # each tower gets images at its own size
            assert tt[name].size == cfg.img_size, (vid, name)
            want_t = dict(jt[name].__dict__)
            if vid.startswith("dinoclip"):   # JAX gives 224 px: mended
                assert want_t["size"] == 224
                want_t["size"] = 336
            assert tt[name].__dict__ == want_t, (vid, name)


@pytest.mark.parametrize("lid", LLM_IDS)
def test_llm_backbone_matches_jax(lid):
    (got, family), (want, jfamily) = (t_mat.get_llm_config(lid),
                                      j_mat.get_llm_config(lid))
    assert family == jfamily
    assert _llm(got) == _llm(want)
    assert isinstance(got, PhiConfig if lid.startswith("phi")
                      else LlamaConfig)
    assert got.head_dim == want.head_dim


@pytest.mark.parametrize("model_id", MODEL_IDS)
def test_model_id_builds_jax_config(model_id):
    got, want = t_mat.get_vlm_config(model_id), j_mat.get_vlm_config(model_id)
    assert _towers(got.vision) == _towers(want.vision)
    assert _llm(got.llm) == _llm(want.llm)
    assert got.arch_specifier == want.arch_specifier
    assert got.num_patches == want.num_patches
    assert got.vision_dim == want.vision_dim
    mc = JaxModelConfig.get_choice_class(model_id)()
    args = (mc.vision_backbone_id, mc.llm_backbone_id, mc.arch_specifier)
    (tcfg, tfam), (jcfg, jfam) = t_load.build_vlm(*args), \
        j_load.build_vlm(*args)
    assert tfam == jfam and tcfg == got
    assert _llm(tcfg.llm) == _llm(jcfg.llm)


@pytest.mark.parametrize("vla_id", ["phi-2+3b-bridge", "phi-2+3b-bridge-2gpu",
                                    "phi-2+3b-bridge-2gpu-bf16"])
def test_phi_vla_configs_build(vla_id):
    vla = t_vla.VLAConfig.get_choice_class(vla_id)()
    cfg = t_mat.get_vlm_config(vla.base_vlm)
    assert vla.base_vlm == "phi-2+3b"
    assert isinstance(cfg.llm, PhiConfig) and cfg.llm.rotary_dim == 32
    assert [n for n, _ in cfg.vision] == ["clip"]
    assert cfg.num_patches == 576 and cfg.vision_dim == 1024


def test_zoo_patch_counts_and_prefixes():
    """The towers' token counts the card runs (patches + class and
    register tokens) and their head widths."""
    tokens = {vid: [(cfg.num_patches + cfg.num_prefix, cfg.head_dim)
                    for _, cfg in t_mat.get_vision_config(vid)]
              for vid in VISION_IDS}
    assert tokens["clip-vit-l"] == [(257, 64)]
    assert tokens["clip-vit-l-336px"] == [(577, 64)]
    assert tokens["in1k-vit-l"] == [(197, 64)]
    assert tokens["siglip-vit-so400m-384px"] == [(729, 72)]
    assert tokens["dinoclip-vit-l-336px"] == [(581, 64), (577, 64)]
    assert tokens["dinosiglip-vit-so-384px"] == [(734, 64), (729, 72)]
    # 384 px at patch 14: a 27 x 27 grid over the top-left 378 px
    (_, dino384), _ = t_mat.get_vision_config("dinosiglip-vit-so-384px")
    assert dino384.grid == 27
    assert t_image.transform_configs_for_backbone(
        "dinosiglip-vit-so-384px", "letterbox")["dino"].size == 384
