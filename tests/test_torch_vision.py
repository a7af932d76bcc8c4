"""Port parity: image preprocessing, the vision towers and the projector
(``emmax_torch``) against ``emmax_tpu`` on the same numpy inputs and the
same weights (bridged), in fp32 on the CPU.

Tolerances: preprocessing 1e-4 absolute on normalized pixels (the resize
weights are built in fp32 by both, and each output sums ~10 taps per axis
in another order; normalization divides by std ~0.225); towers and
projector 1e-5 (fp32 matmuls in another order). With bf16 weights and
f32 pixels both packages compute in f32 from the same weights, so the
encode is held to 1e-5 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import projector as t_proj
from emmax_torch.models import vit as t_vit
from emmax_torch.models import vlm as t_vlm
from emmax_torch.ops import image as t_image
from emmax_tpu.models import projector as j_proj
from emmax_tpu.models import vit as j_vit
from emmax_tpu.models import vlm as j_vlm
from emmax_tpu.ops import image as j_image


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


# downsampling from 256x256 and 480x640, upsampling from 100x150 and 30x20
SIZES = [(256, 256), (480, 640), (100, 150), (30, 20)]


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop",
                                      "letterbox"])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_preprocess_matches(hw, strategy):
    img = np.random.default_rng(hw[0]).integers(0, 256, (2, *hw, 3),
                                                dtype=np.uint8)
    j_cfgs = j_image.dinosiglip_transform_configs(224, strategy)
    t_cfgs = t_image.dinosiglip_transform_configs(224, strategy)
    want = j_image.preprocess_for_towers(jnp.asarray(img), j_cfgs)
    got = t_image.preprocess_for_towers(torch.from_numpy(img), t_cfgs)
    assert set(got) == {"dino", "siglip"}
    for name in want:
        assert got[name].shape == (2, 224, 224, 3)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-4)


def test_resize_identity_is_exact():
    img = np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3),
                                            dtype=np.uint8)
    cfg = t_image.ImageTransformConfig(size=224)
    got = t_image.apply_transform(torch.from_numpy(img), cfg)
    want = t_image.normalize(torch.from_numpy(img).float() / 255.0,
                             cfg.mean, cfg.std)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("tower", ["dino", "siglip"])
def test_vit_forward_matches(tower):
    j_cfg = dict(j_vlm.tiny_vlm_config().vision)[tower]
    t_cfg = dict(t_vlm.tiny_vlm_config().vision)[tower]
    params = j_vit.init_vit_params(jax.random.PRNGKey(3), j_cfg)
    if j_cfg.layerscale:      # make layerscale visible in the output
        params["blocks"]["ls1"] = params["blocks"]["ls1"] * 1e4
        params["blocks"]["ls2"] = params["blocks"]["ls2"] * 1e4
    images = np.random.default_rng(1).standard_normal(
        (2, j_cfg.img_size, j_cfg.img_size, 3)).astype(np.float32)
    want = np.asarray(j_vit.vit_forward(params, j_cfg, jnp.asarray(images)))
    got = t_vit.vit_forward(_bridge(params), t_cfg, torch.from_numpy(images))
    assert got.shape == (2, t_cfg.num_patches, t_cfg.dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the module holds the same weights and gives the same features
    module = t_vit.ViT(t_cfg, _bridge(params))
    torch.testing.assert_close(module(torch.from_numpy(images)), got,
                               rtol=0, atol=0)


def test_vit_prefix_and_final_norm_options():
    j_cfg = dict(j_vlm.tiny_vlm_config().vision)["dino"]
    t_cfg = dict(t_vlm.tiny_vlm_config().vision)["dino"]
    params = j_vit.init_vit_params(jax.random.PRNGKey(4), j_cfg)
    images = np.random.default_rng(2).standard_normal(
        (1, 28, 28, 3)).astype(np.float32)
    kw = dict(num_blocks=j_cfg.depth, strip_prefix=False, final_norm=True)
    want = np.asarray(j_vit.vit_forward(params, j_cfg, jnp.asarray(images),
                                        **kw))
    got = t_vit.vit_forward(_bridge(params), t_cfg, torch.from_numpy(images),
                            **kw)
    assert got.shape[1] == t_cfg.num_patches + t_cfg.num_prefix
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_projector_matches():
    params = j_proj.init_projector_params(
        jax.random.PRNGKey(5), "no-align+fused-gelu-mlp", 80, 64)
    x = np.random.default_rng(3).standard_normal((2, 4, 80)).astype(
        np.float32)
    want = np.asarray(j_proj.projector_forward(params, jnp.asarray(x)))
    got = t_proj.projector_forward(_bridge(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert [tuple(layer["kernel"].shape) for layer in _bridge(params)[
        "layers"]] == t_proj.projector_dims("fused-gelu-mlp", 80, 64)


def test_encode_images_with_bf16_weights_runs_in_f32_as_jax_does():
    # f32 pixels against bf16 weights: JAX promotes and runs the towers and
    # the projector in f32; the port must do the same, not run them in bf16
    j_cfg, t_cfg = j_vlm.tiny_vlm_config(), t_vlm.tiny_vlm_config()
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(6), j_cfg,
                                   dtype=jnp.bfloat16)
    rng = np.random.default_rng(4)
    pixels = {name: rng.standard_normal(
        (2, v.img_size, v.img_size, 3)).astype(np.float32)
        for name, v in j_cfg.vision}
    want = np.asarray(j_vlm.encode_images(
        params, j_cfg, {k: jnp.asarray(v) for k, v in pixels.items()}))
    got = t_vlm.encode_images(_bridge(params), t_cfg,
                              {k: torch.from_numpy(v)
                               for k, v in pixels.items()})
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
