"""Port parity for the zoo's vision towers against ``emmax_tpu`` on the
same numpy pixels and the same weights (bridged), in fp32 on the CPU:
CLIP (class token, the LayerNorm before the blocks, quick GELU), IN1K
(patch 16), a resolution the patch does not divide (the 384 px towers'
27 x 27 grid over the top-left 378 px, at tiny size), and DINO + CLIP's
two towers through the projector; ``convert_timm_vit`` of a CLIP state
dict with ``norm_pre``; and a reference Prismatic ``.pt`` of a CLIP-tower,
Llama-decoder VLM read by both packages' ``convert_prismatic_pt``.

Tolerances: towers and projector 1e-5 (``test_torch_vision.py``: fp32
matmuls in another order); converted weights bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import convert as t_convert
from emmax_torch.models import load as t_load
from emmax_torch.models import vit as t_vit
from emmax_torch.models import vlm as t_vlm
from emmax_torch.models.llama import LlamaConfig as TLlamaConfig
from emmax_tpu.models import convert as j_convert
from emmax_tpu.models import load as j_load
from emmax_tpu.models import vit as j_vit
from emmax_tpu.models import vlm as j_vlm

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(patch_size=14, dim=32, depth=3, n_heads=2, hidden_dim=64)
TOWERS = {
    "clip": dict(img_size=28, class_token=True, pre_norm=True,
                 quick_gelu=True, norm_eps=1e-5, **TINY),
    "in1k": dict(TINY, img_size=32, patch_size=16, class_token=True),
    # 31 px at patch 14: a 2 x 2 grid over the top-left 28 px (the 384 px
    # towers' 27 x 27 over 378 px)
    "grid384": dict(img_size=31, class_token=True, num_reg_tokens=4,
                    layerscale=True, **TINY),
}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jitter(host, rng):
    """Every leaf moved off its init, so unit norms, zero biases and
    layerscale show in the output."""
    if isinstance(host, dict):
        return {k: _jitter(v, rng) for k, v in host.items()}
    if isinstance(host, list):
        return [_jitter(v, rng) for v in host]
    return host + rng.normal(0, 0.1, host.shape).astype(np.float32)


def _port_vlm_cfg(cfg):
    """The port's VLMConfig equal to a JAX one, field by field."""
    return t_vlm.VLMConfig(
        vision=tuple((n, t_vit.ViTConfig(**dataclasses.asdict(v)))
                     for n, v in cfg.vision),
        llm=TLlamaConfig(**dataclasses.asdict(cfg.llm)),
        arch_specifier=cfg.arch_specifier)


@pytest.mark.parametrize("kind", sorted(TOWERS))
def test_tower_matches_jax(kind):
    jcfg = j_vit.ViTConfig(**TOWERS[kind])
    tcfg = t_vit.ViTConfig(**TOWERS[kind])
    host = _jitter(_host(j_vit.init_vit_params(jax.random.PRNGKey(3), jcfg)),
                   np.random.default_rng(0))
    assert ("pre_norm" in host) == jcfg.pre_norm
    images = np.random.default_rng(1).standard_normal(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32)
    for kw in ({}, dict(num_blocks=jcfg.depth, strip_prefix=False,
                        final_norm=True)):
        want = np.asarray(j_vit.vit_forward(
            jax.tree_util.tree_map(jnp.asarray, host), jcfg,
            jnp.asarray(images), **kw))
        got = t_vit.vit_forward(params_from_numpy(host), tcfg,
                                torch.from_numpy(images), **kw)
        n = tcfg.num_patches + (0 if not kw else tcfg.num_prefix)
        assert got.shape == (2, n, tcfg.dim)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's init builds the JAX tree's leaves
    tparams = t_vit.init_vit_params(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree_util.tree_structure(tparams) == \
        jax.tree_util.tree_structure(host)


def test_dinoclip_two_towers_match_jax():
    """DINO (registers) + CLIP at one patch count, concatenated on channels
    and projected: ``encode_images`` of both packages."""
    base = j_vlm.tiny_vlm_config()
    clip = j_vit.ViTConfig(**TOWERS["clip"])
    jcfg = dataclasses.replace(base, vision=(("dino", base.vision[0][1]),
                                             ("clip", clip)))
    assert jcfg.num_patches == 4 and jcfg.vision_dim == 64
    host = _jitter(_host(j_vlm.init_vlm_params(jax.random.PRNGKey(4), jcfg)),
                   np.random.default_rng(2))
    rng = np.random.default_rng(3)
    px = {n: rng.standard_normal((2, v.img_size, v.img_size, 3))
          .astype(np.float32) for n, v in jcfg.vision}
    want = j_vlm.encode_images(jax.tree_util.tree_map(jnp.asarray, host),
                               jcfg, {k: jnp.asarray(v) for k, v in
                                      px.items()})
    got = t_vlm.encode_images(params_from_numpy(host), _port_vlm_cfg(jcfg),
                              {k: torch.from_numpy(v) for k, v in
                               px.items()})
    assert got.shape == (2, 4, jcfg.llm.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_towers_must_agree_on_patch_count():
    clip = t_vit.ViTConfig(**TOWERS["clip"])
    in1k = t_vit.ViTConfig(**dict(TOWERS["in1k"], img_size=48))
    cfg = t_vlm.VLMConfig(vision=(("clip", clip), ("in1k", in1k)),
                          llm=t_vlm.tiny_vlm_config().llm)
    with pytest.raises(ValueError, match="patch count"):
        cfg.num_patches


def _timm_sd(cfg, rng, src_grid=None, prefix=""):
    """A random TIMM ``VisionTransformer`` state dict (numpy) for ``cfg``,
    its position table at ``src_grid`` (resized by the converters)."""
    D, F, P = cfg.dim, cfg.hidden_dim, cfg.patch_size
    g = src_grid or cfg.grid
    shapes = {"patch_embed.proj.weight": (D, 3, P, P),
              "patch_embed.proj.bias": (D,),
              "pos_embed": (1, g * g + int(cfg.class_token), D),
              "norm.weight": (D,), "norm.bias": (D,)}
    if cfg.class_token:
        shapes["cls_token"] = (1, 1, D)
    if cfg.pre_norm:
        shapes.update({"norm_pre.weight": (D,), "norm_pre.bias": (D,)})
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        shapes.update({
            b + "norm1.weight": (D,), b + "norm1.bias": (D,),
            b + "attn.qkv.weight": (3 * D, D), b + "attn.qkv.bias": (3 * D,),
            b + "attn.proj.weight": (D, D), b + "attn.proj.bias": (D,),
            b + "norm2.weight": (D,), b + "norm2.bias": (D,),
            b + "mlp.fc1.weight": (F, D), b + "mlp.fc1.bias": (F,),
            b + "mlp.fc2.weight": (D, F), b + "mlp.fc2.bias": (D,)})
    return {prefix + k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)


@pytest.mark.parametrize("src_grid", [2, 3], ids=["same-grid", "resized"])
def test_convert_timm_clip_with_norm_pre_matches_jax(src_grid):
    jcfg = j_vit.ViTConfig(**TOWERS["clip"])
    sd = _timm_sd(jcfg, np.random.default_rng(5), src_grid)
    want = j_convert.convert_timm_vit(sd, jcfg)
    got = t_convert.convert_timm_vit(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        t_vit.ViTConfig(**TOWERS["clip"]))
    assert "pre_norm" in got
    if src_grid == jcfg.grid:
        _assert_tree_equal(got, want)
    else:     # the bicubic resize: float32 sums in another order
        np.testing.assert_allclose(got["pos_embed"].numpy(),
                                   want["pos_embed"], rtol=0, atol=1e-6)
        _assert_tree_equal({k: v for k, v in got.items() if k != "pos_embed"},
                           {k: v for k, v in want.items()
                            if k != "pos_embed"})


def test_prismatic_pt_with_a_clip_tower_loads_as_jax(tmp_path):
    """A reference ``.pt`` (``{"model": {"projector", "llm_backbone",
    "vision_backbone"}}``) of a CLIP-tower, Llama-decoder VLM: the port's
    ``convert_prismatic_pt`` gives JAX's tree, and the two forwards agree
    on it."""
    base = j_vlm.tiny_vlm_config()
    clip = j_vit.ViTConfig(**TOWERS["clip"])
    jcfg = dataclasses.replace(base, vision=(("clip", clip),))
    tcfg = _port_vlm_cfg(jcfg)
    host = _host(j_vlm.init_vlm_params(jax.random.PRNGKey(6), jcfg))
    parts = t_convert.params_to_prismatic_sd(params_from_numpy(host), tcfg)
    parts["vision_backbone"] = {
        k: torch.from_numpy(v) for k, v in _timm_sd(
            clip, np.random.default_rng(7), prefix="clip_featurizer.").items()}
    path = tmp_path / "x.pt"
    torch.save({"model": parts}, path)
    want = j_load.convert_prismatic_pt(path, jcfg)
    got = t_load.convert_prismatic_pt(path, tcfg)
    _assert_tree_equal(got, want)
    assert "pre_norm" in got["vision"]["clip"]
    rng = np.random.default_rng(8)
    px = {"clip": rng.standard_normal((1, 28, 28, 3)).astype(np.float32)}
    jw = j_vlm.encode_images(jax.tree_util.tree_map(jnp.asarray, want), jcfg,
                             {"clip": jnp.asarray(px["clip"])})
    tw = t_vlm.encode_images(got, tcfg, {"clip": torch.from_numpy(
        px["clip"])})
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
