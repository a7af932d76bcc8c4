"""fp32 x of the int4 matmul on the TF32 tensor cores
(``tf32::int4_tc_kernel`` in ``emmax_torch/csrc/int4_matmul.cu``), held
to ``emmax_tpu`` on the CPU through a numpy emulation of the kernel's
arithmetic:

- each nibble becomes its level ``q + 0.5`` by the kernel's bit trick (a
  masked mantissa, then one fp32 subtraction), exact, and exact in tf32;
- x is split into ``big = rna(x)`` and ``small = rna(x - big)``
  (``cvt.rna.tf32.f32``: the 13 low bits cleared, ties away from zero);
- each MMA adds 8 exact products level * part to its fp32 accumulator;
  the big and small products, the low and high planes and the groups are
  summed as the kernel sums them, each group's sums scaled by its bf16
  scale of the column.

The emulation is held to JAX's XLA route (``int4_matmul(..., impl="xla")``,
the route the fp32 port follows) and to the port's plain version within
1e-5 of the largest |reference| value. JAX's Pallas kernel rounds x to
bf16 (``emmax_tpu/ops/int4_matmul.py:311-313``); the port does not. The tiny
config loaded with ``dtype=float32, quantize="int4"`` gives JAX's greedy
text and actions.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emmax_torch.bridge import params_from_numpy
from emmax_torch.models import load as t_load
from emmax_torch.ops import int4_matmul as t4
from emmax_tpu.models import load as j_load
from emmax_tpu.ops import int4_matmul as j4

RTOL = 1e-5          # fp32 sums in another order: ~1e-7 seen


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _tf32_rna(a):
    """``cvt.rna.tf32.f32`` on finite values: round the 13 low bits away,
    ties away from zero (sign-magnitude bits)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """``split_tf32``: x = big + small, both tf32."""
    big = _tf32_rna(x)
    return big, _tf32_rna((x - big).astype(np.float32))


def _level(w, S, hi):
    """The kernel's ``level<S, HI>`` on uint32 words: the nibble at bits
    S .. S + 3 masked into the mantissa of 2^(23 - S) (the high plane's
    top bit flipped), then 2^(23 - S) + 7.5 subtracted in fp32."""
    E = 23 - S
    base = np.uint32((127 + E) << 23)
    m = w & np.uint32(0xF << S)
    v = (m ^ (base | np.uint32(8 << S))) if hi else (m | base)
    return v.view(np.float32) - np.float32(2.0 ** E + 7.5)


def _levels(w, H, P):
    """The kernel's ``levels<H, P>``: plane P's levels of bytes 2H and
    2H + 1 of each word."""
    sh8, sh16 = w << np.uint32(8), w >> np.uint32(16)
    return {(0, 0): (_level(sh8, 8, False), _level(w, 8, False)),
            (0, 1): (_level(w, 4, True), _level(w, 12, True)),
            (1, 0): (_level(w, 16, False), _level(sh16, 8, False)),
            (1, 1): (_level(sh16, 4, True), _level(sh16, 12, True))}[H, P]


def _emulate(x, q4, scale):
    """The kernel's arithmetic on fp32 x [M, D], q4 [D/2, F] int8 and
    scale [D/group, F] (float): per group and plane, per k-step of 16
    packed rows, two MMAs (packed rows 4t + 2h + {0, 1}, t = 0..3) each
    adding the big and then the small part's 8 exact products to an fp32
    sum; the group's two sums scaled and added to the fp32 total."""
    b = q4.astype(np.int32)
    lv = [((b & 15) - 8).astype(np.float64) + 0.5,
          (b >> 4).astype(np.float64) + 0.5]
    big, small = (p.astype(np.float64) for p in _split(x))
    d2 = q4.shape[0]
    gh = scale.shape[0] // 2
    group = d2 // gh
    s = scale.astype(np.float32)
    tot = np.zeros((x.shape[0], q4.shape[1]), np.float32)
    for g in range(gh):
        acc = []
        for p in range(2):
            a = np.zeros_like(tot)
            for k0 in range(g * group, (g + 1) * group, 16):
                for h in range(2):
                    ks = [k0 + 4 * t + 2 * h + i for t in range(4)
                          for i in range(2)]
                    for part in (big, small):
                        a = (a + part[:, p * d2 + np.array(ks)]
                             @ lv[p][ks]).astype(np.float32)
            acc.append(a)
        tot = (tot + (acc[0] * s[g] + acc[1] * s[gh + g])).astype(np.float32)
    return tot


def test_levels_are_exact_in_every_byte():
    """The bit trick gives ``(b & 15) - 7.5`` and ``(b >> 4) + 0.5`` for
    every byte value at each of a word's four bytes, and every level is a
    tf32 value (rounding it changes nothing)."""
    rng = np.random.default_rng(0)
    vals = np.arange(256, dtype=np.uint32)
    for k in range(4):
        other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(
            np.uint32) & np.uint32(~(0xFF << (8 * k)) & 0xFFFFFFFF)
        w = other | (vals << np.uint32(8 * k))
        byte = vals.astype(np.uint8).view(np.int8).astype(np.int32)
        want = {0: (byte & 15) - 7.5, 1: (byte >> 4) + 0.5}
        for p in range(2):
            got = _levels(w, k // 2, p)[k % 2]
            np.testing.assert_array_equal(got, want[p])
            np.testing.assert_array_equal(_tf32_rna(got), got)


def test_split_keeps_fp32_accuracy():
    """big and small are tf32 values and sum to x within 2^-22 |x|; big
    alone (one TF32 product) is off by up to 2^-11."""
    x = (np.random.default_rng(1).standard_normal(100_000)
         * np.exp2(np.random.default_rng(2).integers(-20, 20, 100_000))
         ).astype(np.float32)
    big, small = _split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    x64 = x.astype(np.float64)
    err = np.abs(big.astype(np.float64) + small - x64)
    assert np.all(err <= 2.0 ** -22 * np.abs(x64))
    assert np.max(np.abs(big - x64) / np.abs(x64)) > 2.0 ** -13


# (M, D, F, group): M 1 / 6 / 13 / 43 as decode, the batched engines and
# the verifier's chunks give it; F ragged against the 256- and 128-column
# blocks; groups of 128, 64, 32 and 16; an odd count of groups per plane
CASES = [(1, 512, 200, 128), (6, 256, 264, 64), (13, 256, 136, 32),
         (43, 288, 72, 16)]


@functools.lru_cache(maxsize=None)
def _case(case):
    M, D, F, group = case
    rng = np.random.default_rng(M + D)
    w = (rng.standard_normal((2, D, F)) * 0.02).astype(np.float32)
    q = j4.quantize_weight_int4_np(w, group=group)
    assert np.asarray(q["scale"]).shape[-2] == D // group
    x = rng.standard_normal((M, D)).astype(np.float32)
    layer = 1
    scale = np.asarray(params_from_numpy(q)["scale"][layer].float())
    return q, x, layer, _emulate(x, np.asarray(q["q4"])[layer], scale)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_emulation_matches_jax_xla_route(case):
    """The emulated kernel against JAX's XLA route on the stacked weight
    (fp32 x, fp32 dequantized weight)."""
    q, x, layer, got = _case(case)
    want = np.asarray(j4.int4_matmul(
        jnp.asarray(x), {"q4": jnp.asarray(q["q4"]),
                         "scale": jnp.asarray(q["scale"]),
                         "layer": jnp.int32(layer)}, impl="xla"))
    assert want.dtype == np.float32
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_emulation_matches_plain(case):
    """The emulated kernel against the port's plain version (the version
    the card tests and ``chip_smoke.py`` hold the kernel to)."""
    q, x, layer, got = _case(case)
    tq = params_from_numpy(q)
    plain = t4.int4_matmul(torch.from_numpy(x), {**tq, "layer": layer})
    assert plain.dtype == torch.float32
    assert _rel(got, plain.numpy()) <= RTOL


def test_fp32_int4_load_gives_jax_tokens(tmp_path):
    """``load_vla(dir, dtype=float32, quantize="int4")`` on a tiny
    Hugging Face dir: the same tree bytes and the same greedy text and
    actions as ``emmax_tpu``'s (the CPU runs the plain version, JAX its
    XLA route: both fp32 x on the fp32 dequantized weight)."""
    import jax

    from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config
    from test_torch_checkpoint import assert_tree_equal
    from test_torch_checkpoint_load import VOCAB, _frame, write_hf_dir

    cfg = tiny_vlm_config(vocab_size=VOCAB)
    d = write_hf_dir(tmp_path / "hf", cfg,
                     init_vlm_params(jax.random.PRNGKey(7), cfg))
    tvla = t_load.load_vla(d, dtype=torch.float32, device="cpu",
                           quantize="int4")
    jvla = j_load.load_vla(d, dtype=jnp.float32, quantize="int4")
    tree = tvla.engine.model.tree()
    assert tree["llm"]["layers"]["wq"]["q4"].dtype == torch.int8
    assert tree["llm"]["embed"].dtype == torch.float32
    assert_tree_equal(tree, jvla.engine.params)
    prompt = tvla.get_prompt("pick the cup", gripper_position=(10, 20))
    ta, tt = tvla.generate_actions(_frame(), prompt, max_new_tokens=12)
    ja, jt = jvla.generate_actions(_frame(), prompt, max_new_tokens=12)
    assert tt == jt and len(ta) == len(ja)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a, b)
