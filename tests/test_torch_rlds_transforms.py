"""The port's trajectory and image transforms against the JAX package's
(TensorFlow here): relabeling with the same random draws, the
fixed-parameter augment ops against TF's ops (within 1e-5), and every OXE
standardization transform (exact, or within 1e-6 where a transform takes
a transcendental function)."""

import zlib

import numpy as np
import pytest
import tensorflow as tf
import torch

from emmax_torch.data import augment, oxe, relabeling
from emmax_tpu.data import augment as jaugment
from emmax_tpu.data import oxe as joxe
from emmax_tpu.data import relabeling as jrelabeling

T = 7


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def assert_close(got, want, path="", tol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert_close(got[k], want[k], f"{path}/{k}", tol)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, f"{path}: {g.shape} vs {w.shape}"
    if w.dtype.kind in "OSU":
        assert g.tolist() == w.tolist(), path
    elif tol:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=path)
    else:
        assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=path)


def _traj(lang_pad_at=4):
    lang = np.full(T, b"put the fork", dtype=object)
    lang[lang_pad_at] = b""
    images = np.empty(T, dtype=object)
    images[:] = [f"img{i}".encode() for i in range(T)]
    return {
        "observation": {
            "image_primary": images,
            "proprio": np.arange(T * 7, dtype=np.float32).reshape(T, 7),
            "timestep": np.arange(T, dtype=np.int32),
        },
        "task": {"language_instruction": lang},
        "action": np.random.default_rng(0).normal(size=(T, 7)).astype(
            np.float32),
    }


def _tf_traj(traj):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tf.constant(x.tolist() if x.dtype == object else x)
    return conv(traj)


def test_relabeling_with_the_same_draws():
    u_goal = np.random.default_rng(1).uniform(size=T).astype(np.float32)
    u_keep = np.random.default_rng(2).uniform(size=T).astype(np.float32)
    ours = relabeling.add_pad_mask_dict(_traj())
    ours = relabeling.uniform_goal_relabel(ours, rand=lambda s: u_goal)
    ours = relabeling.delete_task_conditioning(ours, keep_image_prob=0.5,
                                               rand=lambda s: u_keep)
    theirs = jrelabeling.add_pad_mask_dict(_tf_traj(_traj()))
    theirs = jrelabeling.uniform_goal_relabel(
        theirs, rand=lambda s: tf.constant(u_goal))
    theirs = jrelabeling.delete_task_conditioning(
        theirs, keep_image_prob=0.5, rand=lambda s: tf.constant(u_keep))
    assert_close(ours, _tree(theirs))
    img = ours["task"]["pad_mask_dict"]["image_primary"]
    assert img[4] and (img ^ ours["task"]["pad_mask_dict"][
        "language_instruction"]).all()


# --- augmentation -----------------------------------------------------------

def _float_image(seed=0, h=29, w=33):
    img = np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)
    img[0, :4] = [[0.5] * 3, [0.2, 0.2, 0.7], [0.7, 0.2, 0.2], [0.2, 0.7, 0.7]]
    return img


@pytest.mark.parametrize("op,ours,theirs", [
    ("crop", lambda t: augment.crop_and_resize(t, (0.05, 0.1, 0.95, 0.9),
                                               (29, 33)),
     lambda x: tf.image.crop_and_resize(x[None], [(0.05, 0.1, 0.95, 0.9)],
                                        [0], (29, 33))[0]),
    ("crop outside", lambda t: augment.crop_and_resize(
        t, (-0.1, 0.2, 0.5, 1.2), (17, 9)),
     lambda x: tf.image.crop_and_resize(x[None], [(-0.1, 0.2, 0.5, 1.2)],
                                        [0], (17, 9))[0]),
    ("brightness", lambda t: augment.adjust_brightness(t, 0.13),
     lambda x: tf.image.adjust_brightness(x, 0.13)),
    ("contrast", lambda t: augment.adjust_contrast(t, 1.17),
     lambda x: tf.image.adjust_contrast(x, 1.17)),
    ("saturation low", lambda t: augment.adjust_saturation(t, 0.83),
     lambda x: tf.image.adjust_saturation(x, 0.83)),
    ("saturation high", lambda t: augment.adjust_saturation(t, 1.19),
     lambda x: tf.image.adjust_saturation(x, 1.19)),
    ("hue +", lambda t: augment.adjust_hue(t, 0.04),
     lambda x: tf.image.adjust_hue(x, 0.04)),
    ("hue -", lambda t: augment.adjust_hue(t, -0.05),
     lambda x: tf.image.adjust_hue(x, -0.05)),
    ("hue wrap", lambda t: augment.adjust_hue(t, -0.45),
     lambda x: tf.image.adjust_hue(x, -0.45)),
    ("flip lr", augment.flip_left_right, tf.image.flip_left_right),
    ("flip ud", augment.flip_up_down, tf.image.flip_up_down),
])
def test_augment_op_equals_tf(op, ours, theirs):
    img = _float_image()
    got = ours(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, theirs(tf.constant(img)).numpy(),
                               atol=1e-5, rtol=0, err_msg=op)


def test_augment_dtype_round_trip_and_keys():
    u8 = np.random.default_rng(3).integers(0, 256, (20, 20, 3), np.uint8)
    np.testing.assert_array_equal(
        augment.to_float(torch.from_numpy(u8)).numpy(),
        tf.image.convert_image_dtype(u8, tf.float32).numpy())
    f = np.random.default_rng(4).random((20, 20, 3)).astype(np.float32)
    f = f * 1.2 - 0.1
    np.testing.assert_array_equal(
        augment.to_uint8(torch.from_numpy(f)).numpy(),
        tf.image.convert_image_dtype(f, tf.uint8, saturate=True).numpy())
    kw = augment.OPENVLA_IMAGE_AUGMENT_KWARGS
    assert kw == jaugment.OPENVLA_IMAGE_AUGMENT_KWARGS
    t = torch.from_numpy(u8)
    a = augment.augment_image(t, (5, 0, 0), **kw)
    assert a.dtype == torch.uint8 and a.shape == t.shape
    assert torch.equal(a, augment.augment_image(t, (5, 0, 0), **kw))
    assert not torch.equal(a, augment.augment_image(t, (6, 0, 0), **kw))
    with pytest.raises(ValueError, match="unknown"):
        augment.augment_image(t, (0,), augment_order=["blur"])


# --- OXE ----------------------------------------------------------------------

def _z(x, dim):
    return zlib.compress(np.asarray(x, np.float32).reshape(dim).tobytes())


def _oxe_inputs():
    rng = np.random.default_rng(7)
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = r(T, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    strings = lambda p: np.asarray([f"{p}{i}".encode() for i in range(T)],  # noqa: E731
                                   dtype=object)
    codes = np.zeros((T, 12), np.int32)
    for i in range(T):
        s = [ord(c) for c in f"push {i} é"]
        codes[i, :len(s)] = s
    obs = {
        "state": r(T, 16), "robot_obs": r(T, 15), "robot_state": r(T, 15),
        "end_effector_cartesian_pos": r(T, 7), "image_with_depth":
            strings("d"), "natural_language_instruction": strings("go "),
        "instruction": codes, "depth_image": r(T, 4, 4, 1),
        "depth": r(T, 4, 4, 1), "depth_additional_view": r(T, 4, 4, 1),
        "end_effector_pose": r(T, 7), "position": r(T, 2), "yaw": r(T, 1),
        "eef_pose": r(T, 6), "state_gripper_pose": r(T),
        "tcp_base": r(T, 6), "gripper_width": r(T),
        "cartesian_position": r(T, 6), "gripper_position": rng.uniform(
            size=(T, 1)).astype(np.float32),
        "clip_function_input/base_pose_tool_reached": np.asarray(
            [_z(r(7), 7) for _ in range(T)], dtype=object),
        "gripper_closed": np.asarray([_z(r(1), 1) for _ in range(T)],
                                     dtype=object),
        "exterior_image_1_left": strings("a"),
        "exterior_image_2_left": strings("b"),
    }
    grip = np.float32([[0.0], [1.0], [0.0], [-1.0], [0.0], [1.0], [0.3]])
    dict_action = {
        "world_vector": r(T, 3), "rotation_delta": r(T, 3),
        "gripper_closedness_action": grip,
        "open_gripper": rng.integers(0, 2, T).astype(bool),
        "rel_actions_world": np.concatenate([r(T, 6), grip * 0.7], 1),
        "future/xyz_residual": r(T, 30),
        "future/axis_angle_residual": r(T, 30),
        "future/target_close": rng.integers(0, 2, (T, 10)).astype(np.int64),
        "tcp_base": r(T, 6), "gripper": rng.uniform(size=T).astype(
            np.float32)}
    flat = np.concatenate([r(T, 6), np.float32(
        [[1.0], [0.97], [0.4], [0.02], [0.0], [1.0], [0.6]]), r(T, 3)], 1)
    flat[:, 3:7] = q
    common = {"action_dict": {"cartesian_velocity": r(T, 6) * 0.3,
                              "gripper_position": rng.uniform(
                                  size=(T, 1)).astype(np.float32)},
              "ground_truth_states": {"EE": r(T, 6)}}
    return ({"observation": obs, "action": dict_action, **common},
            {"observation": obs, "action": flat, **common})


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.copy()


TRANSCENDENTAL = {"furniture_bench_dataset_converted_externally_to_rlds",
                  "iamlab_cmu_pickup_insert_converted_externally_to_rlds",
                  "cmu_playing_with_food"}


def test_every_oxe_transform_equals_jax():
    assert set(oxe.OXE_STANDARDIZATION_TRANSFORMS) == set(
        joxe.OXE_STANDARDIZATION_TRANSFORMS)
    inputs = _oxe_inputs()
    for name, fn in sorted(oxe.OXE_STANDARDIZATION_TRANSFORMS.items()):
        if name == "droid":
            continue
        matched = 0
        for traj in inputs:
            try:
                want = _tree(joxe.OXE_STANDARDIZATION_TRANSFORMS[name](
                    _tf_traj(_copy(traj))))
            except (KeyError, TypeError, ValueError, IndexError,
                    tf.errors.OpError):
                continue
            got = fn(_copy(traj))
            assert_close(got, want, name,
                         tol=1e-6 if name in TRANSCENDENTAL else 0.0)
            matched += 1
        assert matched, f"{name}: no input the JAX transform takes"


def test_droid_swap_is_one_of_the_two_and_seeded():
    traj = _oxe_inputs()[1]
    want = _tree(joxe._droid_action(_tf_traj(_copy(traj))))
    seen = set()
    for seed in range(8):
        got = oxe.droid_baseact(_copy(traj), np.random.default_rng(seed))
        swapped = got["observation"]["exterior_image_1_left"][0] == b"b0"
        seen.add(bool(swapped))
        if swapped:
            got["observation"]["exterior_image_1_left"], got["observation"][
                "exterior_image_2_left"] = (
                got["observation"]["exterior_image_2_left"],
                got["observation"]["exterior_image_1_left"])
        assert_close(got, want)
    assert seen == {True, False}


def test_oxe_registry_mixtures_and_kwargs(tmp_path):
    assert oxe.OXE_DATASET_CONFIGS == joxe.OXE_DATASET_CONFIGS
    assert oxe.OXE_NAMED_MIXTURES == joxe.OXE_NAMED_MIXTURES
    assert [int(e) for e in oxe.StateEncoding] == [
        int(e) for e in joxe.StateEncoding]
    assert [int(e) for e in oxe.ActionEncoding] == [
        int(e) for e in joxe.ActionEncoding]
    for name in ("bridge_orig", "fractal20220817_data", "droid_wipe"):
        a = oxe.make_oxe_dataset_kwargs(name, tmp_path, load_depth=True)
        b = joxe.make_oxe_dataset_kwargs(name, tmp_path, load_depth=True)
        assert a.pop("standardize_fn") is oxe.OXE_STANDARDIZATION_TRANSFORMS[
            name]
        b.pop("standardize_fn")
        assert a == b
    # a JOINT_POS dataset is skipped with a warning, duplicates dropped
    mix = oxe.OXE_NAMED_MIXTURES["oxe_magic_soup_plus"] + [
        ("berkeley_mvp_converted_externally_to_rlds", 1.0), ("kuka", 9.0)]
    with pytest.warns(UserWarning, match="berkeley_mvp"):
        a, wa = oxe.get_oxe_dataset_kwargs_and_weights(tmp_path, mix)
    with pytest.warns(UserWarning, match="berkeley_mvp"):
        b, wb = joxe.get_oxe_dataset_kwargs_and_weights(tmp_path, mix)
    assert [k["name"] for k in a] == [k["name"] for k in b] and wa == wb


def test_droid_wrist_frame_actions():
    traj = _oxe_inputs()[1]
    want = _tree(joxe.droid_wristact(_tf_traj(_copy(traj))))
    assert_close(oxe.droid_wristact(_copy(traj)), want, tol=1e-5)
