"""Open X-Embodiment registry in numpy, port of ``emmax_tpu/data/oxe.py``:
per-dataset configs (image / state keys, encodings), standardization
transforms, named mixtures and the kwargs factory with the EEF action
contract.

A standardize function takes a trajectory with a leading time axis (numpy
arrays; strings as object arrays of ``bytes``) and returns the canonical
layout: ``action`` [T, 7] = EEF delta xyz + rpy + absolute gripper in
[0, 1] with +1 = open, plus derived observation keys and
``language_instruction``. Each mirrors the same-named transform of the JAX
package, built from the same small set of combinators, in float32.
"""

from __future__ import annotations

import zlib
from copy import deepcopy
from enum import IntEnum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from emmax_torch.data.normalization import NormalizationType
from emmax_torch.data.relabeling import tree_map

Traj = Dict[str, Any]
f32 = np.float32


# === primitives ===============================================================

def invert_gripper(g):
    """+1 = open <-> 0 = open."""
    return f32(1.0) - g


def clip01(g):
    return np.clip(g, f32(0.0), f32(1.0))


def binarize_gripper(g):
    """Continuous [0, 1] -> binary by a reverse scan (in-transition frames
    take the state eventually reached)."""
    g = np.asarray(g, f32)
    out = np.empty_like(g)
    carry = g[-1] if len(g) else f32(0)
    for i in range(len(g) - 1, -1, -1):
        a = g[i]
        carry = f32(1.0) if a > 0.95 else (f32(0.0) if a < 0.05 else carry)
        out[i] = carry
    return out


def rel2abs_gripper(g):
    """Relative open / close commands -> absolute [0, 1] state, +1 = open:
    the last command carried through no-ops, leading no-ops back-filled
    with the inverse of the first command, open when there is none."""
    g = np.asarray(g, f32)
    cmd = np.where(g < -0.1, f32(1.0), np.where(g > 0.1, f32(0.0), f32(-1.0)))
    has = cmd >= 0
    s = f32(1.0) - cmd[int(np.argmax(has))] if has.any() else f32(1.0)
    out = np.empty_like(cmd)
    for i, c in enumerate(cmd):
        s = c if c >= 0 else s
        out[i] = s
    return out


def quat_to_euler(q):
    """[..., 4] quaternion (x, y, z, w) -> [..., 3] XYZ euler."""
    q = np.asarray(q, f32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    one, two = f32(1.0), f32(2.0)
    roll = np.arctan2(two * (w * x + y * z), one - two * (x * x + y * y))
    pitch = np.arcsin(np.clip(two * (w * y - z * x), -one, one))
    yaw = np.arctan2(two * (w * z + x * y), one - two * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


# === combinators ==============================================================

def _col(x):
    return x[:, None] if x.ndim == 1 else x


def _z(like, n):
    return np.zeros_like(like[:, :n])


def _cat(*parts):
    return np.concatenate(parts, axis=-1)


def _lang(traj: Traj, key: str = "natural_language_instruction") -> Traj:
    traj["language_instruction"] = traj["observation"][key]
    return traj


def _obs_split(traj: Traj, dst: str, src: str, sl) -> Traj:
    traj["observation"][dst] = traj["observation"][src][:, sl]
    return traj


def parts_action(world="world_vector", rot="rotation_delta",
                 grip="gripper_closedness_action",
                 grip_fn: Callable = rel2abs_gripper,
                 language: bool = True) -> Callable[[Traj], Traj]:
    """Dict-action family (RT-1 and friends): world vector, rotation delta
    (or zeros) and a post-processed gripper column."""
    def fn(traj: Traj) -> Traj:
        a = traj["action"]
        w = a[world]
        r = a[rot] if rot is not None else np.zeros_like(w)
        if grip is None:
            g = np.zeros_like(w[:, :1])
        elif grip_fn is rel2abs_gripper:
            raw = np.asarray(a[grip], f32)
            g = rel2abs_gripper(raw[:, 0] if raw.ndim == 2 else raw)[:, None]
        else:
            g = grip_fn(_col(np.asarray(a[grip], f32)))
        traj["action"] = _cat(w, r, g)
        return _lang(traj) if language else traj
    return fn


def flat_gripper(grip_fn: Callable) -> Callable[[Traj], Traj]:
    """Flat-action family: 6 arm dims kept, the last (gripper) processed."""
    def fn(traj: Traj) -> Traj:
        a = traj["action"]
        traj["action"] = _cat(a[:, :6], grip_fn(a[:, -1:]))
        return traj
    return fn


def chain(*fns: Callable[[Traj], Traj]) -> Callable[[Traj], Traj]:
    def fn(traj: Traj) -> Traj:
        for f in fns:
            traj = f(traj)
        return traj
    return fn


def obs_eef_split(src: str = "state", eef=slice(0, 6), grip=slice(-1, None),
                  eef_key: str = "eef_state",
                  grip_key: str = "gripper_state") -> Callable[[Traj], Traj]:
    def fn(traj: Traj) -> Traj:
        _obs_split(traj, eef_key, src, eef)
        _obs_split(traj, grip_key, src, grip)
        return traj
    return fn


# === per-dataset transforms ===================================================

def _identity(traj: Traj) -> Traj:
    return traj


def _drop_first_step(traj: Traj) -> Traj:
    """Bridge V2's first step carries an all-zero action
    (``traj_metadata`` is per trajectory, not per step)."""
    meta = traj.pop("traj_metadata", None)
    traj = tree_map(lambda x: x[1:], traj)
    if meta is not None:
        traj["traj_metadata"] = meta
    return traj


def _relabel_with_reached_state(traj: Traj, state_key: str = "state") -> Traj:
    """Movement actions = reached-state deltas; the last (action-less)
    step is dropped."""
    s = traj["observation"][state_key]
    move = s[1:, :6] - s[:-1, :6]
    grip = traj["action"][:-1, -1:]
    meta = traj.pop("traj_metadata", None)
    traj = tree_map(lambda x: x[:-1], traj)
    traj["action"] = np.concatenate([move, grip], axis=1)
    if meta is not None:
        traj["traj_metadata"] = meta
    return traj


def bridge_oxe(traj: Traj) -> Traj:
    traj = _drop_first_step(traj)
    traj = parts_action(grip="open_gripper",
                        grip_fn=lambda g: np.asarray(g, f32))(traj)
    traj = _relabel_with_reached_state(traj)
    return obs_eef_split(eef_key="EEF_state")(traj)


def bridge_orig(traj: Traj) -> Traj:
    traj = _drop_first_step(traj)
    a = traj["action"]
    traj["action"] = np.concatenate(
        [a[:, :6], binarize_gripper(a[:, -1])[:, None]], axis=1)
    traj = _relabel_with_reached_state(traj)
    return obs_eef_split(eef_key="EEF_state")(traj)


def ppgm(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = np.concatenate(
        [a[:, :6], binarize_gripper(a[:, -1])[:, None]], axis=1)
    _obs_split(traj, "EEF_state", "cartesian_position", slice(0, 6))
    _obs_split(traj, "gripper_state", "gripper_position", slice(-1, None))
    return traj


rt1 = parts_action()


def kuka(traj: Traj) -> Traj:
    traj = parts_action()(traj)
    for key, dim in (("clip_function_input/base_pose_tool_reached", 7),
                     ("gripper_closed", 1)):
        raw = [np.frombuffer(zlib.decompress(bytes(b)), "<f4")
               for b in traj["observation"][key]]
        traj["observation"][key] = np.concatenate(raw).reshape(-1, dim)
    return traj


def taco_play(traj: Traj) -> Traj:
    _obs_split(traj, "state_eef", "robot_obs", slice(0, 6))
    _obs_split(traj, "state_gripper", "robot_obs", slice(7, 8))
    a = traj["action"]["rel_actions_world"]
    traj["action"] = _cat(a[:, :6], clip01(a[:, -1:]))
    return _lang(traj)


def jaco_play(traj: Traj) -> Traj:
    _obs_split(traj, "state_eef", "end_effector_cartesian_pos", slice(0, 6))
    _obs_split(traj, "state_gripper", "end_effector_cartesian_pos",
               slice(-1, None))
    return parts_action(rot=None)(traj)


berkeley_cable_routing = parts_action(grip=None)
roboturk = parts_action(grip_fn=lambda g: invert_gripper(clip01(g)))
nyu_door_opening = parts_action()
viola = parts_action(grip_fn=lambda g: invert_gripper(clip01(g)))


def berkeley_autolab_ur5(traj: Traj) -> Traj:
    _obs_split(traj, "state", "robot_state", slice(6, 14))
    traj["observation"]["depth"] = traj["observation"].pop("image_with_depth")
    return parts_action()(traj)


toto = parts_action(grip="open_gripper",
                    grip_fn=lambda g: np.asarray(g, f32))
pusht = parts_action(grip_fn=lambda g: g)


def language_table(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a),
                          np.ones_like(a[:, :1]))
    # instructions are stored as padded unicode code points
    codes = np.asarray(traj["observation"]["instruction"])
    lang = np.empty(len(codes), dtype=object)
    lang[:] = ["".join(map(chr, row)).split("\x00")[0].encode()
               for row in codes.tolist()]
    traj["language_instruction"] = lang
    return traj


def stanford_kuka_multimodal(traj: Traj) -> Traj:
    traj["observation"]["depth_image"] = traj["observation"]["depth_image"][..., 0]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], _z(a, 3), a[:, -1:])
    return traj


nyu_rot = chain(obs_eef_split(),
                lambda t: {**t, "action": t["action"][..., :7]})


def stanford_hydra(traj: Traj) -> Traj:
    traj = flat_gripper(invert_gripper)(traj)
    s = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(s[:, :3], s[:, 7:10])
    traj["observation"]["gripper_state"] = s[:, -3:-2]
    return traj


austin_buds = chain(flat_gripper(lambda g: invert_gripper(clip01(g))),
                    lambda t: _obs_split(t, "state", "state", slice(0, 8)))


def nyu_franka_play(traj: Traj) -> Traj:
    for k in ("depth", "depth_additional_view"):
        traj["observation"][k] = traj["observation"][k][..., 0].astype(f32)
    _obs_split(traj, "eef_state", "state", slice(-6, None))
    a = traj["action"]
    traj["action"] = _cat(a[:, -8:-2], clip01(a[:, -2:-1]))
    return traj


def maniskill(traj: Traj) -> Traj:
    return _obs_split(traj, "gripper_state", "state", slice(7, 8))


def furniture_bench(traj: Traj) -> Traj:
    s = traj["observation"]["state"]
    traj["observation"]["state"] = _cat(s[:, :7], s[:, -1:])
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]),
                          invert_gripper(clip01(a[:, -1:])))
    return traj


def cmu_franka_exploration(traj: Traj) -> Traj:
    return {**traj, "action": traj["action"][..., :-1]}


ucsd_kitchen = chain(
    lambda t: _obs_split(t, "joint_state", "state", slice(0, 7)),
    lambda t: {**t, "action": t["action"][..., :-1]})


def ucsd_pick_place(traj: Traj) -> Traj:
    traj = obs_eef_split()(traj)
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], _z(a, 3), a[:, -1:])
    return traj


austin_sailor = flat_gripper(lambda g: invert_gripper(clip01(g)))
austin_sirius = flat_gripper(lambda g: invert_gripper(clip01(g)))


def bc_z(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(
        a["future/xyz_residual"][:, :3], a["future/axis_angle_residual"][:, :3],
        invert_gripper(np.asarray(a["future/target_close"][:, :1], f32)))
    return _lang(traj)


utokyo_pr2 = chain(obs_eef_split(),
                   lambda t: {**t, "action": t["action"][..., :-1]})
utokyo_xarm_pick_place = _identity


def utokyo_xarm_bimanual(traj: Traj) -> Traj:
    return {**traj, "action": traj["action"][..., -7:]}


def _pad_xyzg(traj: Traj, arm_dims: int) -> Traj:
    """[xyz.. (arm_dims), grip] -> 7 dims with zero rotation dims."""
    a = traj["action"]
    traj["action"] = _cat(a[:, :arm_dims], _z(a, 6 - arm_dims), a[:, -1:])
    return traj


def robo_net(traj: Traj) -> Traj:
    s = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(s[:, :4], _z(s, 2))
    traj["observation"]["gripper_state"] = s[:, -1:]
    return _pad_xyzg(traj, 4)


berkeley_mvp = _identity
berkeley_rpt = _identity


def kaist_nonprehensile(traj: Traj) -> Traj:
    _obs_split(traj, "state", "state", slice(-7, None))
    a = traj["action"]
    traj["action"] = _cat(a[:, :6], _z(a, 1))
    return traj


def stanford_mask_vit(traj: Traj) -> Traj:
    p = traj["observation"]["end_effector_pose"]
    traj["observation"]["eef_state"] = _cat(p[:, :4], _z(p, 2))
    traj["observation"]["gripper_state"] = p[:, -1:]
    return _pad_xyzg(traj, 4)


tokyo_lsmo = obs_eef_split()
dlr_sara_pour = _identity


def dlr_sara_grid_clamp(traj: Traj) -> Traj:
    return _obs_split(traj, "state", "state", slice(0, 6))


dlr_edan_shared_control = flat_gripper(invert_gripper)


def asu_table_top(traj: Traj) -> Traj:
    traj["observation"]["eef_state"] = traj["ground_truth_states"]["EE"]
    _obs_split(traj, "gripper_state", "state", slice(-1, None))
    return traj


robocook = obs_eef_split()


def imperial_wristcam(traj: Traj) -> Traj:
    return {**traj, "action": traj["action"][..., :-1]}


def iamlab_pick_insert(traj: Traj) -> Traj:
    _obs_split(traj, "joint_state", "state", slice(0, 7))
    _obs_split(traj, "gripper_state", "state", slice(7, 8))
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, 7:8])
    return traj


def uiuc_d3field(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), _z(a, 1))
    return traj


utaustin_mutex = chain(
    lambda t: _obs_split(t, "state", "state", slice(0, 8)),
    flat_gripper(lambda g: invert_gripper(clip01(g))))


def berkeley_fanuc(traj: Traj) -> Traj:
    _obs_split(traj, "joint_state", "state", slice(0, 6))
    _obs_split(traj, "gripper_state", "state", slice(6, 7))
    traj["action"] = _cat(traj["action"],
                          invert_gripper(traj["observation"]["gripper_state"]))
    return traj


def cmu_playing_with_food(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, -1:])
    return traj


def playfusion(traj: Traj) -> Traj:
    return {**traj, "action": _cat(traj["action"][:, :3],
                                   traj["action"][:, -4:])}


def cmu_stretch(traj: Traj) -> Traj:
    s = traj["observation"]["state"]
    traj["observation"]["eef_state"] = _cat(s[:, :3], _z(s, 3))
    traj["observation"]["gripper_state"] = s[:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def gnm(traj: Traj) -> Traj:
    o = traj["observation"]
    o["state"] = _cat(o["position"], _z(o["state"], 3), o["yaw"])
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a), _z(a, 1))
    return traj


def fmb(traj: Traj) -> Traj:
    o = traj["observation"]
    o["proprio"] = _cat(o["eef_pose"], o["state_gripper_pose"][..., None])
    return traj


def dobbe(traj: Traj) -> Traj:
    return {**traj, "observation": {**traj["observation"],
                                    "proprio": traj["observation"]["state"]}}


def roboset(traj: Traj) -> Traj:
    traj["observation"]["proprio"] = traj["observation"]["state"]
    a = traj["action"]
    traj["action"] = _cat(a[:, :7], invert_gripper(clip01(a[:, -1:])))
    return traj


def rh20t(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = _cat(a["tcp_base"], np.asarray(a["gripper"][:, None], f32))
    o = traj["observation"]
    o["proprio"] = _cat(o["tcp_base"], o["gripper_width"][..., None])
    return traj


def tdroid(traj: Traj) -> Traj:
    a = traj["action"]
    traj["action"] = np.concatenate(
        [a[:, :6], binarize_gripper(a[:, -1])[:, None]], axis=1)
    _obs_split(traj, "EEF_state", "cartesian_position", slice(0, 6))
    _obs_split(traj, "gripper_state", "gripper_position", slice(-1, None))
    return traj


def _droid_action(traj: Traj) -> Traj:
    vel = traj["action_dict"]["cartesian_velocity"]
    traj["action"] = _cat(vel[:, :3], vel[:, 3:6],
                          f32(1.0) - traj["action_dict"]["gripper_position"])
    o = traj["observation"]
    o["proprio"] = _cat(o["cartesian_position"], o["gripper_position"])
    return traj


def droid_baseact(traj: Traj,
                  rng: Optional[np.random.Generator] = None) -> Traj:
    """DROID with a random exterior-camera swap (a train-time
    augmentation); ``rng`` defaults to a fresh unseeded generator."""
    traj = _droid_action(traj)
    o = traj["observation"]
    rng = rng if rng is not None else np.random.default_rng()
    if rng.uniform() > 0.5:
        o["exterior_image_1_left"], o["exterior_image_2_left"] = (
            o["exterior_image_2_left"], o["exterior_image_1_left"])
    return traj


droid_finetuning = _droid_action


# === registry =================================================================

OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable[[Traj], Traj]] = {
    "bridge_oxe": bridge_oxe,
    "bridge_orig": bridge_orig,
    "bridge_dataset": bridge_orig,
    "ppgm": ppgm, "ppgm_static": ppgm, "ppgm_wrist": ppgm,
    "fractal20220817_data": rt1,
    "kuka": kuka,
    "taco_play": taco_play,
    "jaco_play": jaco_play,
    "berkeley_cable_routing": berkeley_cable_routing,
    "roboturk": roboturk,
    "nyu_door_opening_surprising_effectiveness": nyu_door_opening,
    "viola": viola,
    "berkeley_autolab_ur5": berkeley_autolab_ur5,
    "toto": toto,
    "language_table": language_table,
    "columbia_cairlab_pusht_real": pusht,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds":
        stanford_kuka_multimodal,
    "nyu_rot_dataset_converted_externally_to_rlds": nyu_rot,
    "stanford_hydra_dataset_converted_externally_to_rlds": stanford_hydra,
    "austin_buds_dataset_converted_externally_to_rlds": austin_buds,
    "nyu_franka_play_dataset_converted_externally_to_rlds": nyu_franka_play,
    "maniskill_dataset_converted_externally_to_rlds": maniskill,
    "furniture_bench_dataset_converted_externally_to_rlds": furniture_bench,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds":
        cmu_franka_exploration,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": ucsd_kitchen,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds":
        ucsd_pick_place,
    "austin_sailor_dataset_converted_externally_to_rlds": austin_sailor,
    "austin_sirius_dataset_converted_externally_to_rlds": austin_sirius,
    "bc_z": bc_z,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": utokyo_pr2,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds":
        utokyo_pr2,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds":
        utokyo_xarm_pick_place,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": utokyo_xarm_bimanual,
    "robo_net": robo_net,
    "berkeley_mvp_converted_externally_to_rlds": berkeley_mvp,
    "berkeley_rpt_converted_externally_to_rlds": berkeley_rpt,
    "kaist_nonprehensile_converted_externally_to_rlds": kaist_nonprehensile,
    "stanford_mask_vit_converted_externally_to_rlds": stanford_mask_vit,
    "tokyo_u_lsmo_converted_externally_to_rlds": tokyo_lsmo,
    "dlr_sara_pour_converted_externally_to_rlds": dlr_sara_pour,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": dlr_sara_grid_clamp,
    "dlr_edan_shared_control_converted_externally_to_rlds":
        dlr_edan_shared_control,
    "asu_table_top_converted_externally_to_rlds": asu_table_top,
    "stanford_robocook_converted_externally_to_rlds": robocook,
    "imperialcollege_sawyer_wrist_cam": imperial_wristcam,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds":
        iamlab_pick_insert,
    "uiuc_d3field": uiuc_d3field,
    "utaustin_mutex": utaustin_mutex,
    "berkeley_fanuc_manipulation": berkeley_fanuc,
    "cmu_playing_with_food": cmu_playing_with_food,
    "cmu_play_fusion": playfusion,
    "cmu_stretch": cmu_stretch,
    "berkeley_gnm_recon": gnm,
    "berkeley_gnm_cory_hall": gnm,
    "berkeley_gnm_sac_son": gnm,
    "droid": droid_baseact,
    "fmb_dataset": fmb,
    "dobbe": dobbe,
    "roboset": roboset,
    "rh20t": rh20t,
    "tdroid_carrot_in_bowl": tdroid,
    "tdroid_pour_corn_in_pot": tdroid,
    "tdroid_flip_pot_upright": tdroid,
    "tdroid_move_object_onto_plate": tdroid,
    "tdroid_knock_object_over": tdroid,
    "tdroid_cover_object_with_towel": tdroid,
    "droid_wipe": droid_finetuning,
}


# === per-dataset configs ====================================

class StateEncoding(IntEnum):
    NONE = -1
    POS_EULER = 1      # xyz (3) + rpy (3) + pad (1) + gripper (1)
    POS_QUAT = 2       # xyz (3) + quat (4) + gripper (1)
    JOINT = 3          # joints (7, padded) + gripper (1)
    JOINT_BIMANUAL = 4


class ActionEncoding(IntEnum):
    EEF_POS = 1        # delta xyz (3) + rpy (3) + gripper (1)
    JOINT_POS = 2      # delta joints (7) + gripper (1)
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4         # delta xyz (3) + R6 (6) + gripper (1)


def _cfg(primary=None, secondary=None, wrist=None, depth=None,
         state=(), se=StateEncoding.POS_EULER,
         ae=ActionEncoding.EEF_POS) -> Dict[str, Any]:
    return {
        "image_obs_keys": {"primary": primary, "secondary": secondary,
                           "wrist": wrist},
        "depth_obs_keys": {"primary": depth, "secondary": None, "wrist": None},
        "state_obs_keys": list(state),
        "state_encoding": se,
        "action_encoding": ae,
    }


SE, AE = StateEncoding, ActionEncoding
_N8 = [None] * 8

OXE_DATASET_CONFIGS: Dict[str, Dict[str, Any]] = {
    "fractal20220817_data": _cfg("image", state=["base_pose_tool_reached", "gripper_closed"], se=SE.POS_QUAT),
    "kuka": _cfg("image", state=["clip_function_input/base_pose_tool_reached", "gripper_closed"], se=SE.POS_QUAT),
    "bridge_oxe": _cfg("image", secondary="image_1", state=["EEF_state", None, "gripper_state"]),
    "bridge_orig": _cfg("image_0", secondary="image_1", state=["EEF_state", None, "gripper_state"]),
    "bridge_dataset": _cfg("image_0", secondary="image_1", state=["EEF_state", None, "gripper_state"]),
    "taco_play": _cfg("rgb_static", wrist="rgb_gripper", depth="depth_static", state=["state_eef", None, "state_gripper"]),
    "jaco_play": _cfg("image", wrist="image_wrist", state=["state_eef", None, "state_gripper"]),
    "berkeley_cable_routing": _cfg("image", state=["robot_state", None], se=SE.JOINT),
    "roboturk": _cfg("front_rgb", state=_N8, se=SE.NONE),
    "nyu_door_opening_surprising_effectiveness": _cfg(wrist="image", state=_N8, se=SE.NONE),
    "viola": _cfg("agentview_rgb", state=["joint_states", "gripper_states"], se=SE.JOINT),
    "berkeley_autolab_ur5": _cfg("image", depth="depth", state=["state"], se=SE.POS_QUAT),
    "toto": _cfg("image", state=["state", None], se=SE.JOINT),
    "language_table": _cfg("rgb", state=["effector_translation"] + [None] * 6),
    "columbia_cairlab_pusht_real": _cfg("image", state=["robot_state"] + [None] * 6),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": _cfg("image", depth="depth_image", state=["ee_position", "ee_orientation", None], se=SE.POS_QUAT),
    "nyu_rot_dataset_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "stanford_hydra_dataset_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "austin_buds_dataset_converted_externally_to_rlds": _cfg("image", state=["state"], se=SE.JOINT),
    "nyu_franka_play_dataset_converted_externally_to_rlds": _cfg("image", depth="depth", state=["eef_state", None, None]),
    "maniskill_dataset_converted_externally_to_rlds": _cfg("image", depth="depth", state=["tcp_pose", "gripper_state"], se=SE.POS_QUAT),
    "furniture_bench_dataset_converted_externally_to_rlds": _cfg("image", state=["state"], se=SE.POS_QUAT),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": _cfg("highres_image", state=_N8, se=SE.NONE),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": _cfg("image", state=["joint_state", None], se=SE.JOINT),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "austin_sailor_dataset_converted_externally_to_rlds": _cfg("image", state=["state"], se=SE.POS_QUAT),
    "austin_sirius_dataset_converted_externally_to_rlds": _cfg("image", state=["state"], se=SE.POS_QUAT),
    "bc_z": _cfg("image", state=["present/xyz", "present/axis_angle", None, "present/sensed_close"]),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": _cfg("image", state=["end_effector_pose", None, None]),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": _cfg("image", state=["pose_r", None, None]),
    "robo_net": _cfg("image", secondary="image1", state=["eef_state", None, "gripper_state"]),
    "berkeley_mvp_converted_externally_to_rlds": _cfg(wrist="hand_image", state=["pose", "gripper"], se=SE.POS_QUAT, ae=AE.JOINT_POS),
    "berkeley_rpt_converted_externally_to_rlds": _cfg(wrist="hand_image", state=["joint_pos", "gripper"], se=SE.JOINT, ae=AE.JOINT_POS),
    "kaist_nonprehensile_converted_externally_to_rlds": _cfg("image", state=["state", None], se=SE.POS_QUAT),
    "stanford_mask_vit_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "tokyo_u_lsmo_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "dlr_sara_pour_converted_externally_to_rlds": _cfg("image", state=["state", None, None]),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": _cfg("image", state=["state", None, None]),
    "dlr_edan_shared_control_converted_externally_to_rlds": _cfg("image", state=["state", None]),
    "asu_table_top_converted_externally_to_rlds": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "stanford_robocook_converted_externally_to_rlds": _cfg("image_1", secondary="image_2", depth="depth_1", state=["eef_state", None, "gripper_state"]),
    "imperialcollege_sawyer_wrist_cam": _cfg("image", state=[None] * 7 + ["state"], se=SE.NONE),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": _cfg("image", state=["joint_state", "gripper_state"], se=SE.JOINT),
    "uiuc_d3field": _cfg("image_1", secondary="image_2", depth="depth_1", state=_N8, se=SE.NONE),
    "utaustin_mutex": _cfg("image", state=["state"], se=SE.JOINT),
    "berkeley_fanuc_manipulation": _cfg("image", state=["joint_state", None, "gripper_state"], se=SE.JOINT),
    "cmu_playing_with_food": _cfg("image", state=["state", None, None]),
    "cmu_play_fusion": _cfg("image", state=["state"], se=SE.JOINT),
    "cmu_stretch": _cfg("image", state=["eef_state", None, "gripper_state"]),
    "berkeley_gnm_recon": _cfg(wrist="image", state=["state", None, None]),
    "berkeley_gnm_cory_hall": _cfg(wrist="image", state=["state", None, None]),
    "berkeley_gnm_sac_son": _cfg(wrist="image", state=["state", None, None]),
    "droid": _cfg("exterior_image_1_left", state=["proprio"], se=SE.POS_QUAT),
    "fmb_dataset": _cfg("image_side_1", depth="image_side_1_depth", state=["proprio"]),
    "dobbe": _cfg("wrist_image", state=["proprio"]),
    "roboset": _cfg("image_left", state=["proprio"], se=SE.JOINT, ae=AE.JOINT_POS),
    "rh20t": _cfg("image_front", state=["proprio"]),
    "tdroid_carrot_in_bowl": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "tdroid_pour_corn_in_pot": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "tdroid_flip_pot_upright": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "tdroid_move_object_onto_plate": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "tdroid_knock_object_over": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "tdroid_cover_object_with_towel": _cfg("static_image", depth="static_depth_image", state=["EEF_state", None, "gripper_state"]),
    "droid_wipe": _cfg("exterior_image_2_left", wrist="wrist_image_left", state=["proprio"]),
}


# === named mixtures ========================================

_HYDRA = "stanford_hydra_dataset_converted_externally_to_rlds"
_BUDS = "austin_buds_dataset_converted_externally_to_rlds"
_NYU_FRANKA = "nyu_franka_play_dataset_converted_externally_to_rlds"
_FURNITURE = "furniture_bench_dataset_converted_externally_to_rlds"
_UCSD_KITCHEN = "ucsd_kitchen_dataset_converted_externally_to_rlds"
_SAILOR = "austin_sailor_dataset_converted_externally_to_rlds"
_SIRIUS = "austin_sirius_dataset_converted_externally_to_rlds"
_EDAN = "dlr_edan_shared_control_converted_externally_to_rlds"
_IAMLAB = "iamlab_cmu_pickup_insert_converted_externally_to_rlds"

_RTX_CORE: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
]

_MAGIC_SOUP_TAIL: List[Tuple[str, float]] = [
    ("language_table", 0.1),
    (_HYDRA, 2.0),
    (_BUDS, 1.0),
    (_NYU_FRANKA, 3.0),
    (_FURNITURE, 0.1),
    (_UCSD_KITCHEN, 2.0),
    (_SAILOR, 1.0),
    (_SIRIUS, 1.0),
    (_EDAN, 1.0),
    (_IAMLAB, 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

OXE_NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_orig", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    "rtx": [
        ("fractal20220817_data", 0.54087122203),
        ("kuka", 0.8341046294),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 2.0),
        ("berkeley_cable_routing", 3.0),
        ("roboturk", 1.0),
        ("viola", 2.0),
        ("berkeley_autolab_ur5", 1.0),
        ("toto", 1.0),
    ],
    "oxe_magic_soup": _RTX_CORE + _MAGIC_SOUP_TAIL,
    "oxe_magic_soup_plus": _RTX_CORE + _MAGIC_SOUP_TAIL + [
        ("bc_z", 0.2), ("fmb_dataset", 1.0), ("dobbe", 0.2), ("droid", 0.06)],
    "oxe_magic_soup_plus_minus":
        [("fractal20220817_data", 1.0)] + _RTX_CORE[1:] + _MAGIC_SOUP_TAIL + [
            ("bc_z", 0.2), ("fmb_dataset", 1.0), ("dobbe", 0.2)],
    **{name: [(name, 1.0)] for name in (
        "tdroid_carrot_in_bowl", "tdroid_pour_corn_in_pot",
        "tdroid_flip_pot_upright", "tdroid_move_object_onto_plate",
        "tdroid_knock_object_over", "tdroid_cover_object_with_towel",
        "droid_wipe")},
}


# === kwargs factory =====================================

def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_root_dir,
    load_camera_views: Tuple[str, ...] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    action_proprio_normalization_type: NormalizationType =
        NormalizationType.BOUNDS_Q99,
) -> Dict[str, Any]:
    """Per-dataset kwargs with the EEF action contract: only the gripper dim
    is absolute / un-normalized (reference ``materialize.py:21-100``)."""
    kwargs = deepcopy(OXE_DATASET_CONFIGS[dataset_name])
    ae = kwargs.pop("action_encoding")
    if ae not in (ActionEncoding.EEF_POS, ActionEncoding.EEF_R6):
        raise ValueError(
            f"cannot load {dataset_name!r}: only EEF_POS/EEF_R6 supported")
    arm = 6 if ae is ActionEncoding.EEF_POS else 9
    kwargs["absolute_action_mask"] = [False] * arm + [True]
    kwargs["action_normalization_mask"] = [True] * arm + [False]
    kwargs["action_proprio_normalization_type"] = \
        action_proprio_normalization_type

    missing = set(load_camera_views) - set(kwargs["image_obs_keys"])
    if missing:
        raise ValueError(
            f"cannot load {dataset_name!r}: missing camera views {missing}")
    kwargs["image_obs_keys"] = {k: v for k, v in kwargs["image_obs_keys"].items()
                                if k in load_camera_views}
    kwargs["depth_obs_keys"] = {k: v for k, v in kwargs["depth_obs_keys"].items()
                                if k in load_camera_views}
    kwargs.pop("state_encoding")
    if not load_depth:
        kwargs.pop("depth_obs_keys")
    if not load_proprio:
        kwargs.pop("state_obs_keys")
    if load_language:
        kwargs["language_key"] = "language_instruction"
    kwargs["standardize_fn"] = OXE_STANDARDIZATION_TRANSFORMS[dataset_name]
    return {"name": dataset_name, "data_dir": str(data_root_dir), **kwargs}


def get_oxe_dataset_kwargs_and_weights(
    data_root_dir,
    mixture_spec: List[Tuple[str, float]],
    **kwargs,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Mixture spec → (per-dataset kwargs, sampling weights); duplicates are
    dropped (first weight wins) and unloadable datasets are skipped with a
    warning (reference ``materialize.py:103-139``)."""
    seen, per_dataset, weights = set(), [], []
    for name, weight in mixture_spec:
        if name in seen:
            continue
        seen.add(name)
        try:
            per_dataset.append(make_oxe_dataset_kwargs(name, data_root_dir,
                                                       **kwargs))
            weights.append(weight)
        except ValueError as e:
            import warnings

            warnings.warn(f"skipping {name}: {e}")
    return per_dataset, weights


# === DROID wrist-frame / R6 actions ==========================================

def euler_to_rmat(e):
    """[..., 3] XYZ euler -> [..., 3, 3] rotation matrix (R = Rz Ry Rx, the
    inverse of ``quat_to_euler``'s extraction)."""
    e = np.asarray(e, f32)
    cx, cy, cz = np.cos(e[..., 0]), np.cos(e[..., 1]), np.cos(e[..., 2])
    sx, sy, sz = np.sin(e[..., 0]), np.sin(e[..., 1]), np.sin(e[..., 2])
    rows = [[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx]]
    return np.stack([np.stack(r, -1) for r in rows], -2)


def rotmat_to_rot6d(mat):
    """[..., 3, 3] -> [..., 6]: the first two rows (R6)."""
    return np.concatenate([mat[..., 0, :], mat[..., 1, :]], axis=-1)


def velocity_to_wrist_frame(velocity, wrist_pose):
    """Base-frame 6-D velocity -> wrist-frame [3 translation + 6 R6]:
    dT' = R^-1 dT, dR' = R^-1 dR R with R the wrist orientation."""
    R = euler_to_rmat(wrist_pose[:, 3:6])
    R_inv = np.swapaxes(R, -1, -2)
    vel_t = (R_inv @ velocity[:, :3][..., None])[..., 0]
    dR = R_inv @ (euler_to_rmat(velocity[:, 3:6]) @ R)
    return np.concatenate([vel_t, rotmat_to_rot6d(dR)], axis=-1)


def droid_wristact(traj: Traj) -> Traj:
    """DROID with EEF_R6 wrist-frame actions: [3 + 6 + 1] = 10 dims."""
    wrist = velocity_to_wrist_frame(
        traj["action_dict"]["cartesian_velocity"],
        traj["observation"]["cartesian_position"])
    traj["action"] = _cat(wrist, traj["action_dict"]["gripper_position"])
    o = traj["observation"]
    o["proprio"] = _cat(o["cartesian_position"], o["gripper_position"])
    return traj
