"""SE(3) helpers (numpy), port of ``emmax_tpu/experiments/transforms3d.py``.

Quaternion / euler / matrix conversions of the WidowX eval's
``tf_transformation.py``, plus the euler -> axis-angle conversion the
SimplerEnv adapter needs (transforms3d's ``euler2axangle``). Conventions:
quaternions are (x, y, z, w); euler angles are intrinsic roll-pitch-yaw
(sxyz).
"""

from __future__ import annotations

import numpy as np


def euler_to_mat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def mat_to_euler(R: np.ndarray):
    sy = -R[2, 0]
    sy = np.clip(sy, -1.0, 1.0)
    pitch = np.arcsin(sy)
    if abs(sy) < 1.0 - 1e-8:
        roll = np.arctan2(R[2, 1], R[2, 2])
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        yaw = 0.0
    return float(roll), float(pitch), float(yaw)


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (R[2, 1] - R[1, 2]) * s
        y = (R[0, 2] - R[2, 0]) * s
        z = (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12))
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    return np.array([x, y, z, w])


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def euler_to_quat(roll, pitch, yaw) -> np.ndarray:
    return mat_to_quat(euler_to_mat(roll, pitch, yaw))


def quat_to_euler(q: np.ndarray):
    return mat_to_euler(quat_to_mat(q))


def euler_to_axangle(roll, pitch, yaw):
    """(axis, angle) from intrinsic rpy — mirrors transforms3d.euler2axangle
    used by the SimplerEnv adapter."""
    q = euler_to_quat(roll, pitch, yaw)
    x, y, z, w = q
    angle = 2.0 * np.arccos(np.clip(w, -1.0, 1.0))
    s = np.sqrt(max(1.0 - w * w, 0.0))
    axis = np.array([1.0, 0.0, 0.0]) if s < 1e-8 else np.array([x, y, z]) / s
    return axis, float(angle)


def pose_to_mat(xyz: np.ndarray, quat: np.ndarray) -> np.ndarray:
    """[x, y, z] + quaternion → 4x4 homogeneous transform
    (``tf_transformation.py:123`` shape)."""
    T = np.eye(4)
    T[:3, :3] = quat_to_mat(quat)
    T[:3, 3] = np.asarray(xyz)
    return T


def mat_to_pose(T: np.ndarray):
    """4x4 transform → (xyz, quaternion) (``tf_transformation.py:233``)."""
    return T[:3, 3].copy(), mat_to_quat(T[:3, :3])


def pose6_to_mat(pose) -> np.ndarray:
    """6-vector [x, y, z, roll, pitch, yaw] → 4x4 transform (the reference
    eval convention, ``tf_transformation.py:123-129``)."""
    pose = np.asarray(pose, np.float64)
    T = np.eye(4)
    T[:3, :3] = euler_to_mat(pose[3], pose[4], pose[5])
    T[:3, 3] = pose[:3]
    return T


def mat_to_pose6(T: np.ndarray) -> np.ndarray:
    """4x4 transform → 6-vector [x, y, z, roll, pitch, yaw]
    (``tf_transformation.py:233-239``)."""
    roll, pitch, yaw = mat_to_euler(np.asarray(T)[:3, :3])
    return np.concatenate([np.asarray(T)[:3, 3], [roll, pitch, yaw]])
