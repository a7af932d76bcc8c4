"""Trajectory segmentation for GCOT generation, port of
``emmax_tpu/gcot/segmentation.py``.

HDBSCAN (``min_cluster_size`` 3) over the 6-DoF pose and scaled time
(``i / 30``) with the reference's spatio-temporal metric, gripper
change-point segments, the composed strategies (``soft``,
``soft_plus_gripper``, ``gripper``, ``nstep``) and key-frame selection.

The clustering is the port's own numpy HDBSCAN (``gcot/hdbscan.py``),
which gives scikit-learn's labels; the distance matrix is built the way
sklearn's ``pairwise_distances`` builds it for a callable metric: the
metric on each pair ``i < j``, mirrored, and the metric of each point with
itself on the diagonal.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from emmax_torch.gcot.hdbscan import hdbscan


def _forward_fill_noise(segments: Sequence[int]) -> List[int]:
    """HDBSCAN labels noise -1; carry the previous cluster forward."""
    out, previous = [], 0
    for seg in segments:
        if seg != -1:
            previous = seg
        out.append(previous)
    return out


def _cosine_similarity(u: np.ndarray, v: np.ndarray) -> float:
    """sklearn's ``cosine_similarity([u], [v])``: rows scaled by their L2
    norm (``einsum`` row norms, a norm under 10 eps taken as 1), then one
    matmul."""
    def normalized(a):
        a = np.array([a], dtype=np.float64)
        norms = np.sqrt(np.einsum("ij,ij->i", a, a))
        norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
        a /= norms[:, None]
        return a

    return float((normalized(u) @ normalized(v).T)[0, 0])


def spatio_temporal_distances(x: np.ndarray, distance: str = "euclidean",
                              time_weight: float = 1.0) -> np.ndarray:
    """The reference's metric over rows ``[state | time]``: the spatial
    term (scipy's ``euclidean``, or, for ``"cosine"``, the cosine
    *similarity*, the reference's quirk) plus ``time_weight`` times the
    time gap."""
    from scipy.spatial.distance import euclidean

    def metric(p1, p2):
        if distance == "euclidean":
            spatial = euclidean(p1[:-1], p2[:-1])
        else:
            spatial = _cosine_similarity(p1[:-1], p2[:-1])
        return spatial + time_weight * abs(p1[-1] - p2[-1])

    n = x.shape[0]
    out = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            out[i, j] = metric(x[i], x[j])
    out = out + out.T
    for i in range(n):
        out[i, i] = metric(x[i], x[i])
    return out


def segment_traj(full_state: np.ndarray, distance: str = "euclidean",
                 time_weight: float = 1.0,
                 time_scale: float = 1.0 / 30.0) -> Tuple[List[int], np.ndarray]:
    """HDBSCAN over ``[state | i * time_scale]`` with the spatio-temporal
    distance. Returns (forward-filled labels, raw labels)."""
    x = np.stack([np.append(o, i * time_scale)
                  for i, o in enumerate(np.asarray(full_state, np.float64))])
    labels = hdbscan(spatio_temporal_distances(x, distance, time_weight),
                     min_cluster_size=3)
    return _forward_fill_noise(labels), labels


def segment_gripper(gripper_state: Sequence[float]) -> List[int]:
    """Change-point segments of a (near-)binary gripper signal: each frame
    labelled with the index where its open / closed run began."""
    previous_index = 0
    out = []
    for i, state in enumerate(gripper_state):
        if round(float(state)) != round(float(gripper_state[previous_index])):
            previous_index = i
        out.append(previous_index)
    return out


def segment_nstep(n_frames: int, step: int = 5) -> List[int]:
    """Fixed n-step segments (the baseline)."""
    return [i // step for i in range(n_frames)]


def soft_segment(proprio_6dof: np.ndarray) -> np.ndarray:
    """Emma-X's default strategy: HDBSCAN over the raw 6-DoF pose."""
    processed, _ = segment_traj(proprio_6dof, distance="euclidean")
    return np.asarray(processed)


def soft_plus_gripper_segment(proprio_6dof: np.ndarray,
                              gripper_action: Sequence[float]) -> np.ndarray:
    """Pose clusters scaled by 100 plus the gripper change points."""
    processed, _ = segment_traj(proprio_6dof, distance="euclidean")
    pose_segment = np.asarray(processed)
    gripper_segment = np.asarray(segment_gripper(gripper_action))
    return pose_segment * 100 + gripper_segment


def compress_segments(overall_segment: np.ndarray) -> List[int]:
    """Segment ids relabelled 1..K in order of first appearance."""
    out, seen, count = [], {}, 0
    for s in overall_segment:
        s = int(s)
        if s not in seen:
            count += 1
            seen[s] = count
        out.append(seen[s])
    return out


def get_key_frames(images: Sequence, overall_segment: np.ndarray
                   ) -> Tuple[List, int]:
    """"Segment k:" markers interleaved with the first frame of each
    segment (the plan annotator's prompt), and the segment count."""
    segments = compress_segments(overall_segment)
    key_frames: List = []
    last = None
    for img, seg in zip(images, segments):
        if seg != last:
            key_frames.append(f"Segment {seg}:")
            key_frames.append(img)
            last = seg
    return key_frames, max(segments)
