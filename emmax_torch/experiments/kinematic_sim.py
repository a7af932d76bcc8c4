"""Scored kinematic manipulation world and episode evaluator, port of
``emmax_tpu/experiments/kinematic_sim.py`` (numpy; the same seeds and
actions give the same frames, infos and successes).

The reference scores policies in the SimplerEnv / ManiSkill2 SAPIEN
simulator (``maniskill2_evaluator.py:15-175``). This module gives the same
evaluation machinery (scored episodes, success detection, per-task
aggregation) over a deterministic kinematic pick-and-place world, so a
success rate can be produced without SAPIEN. It is a physics-light proxy
(no contact dynamics), not a SAPIEN replacement; the ``simpler_env`` path
lives in ``emmax_torch/simpler_eval.py``.

World: a 7-DoF delta-EEF gripper (the BridgeV2 action convention:
[dx, dy, dz, droll, dpitch, dyaw, gripper], gripper >= 0.5 = open) must
grasp an object and release it over a target zone. Observations are
rendered top-down RGB frames (target / object / gripper as colored
squares), so vision policies consume real pixels; ``info["success"]``
follows the ManiSkill2 episode-info contract the evaluator reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SimTask:
    name: str
    instruction: str
    object_xy: Tuple[float, float]
    target_xy: Tuple[float, float]


# widowx_bridge task suite (names mirror simpler_env env ids)
TASKS: Dict[str, SimTask] = {
    "widowx_spoon_on_towel": SimTask(
        "widowx_spoon_on_towel", "put the spoon on the towel",
        (0.30, -0.10), (0.30, 0.12)),
    "widowx_carrot_on_plate": SimTask(
        "widowx_carrot_on_plate", "put carrot on plate",
        (0.26, 0.08), (0.34, -0.08)),
    "widowx_stack_cube": SimTask(
        "widowx_stack_cube", "stack the green block on the yellow block",
        (0.24, -0.06), (0.36, 0.06)),
    "widowx_put_eggplant_in_basket": SimTask(
        "widowx_put_eggplant_in_basket", "put eggplant into yellow basket",
        (0.32, 0.10), (0.24, -0.12)),
}

WORKSPACE_LOW = np.array([0.1, -0.2, 0.0])
WORKSPACE_HIGH = np.array([0.5, 0.2, 0.3])


class KinematicManipEnv:
    """Deterministic pick-and-place world with gym-style step/reset."""

    GRASP_RADIUS = 0.035
    PLACE_RADIUS = 0.05
    TABLE_Z = 0.02
    START_POS = np.array([0.3, 0.0, 0.15])

    def __init__(self, task: SimTask, *, seed: int = 0, im_size: int = 128,
                 max_steps: int = 120, action_scale: float = 1.0,
                 init_noise: float = 0.01) -> None:
        self.task = task
        self.im_size = im_size
        self.max_steps = max_steps
        self.action_scale = action_scale
        self.rng = np.random.default_rng(seed)
        self.init_noise = init_noise
        self.reset()

    # -- dynamics ----------------------------------------------------------
    def reset(self):
        noise = self.rng.normal(scale=self.init_noise, size=2)
        self.gripper_pos = self.START_POS.copy()
        self.gripper_open = True
        self.object_pos = np.array([*self.task.object_xy, self.TABLE_Z])
        self.object_pos[:2] += noise
        self.target_pos = np.array([*self.task.target_xy, self.TABLE_Z])
        self.grasped = False
        self.t = 0
        self.success = False
        return self._obs(), {"instruction": self.task.instruction}

    def step(self, action: Sequence[float]):
        action = np.asarray(action, np.float64).reshape(-1)
        assert action.shape[0] == 7, "7-DoF delta-EEF action expected"
        delta = np.clip(action[:3], -1, 1) * 0.05 * self.action_scale
        self.gripper_pos = np.clip(self.gripper_pos + delta,
                                   WORKSPACE_LOW, WORKSPACE_HIGH)
        want_open = float(action[6]) >= 0.5
        if not want_open and self.gripper_open:
            # closing: grasp if the fingers surround the object
            if (np.linalg.norm(self.gripper_pos - self.object_pos)
                    < self.GRASP_RADIUS):
                self.grasped = True
        if want_open and not self.gripper_open and self.grasped:
            # releasing: object drops straight down onto the table
            self.grasped = False
            self.object_pos = self.object_pos.copy()
            self.object_pos[2] = self.TABLE_Z
        self.gripper_open = want_open
        if self.grasped:
            self.object_pos = self.gripper_pos.copy()
        if (not self.grasped and self.gripper_open
                and np.linalg.norm(self.object_pos[:2] - self.target_pos[:2])
                < self.PLACE_RADIUS
                and self.object_pos[2] <= self.TABLE_Z + 1e-6):
            self.success = True
        self.t += 1
        truncated = self.t >= self.max_steps
        return (self._obs(), float(self.success), self.success, truncated,
                {"success": self.success, "grasped": self.grasped})

    # -- rendering ---------------------------------------------------------
    def _draw(self, img, xy, color, half: int):
        s = self.im_size
        cx = int((xy[0] - WORKSPACE_LOW[0])
                 / (WORKSPACE_HIGH[0] - WORKSPACE_LOW[0]) * (s - 1))
        cy = int((xy[1] - WORKSPACE_LOW[1])
                 / (WORKSPACE_HIGH[1] - WORKSPACE_LOW[1]) * (s - 1))
        img[max(cx - half, 0):cx + half, max(cy - half, 0):cy + half] = color

    def _obs(self) -> Dict[str, np.ndarray]:
        img = np.full((self.im_size, self.im_size, 3), 40, np.uint8)
        self._draw(img, self.target_pos, (40, 200, 40), self.im_size // 12)
        self._draw(img, self.object_pos, (210, 60, 40), self.im_size // 24)
        # gripper brightness encodes height; open/closed flips blue/cyan
        z_frac = self.gripper_pos[2] / WORKSPACE_HIGH[2]
        col = (int(80 + 120 * z_frac), 120 if self.gripper_open else 220,
               250)
        self._draw(img, self.gripper_pos, col, self.im_size // 32)
        return {"image": img,
                "eef_pos": self.gripper_pos.copy(),
                "proprio": np.concatenate(
                    [self.gripper_pos, np.zeros(3),
                     [1.0 if self.gripper_open else 0.0]])}


class ScriptedExpertPolicy:
    """Oracle pick-and-place state machine — validates the evaluator (the
    reference uses ground-truth trajectory replay for the same purpose,
    ``widowx_test_dataset_inference_rollout_gt_traj_in_sim.py``)."""

    def __init__(self, env: KinematicManipEnv) -> None:
        self.env = env

    def reset(self, instruction: str) -> None:
        pass

    def step(self, image, instruction: str):
        env = self.env
        g = env.gripper_pos
        action = np.zeros(7)
        hover = 0.10

        def go(target, open_):
            action[:3] = np.clip((target - g) / 0.05, -1, 1)
            action[6] = 1.0 if open_ else 0.0
            return None, action

        if not env.grasped and not env.success:
            above = np.array([*env.object_pos[:2], hover])
            if np.linalg.norm(g[:2] - env.object_pos[:2]) > 0.01:
                return go(above, True)
            if g[2] > env.object_pos[2] + 0.02:
                return go(env.object_pos + [0, 0, 0.01], True)
            return go(g, False)            # close on the object
        if env.grasped:
            above_t = np.array([*env.target_pos[:2], hover])
            if np.linalg.norm(g[:2] - env.target_pos[:2]) > 0.015:
                return go(above_t, False)
            return go(g, True)             # release over the target
        return None, action


def evaluate_policy(policy, *, tasks: Optional[Sequence[str]] = None,
                    episodes_per_task: int = 5, max_steps: int = 120,
                    im_size: int = 128, seed: int = 0,
                    env_factory: Optional[Callable] = None,
                    on_frame: Optional[Callable] = None) -> Dict:
    """Scored multi-episode evaluation (``maniskill2_evaluator.py:15-175``
    machinery): per-task and aggregate success rates.

    ``policy`` needs ``reset(instruction)`` and
    ``step(image, instruction) -> (raw, action7)``.
    """
    tasks = list(tasks or TASKS)
    results: Dict[str, List[bool]] = {}
    for name in tasks:
        task = TASKS[name]
        results[name] = []
        for ep in range(episodes_per_task):
            env = (env_factory(task, seed + ep) if env_factory
                   else KinematicManipEnv(task, seed=seed + ep,
                                          im_size=im_size,
                                          max_steps=max_steps))
            if isinstance(policy, ScriptedExpertPolicy):
                policy.env = env
            obs, info = env.reset()
            policy.reset(task.instruction)
            success = False
            for _ in range(max_steps):
                _, action = policy.step(obs["image"], task.instruction)
                obs, _, done, truncated, info = env.step(action)
                if on_frame is not None:
                    on_frame(name, ep, obs["image"])
                if info["success"]:
                    success = True
                    break
                if truncated:
                    break
            results[name].append(success)
    per_task = {name: float(np.mean(oks)) for name, oks in results.items()}
    overall = float(np.mean([v for oks in results.values() for v in oks]))
    return {"overall_success_rate": overall, "per_task": per_task,
            "episodes_per_task": episodes_per_task}
