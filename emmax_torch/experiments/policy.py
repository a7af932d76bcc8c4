"""Policy adapters for closed-loop evaluation, port of
``emmax_tpu/experiments/policy.py`` on the port's ``EmmaXVLA``.

- ``EmmaXSimplerInference``: the SimplerEnv / ManiSkill2 adapter
  (``openvla_model.py:72-146``): ``step(image, task) -> (raw_action,
  action)`` with the euler -> axis-angle conversion, the widowx gripper
  threshold and the google-robot sticky gripper;
- ``run_closed_loop``: the WidowX evaluation loop
  (``run_bridgev2_eval.py:149-199``): refresh the observation -> locate
  the gripper -> build the INSTRUCTION / CURRENT GRIPPER prompt -> one
  ``generate_actions`` decode -> execute the returned action chunk. The
  environment sits behind a small protocol, so the same loop drives the
  WidowX client, SimplerEnv or a stand-in.

Around ``generate_actions`` the loop catches ``ValueError`` only (what the
model's text can raise: no proprio statistics in ``pos`` mode, an unknown
``type``), where JAX catches every exception: a ``RuntimeError`` from
torch or a kernel launch ends the run instead of turning into zero
actions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from emmax_torch.experiments.transforms3d import (euler_to_axangle,
                                                  mat_to_pose6, pose6_to_mat)
from emmax_torch.overwatch import initialize_overwatch
from emmax_torch.vla.prompting import build_emma_x_task_prompt

overwatch = initialize_overwatch(__name__)


def normalize_gripper_action(action: np.ndarray, binarize: bool = True
                             ) -> np.ndarray:
    """[0, 1] gripper -> [-1, +1] (+ sign binarize),
    ``robot_utils.py:82-99``."""
    action = np.array(action, dtype=np.float64)
    action[..., -1] = 2.0 * action[..., -1] - 1.0
    if binarize:
        action[..., -1] = np.sign(action[..., -1])
    return action


class EmmaXSimplerInference:
    """SimplerEnv policy adapter around ``EmmaXVLA``."""

    def __init__(self, vla, policy_setup: str = "widowx_bridge",
                 action_scale: float = 1.0, image_size: int = 224,
                 sticky_gripper_num_repeat: int = 15,
                 max_new_tokens: int = 512) -> None:
        self.vla = vla
        self.policy_setup = policy_setup
        self.action_scale = action_scale
        self.image_size = image_size
        self.max_new_tokens = max_new_tokens
        self.sticky_gripper_num_repeat = sticky_gripper_num_repeat
        self.reset(None)

    def reset(self, task_description: Optional[str]) -> None:
        self.task_description = task_description
        self.pending_actions: List[np.ndarray] = []
        self.previous_gripper_action = None
        self.sticky_action_is_on = False
        self.sticky_gripper_action = 0.0
        self.gripper_action_repeat = 0

    def _raw_action(self, image: np.ndarray) -> np.ndarray:
        if not self.pending_actions:
            prompt = self.vla.get_prompt(self.task_description)
            actions, _text = self.vla.generate_actions(
                image, prompt, type="act",
                max_new_tokens=self.max_new_tokens)
            self.pending_actions = [np.asarray(a) for a in actions] or \
                [np.zeros(7)]
        return self.pending_actions.pop(0)

    def step(self, image: np.ndarray,
             task_description: Optional[str] = None
             ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        if task_description is not None and \
                task_description != self.task_description:
            self.reset(task_description)
        assert image.dtype == np.uint8

        raw = self._raw_action(image)
        raw_action = {"world_vector": raw[:3], "rotation_delta": raw[3:6],
                      "open_gripper": raw[6:7]}

        action: Dict[str, np.ndarray] = {}
        action["world_vector"] = raw_action["world_vector"] * self.action_scale
        roll, pitch, yaw = np.asarray(raw_action["rotation_delta"], np.float64)
        axis, angle = euler_to_axangle(roll, pitch, yaw)
        action["rot_axangle"] = axis * angle * self.action_scale

        if self.policy_setup == "google_robot":
            cur = raw_action["open_gripper"]
            rel = (np.array([0.0]) if self.previous_gripper_action is None
                   else self.previous_gripper_action - cur)
            self.previous_gripper_action = cur
            if np.abs(rel) > 0.5 and not self.sticky_action_is_on:
                self.sticky_action_is_on = True
                self.sticky_gripper_action = rel
            if self.sticky_action_is_on:
                self.gripper_action_repeat += 1
                rel = self.sticky_gripper_action
            if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
                self.sticky_action_is_on = False
                self.gripper_action_repeat = 0
                self.sticky_gripper_action = 0.0
            action["gripper"] = np.asarray(rel)
        else:  # widowx_bridge
            action["gripper"] = 2.0 * (raw_action["open_gripper"] > 0.5) - 1.0
        action["terminate_episode"] = np.array([0.0])
        return raw_action, action


# === WidowX-style closed loop =================================================

class RobotEnv(Protocol):
    def get_observation(self) -> Dict: ...

    def step(self, action: np.ndarray) -> None: ...


@dataclasses.dataclass
class EpisodeLog:
    frames: List[np.ndarray]
    actions: List[np.ndarray]
    texts: List[str]


def run_closed_loop(vla, env: RobotEnv, instruction: str, *,
                    gripper_locator: Optional[Callable] = None,
                    max_steps: int = 100, max_new_tokens: int = 512,
                    action_type: str = "act") -> EpisodeLog:
    """One evaluation episode (``run_bridgev2_eval.py:149-199``): each decode
    yields an action chunk executed in turn, the amortization behind the
    reference's 5 Hz control rate."""
    log = EpisodeLog([], [], [])
    t = 0
    while t < max_steps:
        obs = env.get_observation()
        image = np.asarray(obs["full_image"] if "full_image" in obs
                           else obs["image_primary"])
        gripper_xy = (gripper_locator(image) if gripper_locator is not None
                      else (0, 0))
        prompt = build_emma_x_task_prompt(instruction, gripper_xy)
        try:
            actions, text = vla.generate_actions(
                image, prompt, type=action_type,
                max_new_tokens=max_new_tokens)
        except ValueError as e:  # episode-ending parse failure (ref :201-206)
            overwatch.error(f"generate_actions failed: {e}")
            break
        log.texts.append(text)
        if action_type == "pos" and hasattr(env, "move"):
            # position mode: one absolute move per decode: the predicted
            # position delta added to the current EE pose with rotation
            # zeroed, the gripper commanded absolutely
            # (run_bridgev2_position_eval.py:161-179)
            delta = np.asarray(actions[0], np.float64)
            eef = obs.get("eef_transform")
            current = (mat_to_pose6(np.asarray(eef)) if eef is not None
                       else np.zeros(6))
            current[3:] = 0          # rotation/gripper taken absolutely
            goal = pose6_to_mat(delta[:6] + current)
            env.move(goal, float(delta[-1]), duration=3)
            log.frames.append(image)
            log.actions.append(delta)
            t += 1
            continue
        for action in actions:
            if t >= max_steps:
                break
            res = env.step(np.asarray(action))
            log.frames.append(image)
            log.actions.append(np.asarray(action))
            t += 1
            # gym-shaped envs signal a lost server connection through
            # truncated (widowx_env.py:103-108): end the episode instead of
            # sending the rest of the chunk to a dead server
            if isinstance(res, tuple) and len(res) >= 4 and res[3]:
                overwatch.warning("episode truncated (connection lost)")
                return log
    return log
