"""WidowX gym-style environment over the ``widowx_envs`` client service,
port of ``emmax_tpu/experiments/widowx.py`` (host numpy).

The WidowX eval's ``widowx_env.py:30-179``: observation conversion (CHW
float [0, 1] -> HWC uint8; proprio padded to 8 dims as ``[state[:6], 0,
state[-1]]`` to match RLDS training), null observations and truncation on
a lost server connection, and the blocking reset-to-start move with the
15-degree tilted initial orientation. The client is passed in, so all of
this runs against a stand-in; the real ``WidowXClient`` is a network
service on the robot host. The reset's retry loop takes bad input and a
dropped connection (``ValueError``, ``ConnectionError``,
``TimeoutError``); JAX retries on any exception.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

# Initial orientation: the gripper points ~15 degrees away from the standard
# orientation (quat=[0,0,0,1]), widowx_env.py:158-166.
START_ROTATION = np.array([
    [0.267, 0.000, 0.963],
    [0.000, 1.000, 0.000],
    [-0.963, 0.000, 0.267],
])


def convert_obs(obs: Dict, im_size: int) -> Dict:
    """Raw service observation -> eval observation (widowx_env.py:40-52)."""
    image_obs = (np.asarray(obs["image"]).reshape(3, im_size, im_size)
                 .transpose(1, 2, 0) * 255).astype(np.uint8)
    state = np.asarray(obs["state"], np.float64)
    # pad proprio to 8 dims to match RLDS training (6 EEF + pad + gripper)
    proprio = np.concatenate([state[:6], [0], state[-1:]])
    out = {"image_primary": image_obs, "proprio": proprio}
    for key in ("full_image", "eef_transform"):
        if key in obs:
            out[key] = obs[key]
    return out


def null_obs(im_size: int) -> Dict:
    """All-zero observation for lost-connection steps (widowx_env.py:55-60)."""
    return {"image_primary": np.zeros((im_size, im_size, 3), np.uint8),
            "proprio": np.zeros((8,), np.float64)}


def wait_for_obs(client, poll_s: float = 1.0):
    obs = client.get_observation()
    while obs is None:
        time.sleep(poll_s)
        obs = client.get_observation()
    return obs


def start_transform(init_ee_pos: Sequence[float]) -> np.ndarray:
    """4x4 reset-to-start pose: fixed tilted orientation + commanded XYZ."""
    transform = np.eye(4)
    transform[:3, :3] = START_ROTATION
    transform[:3, 3] = np.asarray(init_ee_pos, np.float64)
    return transform


class WidowXGymEnv:
    """Gym-shaped closed-loop env (step/reset/move) over an injected client.

    ``input_fn`` replays the reference's interactive start-position prompts
    (widowx_env.py:147-157); the default accepts the configured
    ``init_ee_pos`` without prompting (headless eval).
    """

    def __init__(self, client, init_ee_pos: Sequence[float] = (0.3, 0.0, 0.15),
                 im_size: int = 256, blocking: bool = True,
                 input_fn: Optional[Callable[[str], str]] = None) -> None:
        self.client = client
        self.init_ee_pos = tuple(float(v) for v in init_ee_pos)
        self.im_size = im_size
        self.blocking = blocking
        self.input_fn = input_fn or (lambda prompt: "")

    def _obs_or_truncate(self):
        raw = self.client.get_observation()
        if raw is None:
            # lost connection with the server mid-step: end the trajectory
            return null_obs(self.im_size), True
        return convert_obs(raw, self.im_size), False

    def step(self, action):
        self.client.step_action(np.asarray(action), blocking=self.blocking)
        obs, truncated = self._obs_or_truncate()
        return obs, 0, False, truncated, {}

    def move(self, qpos, gripper_pos, duration: float = 1):
        """Absolute move + gripper command (the type="pos" eval path,
        run_bridgev2_position_eval.py:161-179)."""
        self.client.move(np.asarray(qpos), duration, blocking=self.blocking)
        self.client.move_gripper(gripper_pos)
        obs, truncated = self._obs_or_truncate()
        return obs, 0, False, truncated, {}

    def move_to_start_state(self) -> None:
        while True:
            try:
                vals = []
                for axis, default in zip("xyz", self.init_ee_pos):
                    raw = self.input_fn(
                        f"Enter {axis} value of gripper starting position "
                        f"(leave empty for default == {default}): ")
                    vals.append(default if raw == "" else float(raw))
                # blocking=True is load-bearing: the controller's
                # _reset_previous_qpos() runs right after the call returns,
                # so a non-blocking move would record a mid-flight state
                # (widowx_env.py:168-172)
                self.client.move(start_transform(vals), duration=0.8,
                                 blocking=True)
                return
            except (ValueError, ConnectionError, TimeoutError) as e:
                print(e)                 # bad input or a dropped link: retry

    def reset(self, seed=None, options=None):
        self.client.reset()
        self.move_to_start_state()
        return convert_obs(wait_for_obs(self.client), self.im_size), {}

    def get_observation(self) -> Dict:
        return convert_obs(wait_for_obs(self.client), self.im_size)
