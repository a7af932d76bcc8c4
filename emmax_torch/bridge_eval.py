"""WidowX BridgeV2 closed-loop evaluation CLI, port of
``experiments/robot/bridge/run_bridgev2_eval.py``.

Connects to a WidowX control server and runs episodes where each
``generate_actions`` decode yields a chunk of 7-DoF actions executed in
turn, with the gripper position for the ``CURRENT GRIPPER`` prompt field
from ``GripperLocator`` (OWL-ViT + SAM with ``--use_detector true``, which
needs ``transformers``; else the darkest-region rule). The robot client
(``widowx_envs``) is a network service; ``--dummy true`` drives the same
loop against random frames. ``--speculative true`` serves the model on the
closed-loop speculative engine (``load_vla(..., speculative=True)``).
Per episode it writes ``episode_<n>_actions.npy``, ``episode_<n>_texts.txt``
and, where OpenCV imports, ``episode_<n>.mp4``; without OpenCV (the card
machine has none) it warns once and writes no video, the reference's own
best-effort handling of that side file. ``--smoke_test`` runs the tiny
random-weight model (vocab 1024) for one dummy episode of at most 16 new
tokens a decode. Runs on the card unless ``--device cpu``.

    python -m emmax_torch.bridge_eval --pretrained_checkpoint runs/<run> \\
        --host <robot host> --save_dir rollouts
    python -m emmax_torch.bridge_eval --smoke_test true --device cpu \\
        --save_dir /tmp/rollouts
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from emmax_torch.conf import parse_config
from emmax_torch.experiments.gripper import GripperLocator, HFDetectorBackend
from emmax_torch.experiments.policy import run_closed_loop
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("bridge-eval")


@dataclass
class BridgeEvalConfig:
    pretrained_checkpoint: Optional[Path] = None
    host: str = "localhost"
    port: int = 5556
    max_episodes: int = 50
    max_steps: int = 100
    control_frequency: float = 5.0            # run_bridgev2_eval.py:89
    max_new_tokens: int = 512
    action_type: str = "act"                  # act | pos
    speculative: bool = False                 # closed-loop speculative decode
    use_detector: bool = False                # OWL-ViT + SAM (downloads)
    dummy: bool = False                       # stand-in env, no robot
    save_dir: Path = Path("rollouts")
    tokenizer_path: Optional[str] = None
    smoke_test: bool = False
    device: str = "cuda"


class WidowXEnvAdapter:
    """The ``widowx_envs`` WidowXClient through ``WidowXGymEnv``
    (observation conversion and proprio padding, the blocking
    reset-to-start; ``experiments/widowx.py``)."""

    def __init__(self, host: str, port: int,
                 init_ee_pos=(0.3, 0.0, 0.15), interactive: bool = True):
        try:
            from widowx_envs.widowx_env_service import (WidowXClient,
                                                        WidowXConfigs)
        except ImportError as e:
            raise ImportError(
                "widowx_envs not installed: this CLI drives a physical "
                "robot server; use --dummy true for the stand-in loop") from e
        from emmax_torch.experiments.widowx import WidowXGymEnv

        client = WidowXClient(host=host, port=port)
        client.init(WidowXConfigs.DefaultEnvParams, image_size=256)
        self.env = WidowXGymEnv(client, init_ee_pos=init_ee_pos,
                                blocking=False,
                                input_fn=input if interactive else None)
        self.env.reset()

    def get_observation(self):
        obs = self.env.get_observation()
        out = {"full_image": obs.get("full_image", obs["image_primary"]),
               "proprio": obs["proprio"]}
        if "eef_transform" in obs:   # pos-mode eval needs the EE pose
            out["eef_transform"] = obs["eef_transform"]
        return out

    def step(self, action):
        return self.env.step(action)

    def move(self, goal_mat, gripper, duration=1):
        return self.env.move(goal_mat, gripper, duration=duration)


class DummyEnv:
    """Random 256x256 frames in place of the robot
    (``dummy_bridgev2_eval.py``)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.executed = []

    def get_observation(self):
        return {"full_image": self.rng.integers(0, 256, (256, 256, 3),
                                                dtype=np.uint8)}

    def step(self, action):
        self.executed.append(np.asarray(action))

    def move(self, goal_mat, gripper, duration=1):
        # pos-mode absolute move (dummy_bridgev2_position_eval.py)
        self.executed.append(("move", np.asarray(goal_mat), gripper))


def main(cfg: BridgeEvalConfig) -> list:
    """Runs the episodes; returns each episode's log."""
    if cfg.smoke_test:
        from emmax_torch.eval_success_rate import build_tiny_vla

        vla = build_tiny_vla(cfg.device, speculative=cfg.speculative)
        cfg.dummy = True
        cfg.max_new_tokens = min(cfg.max_new_tokens, 16)
    else:
        from emmax_torch.models.load import load_vla

        vla = load_vla(cfg.pretrained_checkpoint,
                       tokenizer_path=cfg.tokenizer_path,
                       speculative=cfg.speculative, device=cfg.device)

    locator = GripperLocator(backend=HFDetectorBackend(device=cfg.device)
                             if cfg.use_detector else None)
    env = DummyEnv() if cfg.dummy else WidowXEnvAdapter(cfg.host, cfg.port)

    save_dir = Path(cfg.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    cv2 = _opencv()
    logs = []
    for ep in range(cfg.max_episodes):
        if cfg.dummy and ep >= 1:
            break
        instruction = ("put the spoon on the towel" if cfg.dummy
                       else input("Enter instruction: ").strip())
        t0 = time.time()
        log = run_closed_loop(vla, env, instruction,
                              gripper_locator=locator,
                              max_steps=cfg.max_steps,
                              max_new_tokens=cfg.max_new_tokens,
                              action_type=cfg.action_type)
        dur = time.time() - t0
        hz = len(log.actions) / max(dur, 1e-9)
        overwatch.info(
            f"episode {ep}: {len(log.actions)} actions in {dur:.1f}s "
            f"({hz:.1f} Hz amortized), {len(log.texts)} decodes")
        np.save(save_dir / f"episode_{ep}_actions.npy",
                np.asarray(log.actions))
        (save_dir / f"episode_{ep}_texts.txt").write_text(
            "\n----\n".join(log.texts))
        if cv2 is not None:
            _save_video(cv2, save_dir / f"episode_{ep}.mp4", log.frames,
                        fps=cfg.control_frequency)
        logs.append(log)
    return logs


def _opencv():
    """OpenCV, or None (with one warning) where it is not installed: the
    rollout videos are then skipped."""
    try:
        import cv2
    except ImportError:
        overwatch.warning("OpenCV is not installed: no rollout videos "
                          "(actions and texts are still written)")
        return None
    return cv2


def _save_video(cv2, path, frames, fps: float = 5.0) -> None:
    """Rollout mp4 (the reference saves episode videos,
    ``bridgev2_utils.py:96+``), best effort: a codec failure only warns."""
    if not frames:
        return
    h, w = np.asarray(frames[0]).shape[:2]
    try:
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (w, h))
        for f in frames:
            vw.write(np.ascontiguousarray(np.asarray(f)[..., ::-1]))
        vw.release()
    except (cv2.error, OSError) as e:
        overwatch.warning(f"video save failed ({e}); frames kept in "
                          "memory only")
        return
    overwatch.info(f"saved rollout video -> {path}")


if __name__ == "__main__":
    main(parse_config(BridgeEvalConfig, sys.argv[1:]))
