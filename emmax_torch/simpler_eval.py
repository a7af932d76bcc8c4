"""SimplerEnv / ManiSkill2 evaluation CLI, port of
``experiments/simpler/main_inference.py``.

Builds the policy adapter (``experiments/policy.EmmaXSimplerInference``)
and runs scored episodes (``maniskill2_evaluator.py:15-175``). The
simulator (``simpler_env`` / SAPIEN) is an outside dependency driven
through its public ``simpler_env.make`` API; without it, ``--sim
kinematic`` scores the same adapter over the kinematic world, and
``--dummy true`` runs the adapter loop on random frames. ``--smoke_test``
runs the tiny random-weight model (vocab 1024: the JAX script's 512 fails
``ActionTokenizer``'s vocab check) for 1 episode of 5 steps on the
kinematic world. Runs on the card unless ``--device cpu``.

    python -m emmax_torch.simpler_eval --pretrained_checkpoint runs/<run> \\
        --sim kinematic --episodes 10
    python -m emmax_torch.simpler_eval --smoke_test true --device cpu
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from emmax_torch.conf import parse_config
from emmax_torch.experiments.policy import EmmaXSimplerInference
from emmax_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch("simpler-eval")


@dataclass
class SimplerConfig:
    pretrained_checkpoint: Optional[Path] = None
    env_name: str = "widowx_spoon_on_towel"
    policy_setup: str = "widowx_bridge"       # widowx_bridge | google_robot
    sim: str = "simpler"                      # simpler | kinematic
    episodes: int = 10
    max_steps: int = 120
    max_new_tokens: int = 512
    tokenizer_path: Optional[str] = None
    dummy: bool = False
    smoke_test: bool = False
    device: str = "cuda"


class FlatPolicy:
    """The SimplerEnv adapter's dict actions as one 7-vector
    (world_vector, rot_axangle, gripper), for ``evaluate_policy``."""

    def __init__(self, policy: EmmaXSimplerInference) -> None:
        self.policy = policy

    def reset(self, instruction):
        self.policy.reset(instruction)

    def step(self, image, instruction):
        raw, action = self.policy.step(image, instruction)
        if isinstance(action, dict):
            action = np.concatenate([action["world_vector"],
                                     action["rot_axangle"],
                                     action["gripper"]])
        return raw, action


def main(cfg: SimplerConfig) -> Optional[dict]:
    """Returns the kinematic world's report (``--sim kinematic``), else
    None."""
    if cfg.smoke_test:
        from emmax_torch.eval_success_rate import build_tiny_vla

        vla = build_tiny_vla(cfg.device)
        cfg.sim = "kinematic"
        cfg.episodes = 1
        cfg.max_steps = 5
        cfg.max_new_tokens = 10
    else:
        from emmax_torch.models.load import load_vla

        vla = load_vla(cfg.pretrained_checkpoint,
                       tokenizer_path=cfg.tokenizer_path, device=cfg.device)

    policy = EmmaXSimplerInference(vla, policy_setup=cfg.policy_setup,
                                   max_new_tokens=cfg.max_new_tokens)

    if cfg.dummy:
        rng = np.random.default_rng(0)
        for ep in range(cfg.episodes):
            policy.reset("put the spoon on the towel")
            for _ in range(cfg.max_steps):
                img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
                policy.step(img, "put the spoon on the towel")
            overwatch.info(f"dummy episode {ep}: ran {cfg.max_steps} steps")
        overwatch.info("dummy run complete (no simulator attached)")
        return None

    if cfg.sim == "kinematic":
        # scored over the kinematic pick-and-place world
        # (experiments/kinematic_sim.py); SAPIEN is an outside dependency
        from emmax_torch.experiments.kinematic_sim import (TASKS,
                                                           evaluate_policy)

        names = [cfg.env_name] if cfg.env_name in TASKS else list(TASKS)
        report = evaluate_policy(FlatPolicy(policy), tasks=names,
                                 episodes_per_task=cfg.episodes,
                                 max_steps=cfg.max_steps)
        for name, rate in report["per_task"].items():
            overwatch.info(f"{name}: success rate {rate:.2%}")
        overwatch.info(
            f"overall success rate: {report['overall_success_rate']:.2%}")
        return report

    try:
        import simpler_env
        from simpler_env.utils.env.observation_utils import \
            get_image_from_maniskill2_obs_dict
    except ImportError as e:
        raise ImportError("simpler_env not installed; use --sim kinematic "
                          "or --dummy true") from e

    env = simpler_env.make(cfg.env_name)
    successes = 0
    for ep in range(cfg.episodes):
        obs, _ = env.reset()
        instruction = env.get_language_instruction()
        policy.reset(instruction)
        done, truncated, t = False, False, 0
        while not (done or truncated) and t < cfg.max_steps:
            image = get_image_from_maniskill2_obs_dict(env, obs)
            _, action = policy.step(image, instruction)
            obs, reward, done, truncated, info = env.step(
                np.concatenate([action["world_vector"],
                                action["rot_axangle"], action["gripper"]]))
            t += 1
        successes += int(done)
        overwatch.info(f"episode {ep}: success={bool(done)}")
    overwatch.info(f"success rate: {successes}/{cfg.episodes} "
                   f"= {successes / cfg.episodes:.2%}")
    return None


if __name__ == "__main__":
    main(parse_config(SimplerConfig, sys.argv[1:]))
