"""Closed-loop policy success rate over the kinematic world, port of
``scripts/eval_success_rate.py`` with no TensorFlow or PIL.

The reference scores policies in SAPIEN sims (``maniskill2_evaluator.py:
15-175``) and checks its stack by replaying ground-truth dataset
trajectories in sim (``widowx_test_dataset_inference_rollout_gt_traj_in_
sim.py``). This gives the same figure of merit, task success rate, over
the deterministic kinematic world (``experiments/kinematic_sim.py``),
through the same policy / adapter / evaluator machinery.

Modes (each prints one JSON line):

- ``--mode fixture --data DIR``: roll out the scripted expert and record
  the episodes (JPEG frames from the port's encoder, proprio, 7-DoF
  actions, the instruction) into the RLDS TFRecord layout with the port's
  writer (``data/rlds.write_episodes``);
- ``--mode gt_replay --data DIR``: read the episodes back through the
  port's TFRecord reader and ``parse_episode`` and replay the recorded
  actions open-loop in a fresh env (same task and seed); on the expert
  fixture the success rate must be 1.0;
- ``--mode scripted``: the closed-loop oracle through ``evaluate_policy``;
- ``--mode vla``: the closed-loop success rate of an ``EmmaXVLA``
  (``--run_dir`` through ``load_vla``, or a tiny random-weight model; on
  the card unless ``--device cpu``). Random weights score ~0 by
  construction.

    python -m emmax_torch.eval_success_rate --mode scripted
    python -m emmax_torch.eval_success_rate --mode vla --run_dir runs/<run>
    python -m emmax_torch.eval_success_rate --mode vla --device cpu
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from emmax_torch.experiments.kinematic_sim import (TASKS, KinematicManipEnv,
                                                   ScriptedExpertPolicy,
                                                   evaluate_policy)

FIXTURE_NAME = "kinematic_gt-val-00000.tfrecord"
# the tiny model's identity-range action statistics (as the JAX script's)
TINY_STATS = {"bridge_orig": {"action": {
    "q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}


def make_fixture(data_dir: Path, episodes_per_task: int, max_steps: int,
                 seed: int) -> dict:
    """Expert rollouts -> RLDS episodes. ``episode_id`` carries the env
    seed and ``file_path`` the task name, so gt_replay can rebuild the
    world each trajectory was recorded in."""
    from emmax_torch.data.codec import encode_jpeg
    from emmax_torch.data.rlds import write_episodes

    eps, n_success = [], 0
    for name, task in TASKS.items():
        for ep in range(episodes_per_task):
            env = KinematicManipEnv(task, seed=seed + ep,
                                    max_steps=max_steps)
            policy = ScriptedExpertPolicy(env)
            obs, _ = env.reset()
            frames, proprio, actions = [], [], []
            for _ in range(max_steps):
                _, action = policy.step(obs["image"], task.instruction)
                frames.append(encode_jpeg(obs["image"], quality=95))
                proprio.append(obs["proprio"])
                actions.append(np.asarray(action, np.float32))
                obs, _, done, truncated, info = env.step(action)
                if info["success"] or truncated:
                    break
            n_success += bool(env.success)
            eps.append({"image_bytes": frames,
                        "proprio": np.asarray(proprio, np.float32),
                        "action": np.stack(actions),
                        "language": task.instruction,
                        "file_path": name,
                        "episode_id": seed + ep})
    data_dir.mkdir(parents=True, exist_ok=True)
    write_episodes(data_dir / FIXTURE_NAME, eps)
    return {"mode": "fixture", "episodes": len(eps),
            "expert_success_rate": n_success / len(eps),
            "path": str(data_dir / FIXTURE_NAME)}


def _text(value) -> str:
    return value.decode() if isinstance(value, bytes) else str(value)


def gt_replay(data_dir: Path, max_steps: int) -> dict:
    """Replay recorded actions open-loop in freshly built envs."""
    from emmax_torch.data.rlds import parse_episode
    from emmax_torch.data.tfrecord import read_records

    per_task: dict = {}
    for raw in read_records(data_dir / FIXTURE_NAME):
        traj = parse_episode(raw)
        name = _text(traj["file_path"][0])
        seed = int(traj["episode_id"][0])
        env = KinematicManipEnv(TASKS[name], seed=seed, max_steps=max_steps)
        env.reset()
        for a in traj["action"]:
            _, _, done, truncated, info = env.step(a)
            if info["success"] or truncated:
                break
        per_task.setdefault(name, []).append(bool(env.success))
    flat = [v for oks in per_task.values() for v in oks]
    return {"mode": "gt_replay", "episodes": len(flat),
            "overall_success_rate": float(np.mean(flat)),
            "per_task": {k: float(np.mean(v)) for k, v in per_task.items()}}


class VLAEnvPolicy:
    """EmmaXVLA -> kinematic-env policy: each decode yields an action chunk
    (``run_bridgev2_eval.py:149-199``) consumed a step at a time; the env
    speaks the BridgeV2 7-DoF delta-EEF convention directly. A decode whose
    text cannot be turned into actions (``ValueError``) gives one zero
    action, as in JAX; any other error ends the run."""

    def __init__(self, vla, max_new_tokens: int = 256) -> None:
        self.vla = vla
        self.max_new_tokens = max_new_tokens
        self.pending: list = []

    def reset(self, instruction: str) -> None:
        self.pending = []

    def step(self, image, instruction: str):
        if not self.pending:
            prompt = self.vla.get_prompt(instruction)
            try:
                actions, _ = self.vla.generate_actions(
                    np.asarray(image, np.uint8), prompt, type="act",
                    max_new_tokens=self.max_new_tokens)
            except ValueError:  # text an untrained model cannot act on
                actions = []
            self.pending = [np.asarray(a, np.float64) for a in actions] or \
                [np.zeros(7)]
        return None, self.pending.pop(0)


def build_tiny_vla(device="cuda", params=None, **vla_kw):
    """The tiny Emma-X (vocab 1024: the action bins need >= 516) on
    ``device``: ``params`` as given (e.g. a bridged JAX tree), else random
    weights drawn from seed 0. ``vla_kw`` go to ``EmmaXVLA``."""
    import torch

    from emmax_torch.models.vla import EmmaXVLA
    from emmax_torch.models.vlm import init_vlm_params, tiny_vlm_config
    from emmax_torch.ops.image import ImageTransformConfig
    from emmax_torch.serving.engine import resolve_device
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    device = resolve_device(device)
    cfg = tiny_vlm_config(vocab_size=1024)
    if params is None:
        generator = torch.Generator(device)
        generator.manual_seed(0)
        params = init_vlm_params(generator, cfg, torch.float32, device)
    transforms = {name: ImageTransformConfig(size=v.img_size)
                  for name, v in cfg.vision}
    return EmmaXVLA(cfg, params, ByteLevelTokenizer(vocab_size=1024),
                    transforms, norm_stats=TINY_STATS, device=device,
                    **vla_kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="scripted",
                    choices=["fixture", "gt_replay", "scripted", "vla"])
    ap.add_argument("--data", default="emmax_gt_fixture")
    ap.add_argument("--run_dir", default=None,
                    help="VLA checkpoint dir (vla mode); tiny random if unset")
    ap.add_argument("--episodes_per_task", type=int, default=3)
    ap.add_argument("--max_steps", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="vla mode: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode == "fixture":
        out = make_fixture(Path(args.data), args.episodes_per_task,
                           args.max_steps, args.seed)
    elif args.mode == "gt_replay":
        out = gt_replay(Path(args.data), args.max_steps)
    elif args.mode == "scripted":
        env0 = KinematicManipEnv(next(iter(TASKS.values())), seed=args.seed)
        out = evaluate_policy(ScriptedExpertPolicy(env0),
                              episodes_per_task=args.episodes_per_task,
                              max_steps=args.max_steps, seed=args.seed)
        out["mode"] = "scripted"
    else:
        if args.run_dir:
            from emmax_torch.models.load import load_vla

            vla = load_vla(args.run_dir, device=args.device)
        else:
            vla = build_tiny_vla(args.device)
        out = evaluate_policy(VLAEnvPolicy(vla),
                              episodes_per_task=args.episodes_per_task,
                              max_steps=args.max_steps, seed=args.seed)
        out["mode"] = "vla"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
