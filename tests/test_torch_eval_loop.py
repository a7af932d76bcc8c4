"""Port parity for the evaluation entry points:
``emmax_torch.eval_success_rate`` against ``scripts/eval_success_rate.py``,
and ``emmax_torch.simpler_eval`` / ``emmax_torch.bridge_eval`` run as
their ``--smoke_test`` on the CPU.

The tiny VLA (``init_vlm_params(PRNGKey(0), tiny_vlm_config(1024))``,
bridged) in the closed loop gives JAX's texts, actions and success
exactly (fp32). RLDS fixtures cross over: the port's (its own JPEG encoder
and TFRecord writer) replays to 1.0 through JAX's TF reader, JAX's (PIL
JPEG) through the port's; a sign-flipped action stream replays to 0.0.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from emmax_torch import bridge_eval, simpler_eval
from emmax_torch import eval_success_rate as t_esr
from emmax_torch.bridge import params_from_numpy
from emmax_torch.conf import parse_config
from emmax_torch.data import rlds as t_rlds
from emmax_torch.data.tfrecord import read_records

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import eval_success_rate as j_esr  # noqa: E402

TASK = "widowx_spoon_on_towel"


class _Recorder:
    """Wraps a VLA's ``generate_actions`` to keep each decode's output."""

    def __init__(self, vla):
        self.vla = vla
        self.out = []

    def get_prompt(self, *a):
        return self.vla.get_prompt(*a)

    def generate_actions(self, *a, **kw):
        actions, text = self.vla.generate_actions(*a, **kw)
        self.out.append(([np.asarray(x, np.float64) for x in actions], text))
        return actions, text


def _jax_vla(params):
    """``scripts/eval_success_rate.py``'s ``build_tiny_vla`` on ``params``
    (its own draw runs the initializer op by op, ~13 s on the CPU)."""
    from emmax_tpu.models.vla import EmmaXVLA
    from emmax_tpu.models.vlm import tiny_vlm_config
    from emmax_tpu.ops.image import ImageTransformConfig
    from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

    cfg = tiny_vlm_config(vocab_size=1024)
    return EmmaXVLA(cfg, params, ByteLevelTokenizer(vocab_size=1024),
                    {name: ImageTransformConfig(size=v.img_size)
                     for name, v in cfg.vision},
                    norm_stats=t_esr.TINY_STATS)


def _loop(esr, vla, steps, frames):
    rec = _Recorder(vla)
    report = esr.evaluate_policy(
        esr.VLAEnvPolicy(rec, max_new_tokens=16), tasks=[TASK],
        episodes_per_task=1, max_steps=steps,
        on_frame=lambda n, ep, img: frames.append(img.tobytes()))
    return report, rec.out


def test_tiny_vla_loop_matches_jax():
    from emmax_tpu.models.vlm import init_vlm_params, tiny_vlm_config

    params = jax.jit(init_vlm_params, static_argnums=1)(
        jax.random.PRNGKey(0), tiny_vlm_config(vocab_size=1024))
    jvla = _jax_vla(params)
    tvla = t_esr.build_tiny_vla("cpu", params=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    jframes, tframes = [], []
    want, wout = _loop(j_esr, jvla, 3, jframes)
    got, tout = _loop(t_esr, tvla, 3, tframes)
    assert got == want
    assert len(tout) == len(wout) == 3        # one action a decode
    for (ta, tt), (wa, wt) in zip(tout, wout):
        assert tt == wt
        assert len(ta) == len(wa)
        for a, b in zip(ta, wa):
            np.testing.assert_array_equal(a, b)
    assert tframes == jframes


def test_scripted_mode_prints_jax_json(capsys):
    argv = ["--mode", "scripted", "--episodes_per_task", "1", "--seed", "2"]
    want = j_esr.main(argv)
    jline = capsys.readouterr().out.strip()
    got = t_esr.main(argv)
    tline = capsys.readouterr().out.strip()
    assert got == want and tline == jline
    assert json.loads(tline)["overall_success_rate"] == 1.0


def test_port_fixture_replays_through_jax_tf(tmp_path):
    pytest.importorskip("tensorflow")
    fx = t_esr.main(["--mode", "fixture", "--data", str(tmp_path),
                     "--episodes_per_task", "1"])
    assert fx["expert_success_rate"] == 1.0
    assert fx["episodes"] == len(t_esr.TASKS)
    rp = j_esr.main(["--mode", "gt_replay", "--data", str(tmp_path)])
    assert rp["overall_success_rate"] == 1.0
    assert rp == t_esr.main(["--mode", "gt_replay", "--data",
                             str(tmp_path)])


def test_jax_fixture_replays_through_the_port(tmp_path):
    pytest.importorskip("PIL")
    fx = j_esr.main(["--mode", "fixture", "--data", str(tmp_path),
                     "--episodes_per_task", "1", "--seed", "1"])
    assert fx["expert_success_rate"] == 1.0
    rp = t_esr.main(["--mode", "gt_replay", "--data", str(tmp_path)])
    assert rp["overall_success_rate"] == 1.0
    assert rp["episodes"] == fx["episodes"]


def test_gt_replay_detects_broken_convention(tmp_path):
    """``tests/test_success_rate.py:42`` on the port: sign-flipped
    translations must not replay to success."""
    t_esr.main(["--mode", "fixture", "--data", str(tmp_path),
                "--episodes_per_task", "1"])
    path = tmp_path / t_esr.FIXTURE_NAME
    eps = []
    for raw in read_records(path):
        traj = t_rlds.parse_episode(raw)
        acts = np.array(traj["action"])
        acts[:, :3] *= -1.0                      # corrupt translations
        eps.append({"image_bytes": [b"x"] * len(acts),
                    "proprio": traj["observation"]["proprio"],
                    "action": acts,
                    "language": t_esr._text(
                        traj["task"]["language_instruction"]),
                    "file_path": t_esr._text(traj["file_path"][0]),
                    "episode_id": int(traj["episode_id"][0])})
    t_rlds.write_episodes(path, eps)
    rp = t_esr.main(["--mode", "gt_replay", "--data", str(tmp_path)])
    assert rp["overall_success_rate"] == 0.0


def test_simpler_smoke_test_on_the_cpu():
    report = simpler_eval.main(parse_config(
        simpler_eval.SimplerConfig, ["--smoke_test", "true", "--device",
                                     "cpu"]))
    assert report["episodes_per_task"] == 1
    assert set(report["per_task"]) == {TASK}
    assert 0.0 <= report["overall_success_rate"] <= 1.0


def test_simpler_without_simpler_env_raises_import_error():
    cfg = simpler_eval.SimplerConfig(pretrained_checkpoint="tiny",
                                     device="cpu")
    with pytest.raises(ImportError, match="simpler_env"):
        simpler_eval.main(cfg)


def test_bridge_smoke_test_writes_its_files(tmp_path):
    logs = bridge_eval.main(parse_config(
        bridge_eval.BridgeEvalConfig,
        ["--smoke_test", "true", "--device", "cpu", "--max_steps", "6",
         "--save_dir", str(tmp_path)]))
    assert len(logs) == 1 and len(logs[0].actions) == 6
    actions = np.load(tmp_path / "episode_0_actions.npy")
    assert actions.shape == (6, 7) and np.isfinite(actions).all()
    texts = (tmp_path / "episode_0_texts.txt").read_text().split("\n----\n")
    assert texts == logs[0].texts and len(texts) == 6
    assert (tmp_path / "episode_0.mp4").stat().st_size > 0   # OpenCV here


def test_bridge_without_opencv_writes_no_video(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)     # import fails
    assert bridge_eval._opencv() is None
    bridge_eval.main(parse_config(
        bridge_eval.BridgeEvalConfig,
        ["--smoke_test", "true", "--device", "cpu", "--max_steps", "2",
         "--save_dir", str(tmp_path)]))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "episode_0_actions.npy", "episode_0_texts.txt"]


def test_bridge_without_widowx_envs_raises_import_error():
    with pytest.raises(ImportError, match="widowx_envs"):
        bridge_eval.WidowXEnvAdapter("localhost", 5556)
