"""Port parity for the robot-evaluation layer: ``emmax_torch.experiments``
(SE(3) helpers, the kinematic world, gripper localization, the policy
adapters and closed loops, the WidowX env) and ``emmax_torch.util``
(seeding, profiling) against ``emmax_tpu`` on the CPU.

Host numpy is held exactly: frames byte for byte, infos, successes,
actions, call logs. The closed loops catch ``ValueError`` from
``generate_actions`` as JAX does and let a ``RuntimeError`` through,
where JAX catches every exception.
"""

import json
import os
import random
import sys
import types

import numpy as np
import pytest
import torch

from emmax_torch.experiments import gripper as t_grip
from emmax_torch.experiments import kinematic_sim as t_sim
from emmax_torch.experiments import policy as t_pol
from emmax_torch.experiments import transforms3d as t_tf
from emmax_torch.experiments import widowx as t_wx
from emmax_torch.util import profiling as t_prof
from emmax_torch.util import seeding as t_seed
from emmax_tpu.experiments import gripper as j_grip
from emmax_tpu.experiments import kinematic_sim as j_sim
from emmax_tpu.experiments import policy as j_pol
from emmax_tpu.experiments import transforms3d as j_tf
from emmax_tpu.experiments import widowx as j_wx
from emmax_tpu.util import profiling as j_prof
from emmax_tpu.util import seeding as j_seed


def _equal(got, want, path="out"):
    """Nested results equal exactly (arrays by value and dtype)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------- transforms3d --

def test_transforms3d_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(25):
        rpy = rng.uniform(-3.0, 3.0, 3)
        xyz = rng.normal(size=3)
        R = j_tf.euler_to_mat(*rpy)
        cases = [("euler_to_mat", rpy), ("mat_to_euler", (R,)),
                 ("mat_to_quat", (R,)), ("euler_to_quat", rpy),
                 ("quat_to_mat", (j_tf.mat_to_quat(R),)),
                 ("quat_to_euler", (j_tf.mat_to_quat(R),)),
                 ("euler_to_axangle", rpy),
                 ("pose_to_mat", (xyz, j_tf.euler_to_quat(*rpy))),
                 ("mat_to_pose", (j_tf.pose6_to_mat([*xyz, *rpy]),)),
                 ("pose6_to_mat", ([*xyz, *rpy],)),
                 ("mat_to_pose6", (j_tf.pose6_to_mat([*xyz, *rpy]),))]
        for name, args in cases:
            want = getattr(j_tf, name)(*args)
            got = getattr(t_tf, name)(*args)
            for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                            np.atleast_1d(np.asarray(want, dtype=object))):
                np.testing.assert_allclose(np.asarray(g, np.float64),
                                           np.asarray(w, np.float64),
                                           rtol=0, atol=1e-12, err_msg=name)
    # gimbal lock and the trace <= 0 branch
    for R in (j_tf.euler_to_mat(0.3, np.pi / 2, 0.1), np.diag([1., -1, -1])):
        np.testing.assert_allclose(t_tf.mat_to_euler(R), j_tf.mat_to_euler(R),
                                   atol=1e-12)
        np.testing.assert_allclose(t_tf.mat_to_quat(R), j_tf.mat_to_quat(R),
                                   atol=1e-12)


# ------------------------------------------------------- kinematic world --

@pytest.mark.parametrize("task", ["widowx_carrot_on_plate",
                                  "widowx_put_eggplant_in_basket"])
def test_kinematic_world_steps_match_jax(task):
    """Seeded random and grasp-seeking actions: byte-equal frames, equal
    infos and successes, equal state."""
    rng = np.random.default_rng(5)
    envs = [m.KinematicManipEnv(m.TASKS[task], seed=3, im_size=64,
                                max_steps=40) for m in (j_sim, t_sim)]
    outs = [e.reset() for e in envs]
    _equal(outs[1], outs[0])
    for t in range(40):
        if t % 3:
            action = rng.uniform(-1.2, 1.2, 7)
        else:                     # head for the object, gripper random
            d = (envs[0].object_pos - envs[0].gripper_pos) / 0.05
            action = np.array([*np.clip(d, -1, 1), 0, 0, 0,
                               float(rng.random() < 0.5)])
        steps = [e.step(action) for e in envs]
        _equal(steps[1], steps[0])
        for k in ("gripper_pos", "object_pos", "grasped", "success"):
            _equal(getattr(envs[1], k), getattr(envs[0], k), k)
        if steps[0][3]:
            break


def test_scripted_expert_report_matches_jax():
    frames = {"jax": [], "torch": []}
    reports = {}
    for key, m in (("jax", j_sim), ("torch", t_sim)):
        env0 = m.KinematicManipEnv(m.TASKS["widowx_stack_cube"], seed=0)
        reports[key] = m.evaluate_policy(
            m.ScriptedExpertPolicy(env0), episodes_per_task=2, seed=4,
            on_frame=lambda name, ep, img, key=key: frames[key].append(
                (name, ep, img.tobytes())))
    assert reports["torch"] == reports["jax"]
    assert reports["torch"]["overall_success_rate"] == 1.0
    assert frames["torch"] == frames["jax"] and frames["jax"]


# --------------------------------------------------------------- gripper --

def test_mask_to_pos_and_locator_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        mask = rng.random((40, 56)) < 0.05
        assert t_grip.mask_to_pos_naive(mask, 3, -4) == \
            j_grip.mask_to_pos_naive(mask, 3, -4)
    assert t_grip.mask_to_pos_naive(np.zeros((5, 5), bool)) == (0, 0)
    for size in (64, 128, 256):
        img = rng.integers(30, 256, (size, size, 3), dtype=np.uint8)
        y, x = rng.integers(0, size - 8, 2)
        img[y:y + 8, x:x + 8] = rng.integers(0, 20)
        assert t_grip.GripperLocator()(img) == j_grip.GripperLocator()(img)
    # a backend whose mask wins over the darkest region
    mask = np.zeros((128, 128), bool)
    mask[20:30, 40:50] = True
    assert (t_grip.GripperLocator(backend=lambda im: mask)(img[:128, :128])
            == j_grip.GripperLocator(backend=lambda im: mask)(img[:128, :128]))


def test_locator_lets_a_detector_error_through():
    def broken(image):
        raise RuntimeError("CUDA error: launch failure")

    with pytest.raises(RuntimeError, match="launch failure"):
        t_grip.GripperLocator(backend=broken)(np.zeros((8, 8, 3), np.uint8))


class _FakeOwlProcessor:
    """Detects the brightest-red rectangle; a decoy low-score box first
    (``tests/test_gripper_backend.py``'s contract)."""

    def __call__(self, *, text, images, return_tensors):
        assert return_tensors == "pt"
        self._img = np.asarray(images)
        return {"pixel_values": torch.zeros(1)}

    def post_process_object_detection(self, outputs, *, threshold,
                                      target_sizes):
        h, w = [int(v) for v in target_sizes[0]]
        assert (h, w) == self._img.shape[:2]
        red = (self._img[..., 0] > 200) & (self._img[..., 1] < 50)
        if not red.any():
            return [{"boxes": torch.zeros((0, 4)),
                     "scores": torch.zeros((0,))}]
        ys, xs = np.nonzero(red)
        box = [xs.min(), ys.min(), xs.max(), ys.max()]
        return [{"boxes": torch.tensor([[0.0, 0.0, 4.0, 4.0], box],
                                       dtype=torch.float32),
                 "scores": torch.tensor([0.10, 0.90])}]


class _FakeSamProcessor:
    def __init__(self):
        self.image_processor = self

    def __call__(self, pil, *, input_boxes, return_tensors):
        self._box = [int(v) for v in input_boxes[0][0]]
        img = np.asarray(pil)
        return {"original_sizes": torch.tensor([list(img.shape[:2])]),
                "reshaped_input_sizes": torch.tensor([[64, 64]])}

    def post_process_masks(self, pred_masks, original_sizes,
                           reshaped_input_sizes):
        h, w = [int(v) for v in original_sizes[0]]
        x0, y0, x1, y1 = self._box
        mask = torch.zeros((1, 1, h, w), dtype=torch.bool)
        mask[0, 0, y0:y1 + 1, x0:x1 + 1] = True
        return [mask]


class _FakeModel:
    def __init__(self, out=None):
        self._out = out
        self.devices = []

    def eval(self):
        return self

    def to(self, device):
        self.devices.append(str(device))
        return self

    def __call__(self, **inputs):
        return self._out


@pytest.fixture()
def fake_transformers(monkeypatch):
    """A stand-in ``transformers`` module in ``sys.modules`` (the port
    imports it inside ``HFDetectorBackend.__init__``, JAX's too)."""
    def fp(obj):
        return type("FP", (), {"from_pretrained":
                               staticmethod(lambda *a, **k: obj)})

    out = types.SimpleNamespace(pred_masks=torch.zeros((1, 1, 1, 4, 4)))
    owl, sam = _FakeModel(), _FakeModel(out)
    fake = types.ModuleType("transformers")
    fake.OwlViTProcessor = fp(_FakeOwlProcessor())
    fake.OwlViTForObjectDetection = fp(owl)
    fake.AutoProcessor = fp(_FakeSamProcessor())
    fake.SamModel = fp(sam)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    return owl, sam


def test_detector_backend_on_fake_modules_matches_jax(fake_transformers):
    img = np.zeros((256, 256, 3), np.uint8) + 120
    img[100:120, 140:170, 0] = 255                 # red blob
    img[100:120, 140:170, 1:] = 0
    backend = t_grip.HFDetectorBackend(device="cpu")
    assert fake_transformers[0].devices == ["cpu"]
    assert fake_transformers[1].devices == ["cpu"]
    mask = backend(img)
    np.testing.assert_array_equal(mask, j_grip.HFDetectorBackend()(img))
    assert mask.dtype == bool and mask[110, 150] and not mask[0, 0]
    x, y = t_grip.GripperLocator(backend=backend)(img)
    assert (x, y) == j_grip.GripperLocator(
        backend=j_grip.HFDetectorBackend())(img)
    assert (x, y) == (round(179 * 224 / 256), round(109 * 224 / 256))
    # no detection: the darkest-region rule, as JAX
    plain = np.full((128, 128, 3), 200, np.uint8)
    plain[60:64, 60:64] = 0
    assert backend(plain) is None
    assert t_grip.GripperLocator(backend=backend)(plain) == (
        round(73 * 224 / 128), round(53 * 224 / 128))


def test_detector_backend_raises_without_a_card(fake_transformers,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_grip.HFDetectorBackend()


# -------------------------------------------------------- policy adapter --

CHUNK = [np.array([0.01, -0.02, 0.03, 0.1, -0.2, 0.3, 0.9]),
         np.array([-0.02, 0.01, 0.0, -0.3, 0.2, 0.1, 0.1]),
         np.array([0.0, 0.03, -0.01, 0.05, 0.0, -0.4, 0.6])]
GCOT = ("PLAN: reach the spoon\nMOVEMENT: move down\nNEXT GRIPPER: [120, 96]"
        "\nPOLICIES: abcdefgh; ijklmnop; qrstuvwx")


class StubVLA:
    """Fixed GCOT text whose POLICIES line holds a 3-action chunk; logs
    its calls."""

    def __init__(self, error=None):
        self.calls = []
        self.error = error

    def get_prompt(self, task, gripper_position=None):
        return f"In: {task} @ {gripper_position}\nOut:"

    def generate_actions(self, image, prompt, type="act",
                         max_new_tokens=512):
        self.calls.append((prompt, type, max_new_tokens,
                           int(np.asarray(image).sum())))
        if self.error is not None:
            raise self.error
        if type == "pos":
            return [CHUNK[0]], "MOVEMENT: ..."
        return [a.copy() for a in CHUNK], GCOT


@pytest.mark.parametrize("setup", ["widowx_bridge", "google_robot"])
def test_simpler_adapter_matches_jax(setup):
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
              for _ in range(20)]
    runs = []
    for m in (j_pol, t_pol):
        vla = StubVLA()
        policy = m.EmmaXSimplerInference(vla, policy_setup=setup,
                                         action_scale=1.5, max_new_tokens=64,
                                         sticky_gripper_num_repeat=4)
        steps = [policy.step(f, "put the spoon on the towel" if i < 12
                             else "open the drawer")
                 for i, f in enumerate(frames)]
        runs.append((steps, vla.calls))
    _equal(runs[1], runs[0])
    assert len(runs[1][1]) == 7        # 12 / 3 + ceil(8 / 3) decodes


class _MockEnv:
    def __init__(self, rng):
        self.rng = rng
        self.steps = []

    def get_observation(self):
        return {"full_image": self.rng.integers(0, 256, (32, 32, 3),
                                                dtype=np.uint8)}

    def step(self, action):
        self.steps.append(np.asarray(action))


class _PosEnv:
    def __init__(self):
        self.moves = []
        self.eef = j_tf.pose6_to_mat([0.3, 0.0, 0.15, 0.1, 0.2, 0.3])

    def get_observation(self):
        return {"full_image": np.zeros((8, 8, 3), np.uint8),
                "eef_transform": self.eef}

    def move(self, goal, gripper, duration=1):
        self.moves.append((np.asarray(goal), gripper, duration))

    def step(self, action):
        raise AssertionError("pos mode must not use step()")


class _TruncEnv:
    def __init__(self):
        self.steps = 0

    def get_observation(self):
        return {"full_image": np.zeros((8, 8, 3), np.uint8)}

    def step(self, action):
        self.steps += 1
        return ({}, 0, False, self.steps >= 2, {})


def _log(log):
    return (log.frames, log.actions, log.texts)


@pytest.mark.parametrize("case", ["act", "pos", "truncation"])
def test_run_closed_loop_matches_jax(case):
    runs = []
    for m, gm in ((j_pol, j_grip), (t_pol, t_grip)):
        vla = StubVLA()
        if case == "act":
            env = _MockEnv(np.random.default_rng(1))
            log = m.run_closed_loop(vla, env, "put the pot by the cans",
                                    gripper_locator=gm.GripperLocator(),
                                    max_steps=7, max_new_tokens=10)
            trace = env.steps
        elif case == "pos":
            env = _PosEnv()
            log = m.run_closed_loop(vla, env, "reach", max_steps=2,
                                    action_type="pos")
            trace = env.moves
        else:
            env = _TruncEnv()
            log = m.run_closed_loop(vla, env, "reach", max_steps=10)
            trace = env.steps
        runs.append((_log(log), trace, vla.calls))
    _equal(runs[1], runs[0])
    n_actions = {"act": 7, "pos": 2, "truncation": 2}[case]
    assert len(runs[1][0][1]) == n_actions


def test_loops_catch_value_error_and_pass_runtime_error():
    """JAX catches every exception around ``generate_actions``; the port
    only ``ValueError``, which it handles as JAX does (the episode ends;
    the success-rate policy takes one zero action)."""
    from emmax_torch.eval_success_rate import VLAEnvPolicy

    frame = np.zeros((8, 8, 3), np.uint8)
    for m in (j_pol, t_pol):
        log = m.run_closed_loop(StubVLA(ValueError("no proprio stats")),
                                _MockEnv(np.random.default_rng(0)), "x",
                                max_steps=3)
        assert _log(log) == ([], [], [])
    _, action = VLAEnvPolicy(StubVLA(ValueError("bad"))).step(frame, "x")
    np.testing.assert_array_equal(action, np.zeros(7))
    for error in (RuntimeError("CUDA error: an illegal memory access"),
                  torch.cuda.OutOfMemoryError("out of memory")):
        with pytest.raises(RuntimeError):
            t_pol.run_closed_loop(StubVLA(error),
                                  _MockEnv(np.random.default_rng(0)), "x",
                                  max_steps=3)
        with pytest.raises(RuntimeError):
            VLAEnvPolicy(StubVLA(error)).step(frame, "x")
        with pytest.raises(RuntimeError):
            t_pol.EmmaXSimplerInference(StubVLA(error)).step(frame, "x")


def test_normalize_gripper_action_matches_jax():
    a = np.random.default_rng(3).uniform(0, 1, (5, 7))
    a[0, -1] = 0.5
    for binarize in (True, False):
        _equal(t_pol.normalize_gripper_action(a, binarize),
               j_pol.normalize_gripper_action(a, binarize))


# ---------------------------------------------------------------- widowx --

class _FakeWidowXClient:
    """``tests/test_experiments.py``'s fake client."""

    def __init__(self, im_size=4, fail_after=None):
        self.im_size = im_size
        self.calls = []
        self.fail_after = fail_after
        self.n_obs = 0
        self.state = np.arange(7, dtype=np.float64) / 10.0

    def get_observation(self):
        self.n_obs += 1
        if self.fail_after is not None and self.n_obs > self.fail_after:
            return None
        img = np.linspace(0, 1, 3 * self.im_size * self.im_size)
        return {"image": img, "state": self.state,
                "full_image": np.zeros((8, 8, 3), np.uint8),
                "eef_transform": np.eye(4)}

    def step_action(self, action, blocking=False):
        self.calls.append(("step", np.asarray(action), blocking))

    def move(self, transform, duration=1, blocking=False):
        self.calls.append(("move", np.asarray(transform), duration,
                           blocking))

    def move_gripper(self, pos):
        self.calls.append(("gripper", pos))

    def reset(self):
        self.calls.append(("reset",))


def _widowx_session(m, fail_after):
    client = _FakeWidowXClient(fail_after=fail_after)
    answers = iter(["oops", "", "", "0.25", "", "0.2"])
    prompts = []

    def fake_input(prompt):
        prompts.append(prompt)
        return next(answers)

    env = m.WidowXGymEnv(client, init_ee_pos=(0.3, 0.0, 0.15), im_size=4,
                         blocking=False, input_fn=fake_input)
    out = [env.reset(), env.get_observation()]
    for i in range(3):
        out.append(env.step(np.full(7, 0.1 * i)))
    out.append(env.move(np.eye(4), 0.9, duration=2))
    out.append(m.convert_obs(client.get_observation() or {
        "image": np.zeros(48), "state": np.zeros(7)}, 4))
    out.append(m.null_obs(4))
    out.append(m.start_transform((0.1, 0.2, 0.3)))
    return out, client.calls, prompts


@pytest.mark.parametrize("fail_after", [None, 4])
def test_widowx_env_call_log_matches_jax(fail_after):
    """Reset (a bad answer retried, then the prompts), observations,
    steps, an absolute move; with ``fail_after`` the lost connection's
    null observations and truncation."""
    got, want = (_widowx_session(m, fail_after) for m in (t_wx, j_wx))
    _equal(got, want)
    assert got[1][1][0] == "move" and got[1][1][3] is True  # blocking reset
    if fail_after is not None:
        assert got[0][-5][3] is True                        # truncated


# ------------------------------------------------------------------ util --

def test_seeding_streams_match_jax(monkeypatch):
    monkeypatch.setenv("EXPERIMENT_GLOBAL_SEED", "0")
    draws = []
    for m in (j_seed, t_seed):
        fn = m.set_global_seed(1234, get_worker_init_fn=True)
        row = [np.random.rand(3).tolist(), random.random(),
               os.environ["EXPERIMENT_GLOBAL_SEED"]]
        fn(3)
        row += [np.random.rand(3).tolist(), random.random(),
                m.make_worker_rng(7, 2, epoch=1).random(4).tolist()]
        draws.append(row)
    assert draws[1] == draws[0]
    assert t_seed.set_global_seed(5) is None
    assert t_seed.check_bloat16_supported("cpu") is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_seed.check_bloat16_supported("cuda") is False


def test_profiling_trace_annotate_and_timer(tmp_path, monkeypatch):
    with t_prof.trace(str(tmp_path)) as prof:
        with t_prof.annotate("emmax.section"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.name for e in prof.events()}
    assert "emmax.section" in names
    blob = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "emmax.section"
               for e in blob["traceEvents"])
    clock = iter([1.0, 1.5, 2.0, 2.25] * 2)      # one clock, both timers
    monkeypatch.setattr(t_prof.time, "perf_counter", lambda: next(clock))
    timers = [m.SectionTimer() for m in (j_prof, t_prof)]
    for timer in timers:
        for _ in range(2):
            with timer("data"):
                pass
    assert timers[1].summary() == timers[0].summary() == {
        "data": {"total_s": 0.75, "count": 2, "mean_ms": 375.0}}
    timers[1].log()
