"""The port's GCOT generation against the JAX package's: the port's own
HDBSCAN label for label against scikit-learn's, segmentation, movement
verbalization, plan annotation, the three assembly modes and the two CLIs
over one TFRecord fixture. Records compare equal in JSON; statistics
within 1e-12."""

import importlib.util
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.cluster import HDBSCAN

from emmax_torch.gcot import assemble as t_asm
from emmax_torch.gcot import plans as t_plans
from emmax_torch.gcot import segmentation as t_seg
from emmax_torch.gcot.hdbscan import hdbscan
from emmax_torch.gcot.verbalize import describe_move
from emmax_tpu.gcot import assemble as j_asm
from emmax_tpu.gcot import plans as j_plans
from emmax_tpu.gcot import segmentation as j_seg
from emmax_tpu.gcot.verbalize import describe_move as j_describe_move

REPO = Path(__file__).resolve().parent.parent


def sk_labels(dist: np.ndarray) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # sklearn's FutureWarning on copy
        return HDBSCAN(min_cluster_size=3, metric="precomputed",
                       copy=True).fit_predict(dist.copy())


def _timed_rows(state: np.ndarray) -> np.ndarray:
    return np.stack([np.append(o, i / 30.0) for i, o in
                     enumerate(np.asarray(state, np.float64))])


def _trajectories(family: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        T = int(rng.integers(8, 61))
        if family == "random_walk":
            yield np.cumsum(rng.normal(0, 0.01, (T, 6)), 0).astype(np.float32)
        elif family == "piecewise":
            state = np.zeros((T, 6))
            for block in np.array_split(np.arange(T), int(rng.integers(1, 5))):
                state[block] = (rng.normal(0, 0.2, 6)
                                + rng.normal(0, 1e-3, (len(block), 6)))
            yield state
        else:   # "linear": constant-velocity phases, the bridge proprio shape
            vel = rng.normal(0, 0.02, (int(rng.integers(1, 4)), 6))
            steps = vel[np.minimum(np.arange(T) * len(vel) // T,
                                   len(vel) - 1)]
            yield np.cumsum(steps + rng.normal(0, 2e-3, (T, 6)), 0)


@pytest.mark.parametrize("family", ["random_walk", "piecewise", "linear"])
def test_hdbscan_matches_sklearn(family):
    """70 seeded trajectories of 8-60 frames a family (210 in all): the
    spatio-temporal matrix, labels equal sklearn's."""
    seen = set()
    for state in _trajectories(family, 70, seed=len(family)):
        dist = t_seg.spatio_temporal_distances(_timed_rows(state))
        got = hdbscan(dist)
        np.testing.assert_array_equal(got, sk_labels(dist))
        seen.add(len(set(got.tolist()) - {-1}))
    assert max(seen) >= 2          # the cases reach several clusters


def test_hdbscan_edge_cases():
    rng = np.random.default_rng(5)
    cases = {
        "fewest_points": np.array([[0.0, 1, 5], [1, 0, 5], [5, 5, 0]]),
        "all_equal": np.ones((6, 6)) - np.eye(6),
        "zeros": np.zeros((5, 5)),
    }
    g = rng.integers(0, 3, (40, 4))       # integer grid, L1: most tie
    cases["ties"] = np.abs(g[:, None] - g[None]).sum(-1).astype(float)
    blob = rng.normal(0, 1e-3, (25, 3))            # one tight blob
    cases["one_blob"] = np.sqrt(((blob[:, None] - blob[None]) ** 2).sum(-1))
    two = np.concatenate([blob, blob[:12] + 5.0])  # the blob and one more
    cases["two_blobs"] = np.sqrt(((two[:, None] - two[None]) ** 2).sum(-1))
    scattered = rng.uniform(0, 1, (7, 2))
    cases["scattered"] = np.sqrt(
        ((scattered[:, None] - scattered[None]) ** 2).sum(-1))
    labels = {}
    for name, dist in cases.items():
        labels[name] = hdbscan(dist)
        np.testing.assert_array_equal(labels[name], sk_labels(dist),
                                      err_msg=name)
    assert (labels["all_equal"] == -1).all()       # all noise
    assert (labels["fewest_points"] == -1).all()
    assert set(labels["two_blobs"].tolist()) == {0, 1}
    assert len(set(labels["ties"].tolist())) > 2
    for bad in (np.zeros((2, 2)), np.zeros((1, 1))):
        with pytest.raises(ValueError):
            hdbscan(bad)
        with pytest.raises(ValueError):
            sk_labels(bad)


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_segment_traj_matches_jax(distance):
    """Two trajectories through JAX's full ``segment_traj`` (sklearn with
    the Python metric): raw and forward-filled labels equal."""
    for state in list(_trajectories("linear", 2, seed=11)):
        want_filled, want = j_seg.segment_traj(state, distance)
        got_filled, got = t_seg.segment_traj(state, distance)
        np.testing.assert_array_equal(got, want)
        assert got_filled == want_filled


def test_segmentation_helpers_match_jax():
    rng = np.random.default_rng(3)
    state = next(_trajectories("linear", 1, seed=4))
    grip = (rng.uniform(size=len(state)) > 0.5).astype(float)
    np.testing.assert_array_equal(
        t_seg.soft_plus_gripper_segment(state, grip),
        j_seg.soft_plus_gripper_segment(state, grip))
    assert t_seg.segment_gripper(grip) == j_seg.segment_gripper(grip)
    assert t_seg.segment_nstep(17, 4) == j_seg.segment_nstep(17, 4)
    seg = rng.integers(0, 9, 30)
    assert t_seg.compress_segments(seg) == j_seg.compress_segments(seg)
    frames = [f"img{i}" for i in range(30)]
    assert t_seg.get_key_frames(frames, seg) == j_seg.get_key_frames(frames,
                                                                     seg)
    noisy = [-1, -1, 2, -1, 0, 0, -1, 3]
    assert (t_seg._forward_fill_noise(noisy)
            == j_seg._forward_fill_noise(noisy))


def test_describe_move_matches_jax():
    rng = np.random.default_rng(0)
    moves = np.concatenate([rng.normal(0, 0.01, (50, 6)),
                            rng.uniform(0, 1, (50, 1))], 1)
    moves[0] = 0.0
    moves[1, 6] = 0.5
    for move in moves:
        assert describe_move(move) == j_describe_move(move)
    assert "yaw counterclockwise" in describe_move([0, 0, 0, 0, 0, 0.1, 1])


class _Flaky:
    """An annotator that fails, then answers badly, then well."""

    def __init__(self):
        self.calls = 0

    def annotate(self, instruction, key_frames, segment_count):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("transient")
        if self.calls == 2:
            return "{1: ['only one', 'entry']}"
        return str({k: [f"s{k}", f"r{k}"] for k in range(1, segment_count + 1)})


def test_plans_match_jax(tmp_path):
    assert t_plans.PLAN_PROMPT == j_plans.PLAN_PROMPT
    texts = ["{1: ['a', 'b'], 2: ['c', 'd']}", "{1: ['a', 'b']}",
             "{1: ['a']}", "no dict here", "x {1: ('a', 'b')} y",
             "{1: ['a', 'b'], 2: 'cd'}", "{1: [}"]
    for text in texts:
        for n in (1, 2):
            assert (t_plans.validate_plan(text, n)
                    == j_plans.validate_plan(text, n))
    for make, mod in ((lambda: _Flaky(), t_plans), (lambda: _Flaky(),
                                                    j_plans)):
        assert mod.annotate_with_retries(make(), "go", [], 2) == \
            "{1: ['s1', 'r1'], 2: ['s2', 'r2']}"
        assert mod.annotate_with_retries(make(), "go", [], 2,
                                         max_retries=2) == "NA"
    samples = [{"key": f"traj{i}|{i}", "instruction": f"do thing {i}",
                "key_frames": [], "segment_count": 1 + i % 3,
                "segments": [1] * 3 + [2] * (i % 3 > 0) * 2
                + [3] * (i % 3 > 1) * 2} for i in range(5)]
    got = t_plans.generate_plans(samples, t_plans.HeuristicAnnotator(),
                                 out_path=tmp_path / "t.json",
                                 checkpoint_every=2)
    want = j_plans.generate_plans(samples, j_plans.HeuristicAnnotator(),
                                  out_path=tmp_path / "j.json",
                                  checkpoint_every=2)
    assert got == want
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def _raw(mod, rng, plan, segments, T):
    return mod.RawSample(
        sample_dir=f"/data/bridge/traj{T}|{T}", instruction="put the cup",
        highlevel_plan=plan, segments=list(segments),
        gripper_2d=[[int(v) for v in rng.integers(0, 224, 2)]
                    for _ in range(T)],
        full_state=rng.normal(0, 0.05, (T, 7)).astype(np.float32),
        action_policy=np.concatenate(
            [rng.normal(0, 0.02, (T, 6)), rng.integers(0, 2, (T, 1))],
            1).astype(np.float32))


def _raw_samples(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for T in (12, 17, 25, 9):
        n_seg = 1 + T % 4
        segments = np.repeat(np.arange(1, n_seg + 1) * 7,
                             np.diff(np.linspace(0, T, n_seg + 1).astype(int)))
        plan = str({k: [f"sub {k}", f"why {k}"] for k in range(1, n_seg + 1)})
        out.append(_raw(mod, rng, plan if T != 25 else {
            f"segment_{k}": (f"sub {k}", f"why {k}")
            for k in range(1, n_seg + 1)}, segments, T))
    # the invalid kinds: no answer, no dict, bad dict, bad format, bad count
    for plan in ("NA", "nothing", "{1: [}", "{1: ['a']}",
                 "{1: ['a', 'b'], 2: ['c', 'd'], 3: ['e', 'f']}"):
        out.append(_raw(mod, rng, plan, [1] * 5 + [2] * 5, 10))
    return out


@pytest.mark.parametrize("mode", sorted(j_asm.SAMPLE_MODES))
def test_assemble_dataset_matches_jax(mode):
    assert t_asm.SAMPLE_MODES.keys() == j_asm.SAMPLE_MODES.keys()
    got, got_stats, got_report = t_asm.assemble_dataset(
        _raw_samples(t_asm, 7), mode=mode)
    want, want_stats, want_report = j_asm.assemble_dataset(
        _raw_samples(j_asm, 7), mode=mode)
    assert got_report == want_report == {
        "valid": 4, "no response": 1, "no dict": 1, "no valid dict": 1,
        "wrong format": 1, "wrong segment number": 1}
    assert json.dumps(got) == json.dumps(want)
    assert got_stats["num_samples"] == want_stats["num_samples"] == len(got)
    for key in ("Q1", "Q99"):
        np.testing.assert_allclose(got_stats[key], want_stats[key], rtol=0,
                                   atol=1e-12)
    if mode == "single_policy":
        assert len(got) == sum(T - 1 for T in (12, 17, 25, 9))
    assert (t_asm.INPUT_TEMPLATE, t_asm.REASON_TEMPLATE,
            t_asm.POSITION_TEMPLATE, t_asm.MOVEMENT_TEMPLATE) == (
        j_asm.INPUT_TEMPLATE, j_asm.REASON_TEMPLATE,
        j_asm.POSITION_TEMPLATE, j_asm.MOVEMENT_TEMPLATE)


# --- the two CLIs on one TFRecord fixture -----------------------------------

def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclass resolution needs it
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bridge_dir(tmp_path_factory):
    from emmax_torch.data import codec, rlds

    root = tmp_path_factory.mktemp("gcot_bridge")
    rng = np.random.default_rng(17)
    frame = codec.encode_jpeg(rng.integers(0, 256, (16, 16, 3),
                                           dtype=np.uint8), 90)
    for split, ids in (("train", range(4)), ("val", range(4, 6))):
        eps = []
        for i in ids:
            T = int(rng.integers(10, 31))
            vel = rng.normal(0, 0.02, (3, 6))       # three straight phases
            state = np.cumsum(vel[np.arange(T) * 3 // T]
                              + rng.normal(0, 2e-3, (T, 6)), 0)
            eps.append({"image_bytes": [frame] * T,
                        "proprio": np.concatenate(
                            [state, rng.uniform(0, 1, (T, 1))], 1),
                        "action": np.concatenate(
                            [rng.normal(0, 0.02, (T, 6)),
                             (np.arange(T)[:, None] // 6) % 2], 1),
                        "language": f"put the block {i} in the pot",
                        "file_path": f"/data/bridge/raw/traj{i}",
                        "episode_id": i})
        rlds.write_episodes(root / f"bridge_orig-{split}-00000.tfrecord", eps)
    return root


@pytest.mark.parametrize("segmentation,mode", [
    ("soft", "single_policy"), ("soft_gripper", "aug_multiple_policy"),
    ("nstep", "multiple_policy")])
def test_gcot_clis_match_jax(bridge_dir, tmp_path, segmentation, mode):
    from emmax_torch import gcot_create_dataset as t_create
    from emmax_torch import gcot_generate_plans as t_gen
    from emmax_torch.data.gcot import GCOTDataset
    from emmax_torch.data.rlds import RLDSFrameSource
    from emmax_torch.vla.action_tokenizer import ActionTokenizer
    from emmax_torch.vla.tokenizer import ByteLevelTokenizer

    j_gen, j_create = _script("gcot_generate_plans"), _script(
        "gcot_create_dataset")
    grip = tmp_path / "gripper.json"
    grip.write_text(json.dumps({"/data/bridge/raw/traj1|1": {"features": {
        "gripper_position": [[10 * t, 256 - 7 * t] for t in range(40)]}}}))
    for tag, gen, create in (("t", t_gen, t_create),
                             ("j", j_gen, j_create)):
        for split in ("train", "val"):
            gen.main(gen.PlansConfig(
                data_dir=bridge_dir, split=split, out_dir=tmp_path / tag,
                segmentation=segmentation, nstep=4))
        create.main(create.AssembleConfig(
            data_dir=bridge_dir, plans_dir=tmp_path / tag,
            gripper_positions=grip, out_root=tmp_path / f"{tag}_ds",
            tag=mode, mode=mode))
    for rel in ("t/plans_train.json", "t/plans_val.json",
                f"t_ds/{mode}/second_version.json",
                f"t_ds/{mode}/dataset_statistics.json"):
        got = json.loads((tmp_path / rel).read_text())
        want = json.loads((tmp_path / ("j" + rel[1:])).read_text())
        assert got == want, rel
    plans = json.loads((tmp_path / "t/plans_train.json").read_text())
    assert len(plans) == 4
    if segmentation == "soft":
        assert max(max(segs) for _, segs, _ in plans.values()) >= 2

    records = json.loads(
        (tmp_path / f"t_ds/{mode}/second_version.json").read_text())
    source = RLDSFrameSource(bridge_dir)
    assert {r["current_image_path"].rsplit("/", 1)[0]
            for r in records} <= set(source.index)
    tok = ByteLevelTokenizer()
    ds = GCOTDataset(records, ActionTokenizer(tok), tok, source,
                     data_mix="movement_policy", mask_inst=True)
    item = ds[len(ds) - 1]
    assert item["image"].shape == (16, 16, 3)
    assert len(item["input_ids"]) == len(item["labels"]) > 20
