"""The port's host tools against the JAX package's scripts: the checkpoint
janitor, the LRV / LVIS-Instruct-4V mixes (byte for byte), the RLDS
conversion, the pretraining-data download (through ``file://`` URLs: no
network), OCR-VQA's JPG conversion and ``verify_emmax``'s smoke test."""

import importlib.util
import json
import os
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from emmax_torch import convert_rlds as t_conv
from emmax_torch import monitor_folder as t_janitor
from emmax_torch import preprocess as t_pre
from emmax_torch.additional_datasets import lrv_instruct as t_lrv
from emmax_torch.additional_datasets import lvis_instruct_4v as t_lvis
from emmax_torch.data import download as t_dl
from emmax_tpu.data import download as j_dl

REPO = Path(__file__).resolve().parent.parent


def _script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod               # dataclass resolution needs it
    spec.loader.exec_module(mod)
    return mod


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# --- the janitor --------------------------------------------------------------

def _checkpoints(root: Path) -> None:
    """Checkpoint dirs and ``.pt`` files of known sizes and ages, and
    files the janitor must leave."""
    rng = np.random.default_rng(0)
    t = 1_700_000_000
    for i, rel in enumerate(["a/checkpoints/step-000100", "b/step-000050",
                             "a/checkpoints/step-000300",
                             "c/deep/step-000010"]):
        d = root / rel
        d.mkdir(parents=True)
        (d / "state.pt").write_bytes(rng.bytes(1000 * (i + 1)))
        (d / "config.json").write_bytes(b"{}")
        for p in (d / "state.pt", d / "config.json", d):
            os.utime(p, (t + 10 * i, t + 10 * i))
    for i, rel in enumerate(["b/step-7.pt", "c/step-9.pt"]):
        (root / rel).write_bytes(rng.bytes(1500))
        os.utime(root / rel, (t + 5 + 20 * i, t + 5 + 20 * i))
    (root / "a" / "notes.pt").write_bytes(b"x" * 5000)
    (root / "c" / "step-log.txt").write_bytes(b"kept")


@pytest.mark.parametrize("limit", [0, 4000, 9000, 1e9])
def test_sweep_matches_jax(tmp_path, limit):
    j_janitor = _script(REPO / "scripts" / "monitor_folder.py",
                        "jax_monitor_folder")
    for name in ("t", "j"):
        _checkpoints(tmp_path / name)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    removed = t_janitor.sweep(tmp_path / "t", limit)
    assert removed == j_janitor.sweep(tmp_path / "j", limit)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert (removed == 0) == (limit == 1e9)
    t_janitor.main(t_janitor.JanitorConfig(folder=tmp_path / "t",
                                           limit_gb=0.0, once=True))
    assert not list((tmp_path / "t").rglob("step-0*"))
    assert (tmp_path / "t" / "a" / "notes.pt").exists()


# --- the LRV / LVIS-Instruct-4V mixes ----------------------------------------

def _instruct_root(base: Path) -> Path:
    rng = np.random.default_rng(4)
    lrv_dir = base / "lrv"
    (lrv_dir / "lrv-vg").mkdir(parents=True)
    (lrv_dir / "lrv-chart").mkdir(parents=True)
    vg = [{"image_id": 100 + i, "question": f" What is {i}? ",
           "answer": f" It is {i}. "} for i in range(9)]
    chart = [{"image_id": f"stat_{i}.png", "question": "Max value?",
              "answer": str(int(rng.integers(0, 99)))} for i in range(4)]
    (lrv_dir / "filter_cap1.json").write_text(json.dumps(vg[:5]))
    (lrv_dir / "filter_cap_more1.json").write_text(json.dumps(vg[5:]))
    (lrv_dir / "chart_release_update.json").write_text(json.dumps(chart))
    for ex in vg:
        (lrv_dir / "lrv-vg" / f"{ex['image_id']}.jpg").write_bytes(b"jpg")
    for ex in chart:
        (lrv_dir / "lrv-chart" / ex["image_id"]).write_bytes(b"png")
    base_mix = [{"id": f"llava{i}", "conversations": [
        {"from": "human", "value": f"q{i}"}]} for i in range(11)]
    (base / "llava_v1_5_mix665k.json").write_text(json.dumps(base_mix))
    (base / "coco").mkdir()
    lvis = []
    for i in range(6):
        (base / "coco" / f"im{i}.jpg").write_bytes(b"jpg")
        lvis.append({"id": f"lv{i}", "image": f"coco/im{i}.jpg",
                     "conversations": []})
    (base / "lvis_instruct4v_220k.json").write_text(json.dumps(lvis))
    return base


def test_instruct_mixes_match_jax_byte_for_byte(tmp_path):
    j_lrv = _script(REPO / "scripts" / "additional-datasets" /
                    "lrv_instruct.py", "lrv_instruct")
    sys.path.insert(0, str(REPO / "scripts" / "additional-datasets"))
    try:
        j_lvis = _script(REPO / "scripts" / "additional-datasets" /
                         "lvis_instruct_4v.py", "jax_lvis_instruct_4v")
        t_root = _instruct_root(tmp_path / "t")
        j_root = _instruct_root(tmp_path / "j")
        assert t_lvis.main(["--base_dir", str(t_root)]) == \
            j_lvis.build_lvis_instruct_4v(j_root) == 17
        assert t_lrv.main(["--base_dir", str(t_root)]) == \
            j_lrv.build_lrv_instruct(j_root)
    finally:
        sys.path.remove(str(REPO / "scripts" / "additional-datasets"))
    for name in ("llava_v1_5_lvis4v_mix888k.json",
                 "llava_v1_5_lrv_mix1008k.json",
                 "llava_v1_5_lvis4v_lrv_mix1231k.json"):
        assert (t_root / name).read_bytes() == (j_root / name).read_bytes()
    assert len(json.loads((t_root / "llava_v1_5_lvis4v_lrv_mix1231k.json")
                          .read_text())) == 17 + 13
    with pytest.raises(FileNotFoundError, match="Missing Image"):
        t_lrv.convert_lrv_examples(
            [{"image_id": 999, "question": "q", "answer": "a"}],
            "lrv/lrv-vg", image_suffix=".jpg",
            image_dir=t_root / "lrv" / "lrv-vg")
    (t_root / "coco" / "im3.jpg").unlink()
    with pytest.raises(FileNotFoundError, match="Missing Image"):
        t_lvis.build_lvis_instruct_4v(t_root)
    t_lvis.build_lvis_instruct_4v(t_root, verify_images=False)


def test_mix_instruct_datasets_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for i, n in enumerate((7, 4, 5)):
        (tmp_path / f"in{i}.json").write_text(json.dumps(
            [{"id": f"{i}-{k}", "v": int(rng.integers(0, 9))}
             for k in range(n)]))
    ins = [tmp_path / "in1.json", tmp_path / "in2.json"]
    assert t_dl.mix_instruct_datasets(tmp_path / "in0.json", ins,
                                      tmp_path / "t" / "mix.json") == \
        j_dl.mix_instruct_datasets(tmp_path / "in0.json", ins,
                                   tmp_path / "j" / "mix.json") == 16
    assert (tmp_path / "t" / "mix.json").read_bytes() == \
        (tmp_path / "j" / "mix.json").read_bytes()


# --- download, OCR-VQA images and the preprocess CLI --------------------------

def _images(d: Path) -> None:
    from PIL import Image

    rng = np.random.default_rng(2)
    d.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)).save(
        d / "a.png")
    frames = [Image.fromarray(rng.integers(0, 256, (9, 9), dtype=np.uint8),
                              "L") for _ in range(2)]
    frames[0].save(d / "b.gif", save_all=True, append_images=frames[1:])
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        d / "c.jpg")


def test_convert_to_jpg_matches_jax(tmp_path):
    for name in ("t", "j"):
        _images(tmp_path / name)
    t_dl.convert_to_jpg(tmp_path / "t")
    j_dl.convert_to_jpg(tmp_path / "j")
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert {p.name for p in (tmp_path / "t").iterdir()} == {
        "a.png", "a.jpg", "b.gif", "b.jpg", "c.jpg"}
    (tmp_path / "t" / "d.bmp").write_bytes(b"bmp")
    with pytest.raises(ValueError, match="Unexpected image format"):
        t_dl.convert_to_jpg(tmp_path / "t")


@pytest.fixture
def local_components(tmp_path, monkeypatch):
    """``llava-v1.5-instruct`` served from ``file://`` URLs: a chat JSON
    and a zip holding OCR-VQA images."""
    src = tmp_path / "src"
    _images(src / "zip" / "ocr_vqa" / "images")
    archive = shutil.make_archive(str(src / "images"), "zip", src / "zip")
    (src / "chat.json").write_text(json.dumps([{"id": "x"}]))
    comps = {"llava-v1.5-instruct": [
        {"name": "llava_v1_5_mix665k.json",
         "url": (src / "chat.json").as_uri(), "extract": False},
        {"name": "images.zip", "url": Path(archive).as_uri(),
         "extract": True}]}
    for mod in (t_dl, j_dl):
        monkeypatch.setattr(mod, "DATASET_COMPONENTS", comps)
    monkeypatch.setattr(t_pre, "DATASET_COMPONENTS", comps)
    return src


def test_download_extract_and_preprocess_match_jax(tmp_path,
                                                   local_components):
    j_pre = _script(REPO / "scripts" / "preprocess.py", "jax_preprocess")
    j_pre.DATASET_COMPONENTS = t_pre.DATASET_COMPONENTS
    t_pre.main(t_pre.PreprocessConfig(root_dir=tmp_path / "t"))
    j_pre.main(j_pre.PreprocessConfig(root_dir=tmp_path / "j"))
    got = _tree(tmp_path / "t")
    assert got == _tree(tmp_path / "j")
    ocr = "download/llava-v1.5-instruct/ocr_vqa/images/"
    assert {ocr + n for n in ("a.jpg", "b.jpg", "a.png")} <= set(got)
    assert json.loads(got["download/llava-v1.5-instruct/"
                          "llava_v1_5_mix665k.json"]) == [{"id": "x"}]
    # present components are not fetched again
    shutil.rmtree(local_components)
    t_dl.download_extract("llava-v1.5-instruct", tmp_path / "t")
    with pytest.raises(SystemExit):
        t_pre.main(t_pre.PreprocessConfig(dataset_id="nope"))


# --- the RLDS conversion ------------------------------------------------------

class _Tensor:
    """What ``iter_tfds_episodes`` reads of a TF tensor: ``.numpy()``."""

    def __init__(self, value):
        self.value = value

    def numpy(self):
        return self.value


def _raw_episodes(seed: int, n: int, encoded: bool):
    from emmax_torch.data.codec import encode_jpeg

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:16, 0:16]
    for eid in range(n):
        T = 4 + eid
        imgs = np.clip(np.stack([x * 12 + 20 * eid, y * 10, (x + y) * 6], -1)
                       + rng.normal(0, 3, (T, 16, 16, 3)), 0, 255).astype(
                           np.uint8)
        yield {
            "steps": {
                "observation": {
                    "image_0": ([encode_jpeg(i, 90) for i in imgs] if encoded
                                else imgs),
                    "state": rng.normal(size=(T, 7)).astype(np.float32),
                },
                "action": rng.normal(size=(T, 7)).astype(np.float32),
                "language_instruction": [b"fold the towel"] * T,
            },
            "episode_metadata": {
                "file_path": np.asarray(f"/raw/traj{eid}.tfrecord".encode()),
                "episode_id": np.asarray(eid, np.int64),
            },
        }


def test_convert_episodes_round_trip(tmp_path):
    """Arrays are JPEG-encoded by the port's codec; the shards read back
    through the port's and JAX's pipelines; metadata and proprio as
    JAX's conversion gives them."""
    from emmax_torch.data import codec
    from emmax_torch.data.rlds import make_dataset_from_rlds
    from emmax_tpu.data.rlds import make_dataset_from_rlds as j_make

    j_conv = _script(REPO / "scripts" / "convert_rlds.py", "jax_convert_rlds")
    raws = list(_raw_episodes(0, 3, encoded=False))
    eps = list(t_conv.convert_episodes(raws, image_key="image_0",
                                       state_keys=["state", None]))
    want = list(j_conv.convert_episodes(raws, image_key="image_0",
                                        state_keys=["state", None]))
    for a, b in zip(eps, want):
        for k in ("language", "file_path", "episode_id"):
            assert a[k] == b[k]
        np.testing.assert_array_equal(a["proprio"], b["proprio"])
        np.testing.assert_array_equal(a["action"], b["action"])
        assert a["proprio"].shape[1] == 8 and not a["proprio"][:, 7].any()
    assert t_conv.write_shards(eps, tmp_path, "synthetic", "train",
                               shard_size=2) == 3
    assert len(list(tmp_path.glob("synthetic-train-*.tfrecord"))) == 2
    ds, stats = make_dataset_from_rlds(tmp_path, "synthetic", "train")
    trajs = sorted(ds, key=lambda t: len(t["action"]))
    assert [len(t["action"]) for t in trajs] == [4, 5, 6]
    assert stats["num_trajectories"] == 3
    frame = codec.decode_image(trajs[0]["observation"]["image_primary"][0],
                               "islow")
    err = np.abs(frame.astype(int) - raws[0]["steps"]["observation"]
                 ["image_0"][0].astype(int))
    assert frame.shape == (16, 16, 3) and err.mean() < 4
    jds, jstats = j_make(tmp_path, "synthetic", "train")
    assert len(list(jds.as_numpy_iterator())) == 3
    assert jstats["action"]["q01"] == stats["action"]["q01"]


def test_convert_with_stand_in_tfds_matches_jax(tmp_path, monkeypatch):
    """``convert`` through the real ``iter_tfds_episodes`` over a stand-in
    ``tensorflow_datasets`` (episodes of per-step dicts of tensors):
    frames already encoded, so the port's shards hold JAX's episodes
    (parsed: the two Example writers order fields differently) and its
    statistics equal JAX's."""
    from emmax_torch.data import tfrecord
    from emmax_torch.data.rlds import parse_episode
    j_conv = _script(REPO / "scripts" / "convert_rlds.py", "jax_convert_rlds")

    class FakeBuilder:
        def __init__(self, name, data_dir):
            assert (name, data_dir) == ("synthetic", "/tfds-root")

        def as_dataset(self, split, shuffle_files=False):
            assert not shuffle_files
            out = []
            for ep in _raw_episodes(5, 3 if split == "train" else 1,
                                    encoded=True):
                s = ep["steps"]
                steps = [{"observation": {
                    "image_0": _Tensor(s["observation"]["image_0"][t]),
                    "state": _Tensor(s["observation"]["state"][t])},
                    "action": _Tensor(s["action"][t]),
                    "language_instruction": _Tensor(
                        s["language_instruction"][t])}
                    for t in range(len(s["action"]))]
                out.append({"steps": steps, "episode_metadata": {
                    k: _Tensor(v) for k, v in ep["episode_metadata"].items()}})
            return out

    fake = types.ModuleType("tensorflow_datasets")
    fake.builder = FakeBuilder
    monkeypatch.setitem(sys.modules, "tensorflow_datasets", fake)
    kw = dict(splits=("train", "val"), shard_size=2, image_key="image_0",
              state_keys=["state"])
    assert t_conv.convert("synthetic", "/tfds-root", tmp_path / "t", **kw) \
        == j_conv.convert("synthetic", "/tfds-root", tmp_path / "j", **kw) \
        == {"train": 3, "val": 1}
    got = _tree(tmp_path / "t")
    assert sorted(got) == ["dataset_statistics.json",
                           "synthetic-train-00000.tfrecord",
                           "synthetic-train-00001.tfrecord",
                           "synthetic-val-00000.tfrecord"]
    want = _tree(tmp_path / "j")
    for name in got:
        if name.endswith(".tfrecord"):
            a, b = ([parse_episode(r) for r in tfrecord.read_records(
                tmp_path / d / name)] for d in "tj")
            assert len(a) == len(b) > 0
            for ea, eb in zip(a, b):
                assert ea["task"] == eb["task"]
                for k in ("file_path", "episode_id", "action"):
                    np.testing.assert_array_equal(ea[k], eb[k])
                for k in ("image_primary", "proprio"):
                    np.testing.assert_array_equal(ea["observation"][k],
                                                  eb["observation"][k])
    assert json.loads(got["dataset_statistics.json"]) == \
        json.loads(want["dataset_statistics.json"])


# --- verify_emmax ---------------------------------------------------------------

def test_verify_emmax_smoke():
    """The port's ``--smoke_test`` (vocab 1024) drives generate_actions and
    predict_action; JAX's builds ``tiny_vlm_config(512)``, whose vocab
    ``ActionTokenizer`` refuses."""
    from emmax_torch import verify_emmax

    out = verify_emmax.main(verify_emmax.VerifyConfig(smoke_test=True,
                                                      device="cpu"))
    assert set(out) == {"fp32"}
    run = out["fp32"]
    assert run["predict_action"].shape == (7,)
    assert np.isfinite(run["predict_action"]).all()
    assert run["actions"].ndim == 2 and run["actions"].shape[1] == 7
    from emmax_tpu.vla.action_tokenizer import ActionTokenizer
    from emmax_tpu.vla.tokenizer import ByteLevelTokenizer

    with pytest.raises(ValueError):    # what JAX's smoke model meets
        ActionTokenizer(ByteLevelTokenizer(512))
    assert "tiny_vlm_config(512)" in (
        REPO / "vla-scripts" / "extern" / "verify_emmax.py").read_text()
