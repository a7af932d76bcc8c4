"""The port's RLDS data path against the JAX package's, which runs on
TensorFlow here: TFRecord and Example parsing, the JPEG / PNG codec, the
trajectory pipeline, the statistics, chunking, frames and
``RLDSFrameSource``. Every check is exact (bit for bit) unless it says
otherwise."""

import json

import cv2
import numpy as np
import pytest
import tensorflow as tf

from emmax_torch.data import codec, rlds, tfrecord
from emmax_tpu.data import rlds as jrlds

SIZE = 40            # frames not a multiple of 16 wide


def _frame(rng, h=SIZE, w=SIZE + 3):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 3 % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def _episodes(rng, n, first_id=0):
    eps = []
    for i in range(n):
        T = int(rng.integers(6, 10))
        eps.append({
            "image_bytes": [tf.io.encode_jpeg(_frame(rng), quality=95).numpy()
                            for _ in range(T)],
            "proprio": rng.normal(size=(T, 7)).astype(np.float32),
            "action": np.concatenate(
                [rng.normal(size=(T, 6)),
                 rng.choice([0.0, 0.5, 1.0], size=(T, 1))], 1).astype(
                     np.float32),
            "language": f"put the thing {i}" if i != 2 else "",
            "file_path": f"bridge/raw/traj{first_id + i}",
            "episode_id": first_id + i,
        })
    return eps


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rlds")
    rng = np.random.default_rng(0)
    jrlds.write_episodes(root / "bridge_orig-train-00000.tfrecord",
                         _episodes(rng, 4))
    jrlds.write_episodes(root / "bridge_orig-train-00001.tfrecord",
                         _episodes(rng, 2, first_id=4))
    jrlds.write_episodes(root / "bridge_orig-val-00000.tfrecord",
                         _episodes(rng, 2, first_id=6))
    return root


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, f"{path}: {g.shape} vs {w.shape}"
    if w.dtype.kind in "OSU":
        assert g.tolist() == w.tolist(), path
    else:
        assert g.dtype == w.dtype, f"{path}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=path)


# --- TFRecord ---------------------------------------------------------------

def test_tfrecord_both_ways(data_dir, tmp_path):
    path = data_dir / "bridge_orig-train-00000.tfrecord"
    ours = list(tfrecord.read_records(path))
    theirs = [r.numpy() for r in tf.data.TFRecordDataset(str(path))]
    assert ours == theirs
    # the port's writer: TF reads the records and parses the examples
    feats = {"b": [b"x", b"", b"\xff\x00"], "f": np.float32([1.5, -2.0]),
             "i": np.int64([3, -7, 2 ** 40]), "e": []}
    out = tmp_path / "ours.tfrecord"
    with tfrecord.TFRecordWriter(out) as w:
        w.write(tfrecord.serialize_example(feats))
        w.write(b"raw")
    recs = [r.numpy() for r in tf.data.TFRecordDataset(str(out))]
    assert recs[1] == b"raw"
    ex = tf.train.Example.FromString(recs[0]).features.feature
    assert list(ex["b"].bytes_list.value) == feats["b"]
    assert list(ex["f"].float_list.value) == [1.5, -2.0]
    assert list(ex["i"].int64_list.value) == [3, -7, 2 ** 40]
    assert tfrecord.parse_example(recs[0])["i"].tolist() == [3, -7, 2 ** 40]


def test_example_unpacked_fields():
    """TF reads (and other writers write) repeated floats and ints one
    tagged value each; the parser takes both forms."""
    msg = tf.train.Example()
    msg.features.feature["f"].float_list.value.extend([0.25, 3.0])
    msg.features.feature["i"].int64_list.value.extend([-1, 5])
    packed = msg.SerializeToString()
    parsed = tfrecord.parse_example(packed)
    assert parsed["f"].tolist() == [0.25, 3.0]
    assert parsed["i"].tolist() == [-1, 5]
    # hand-built unpacked form: Feature{float_list{value: (tag 0x0D) f32}}
    def ld(field, body):
        return bytes([field << 3 | 2, len(body)]) + body
    flist = b"".join(b"\x0d" + np.float32(v).tobytes() for v in (0.25, 3.0))
    ilist = b"\x08\x05\x08\x07"
    feats = (ld(1, ld(1, b"f") + ld(2, ld(2, flist)))
             + ld(1, ld(1, b"i") + ld(2, ld(3, ilist))))
    example = ld(1, feats)
    got = tfrecord.parse_example(example)
    assert got["f"].tolist() == [0.25, 3.0] and got["i"].tolist() == [5, 7]
    spec = {"f": tf.io.VarLenFeature(tf.float32),
            "i": tf.io.VarLenFeature(tf.int64)}
    ref = tf.io.parse_single_example(example, spec)
    assert tf.sparse.to_dense(ref["f"]).numpy().tolist() == [0.25, 3.0]
    assert tf.sparse.to_dense(ref["i"]).numpy().tolist() == [5, 7]


@pytest.mark.parametrize("where", [3, 9, -3])
def test_corrupted_crc_raises(data_dir, tmp_path, where):
    raw = bytearray((data_dir / "bridge_orig-val-00000.tfrecord").read_bytes())
    raw[where] ^= 0x01            # length's CRC, payload, payload's CRC
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC|truncated"):
        list(tfrecord.read_records(bad))


# --- codec ------------------------------------------------------------------

def _jpegs(rng):
    img = _frame(rng, 37, 53)
    out = {}
    for q in (75, 95):
        for name, flag in (("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                           ("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                           ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)):
            ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
                cv2.IMWRITE_JPEG_QUALITY, q,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
            out[f"cv2 q{q} {name}"] = enc.tobytes()
        for chroma in (True, False):
            out[f"tf q{q} {'420' if chroma else '444'}"] = tf.io.encode_jpeg(
                img, quality=q, chroma_downsampling=chroma).numpy()
    ok, enc = cv2.imencode(".jpg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    out["cv2 grey"] = enc.tobytes()
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["cv2 restarts"] = enc.tobytes()
    return img, out


def test_jpeg_ifast_equals_tf_and_islow_equals_libjpeg():
    img, blobs = _jpegs(np.random.default_rng(1))
    for name, blob in blobs.items():
        want = tf.io.decode_image(blob, channels=3,
                                  expand_animations=False).numpy()
        np.testing.assert_array_equal(codec.decode_jpeg(blob, "ifast"), want,
                                      err_msg=name)
        want_islow = cv2.imdecode(np.frombuffer(blob, np.uint8),
                                  cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(codec.decode_jpeg(blob, "islow"),
                                      want_islow, err_msg=name)
    batch = codec.decode_jpeg_batch(list(blobs.values())[:5], "ifast",
                                    threads=3)
    for got, blob in zip(batch, list(blobs.values())[:5]):
        np.testing.assert_array_equal(got, codec.decode_jpeg(blob))
    with pytest.raises(ValueError):
        codec.decode_jpeg(blobs["cv2 q75 420"][:200])
    with pytest.raises(ValueError, match="dct"):
        codec.decode_jpeg(blobs["cv2 q75 420"], "float")


def test_islow_equals_the_jax_frame_store(tmp_path):
    from emmax_tpu.data.framestore import FrameStore, FrameStoreWriter

    _, blobs = _jpegs(np.random.default_rng(2))
    w = FrameStoreWriter(tmp_path / "s.efs")
    colour = [b for k, b in blobs.items() if "grey" not in k]
    w.add_trajectory("k|0", colour)
    store = FrameStore(w.finalize())
    for i, blob in enumerate(colour):
        np.testing.assert_array_equal(codec.decode_jpeg(blob, "islow"),
                                      store.get_frame("k|0", i))


def test_directory_frames_decode_as_the_jax_package(tmp_path):
    """``--frames_dir`` frames: the port's ISLOW decode against the JAX
    package's ``cv2.imread``."""
    from emmax_torch.data.gcot import DirectoryFrameSource
    from emmax_tpu.data.gcot import DirectoryFrameSource as JaxSource

    _, blobs = _jpegs(np.random.default_rng(7))
    (tmp_path / "traj|3").mkdir()
    for i, key in enumerate(("cv2 q95 420", "tf q75 444", "cv2 grey")):
        (tmp_path / "traj|3" / f"im_{i}.jpg").write_bytes(blobs[key])
        np.testing.assert_array_equal(
            DirectoryFrameSource(tmp_path).get_frame("traj|3", i),
            JaxSource(tmp_path).get_frame("traj|3", i))
    with pytest.raises(FileNotFoundError):
        DirectoryFrameSource(tmp_path).get_frame("traj|3", 9)


@pytest.mark.parametrize("quality", [75, 95])
def test_encoder_bytes_decode_the_same_under_tf(quality):
    img = _frame(np.random.default_rng(3), 45, 61)
    blob = codec.encode_jpeg(img, quality)
    ours = codec.decode_jpeg(blob, "ifast")
    np.testing.assert_array_equal(
        tf.io.decode_image(blob, channels=3).numpy(), ours)
    assert codec.jpeg_size(blob) == (61, 45)
    # a faithful encoding: mean error within TF's own encoder's + 0.5 level
    tf_err = np.abs(tf.io.decode_image(tf.io.encode_jpeg(
        img, quality=quality)).numpy().astype(int) - img).mean()
    assert np.abs(ours.astype(int) - img).mean() <= tf_err + 0.5


def test_png_decodes_as_tf():
    img = _frame(np.random.default_rng(4), 19, 23)
    for arr in (img, img[..., :1], np.concatenate([img, img[..., :1]], -1)):
        blob = tf.io.encode_png(arr).numpy()
        np.testing.assert_array_equal(
            codec.decode_image(blob), tf.io.decode_image(blob,
                                                         channels=3).numpy())
    with pytest.raises(ValueError, match="unsupported"):
        codec.decode_image(b"GIF89a....")


# --- the trajectory pipeline -------------------------------------------------

def _first_trajs(ds, n=99):
    out = []
    for t in ds:
        out.append(t)
        if len(out) == n:
            break
    return out


def test_trajectories_and_statistics(data_dir, tmp_path):
    ours, ostats = rlds.make_dataset_from_rlds(data_dir, "bridge_orig",
                                               "train",
                                               cache_dir=tmp_path / "c")
    theirs, tstats = jrlds.make_dataset_from_rlds(data_dir, "bridge_orig",
                                                  "train")
    assert ostats == json.loads(json.dumps(tstats))
    assert ostats["num_trajectories"] == 8          # all splits
    o, t = list(ours), list(theirs.as_numpy_iterator())
    assert len(o) == len(t) == 6
    for a, b in zip(o, t):
        assert_tree_equal(a, b)
    # the cache file is the JAX package's: it reads what the port wrote
    (cached,) = (tmp_path / "c").glob("dataset_statistics_*.json")
    _, jstats = jrlds.make_dataset_from_rlds(data_dir, "bridge_orig", "val",
                                             cache_dir=tmp_path / "c")
    assert jstats == json.loads(cached.read_text())


def test_chunking_window_and_future(data_dir):
    kw = dict(window_size=2, future_action_window_size=3,
              skip_unlabeled=True)
    ours = rlds.apply_trajectory_transforms(
        rlds.make_dataset_from_rlds(data_dir, "bridge_orig", "train")[0],
        **kw)
    theirs = jrlds.apply_trajectory_transforms(
        jrlds.make_dataset_from_rlds(data_dir, "bridge_orig", "train")[0],
        **kw)
    o, t = list(ours), list(theirs.as_numpy_iterator())
    assert len(o) == len(t) == 5                     # one unlabeled dropped
    for a, b in zip(o, t):
        assert_tree_equal(a, b)


def test_goal_clamp_and_zeroed_actions_past_the_goal():
    T = 6
    traj = {"observation": {"proprio": np.zeros((T, 2), np.float32),
                            "timestep": np.arange(T, dtype=np.int32)},
            "action": np.arange(1, T + 1, dtype=np.float32)[:, None]
            * np.ones((1, 2), np.float32),
            "task": {"timestep": np.int32([2, 2, 2, 4, 5, 5])}}
    jtraj = {"observation": {k: tf.constant(v) for k, v in
                             traj["observation"].items()},
             "action": tf.constant(traj["action"]),
             "task": {"timestep": tf.constant(traj["task"]["timestep"])}}
    ours = rlds.chunk_trajectory(traj, 2, 3)
    ds = jrlds.apply_trajectory_transforms(
        tf.data.Dataset.from_tensors(jtraj), window_size=2,
        future_action_window_size=3)
    theirs = next(ds.as_numpy_iterator())
    theirs["observation"].pop("pad_mask_dict")
    theirs["task"].pop("pad_mask_dict")
    assert_tree_equal(ours, theirs)
    assert (ours["action"][0, -1] == 0).all()        # past goal 2


def test_frames_resize_and_order(data_dir):
    """Frames in order with the same metadata; the lanczos3 resize of the
    same decoded pixels within 1 level (float summation order), on at most
    1% of the values."""
    ours, _ = rlds.make_single_dataset(data_dir, "bridge_orig", "train",
                                       resize=(24, 24))
    theirs, _ = jrlds.make_single_dataset(data_dir, "bridge_orig", "train",
                                          resize=(24, 24))
    o, t = list(ours), list(theirs.as_numpy_iterator())
    assert len(o) == len(t)
    diffs = []
    for a, b in zip(o, t):
        ia = a["observation"].pop("image_primary")
        ib = b["observation"].pop("image_primary")
        assert ia.shape == ib.shape == (1, 24, 24, 3) and ia.dtype == np.uint8
        diffs.append(np.abs(ia.astype(int) - ib))
        assert_tree_equal(a, b)
    d = np.stack(diffs)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_single_dataset_order_with_a_shuffle_buffer_of_one(data_dir):
    ds, _ = rlds.make_dataset_from_rlds(data_dir, "bridge_orig", "train")
    frames = rlds.flatten_trajectories(rlds.apply_trajectory_transforms(ds))
    ours = rlds.make_interleaved_dataset([frames], [1.0],
                                         shuffle_buffer_size=1)
    jds, _ = jrlds.make_dataset_from_rlds(data_dir, "bridge_orig", "train")
    jframes = jrlds.flatten_trajectories(
        jrlds.apply_trajectory_transforms(jds))
    theirs = jrlds.make_interleaved_dataset([jframes], [1.0],
                                            shuffle_buffer_size=1)
    n = sum(len(t["action"]) for t in ds) + 5        # wraps around once
    o = _first_trajs(ours, n)
    t = _first_trajs(theirs.as_numpy_iterator(), n)
    for a, b in zip(o, t):
        assert_tree_equal(a, b)


def test_mixture_proportions(tmp_path):
    """Frames of each dataset in 2000 draws lie within 4 standard
    deviations of the binomial count."""
    rng = np.random.default_rng(5)
    blob = codec.encode_jpeg(_frame(rng, 8, 8))
    for name in ("bridge_orig", "rt_1"):
        rlds.write_episodes(tmp_path / f"{name}-train-0.tfrecord", [{
            "image_bytes": [blob] * 5, "proprio": np.zeros((5, 7)),
            "action": np.zeros((5, 7)), "language": name,
            "file_path": name, "episode_id": 0}])
    dss = [rlds.flatten_trajectories(rlds.apply_trajectory_transforms(
        rlds.make_dataset_from_rlds(tmp_path, n, "train")[0]))
        for n in ("bridge_orig", "rt_1")]
    w = [3.0, 1.0]
    mixed = rlds.make_interleaved_dataset(dss, w, shuffle_buffer_size=64,
                                          seed=3)
    N = 2000
    names = [f["dataset_name"] for f in _first_trajs(mixed, N)]
    k = sum(n == b"bridge_orig" for n in names)
    p = w[0] / sum(w)
    assert abs(k - N * p) <= 4 * np.sqrt(N * p * (1 - p))
    again = [f["dataset_name"] for f in _first_trajs(mixed, N)]
    assert again == names                              # seeded


def test_rlds_frame_source(data_dir):
    ours = rlds.RLDSFrameSource(data_dir)
    theirs = jrlds.RLDSFrameSource(data_dir)
    assert sorted(ours.index) == sorted(theirs.index)
    assert len(ours.index) == 8
    for key in sorted(ours.index)[::3]:
        assert list(ours.index[key]) == list(theirs.index[key])
        for i in (0, len(ours.index[key]) - 1):
            np.testing.assert_array_equal(ours.get_frame(key, i),
                                          theirs.get_frame(key, i))


def test_port_writer_reads_back_under_tf(tmp_path):
    rng = np.random.default_rng(6)
    eps = _episodes(rng, 2)
    rlds.write_episodes(tmp_path / "bridge_orig-train-0.tfrecord", eps)
    ours, _ = rlds.make_dataset_from_rlds(tmp_path, "bridge_orig", "train")
    theirs, _ = jrlds.make_dataset_from_rlds(tmp_path, "bridge_orig", "train")
    for a, b in zip(ours, theirs.as_numpy_iterator()):
        assert_tree_equal(a, b)
