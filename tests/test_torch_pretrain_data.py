"""Port parity: the VLM pretraining data path (``emmax_torch.util.batching``,
``emmax_torch.data.pretrain``, ``collate_lm`` / ``SplitModalityLoader``,
``conf.datasets``, the image transforms of every backbone id and the
metric containers) against ``emmax_tpu``'s, exactly: the same index lists,
samples, arrays and pushed values."""

import json
import sys

import numpy as np
import pytest

from emmax_torch.conf import DatasetConfig as TorchDatasetConfig
from emmax_torch.conf import dump_config as t_dump
from emmax_torch.data import collators as t_coll
from emmax_torch.data import pretrain as t_pre
from emmax_torch.models import materialize as t_mat
from emmax_torch.ops import image as t_image
from emmax_torch.training import metrics as t_metrics
from emmax_torch.util.batching import split_modality_batches as t_split
from emmax_torch.vla.tokenizer import ByteLevelTokenizer as TorchTok
from emmax_tpu.conf import DatasetConfig as JaxDatasetConfig
from emmax_tpu.conf import dump_config as j_dump
from emmax_tpu.data import collators as j_coll
from emmax_tpu.data import pretrain as j_pre
from emmax_tpu.models import materialize as j_mat
from emmax_tpu.ops import image as j_image
from emmax_tpu.training import metrics as j_metrics
from emmax_tpu.util.batching import split_modality_batches as j_split
from emmax_tpu.vla.tokenizer import ByteLevelTokenizer as JaxTok


@pytest.fixture(scope="module")
def chat(tmp_path_factory):
    """JAX's synthetic chat JSON, every 2nd example text-only."""
    root = tmp_path_factory.mktemp("llava")
    j_pre.make_synthetic_chat_json(root / "chat.json", 10,
                                   image_dir=root / "img", text_only_every=2)
    return root / "chat.json", root / "img"


@pytest.mark.parametrize("batch_size", [1, 3, 4])
def test_split_modality_batches_equal_jax(batch_size):
    rng = np.random.default_rng(batch_size)
    for n, mm_share in ((13, 0.6), (8, 1.0), (7, 0.0), (29, 0.3)):
        lengths = rng.integers(1, 60, n).tolist()
        is_mm = (rng.random(n) < mm_share).tolist()
        for seed in (0, 7, 123):
            for epoch in (0, 1, 4):
                for shards in (1, 2, 3):
                    for index in range(shards):
                        kw = dict(seed=seed, epoch=epoch, num_shards=shards,
                                  shard_index=index)
                        assert t_split(lengths, is_mm, batch_size, **kw) == \
                            j_split(lengths, is_mm, batch_size, **kw)


def test_synthetic_chat_json_equals_jax(chat, tmp_path):
    ann, imgs = chat
    t_pre.make_synthetic_chat_json(tmp_path / "chat.json", 10,
                                   image_dir=tmp_path / "img",
                                   text_only_every=2)
    assert json.loads((tmp_path / "chat.json").read_text()) == \
        json.loads(ann.read_text())
    names = sorted(p.name for p in imgs.iterdir())
    assert names == sorted(p.name for p in (tmp_path / "img").iterdir())
    assert len(names) == 5
    for name in names:
        assert (tmp_path / "img" / name).read_bytes() == \
            (imgs / name).read_bytes()


@pytest.mark.parametrize("kind,style", [("align", None),
                                        ("finetune", "pure"),
                                        ("finetune", "vicuna-v15")])
def test_datasets_equal_jax(chat, kind, style):
    ann, imgs = chat
    kw = {} if style is None else {"prompt_style": style}
    jcls, tcls = ((j_pre.AlignDataset, t_pre.AlignDataset) if kind == "align"
                  else (j_pre.FinetuneDataset, t_pre.FinetuneDataset))
    want = jcls(ann, imgs, JaxTok(), **kw)
    got = tcls(ann, imgs, TorchTok(), **kw)
    if style is None and kind == "finetune":
        assert got.prompt_style == "vicuna-v15"
    assert len(got) == len(want) == 10
    assert got.modality_lengths() == want.modality_lengths()
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g["input_ids"] == w["input_ids"]
        assert g["labels"] == w["labels"]
        if w["image"] is None:
            assert g["image"] is None and i % 2 == 0
        else:
            assert g["image"].dtype == np.uint8
            np.testing.assert_array_equal(g["image"], w["image"])


def test_image_loader_replaces_opencv(chat, monkeypatch):
    """Without OpenCV the default decoder and the JSON writer raise an
    ImportError naming it; a dataset given an ``image_loader`` reads no
    file through OpenCV."""
    ann, imgs = chat
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        t_pre.AlignDataset(ann, imgs, TorchTok())[1]
    with pytest.raises(ImportError, match="cv2"):
        t_pre.make_synthetic_chat_json(imgs.parent / "x.json", 2,
                                       image_dir=imgs)
    calls = []

    def frames(root, rel):
        calls.append(rel)
        return None if rel is None else np.full((5, 7, 3), 9, np.uint8)

    ds = t_pre.FinetuneDataset(ann, imgs, TorchTok(), image_loader=frames)
    assert ds[0]["image"] is None and ds[1]["image"].shape == (5, 7, 3)
    assert calls == [None, "img_1.jpg"]


def test_collate_lm_and_split_modality_loader_equal_jax(chat):
    ann, imgs = chat
    for bs in (2, 3):
        got_loader = t_coll.SplitModalityLoader(
            t_pre.FinetuneDataset(ann, imgs, TorchTok()), bs,
            lambda s: t_coll.collate_lm(s, 0, pad_multiple=16), seed=5)
        want_loader = j_coll.SplitModalityLoader(
            j_pre.FinetuneDataset(ann, imgs, JaxTok()), bs,
            lambda s: j_coll.collate_lm(s, 0, pad_multiple=16), seed=5)
        assert len(got_loader) == len(want_loader)
        for epoch in (0, 1):
            got = list(got_loader.epoch(epoch))
            want = list(want_loader.epoch(epoch))
            assert len(got) == len(want) == len(got_loader)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k])
                # modality-pure batches; text-only rows get 224 px zeros
                mm = g["multimodal_mask"]
                assert mm.all() or not mm.any()
                if not mm.any():
                    assert g["images"].shape[1:] == (224, 224, 3)
                    assert not g["images"].any()
    mixed = [t_pre.FinetuneDataset(ann, imgs, TorchTok())[i]
             for i in (0, 1, 2)]
    got = t_coll.collate_lm(mixed, 0)
    want = j_coll.collate_lm([j_pre.FinetuneDataset(ann, imgs, JaxTok())[i]
                              for i in (0, 1, 2)], 0)
    assert got["multimodal_indices"].dtype == np.int64
    np.testing.assert_array_equal(got["multimodal_indices"], [1])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_configs_and_dump_config_equal_jax(tmp_path):
    from emmax_torch.conf import config_to_dict as t_dict
    from emmax_tpu.conf import config_to_dict as j_dict

    ids = sorted(JaxDatasetConfig._registry[JaxDatasetConfig])
    assert sorted(TorchDatasetConfig._registry[TorchDatasetConfig]) == ids
    assert len(ids) == 5
    for choice in ids:
        got = TorchDatasetConfig.get_choice_class(choice)()
        want = JaxDatasetConfig.get_choice_class(choice)()
        assert t_dict(got) == j_dict(want)
        t_dump(got, tmp_path / "t" / f"{choice}.json")
        j_dump(want, tmp_path / "j" / f"{choice}.json")
        assert (tmp_path / "t" / f"{choice}.json").read_text() == \
            (tmp_path / "j" / f"{choice}.json").read_text()


def test_transforms_for_every_backbone_equal_jax():
    for vid in sorted(j_mat.VISION_BACKBONES):
        for resize in ("resize-naive", "resize-crop", "letterbox"):
            got = t_image.transform_configs_for_backbone(vid, resize)
            want = j_image.transform_configs_for_backbone(vid, resize)
            assert got.keys() == want.keys(), vid
            for k in want:
                w = dict(want[k].__dict__)
                if vid.startswith("dinoclip"):
                    # the port mends JAX's 224 px: both towers take 336 px
                    w["size"] = 336
                assert got[k].__dict__ == w, (vid, k)
    got = t_mat.get_image_transforms("dinosiglip-vit-so-224px", "letterbox")
    want = j_mat.get_image_transforms("dinosiglip-vit-so-224px", "letterbox")
    assert {k: v.__dict__ for k, v in got.items()} == \
        {k: v.__dict__ for k, v in want.items()}
    with pytest.raises(KeyError, match="unknown vision backbone"):
        t_mat.get_image_transforms("no-such-backbone", "letterbox")
    got = t_mat.get_vlm_config("prism-dinosiglip-224px+7b")
    want = j_mat.get_vlm_config("prism-dinosiglip-224px+7b")
    assert got.arch_specifier == want.arch_specifier
    assert got.num_patches == want.num_patches == 256
    assert got.vision_dim == want.vision_dim == 2176
    assert [n for n, _ in got.vision] == [n for n, _ in want.vision]
    for (_, g), (_, w) in zip(got.vision, want.vision):
        assert g.__dict__ == w.__dict__
    assert got.llm.__dict__ == want.llm.__dict__


class _Recorder:
    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append((step, {k: v for k, v in metrics.items()
                                 if k != "step_time_s"}))

    def finalize(self):
        self.rows.append("final")


@pytest.mark.parametrize("kind", ["Metrics", "VLAMetrics",
                                  "VLADiscreteMetrics"])
def test_metric_containers_push_what_jax_pushes(kind):
    rng = np.random.default_rng(0)
    logs = []
    for mod in (t_metrics, j_metrics):
        rec = _Recorder()
        m = getattr(mod, kind)([rec], window=3)
        statuses = []
        for step in range(7):
            m.commit(loss=float(rng.random()), grad_norm=step * 0.5)
            if kind == "VLAMetrics":
                m.commit_for_dataset("bridge", loss=step + 0.25)
            if step % 2:
                m.push(1e-3 * step, extra={"epoch": step // 3})
                statuses.append(m.status(step // 3, 1e-3 * step))
            else:
                m.global_step += 1
        m.finalize()
        logs.append((rec.rows, statuses, m.global_step))
        rng = np.random.default_rng(0)
    assert logs[0] == logs[1]
    if kind == "VLAMetrics":
        assert "bridge/loss" in logs[0][0][0][1]
