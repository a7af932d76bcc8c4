"""OpenVLA's RLDS training path: streaming frames -> action-token batches.
Port of ``emmax_tpu/data/rlds_vla.py``.

Each frame becomes the chat prompt ``"What action should the robot take
to {lang}?"`` with the tokenized 7-DoF action as the answer, supervision
on the action tokens (and the stop token). Built on the TF-free pipeline of
``emmax_torch.data.rlds`` with named-mixture weighted interleaving.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from emmax_torch.models.llama import IGNORE_INDEX
from emmax_torch.vla.action_tokenizer import ActionTokenizer
from emmax_torch.vla.prompting import PromptBuilder


class RLDSBatchTransform:
    """RLDS frame dict -> {"image", "input_ids", "labels", "dataset_name"}."""

    def __init__(self, action_tokenizer: ActionTokenizer, tokenizer,
                 prompt_style: str = "pure",
                 predict_stop_token: bool = True) -> None:
        self.action_tokenizer = action_tokenizer
        self.tokenizer = tokenizer
        self.prompt_style = prompt_style
        self.predict_stop_token = predict_stop_token

    def __call__(self, frame: Dict, dataset_name: str = "bridge_orig") -> Dict:
        action = np.asarray(frame["action"])
        if action.ndim == 2:  # [window, 7] chunking
            action = action[0]
        img = np.asarray(frame["observation"]["image_primary"])
        if img.ndim == 4:  # [window, H, W, 3]
            img = img[0]
        lang = frame["task"]["language_instruction"]
        if isinstance(lang, bytes):
            lang = lang.decode()
        lang = str(lang).lower()

        pb = PromptBuilder(self.prompt_style)
        pb.add_turn("human", f"What action should the robot take to {lang}?")
        pb.add_turn("gpt", self.action_tokenizer(action))
        input_ids = self.tokenizer.encode(pb.get_prompt(),
                                          add_special_tokens=True)
        labels = list(input_ids)
        # supervise only the action tokens and the stop token
        cut = len(labels) - (len(action) + 1)
        labels[:cut] = [IGNORE_INDEX] * cut
        if not self.predict_stop_token:
            labels[-1] = IGNORE_INDEX
        return {"image": img.astype(np.uint8), "input_ids": input_ids,
                "labels": labels, "dataset_name": dataset_name}


class RLDSIterableDataset:
    """Streaming frames over (possibly mixed) RLDS datasets: ``__iter__``
    yields transformed samples forever, shuffled and interleaved by
    mixture weight. With ``num_shards`` > 1 each shard keeps its own 1/N of
    the frames before they are decoded, resized and augmented."""

    def __init__(self, data_root_dir, data_mix: str,
                 batch_transform: RLDSBatchTransform, *,
                 resize_resolution: Optional[Tuple[int, int]] = None,
                 shuffle_buffer_size: int = 10_000, train: bool = True,
                 image_aug: bool = False,
                 num_shards: int = 1, shard_index: int = 0,
                 goal_relabeling_strategy: Optional[str] = None,
                 task_augment_strategy: Optional[str] = None,
                 task_augment_kwargs: Optional[Dict] = None,
                 cache_dir=None) -> None:
        from emmax_torch.data.rlds import (NAMED_MIXTURES,
                                           apply_frame_transforms,
                                           apply_trajectory_transforms,
                                           flatten_trajectories,
                                           make_dataset_from_rlds,
                                           make_interleaved_dataset)

        aug_kwargs = None
        if image_aug:
            from emmax_torch.data.augment import OPENVLA_IMAGE_AUGMENT_KWARGS
            aug_kwargs = OPENVLA_IMAGE_AUGMENT_KWARGS

        mixture = NAMED_MIXTURES.get(data_mix, [(data_mix, 1.0)])
        split = "train" if train else "val"
        datasets, weights, statistics = [], [], {}
        for name, weight in mixture:
            ds, stats = make_dataset_from_rlds(data_root_dir, name, split,
                                               cache_dir=cache_dir)
            ds = apply_trajectory_transforms(
                ds, train=train, window_size=1, skip_unlabeled=True,
                goal_relabeling_strategy=goal_relabeling_strategy,
                task_augment_strategy=task_augment_strategy,
                task_augment_kwargs=task_augment_kwargs)
            ds = flatten_trajectories(ds)
            if num_shards > 1:
                ds = ds.shard(num_shards, shard_index)
            ds = apply_frame_transforms(ds, resize=resize_resolution,
                                        train=train,
                                        image_augment_kwargs=aug_kwargs)
            datasets.append(ds)
            weights.append(weight)
            statistics[name] = stats
        self.dataset_statistics = statistics
        self._names = [n for n, _ in mixture]
        self._ds = make_interleaved_dataset(
            datasets, weights, shuffle_buffer_size=shuffle_buffer_size)
        self.batch_transform = batch_transform

    def __iter__(self) -> Iterator[Dict]:
        for frame in self._ds:
            name = frame.get("dataset_name", self._names[0])
            if isinstance(name, bytes):
                name = name.decode()
            yield self.batch_transform(frame, dataset_name=name)


class StreamingBatcher:
    """Collate a streaming sample iterator into fixed-size batches.

    Its sharding skips samples after the producing pipeline; for RLDS
    streams ``RLDSIterableDataset(num_shards=, shard_index=)`` shards before
    the decode instead."""

    def __init__(self, dataset, batch_size: int, collate_fn, *,
                 num_shards: int = 1, shard_index: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_fn
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __iter__(self):
        buf: List[Dict] = []
        for i, sample in enumerate(self.dataset):
            if i % self.num_shards != self.shard_index:
                continue
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate(buf)
                buf = []

    def epoch(self, epoch: int = 0):
        """``BatchLoader``'s interface (a stream's epochs are virtual)."""
        return iter(self)
