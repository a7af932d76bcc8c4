"""VLA dataset and collator factories, port of
``emmax_tpu/vla/materialize.py``: ``get_vla_dataset_and_collator``
(OpenVLA's RLDS action-token stream) and
``get_discrete_dataset_and_collator`` (Emma-X's GCOT records: map-style
datasets, a right-padding train collator and a left-padding val collator;
the val dataset reads the train records, as the upstream recipe does).
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Optional, Tuple

from emmax_torch.data.collators import collate_train, collate_val
from emmax_torch.vla.action_tokenizer import ActionTokenizer


def get_vla_dataset_and_collator(
    data_root_dir,
    data_mix: str,
    action_tokenizer: ActionTokenizer,
    tokenizer,
    *,
    prompt_style: str = "pure",
    shuffle_buffer_size: int = 10_000,
    train: bool = True,
    resize_resolution: Optional[Tuple[int, int]] = None,
    predict_stop_token: bool = True,
    image_aug: bool = False,
    cache_dir=None,
):
    """(streaming dataset, collator) of the RLDS action-token path;
    ``image_aug=True`` turns on OpenVLA's training augmentation."""
    from emmax_torch.data.rlds_vla import (RLDSBatchTransform,
                                           RLDSIterableDataset)

    transform = RLDSBatchTransform(action_tokenizer, tokenizer,
                                   prompt_style=prompt_style,
                                   predict_stop_token=predict_stop_token)
    dataset = RLDSIterableDataset(data_root_dir, data_mix, transform,
                                  resize_resolution=resize_resolution,
                                  shuffle_buffer_size=shuffle_buffer_size,
                                  train=train, image_aug=image_aug,
                                  cache_dir=cache_dir)
    collator = partial(collate_train, pad_id=tokenizer.pad_id)
    return dataset, collator


def get_discrete_dataset_and_collator(
    data_root_dir,
    file_name: str,
    action_tokenizer: ActionTokenizer,
    tokenizer,
    frame_source,
    *,
    data_mix: str = "movement_policy",
    mask_inst: bool = True,
    prompt_style: str = "pure",
    max_length: int = 2048,
):
    """(train dataset, val dataset, train collator, val collator) of the
    GCOT path."""
    from emmax_torch.data.gcot import GCOTDataset

    path = Path(data_root_dir) / file_name
    train_ds = GCOTDataset(path, action_tokenizer, tokenizer, frame_source,
                           data_mix=data_mix, mask_inst=mask_inst,
                           split="train", prompt_style=prompt_style)
    val_ds = GCOTDataset(path, action_tokenizer, tokenizer, frame_source,
                         data_mix=data_mix, split="val",
                         prompt_style=prompt_style)
    train_collator = partial(collate_train, pad_id=tokenizer.pad_id,
                             max_length=max_length)
    val_collator = partial(collate_val, pad_id=tokenizer.pad_id,
                           max_length=max_length)
    return train_ds, val_ds, train_collator, val_collator
