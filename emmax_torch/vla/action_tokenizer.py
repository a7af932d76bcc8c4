"""Continuous-action ↔ token discretization.

Host-side (numpy) Emma-X / OpenVLA action tokenizer
(reference: ``prismatic/vla/action_tokenizer.py:13-72``).
Pure numpy on the host; the port keeps its own copy of
``emmax_tpu/vla/action_tokenizer.py`` (minus the jnp decode twin).

Semantics (kept exactly):
- ``n_bins`` uniform bin *edges* over ``[min_action, max_action]``; bin
  centers are midpoints, so there are ``n_bins - 1`` centers.
- A value digitized to bin ``i`` (1..n_bins) maps to token id
  ``vocab_size - i`` — the final ``n_bins`` tokens of the base vocabulary
  (``action_tokenizer.py:36,41-47``).
- Decoding token id ``t``: ``i = vocab_size - t``; center index
  ``clip(i - 1, 0, n_bins - 2)`` (``action_tokenizer.py:65-68``).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

from emmax_torch.vla.tokenizer import Tokenizer


class ActionTokenizer:
    def __init__(self, tokenizer: Tokenizer, bins: int = 256,
                 min_action: float = -1.0, max_action: float = 1.0) -> None:
        self.tokenizer = tokenizer
        self.n_bins = bins
        self.min_action = float(min_action)
        self.max_action = float(max_action)
        self.bins = np.linspace(self.min_action, self.max_action, self.n_bins)
        self.bin_centers = (self.bins[:-1] + self.bins[1:]) / 2.0
        # Contract: action tokens overwrite the final `n_bins` base-vocab ids.
        self.action_token_begin_idx: int = int(tokenizer.vocab_size - (self.n_bins + 1))
        # the action region must not collide with the tokenizer's byte/
        # special ids — on tiny test vocabs the top bins would otherwise
        # silently decode as raw bytes and break the decode->encode
        # round trip (contract 3 in vla/tokenizer.py)
        floor = getattr(tokenizer, "_action_lo", None)
        if floor is not None and tokenizer.vocab_size - self.n_bins < floor:
            raise ValueError(
                f"vocab_size={tokenizer.vocab_size} cannot host {bins} "
                f"action bins above the byte region (needs vocab_size >= "
                f"{floor + self.n_bins}); use a larger vocab or fewer bins")

    # -- continuous -> token ids ----------------------------------------------
    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        action = np.clip(np.asarray(action, dtype=np.float64),
                         self.min_action, self.max_action)
        discretized = np.digitize(action, self.bins)
        return (self.tokenizer.vocab_size - discretized).astype(np.int64)

    # -- continuous -> string (for prompt/target assembly) --------------------
    def __call__(self, action: np.ndarray) -> Union[str, List[str]]:
        ids = self.encode_to_ids(action)
        if ids.ndim == 1:
            return self.tokenizer.decode(list(ids))
        return [self.tokenizer.decode(list(row)) for row in ids]

    # -- token ids -> continuous ----------------------------------------------
    def decode_token_ids_to_actions(self, action_token_ids: np.ndarray) -> np.ndarray:
        discretized = self.tokenizer.vocab_size - np.asarray(action_token_ids)
        discretized = np.clip(discretized - 1, a_min=0,
                              a_max=self.bin_centers.shape[0] - 1)
        return self.bin_centers[discretized]

    @property
    def vocab_size(self) -> int:
        return self.n_bins


def unnormalize_actions(actions: np.ndarray, norm_stats: dict) -> np.ndarray:
    """BOUNDS_Q99 un-normalization with per-dim mask.

    ``0.5 * (a + 1) * (q99 - q01) + q01`` where mask is True, else passthrough
    (reference: ``prismatic/models/vlms/prismatic.py:674-685`` and
    ``prismatic/models/vlas/openvla.py:95-102``).
    """
    actions = np.asarray(actions, dtype=np.float64)
    high = np.array(norm_stats["q99"], dtype=np.float64)
    low = np.array(norm_stats["q01"], dtype=np.float64)
    mask = np.array(norm_stats.get("mask", np.ones_like(low, dtype=bool)))
    return np.where(mask, 0.5 * (actions + 1.0) * (high - low) + low, actions)


def unnormalize_proprio(delta: np.ndarray, proprio_stats: dict) -> np.ndarray:
    """Proprio (movement-plan) un-normalization using Q1/Q99 keys
    (reference: ``prismatic/models/vlms/prismatic.py:687-696``)."""
    delta = np.asarray(delta, dtype=np.float64)
    high = np.array(proprio_stats["Q99"], dtype=np.float64)
    low = np.array(proprio_stats["Q1"], dtype=np.float64)
    mask = np.array(proprio_stats.get("mask", np.ones_like(low, dtype=bool)))
    return np.where(mask, 0.5 * (delta + 1.0) * (high - low) + low, delta)
