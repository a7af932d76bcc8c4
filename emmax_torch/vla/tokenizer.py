"""Tokenizer protocol + self-contained byte-level tokenizer.

The reference stack assumes a Llama-2 SentencePiece tokenizer (see
``prismatic/vla/solver.py:188-190`` and
``prismatic/models/backbones/llm/base_llm.py:164-180``) with these contracts:

1. ``encode(text, add_special_tokens=True)`` prepends exactly one BOS token.
2. ``encode(text, add_special_tokens=False)`` prepends a SentencePiece
   word-boundary piece ("▁", Llama id 29871) before the first real token —
   the Emma-X ``Solver`` relies on this by dropping the first token of every
   re-tokenized policy string (``solver.py:125-127``), and OpenVLA appends
   id 29871 to prompts (``prismatic/models/vlas/openvla.py:60-65``).
3. The *last 256 entries of the base vocab* (``vocab_size`` = 32000, before
   pad-resize to 32064) round-trip exactly through decode→encode — they are
   the action tokens (``prismatic/vla/action_tokenizer.py:34-47``).

``ByteLevelTokenizer`` reproduces all three contracts without any external
vocab file so the full pipeline (action tokenizer, solver, prompt assembly,
training targets, greedy decode parity tests) is exercisable hermetically.
``HFTokenizerAdapter`` wraps a real ``transformers`` tokenizer (e.g. the
production Llama-2 tokenizer) behind the same protocol.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    """Minimal tokenizer surface needed by the Emma-X stack."""

    vocab_size: int          # base vocab size (excludes added pad token)
    padded_vocab_size: int   # after pad_to_multiple_of resize (embedding rows)
    bos_id: int
    eos_id: int
    pad_id: int
    empty_token_id: int      # Llama "▁" (29871); SP word-boundary piece

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...


def pad_to_multiple(n: int, multiple: int = 64) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# Reserved unicode range for "action region" surface forms: the last
# ACTION_REGION_SIZE tokens of the base vocab decode to single private-use
# characters and re-encode to themselves (mimicking Llama's property that its
# tail-of-vocab pieces round-trip).
_PUA_BASE = 0xE000
ACTION_REGION_SIZE = 512  # covers n_bins=256 plus headroom


@dataclasses.dataclass
class ByteLevelTokenizer:
    """Hermetic byte-level tokenizer with Llama-like contracts.

    Vocab layout (base ``vocab_size`` defaults to 32000, matching Llama-2):

    - 0: ``<unk>``, 1: ``<s>``, 2: ``</s>``
    - 3: ``▁`` word-boundary piece (plays the role of Llama id 29871)
    - 4..259: byte tokens for bytes 0..255
    - ``vocab_size - ACTION_REGION_SIZE`` .. ``vocab_size - 1``: action-region
      tokens; token id ``t`` decodes to ``chr(0xE000 + vocab_size - t)`` and
      that character re-encodes to ``t``.
    - everything else: unused filler (never produced by ``encode``).
    - ``vocab_size``: added ``<PAD>`` (embeddings resized to
      ``pad_to_multiple(vocab_size + 1, 64)`` as in
      ``prismatic/models/backbones/llm/llama2.py:73-76``).
    """

    vocab_size: int = 32000
    model_max_length: int = 2048

    def __post_init__(self) -> None:
        self.unk_id = 0
        self.bos_id = 1
        self.eos_id = 2
        self.empty_token_id = 3
        self._byte_base = 4
        self.pad_id = self.vocab_size  # added token, first id past base vocab
        self.padded_vocab_size = pad_to_multiple(self.vocab_size + 1, 64)
        # action region never overlaps the byte/special region (tiny test
        # vocabs would otherwise have every id decode as an action char)
        self._action_lo = max(self.vocab_size - ACTION_REGION_SIZE,
                              self._byte_base + 256)

    # -- helpers -------------------------------------------------------------
    def _char_to_action_id(self, ch: str) -> Optional[int]:
        cp = ord(ch)
        k = cp - _PUA_BASE
        if 1 <= k <= ACTION_REGION_SIZE and self.vocab_size - k >= self._action_lo:
            return self.vocab_size - k
        return None

    def _action_id_to_char(self, tid: int) -> Optional[str]:
        if self._action_lo <= tid < self.vocab_size:
            return chr(_PUA_BASE + (self.vocab_size - tid))
        return None

    # -- protocol ------------------------------------------------------------
    _SPECIAL_STRINGS = (("</s>", "eos_id"), ("<s>", "bos_id"),
                        ("<PAD>", "pad_id"), ("<unk>", "unk_id"))

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.bos_id)
        # SentencePiece-style word-boundary prefix before the first piece.
        ids.append(self.empty_token_id)
        i = 0
        while i < len(text):
            # literal special-token strings map to their ids (Llama contract:
            # "</s>" in training targets becomes the EOS token)
            matched = False
            if text[i] == "<":
                for s, attr in self._SPECIAL_STRINGS:
                    if text.startswith(s, i):
                        ids.append(getattr(self, attr))
                        i += len(s)
                        matched = True
                        break
            if matched:
                continue
            ch = text[i]
            aid = self._char_to_action_id(ch)
            if aid is not None:
                ids.append(aid)
            else:
                ids.extend(self._byte_base + b for b in ch.encode("utf-8"))
            i += 1
        return ids[: self.model_max_length]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush() -> None:
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        for tid in ids:
            tid = int(tid)
            if tid in (self.bos_id, self.eos_id, self.unk_id, self.pad_id):
                if not skip_special_tokens:
                    flush()
                    out.append({self.bos_id: "<s>", self.eos_id: "</s>",
                                self.unk_id: "<unk>", self.pad_id: "<PAD>"}[tid])
                continue
            if tid == self.empty_token_id:
                # "▁": SentencePiece renders the word boundary as NOTHING at
                # the very start and as a SPACE mid-sequence — dropping it
                # everywhere silently glued separately-encoded segments
                # together ("a"+"b" -> "ab" instead of "a b")
                if out or buf:
                    buf.append(ord(" "))
                continue
            ach = self._action_id_to_char(tid)
            if ach is not None:
                flush()
                out.append(ach)
            elif self._byte_base <= tid < self._byte_base + 256:
                buf.append(tid - self._byte_base)
            # filler ids decode to nothing
        flush()
        return "".join(out)

    def __call__(self, text: str, add_special_tokens: bool = True):
        """HF-style call returning an object with ``.input_ids``."""
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return _Encoding(input_ids=ids)


@dataclasses.dataclass
class _Encoding:
    input_ids: List[int]


class HFTokenizerAdapter:
    """Adapts a ``transformers`` tokenizer (e.g. real Llama-2) to the protocol.

    Mirrors the pad handling in ``prismatic/models/backbones/llm/llama2.py:73-76``:
    adds ``<PAD>`` and reports embedding rows padded to a multiple of 64.
    """

    def __init__(self, hf_tokenizer, empty_token_id: int = 29871,
                 pad_multiple: int = 64) -> None:
        self._tok = hf_tokenizer
        if hf_tokenizer.pad_token is None:
            hf_tokenizer.add_special_tokens({"pad_token": "<PAD>"})
        self.vocab_size = int(hf_tokenizer.vocab_size)
        self.padded_vocab_size = pad_to_multiple(len(hf_tokenizer), pad_multiple)
        self.bos_id = int(hf_tokenizer.bos_token_id)
        self.eos_id = int(hf_tokenizer.eos_token_id)
        self.pad_id = int(hf_tokenizer.pad_token_id)
        self.empty_token_id = empty_token_id

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return list(self._tok(text, add_special_tokens=add_special_tokens).input_ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def __call__(self, text: str, add_special_tokens: bool = True):
        return _Encoding(input_ids=self.encode(text, add_special_tokens))


def load_tokenizer(path_or_none: Optional[str] = None,
                   model_max_length: int = 2048) -> Tokenizer:
    """Load the production tokenizer if a path is given, else the hermetic one."""
    if path_or_none is None:
        return ByteLevelTokenizer(model_max_length=model_max_length)
    from transformers import AutoTokenizer  # local import: heavyweight

    hf_tok = AutoTokenizer.from_pretrained(
        path_or_none, model_max_length=model_max_length, padding_side="right"
    )
    return HFTokenizerAdapter(hf_tok)
