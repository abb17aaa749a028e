"""Text tokenizers for the TTS prompt.

This package's own copy of the JAX package's ``train/data/tokenizer.py`` for
what serving ``tts-1b`` needs: the byte-level tokenizer (``tokenizer_type``
``none`` or ``byte``), which needs no vocabulary file. The tokenizers that
read a vocabulary file or an extra package (``huggingface``,
``sentencepiece``, ``tiktoken``) wait until such files are in the repo and
raise with their queue item.
"""

from __future__ import annotations

from typing import Protocol

from maxtext_indextts2_tpu_torch.unported import _unsupported


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: list[int]) -> str: ...
    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """Bytes + 2 specials: 0=pad, 1=bos, 2=eos; byte b -> b+3."""

    PAD, BOS, EOS = 0, 1, 2

    def __init__(self, add_bos: bool = True, add_eos: bool = True):
        self.add_bos = add_bos
        self.add_eos = add_eos

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str) -> list[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if self.add_bos:
            ids = [self.BOS] + ids
        if self.add_eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids) -> str:
        return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", errors="replace")


def build_tokenizer(cfg) -> Tokenizer:
    kind = cfg.tokenizer_type
    if kind in ("none", "byte", ""):
        return ByteTokenizer(cfg.add_bos, cfg.add_eos)
    if kind in ("huggingface", "sentencepiece", "tiktoken"):
        _unsupported(f"the tokenizer_type={kind!r} wrapper",
                     "4b, rest of training: weight import and tokenizer wrappers, item 4b.1")
    raise ValueError(f"unknown tokenizer_type: {kind}")
