"""Text tokenizers.

This package's own copy of the JAX package's ``train/data/tokenizer.py``: the
byte-level tokenizer (``tokenizer_type`` ``none`` or ``byte``, no vocabulary
file), and the wrappers of ``tiktoken`` (``tiktoken``), ``transformers``'
``AutoTokenizer`` (``huggingface``) and ``sentencepiece`` (``sentencepiece``),
each of which imports its package only when it is built.
"""

from __future__ import annotations

from typing import Protocol


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


class TikTokenTokenizer:
    """OpenAI ``tiktoken`` wrapper (imported here only)."""

    def __init__(self, encoding_name: str = "cl100k_base", add_bos: bool = False,
                 add_eos: bool = False):
        import tiktoken

        self._enc = tiktoken.get_encoding(encoding_name)
        self.add_bos = add_bos
        self.add_eos = add_eos

    @property
    def vocab_size(self) -> int:
        return self._enc.n_vocab

    def encode(self, text: str) -> list[int]:
        return self._enc.encode(text)

    def decode(self, ids) -> str:
        return self._enc.decode(list(ids))


class HFTokenizer:
    """``transformers.AutoTokenizer`` wrapper (imported here only); bos / eos
    added by the wrapper where the tokenizer has them."""

    def __init__(self, path: str, add_bos: bool = True, add_eos: bool = True):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        self.add_bos = add_bos
        self.add_eos = add_eos

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    def encode(self, text: str) -> list[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        if self.add_bos and self.tok.bos_token_id is not None:
            ids = [self.tok.bos_token_id] + ids
        if self.add_eos and self.tok.eos_token_id is not None:
            ids = ids + [self.tok.eos_token_id]
        return ids

    def decode(self, ids) -> str:
        return self.tok.decode(ids)


class SentencePieceTokenizer:
    """``sentencepiece`` wrapper (imported here only); bos / eos added by the
    wrapper."""

    def __init__(self, path: str, add_bos: bool = True, add_eos: bool = True):
        import sentencepiece as spm

        self.sp = spm.SentencePieceProcessor(model_file=path)
        self.add_bos = add_bos
        self.add_eos = add_eos

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size()

    def encode(self, text: str) -> list[int]:
        ids = self.sp.encode(text)
        if self.add_bos:
            ids = [self.sp.bos_id()] + ids
        if self.add_eos:
            ids = ids + [self.sp.eos_id()]
        return ids

    def decode(self, ids) -> str:
        return self.sp.decode(list(ids))


def build_tokenizer(cfg) -> Tokenizer:
    kind = cfg.tokenizer_type
    if kind in ("none", "byte", ""):
        return ByteTokenizer(cfg.add_bos, cfg.add_eos)
    if kind == "huggingface":
        return HFTokenizer(cfg.tokenizer_path, cfg.add_bos, cfg.add_eos)
    if kind == "sentencepiece":
        return SentencePieceTokenizer(cfg.tokenizer_path, cfg.add_bos, cfg.add_eos)
    if kind == "tiktoken":
        return TikTokenTokenizer(cfg.tokenizer_path or "cl100k_base", cfg.add_bos, cfg.add_eos)
    raise ValueError(f"unknown tokenizer_type: {kind}")
