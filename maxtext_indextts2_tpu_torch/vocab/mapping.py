"""Audio-token vocab mapping with the soft-token skip.

This package's own copy of the JAX package's ``vocab/mapping.py`` (the port
imports nothing of that package); ``tests/test_torch_port_hygiene.py`` holds
the two equal. A base tokenizer of ``original_vocab_size`` entries contains
one *soft token* at ``soft_token_index`` that has no embedding row, so for
token indices above it ``embedding_idx = token_idx - 1``. Audio ids
[0, codebook) are assigned first to reused ``<unusedN>`` token indices, then
to newly appended tokens; two marker tokens (begin-text ``e_<BT>``,
begin-audio ``e_<BA>``) and pad rows (audio_id == -1) follow, so the final
embedding count is a multiple of ``pad_multiple``. JSON serialization is
key-compatible with the reference's ``audio_token_mapping_adjusted.json``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

AUDIO_BT = "e_<BT>"  # marks start of text in a TTS sequence
AUDIO_BA = "e_<BA>"  # marks start of audio tokens


@dataclass
class AudioVocabMapping:
    original_vocab_size: int
    codebook_size: int
    soft_token_index: int | None
    # audio_id -> token index in the *extended tokenizer* space
    audio_to_token: dict[int, int] = field(default_factory=dict)
    num_pad_tokens: int = 0
    pad_multiple: int = 128

    # ------------------------------------------------------------- derived
    def token_to_embedding(self, token_idx: int) -> int:
        if self.soft_token_index is not None:
            if token_idx == self.soft_token_index:
                raise ValueError(f"soft token {token_idx} has no embedding row")
            if token_idx > self.soft_token_index:
                return token_idx - 1
        return token_idx

    def embedding_to_token(self, emb_idx: int) -> int:
        if self.soft_token_index is not None and emb_idx >= self.soft_token_index:
            return emb_idx + 1
        return emb_idx

    def audio_to_embedding(self, audio_id: int) -> int:
        return self.token_to_embedding(self.audio_to_token[audio_id])

    @property
    def num_audio_entries(self) -> int:
        """codebook + 2 markers."""
        return self.codebook_size + 2

    @property
    def marker_bt_audio_id(self) -> int:
        return self.codebook_size

    @property
    def marker_ba_audio_id(self) -> int:
        return self.codebook_size + 1

    @property
    def adjusted_vocab_size(self) -> int:
        """Number of embedding rows (soft token excluded, pads included)."""
        base = self.original_vocab_size - (1 if self.soft_token_index is not None else 0)
        new_tokens = sum(
            1 for t in self.audio_to_token.values() if t >= self.original_vocab_size
        )
        return base + new_tokens + self.num_pad_tokens

    # ------------------------------------------------------------- arrays
    def audio_to_embedding_array(self) -> np.ndarray:
        """[codebook+2] int32: audio id (incl. markers) -> embedding row."""
        out = np.full(self.num_audio_entries, -1, dtype=np.int32)
        for a, t in self.audio_to_token.items():
            out[a] = self.token_to_embedding(t)
        return out

    def embedding_to_audio_array(self, vocab_size: int | None = None) -> np.ndarray:
        """[vocab] int32: embedding row -> audio id, -1 for text/pad rows."""
        n = vocab_size or self.adjusted_vocab_size
        out = np.full(n, -1, dtype=np.int32)
        for a, t in self.audio_to_token.items():
            e = self.token_to_embedding(t)
            if e < n:
                out[e] = a
        return out

    # ------------------------------------------------------------- io
    def to_json_dict(self) -> dict:
        e2a = {}
        detailed = {}
        for a, t in sorted(self.audio_to_token.items()):
            e = self.token_to_embedding(t)
            if a < self.codebook_size:
                e2a[str(e)] = a
                detailed[str(e)] = {"audio_id": a, "original_token_idx": t}
        # pad rows at the tail carry audio_id -1 (reference convention)
        start_pad = self.adjusted_vocab_size - self.num_pad_tokens
        for e in range(start_pad, self.adjusted_vocab_size):
            e2a[str(e)] = -1
        a2e = {str(a): self.token_to_embedding(t)
               for a, t in sorted(self.audio_to_token.items()) if a < self.codebook_size}
        return {
            "embedding_to_audio": e2a,
            "audio_to_embedding": a2e,
            "detailed_mappings": detailed,
            "stats": {
                "total_mappings": len(e2a),
                "total_audio_tokens": self.codebook_size,
                "padding_tokens": self.num_pad_tokens,
                "max_embedding_index": self.adjusted_vocab_size - 1,
                "original_vocab_size": self.original_vocab_size,
                "adjusted_vocab_size": self.adjusted_vocab_size,
                "soft_token_index": self.soft_token_index,
                "marker_tokens": {
                    AUDIO_BT: self.audio_to_token.get(self.marker_bt_audio_id),
                    AUDIO_BA: self.audio_to_token.get(self.marker_ba_audio_id),
                },
            },
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f)

    @classmethod
    def from_json(cls, path: str) -> "AudioVocabMapping":
        """Load either our JSON or the reference's adjusted-mapping JSON."""
        with open(path) as f:
            raw = json.load(f)
        stats = raw.get("stats", {})
        soft = stats.get("soft_token_index")
        if soft is None and "Soft token" in str(stats.get("note", "")):
            # reference file: parse "original index 262144" from the note
            import re

            m = re.search(r"index (\d+)", stats["note"])
            soft = int(m.group(1)) if m else None
        detailed = raw.get("detailed_mappings", {})
        audio_to_token = {
            int(v["audio_id"]): int(v["original_token_idx"]) for v in detailed.values()
        }
        mapping = cls(
            original_vocab_size=int(stats.get("original_vocab_size", 0)),
            codebook_size=int(stats.get("total_audio_tokens", 8192)),
            soft_token_index=soft,
            audio_to_token=audio_to_token,
            num_pad_tokens=int(stats.get("padding_tokens", 0)),
        )
        markers = stats.get("marker_tokens") or {}
        if markers.get(AUDIO_BT) is not None:
            mapping.audio_to_token[mapping.marker_bt_audio_id] = markers[AUDIO_BT]
        if markers.get(AUDIO_BA) is not None:
            mapping.audio_to_token[mapping.marker_ba_audio_id] = markers[AUDIO_BA]
        return mapping


def build_mapping(
    original_vocab_size: int,
    codebook_size: int = 8192,
    reusable_token_indices: list[int] | None = None,
    soft_token_index: int | None = None,
    pad_multiple: int = 128,
) -> AudioVocabMapping:
    """Assign audio ids to reused + appended tokens, add markers, pad.

    Mirrors extend_tokenizer_with_audio_tokens (reference
    vocab_expansion/extend_tokenizer.py:49): reuse all provided ``<unusedN>``
    indices first (sorted), append the remainder plus 2 markers after the base
    vocab, then pad the embedding count to ``pad_multiple``.
    """
    reuse = sorted(reusable_token_indices or [])
    if soft_token_index is not None and soft_token_index in reuse:
        raise ValueError("soft token cannot be reused as an audio token")
    audio_to_token: dict[int, int] = {}
    n_reused = min(len(reuse), codebook_size)
    for a in range(n_reused):
        audio_to_token[a] = reuse[a]
    next_new = original_vocab_size
    for a in range(n_reused, codebook_size + 2):  # +2 markers
        audio_to_token[a] = next_new
        next_new += 1

    mapping = AudioVocabMapping(
        original_vocab_size=original_vocab_size,
        codebook_size=codebook_size,
        soft_token_index=soft_token_index,
        audio_to_token=audio_to_token,
        pad_multiple=pad_multiple,
    )
    rows = mapping.adjusted_vocab_size
    mapping.num_pad_tokens = (-rows) % pad_multiple
    return mapping


def default_mapping(cfg) -> AudioVocabMapping:
    """The mapping a pipeline uses when it is given none: the file at
    ``cfg.audio_token_mapping_path``, or else a contiguous block of
    ``audio_codebook_size`` ids + 2 markers right after the text vocabulary
    (no reuse, no soft token), padded to a multiple of 128 so that it ends at
    ``cfg.vocab_size``. Counterpart of the JAX package's
    ``train/data/audio_iterator.py`` ``_default_mapping``."""
    if cfg.audio_token_mapping_path:
        return AudioVocabMapping.from_json(cfg.audio_token_mapping_path)
    base = cfg.vocab_size - ((cfg.audio_codebook_size + 2 + 127) // 128) * 128
    return build_mapping(max(base, 0), cfg.audio_codebook_size)
