"""Emilia-style audio-LM data pipeline: (text, audio) -> packed token rows.

This package's own copy of the JAX package's
``train/data/audio_iterator.py`` (numpy only; ``tests/test_torch_data.py``
holds the batches of the two equal). Per example the LM sequence is::

    e_<BT>  <text tokens...>  e_<BA>  <audio semantic tokens...>  EOS

with every id expressed in *embedding-row* space via the vocab mapping
(soft-token skip handled in ``vocab/mapping.py``). Semantic tokens come from
(in priority order): a precomputed dataset column, an injected
``audio_tokenizer_fn`` (e.g. the semantic tokenizer), or a deterministic
synthetic generator. Streaming an HF dataset (``dataset_path``) imports
``datasets`` only when it starts.
"""

from __future__ import annotations

import itertools
from collections.abc import Iterator

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.train.data.packing import PackedBatcher
from maxtext_indextts2_tpu_torch.train.data.tokenizer import build_tokenizer
from maxtext_indextts2_tpu_torch.vocab.mapping import AudioVocabMapping, default_mapping


def build_tts_sequence(
    text_ids: list[int],
    audio_ids: list[int],
    mapping: AudioVocabMapping,
    eos_id: int | None = 2,
) -> list[int]:
    bt = mapping.audio_to_embedding(mapping.marker_bt_audio_id)
    ba = mapping.audio_to_embedding(mapping.marker_ba_audio_id)
    seq = [bt] + [mapping.token_to_embedding(t) for t in text_ids] + [ba]
    seq += [mapping.audio_to_embedding(a) for a in audio_ids]
    if eos_id is not None:
        seq.append(eos_id)
    return seq


def split_tts_sequence(
    embedding_ids: list[int], mapping: AudioVocabMapping
) -> tuple[list[int], list[int]]:
    """Inverse of build_tts_sequence: embedding ids -> (text ids, audio ids)."""
    ba = mapping.audio_to_embedding(mapping.marker_ba_audio_id)
    bt = mapping.audio_to_embedding(mapping.marker_bt_audio_id)
    e2a = mapping.embedding_to_audio_array()
    text, audio = [], []
    in_audio = False
    for e in embedding_ids:
        if e == bt:
            in_audio = False
            continue
        if e == ba:
            in_audio = True
            continue
        if in_audio:
            a = int(e2a[e]) if 0 <= e < len(e2a) else -1
            if 0 <= a < mapping.codebook_size:
                audio.append(a)
        else:
            text.append(mapping.embedding_to_token(e))
    return text, audio


def _synthetic_examples(cfg: Config, tokenizer, mapping, seed: int) -> Iterator[list[int]]:
    rng = np.random.default_rng(seed)
    while True:
        n_text = int(rng.integers(4, 24))
        n_audio = int(rng.integers(16, 100))
        text_ids = rng.integers(3, min(250, cfg.vocab_size // 64 + 3), size=n_text).tolist()
        audio_ids = rng.integers(0, cfg.audio_codebook_size, size=n_audio).tolist()
        yield build_tts_sequence(text_ids, audio_ids, mapping)


def _hf_examples(cfg: Config, tokenizer, mapping, audio_tokenizer_fn) -> Iterator[list[int]]:
    from datasets import load_dataset

    ds = load_dataset(cfg.dataset_path, split="train", streaming=True)
    if cfg.emilia_language:
        try:
            ds = ds.filter(
                lambda ex: ex.get("language", cfg.emilia_language) == cfg.emilia_language)
        except (KeyError, TypeError):
            pass
    for ex in ds:
        text = ex.get("text") or ex.get("transcript") or ""
        text_ids = tokenizer.encode(text)
        if "semantic_tokens" in ex and ex["semantic_tokens"] is not None:
            audio_ids = list(ex["semantic_tokens"])
        elif audio_tokenizer_fn is not None and "audio" in ex:
            wav = np.asarray(ex["audio"]["array"], np.float32)
            ids, lens = audio_tokenizer_fn(wav[None])
            audio_ids = np.asarray(ids)[0, : int(np.asarray(lens)[0])].tolist()
        else:
            continue
        yield build_tts_sequence(text_ids, audio_ids, mapping)


def make_emilia_audio_train_iterator(
    cfg: Config, audio_tokenizer_fn=None, process_index: int = 0, process_count: int = 1
):
    tokenizer = build_tokenizer(cfg)
    mapping = default_mapping(cfg)
    if cfg.dataset_path:
        source = _hf_examples(cfg, tokenizer, mapping, audio_tokenizer_fn)
    else:
        source = _synthetic_examples(cfg, tokenizer, mapping, cfg.data_shuffle_seed + process_index)
    if process_count > 1:
        source = itertools.islice(source, process_index, None, process_count)
    batch = cfg.global_batch_size_to_load // process_count
    return PackedBatcher(source, batch, cfg.max_target_length, pack=cfg.packing)


def make_emilia_audio_eval_iterator(cfg: Config, **kwargs):
    """The eval stream: the train stream's construction (the JAX package's
    eval iterator is the same call)."""
    return make_emilia_audio_train_iterator(cfg, **kwargs)
