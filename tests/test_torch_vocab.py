"""The text side of the PyTorch package's TTS pipeline against the JAX
package: the audio-vocabulary mapping (its own copy), the byte tokenizer,
the LM prompt and the mapping of generated ids back to semantic tokens. All
exact: this is integer bookkeeping.
"""

import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.audio.pipeline import TTSPipeline as JaxTTSPipeline
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train.data import tokenizer as jax_tokenizer
from maxtext_indextts2_tpu.train.data.audio_iterator import _default_mapping
from maxtext_indextts2_tpu.vocab import mapping as jax_mapping
from maxtext_indextts2_tpu_torch.audio.pipeline import TTSPipeline
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train.data import tokenizer
from maxtext_indextts2_tpu_torch.vocab import mapping

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

MAPPINGS = {
    "contiguous": dict(original_vocab_size=384, codebook_size=8192),
    "reused_and_soft_token": dict(original_vocab_size=1000, codebook_size=64,
                                  reusable_token_indices=[990, 5, 7, 300, 998],
                                  soft_token_index=500, pad_multiple=64),
    "more_reuse_than_codes": dict(original_vocab_size=200, codebook_size=4,
                                  reusable_token_indices=list(range(10, 20))),
}
CONFIGS = {
    "tiny_tts": ["vocab_size=9344", "audio_codebook_size=8192"],
    "tts_1b": ["vocab_size=8704", "audio_codebook_size=8192"],
    "small": ["vocab_size=512", "audio_codebook_size=64", "add_bos=false"],
}


def _pair(cfg_args):
    """(PyTorch pipeline, JAX pipeline) holding only the text side."""
    args = ["per_device_batch_size=1"] + list(cfg_args)
    tpipe = TTSPipeline(cfg=load_config(args), s2a=None, codec=None)
    jpipe = JaxTTSPipeline(cfg=jax_load_config(args + ["per_device_batch_size=0.125"]),
                           engine=None, semantic_tokenizer=None, s2a=None, s2a_params=None,
                           codec=None, codec_params=None)
    return tpipe, jpipe


@pytest.mark.parametrize("name", list(MAPPINGS))
def test_mapping_arrays_and_json_equal_the_jax_package(name, tmp_path):
    kw = MAPPINGS[name]
    got, want = mapping.build_mapping(**kw), jax_mapping.build_mapping(**kw)
    assert got.audio_to_token == want.audio_to_token
    assert got.adjusted_vocab_size == want.adjusted_vocab_size
    assert got.adjusted_vocab_size % kw.get("pad_multiple", 128) == 0
    np.testing.assert_array_equal(got.audio_to_embedding_array(), want.audio_to_embedding_array())
    for vocab in (None, got.adjusted_vocab_size - 3):
        np.testing.assert_array_equal(got.embedding_to_audio_array(vocab),
                                      want.embedding_to_audio_array(vocab))
    assert got.to_json_dict() == want.to_json_dict()
    # the file written by one package loads in the other
    got.save(str(tmp_path / "m.json"))
    back = jax_mapping.AudioVocabMapping.from_json(str(tmp_path / "m.json"))
    again = mapping.AudioVocabMapping.from_json(str(tmp_path / "m.json"))
    assert back.to_json_dict() == again.to_json_dict() == want.to_json_dict()
    if kw.get("soft_token_index") is not None:
        with pytest.raises(ValueError, match="soft token"):
            got.token_to_embedding(kw["soft_token_index"])
        assert got.embedding_to_token(kw["soft_token_index"]) == kw["soft_token_index"] + 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_default_mapping_equals_the_jax_package(name):
    args = ["per_device_batch_size=1"] + CONFIGS[name]
    got = mapping.default_mapping(load_config(args))
    want = _default_mapping(jax_load_config(args + ["per_device_batch_size=0.125"]))
    assert got.to_json_dict() == want.to_json_dict()
    vocab = load_config(args).vocab_size
    np.testing.assert_array_equal(got.embedding_to_audio_array(vocab),
                                  want.embedding_to_audio_array(vocab))
    assert got.adjusted_vocab_size <= vocab


@pytest.mark.parametrize("text", ["", "hello tpu", "Grüße, 世界! \n\t"])
@pytest.mark.parametrize("bos,eos", [(True, True), (False, True), (False, False)])
def test_byte_tokenizer_equals_the_jax_package(text, bos, eos):
    got, want = tokenizer.ByteTokenizer(bos, eos), jax_tokenizer.ByteTokenizer(bos, eos)
    ids = got.encode(text)
    assert ids == want.encode(text) and got.vocab_size == want.vocab_size == 259
    assert got.decode(ids) == want.decode(ids) == text


def test_build_tokenizer_takes_byte_and_names_the_queue_item_for_the_others():
    for kind in ("none", "byte", ""):
        cfg = load_config([f"tokenizer_type={kind}", "add_eos=false"])
        tok = tokenizer.build_tokenizer(cfg)
        assert isinstance(tok, tokenizer.ByteTokenizer) and not tok.add_eos
    for kind in ("huggingface", "sentencepiece", "tiktoken"):
        with pytest.raises(NotImplementedError, match="port queue: 4"):
            tokenizer.build_tokenizer(load_config([f"tokenizer_type={kind}"]))
    with pytest.raises(ValueError, match="unknown tokenizer_type"):
        tokenizer.build_tokenizer(load_config(["tokenizer_type=nope"]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_prompt_equals_the_jax_package(name):
    tpipe, jpipe = _pair(CONFIGS[name])
    codebook = tpipe.mapping.codebook_size
    sem = np.random.default_rng(0).integers(0, codebook, size=23)
    for text in ("ab", "a longer sentence, with punctuation."):
        got = tpipe.text_and_prompt_to_lm_prompt(text, sem)
        want = jpipe.text_and_prompt_to_lm_prompt(text, sem)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    m = tpipe.mapping
    assert got[0] == m.audio_to_embedding(m.marker_bt_audio_id)
    ba = list(got).index(m.audio_to_embedding(m.marker_ba_audio_id))
    np.testing.assert_array_equal(got[ba + 1:], [m.audio_to_embedding(int(a)) for a in sem])
    assert (got < tpipe.cfg.vocab_size).all()


@pytest.mark.parametrize("force_frames", [False, True])
def test_map_semantic_equals_the_jax_package(force_frames):
    tpipe, jpipe = _pair(CONFIGS["tiny_tts"])
    m = tpipe.mapping
    audio = [m.audio_to_embedding(a) for a in (0, 5, 8191, 17)]
    streams = [
        audio,
        audio[:2] + [3] + audio[2:],  # a text id stops the stream
        audio[:1] + [m.audio_to_embedding(m.marker_ba_audio_id)] + audio,  # a marker too
        [9343, -1, 10_000] + audio,  # a pad row and ids outside the table
        [],
    ]
    for ids in streams:
        got = tpipe.map_semantic(ids, force_frames=force_frames)
        assert got == jpipe.map_semantic(ids, force_frames=force_frames)
        assert all(0 <= a < m.codebook_size for a in got)
        if force_frames:
            assert len(got) == len(ids)
    assert tpipe.map_semantic(streams[1]) == [0, 5]
