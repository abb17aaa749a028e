"""Reading an HF model directory without ``transformers``
(``utils/ckpt_conversion._read_hf_state_dict``) as ``from_pretrained`` reads
it, and the audio CLI's w2v-BERT directory on that reader.

- A directory that ships both weight formats gives the safetensors values
  (the ``pytorch_model*.bin`` files are not read at all).
- A legacy (pre-zip) ``pytorch_model.bin`` loads: only zip-format files are
  memory-mapped.
- ``audio/cli._load_w2vbert_sd`` of a ``save_pretrained`` random
  ``Wav2Vec2BertModel`` equals ``from_pretrained(...).state_dict()`` bitwise.
"""

import os

import pytest
import torch

from maxtext_indextts2_tpu_torch.audio import cli
from maxtext_indextts2_tpu_torch.utils.ckpt_conversion import _read_hf_state_dict

torch.set_num_threads(1)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model.embed_tokens.weight": torch.randn((16, 8), generator=g),
            "model.norm.weight": torch.randn((8,), generator=g)}


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_a_directory_with_both_formats_gives_the_safetensors_values(tmp_path):
    from safetensors.torch import save_file

    st, pt = _state(0), _state(1)
    save_file(st, str(tmp_path / "model.safetensors"))
    torch.save(pt, tmp_path / "pytorch_model.bin")
    _assert_equal(_read_hf_state_dict(str(tmp_path)), st)


def test_bin_files_are_read_when_there_is_no_safetensors_file(tmp_path):
    parts = [_state(2), {"lm_head.weight": torch.ones((4, 8))}]
    torch.save(parts[0], tmp_path / "pytorch_model-00001-of-00002.bin")
    torch.save(parts[1], tmp_path / "pytorch_model-00002-of-00002.bin")
    _assert_equal(_read_hf_state_dict(str(tmp_path)), {**parts[0], **parts[1]})


def test_a_legacy_bin_file_loads(tmp_path):
    sd = _state(3)
    torch.save(sd, tmp_path / "pytorch_model.bin", _use_new_zipfile_serialization=False)
    _assert_equal(_read_hf_state_dict(str(tmp_path)), sd)


def test_an_empty_directory_names_what_it_looked_for(tmp_path):
    with pytest.raises(FileNotFoundError, match="safetensors or pytorch_model"):
        _read_hf_state_dict(str(tmp_path))


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model_bin"])
def test_cli_reads_a_w2vbert_directory_without_transformers(tmp_path, safe, monkeypatch):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    config = transformers.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        feature_projection_input_dim=160, conv_depthwise_kernel_size=5,
        position_embeddings_type="relative_key", left_max_position_embeddings=8,
        right_max_position_embeddings=8)
    model = transformers.Wav2Vec2BertModel(config).eval()
    model.save_pretrained(tmp_path / "w2v", safe_serialization=safe)
    want = transformers.Wav2Vec2BertModel.from_pretrained(tmp_path / "w2v").state_dict()
    # the directory route must not need transformers at all
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    got = cli._load_w2vbert_sd(str(tmp_path / "w2v"))
    _assert_equal(got, dict(want))
    assert os.path.isdir(tmp_path / "w2v")
