"""The text tokenizer wrappers of the PyTorch package (``sentencepiece``,
``tiktoken``, ``huggingface``) against the JAX package's, with stub modules
in ``sys.modules`` (as ``tests/test_gated_imports.py`` does): the same ids,
vocabulary size and decoded text from both packages' wrappers, for every
bos / eos setting. The stubs are deterministic, so the ids must be EQUAL.
"""

import sys
import types

import pytest

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.train.data import tokenizer as jax_tokenizer
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train.data import tokenizer


class _FakeSP:
    def __init__(self, model_file):
        assert model_file == "/fake/spm.model"

    def encode(self, text):
        return [10 + (b % 50) for b in text.encode()]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)

    def bos_id(self):
        return 1

    def eos_id(self):
        return 2

    def vocab_size(self):
        return 32000


class _FakeEnc:
    n_vocab = 100277

    def encode(self, text):
        return [len(w) for w in text.split()]

    def decode(self, ids):
        return " ".join("x" * i for i in ids)


class _FakeAutoTokenizer:
    bos_token_id, eos_token_id = 5, 6

    @classmethod
    def from_pretrained(cls, path):
        assert path == "/fake/hf"
        return cls()

    def __len__(self):
        return 777

    def encode(self, text, add_special_tokens=True):
        assert add_special_tokens is False  # bos / eos are the wrapper's
        return [100 + b for b in text.encode()]

    def decode(self, ids):
        return "|".join(str(i) for i in ids)


@pytest.fixture
def stubs(monkeypatch):
    spm = types.ModuleType("sentencepiece")
    spm.SentencePieceProcessor = _FakeSP
    tik = types.ModuleType("tiktoken")
    tik.get_encoding = lambda name: _FakeEnc() if name in ("cl100k_base", "o200k_base") else None
    hf = types.ModuleType("transformers")
    hf.AutoTokenizer = _FakeAutoTokenizer
    for name, mod in (("sentencepiece", spm), ("tiktoken", tik), ("transformers", hf)):
        monkeypatch.setitem(sys.modules, name, mod)


KINDS = {
    "sentencepiece": (["tokenizer_path=/fake/spm.model"], "SentencePieceTokenizer"),
    "tiktoken": ([], "TikTokenTokenizer"),
    "tiktoken_named": (["tokenizer_path=o200k_base"], "TikTokenTokenizer"),
    "huggingface": (["tokenizer_path=/fake/hf"], "HFTokenizer"),
}


@pytest.mark.parametrize("bos,eos", [("true", "true"), ("false", "true"), ("false", "false")])
@pytest.mark.parametrize("kind", list(KINDS))
def test_wrapper_equals_the_jax_package(stubs, kind, bos, eos):
    keys, cls = KINDS[kind]
    args = [f"tokenizer_type={kind.split('_')[0]}", f"add_bos={bos}", f"add_eos={eos}", *keys]
    ours = tokenizer.build_tokenizer(load_config(args))
    theirs = jax_tokenizer.build_tokenizer(jax_load_config(args))
    assert type(ours).__name__ == type(theirs).__name__ == cls
    text = "zero shot speech"
    ids = ours.encode(text)
    assert ids == theirs.encode(text) and len(ids) > 0
    assert ours.vocab_size == theirs.vocab_size
    assert ours.decode(ids) == theirs.decode(ids)


def test_sentencepiece_and_hf_wrappers_add_bos_and_eos(stubs):
    sp = tokenizer.build_tokenizer(load_config(["tokenizer_type=sentencepiece",
                                                "tokenizer_path=/fake/spm.model"]))
    ids = sp.encode("hi")
    assert ids[0] == 1 and ids[-1] == 2 and sp.vocab_size == 32000
    hf = tokenizer.build_tokenizer(load_config(["tokenizer_type=huggingface",
                                                "tokenizer_path=/fake/hf"]))
    ids = hf.encode("hi")
    assert ids == [5, 204, 205, 6] and hf.vocab_size == 777


def test_wrappers_import_their_package_only_when_built(monkeypatch):
    """Without the package, building the wrapper fails with the import
    error; importing the module does not need it."""
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    with pytest.raises(ImportError):
        tokenizer.build_tokenizer(load_config(["tokenizer_type=sentencepiece",
                                               "tokenizer_path=/x"]))
    assert isinstance(tokenizer.build_tokenizer(load_config([])), tokenizer.ByteTokenizer)
