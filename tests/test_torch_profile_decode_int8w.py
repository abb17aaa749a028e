"""``tools/profile_decode.py int8w=true`` profiles the ``int8w_serve`` engine
(``int8w_matmul`` in every product) with the same recipe as the bf16 one;
its options parse, and it refuses to run without a card."""

import pytest

from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.tools import profile_decode


def test_int8w_option_adds_int8w_serve_and_nothing_else():
    plain, quant = profile_decode.parse([]), profile_decode.parse(["int8w=true"])
    assert plain["int8w"] == 0 and quant["int8w"] == 1
    a, b = profile_decode.engine_args(plain), profile_decode.engine_args(quant)
    assert b == a + ["quantization=int8w_serve"]
    assert load_config(b).quantization == "int8w_serve" and load_config(a).quantization == ""


def test_paged_and_int8w_together():
    args = profile_decode.engine_args(profile_decode.parse(["paged=true", "int8w=true",
                                                            "slots=8"]))
    assert "paged_attention=true" in args and args[-1] == "quantization=int8w_serve"
    assert "per_device_batch_size=8" in args


def test_refuses_unknown_option_and_needs_the_card(monkeypatch):
    import torch

    with pytest.raises(SystemExit, match="unknown option"):
        profile_decode.parse(["quant=int8"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        profile_decode.main(["int8w=true"])
