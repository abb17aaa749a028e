"""``tools/bench_grouped_fwd.py`` parses its options, selects its cases by
substring and refuses to run without a card; it needs none to do so."""

import pytest

from maxtext_indextts2_tpu_torch.tools import bench_grouped_fwd as bench


def test_cases_cover_the_forward_targets():
    names = [c[0] for c in bench.cases([])]
    for want in ("qwen3_train_wi", "qwen3_train_wo", "qwen3_prefill_wi", "qwen3_prefill_wo",
                 "mixtral_prefill_wi", "single_rows", "mixtral_decode_wo", "llama4_decode_wo",
                 "main_path"):
        assert want in names
    assert len(set(names)) == len(names)
    for name, rows, groups, k, n, routing in bench.cases([]):
        assert rows > 0 and groups > 0 and k % 8 == 0 and n % 8 == 0, name
        assert isinstance(routing, str) or sum(routing) == rows and len(routing) == groups


def test_int8_cases_cover_the_int8_targets():
    """The ``int8_*`` cases time grouped_matmul_int8: qwen3's decode (the
    main path) and prefill, mixtral's decode, at K and N the kernel takes."""
    int8 = [c for c in bench.cases(["int8_"])]
    names = [c[0] for c in int8]
    for want in ("int8_main_path", "int8_qwen3_decode_wo", "int8_qwen3_prefill_wi",
                 "int8_mixtral_decode_wi"):
        assert want in names
    assert all(k % 16 == 0 and n % 16 == 0 for _, _, _, k, n, _ in int8)
    assert [c[0] for c in bench.cases(["int8_qwen3_prefill"])] == [
        "int8_qwen3_prefill_wi", "int8_qwen3_prefill_wo"]


@pytest.mark.parametrize("wanted,names", [
    (["mixtral"], ["mixtral_prefill_wi", "mixtral_decode_wi", "mixtral_decode_wo",
                   "int8_mixtral_decode_wi", "int8_mixtral_decode_wo"]),
    (["train", "single"], ["qwen3_train_wi", "qwen3_train_wo", "single_rows",
                           "int8_single_rows"]),
    (["no_such_case"], []),
])
def test_cases_filter_by_substring(wanted, names):
    assert [c[0] for c in bench.cases(wanted)] == names


def test_options():
    assert bench.parse([]) == dict(tag="", repeats="2", iters="20", cases="")
    assert bench.parse(["tag=parent", "repeats=3", "cases=a,b"])["cases"] == "a,b"
    with pytest.raises(SystemExit, match="unknown option"):
        bench.parse(["route=fwd"])


def test_needs_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench.main(["cases=main_path", "repeats=1"])
