"""``tools/bench_int8w.py`` parses its options, selects its cases by substring
and refuses to run without a card; it needs none to do so."""

import pytest

from maxtext_indextts2_tpu_torch.ops import int8w_matmul as iw
from maxtext_indextts2_tpu_torch.tools import bench_int8w as bench


def test_cases_cover_the_decode_shapes():
    names = [c[0] for c in bench.cases([])]
    for want in ("main_path", "flagship", "flagship_15360x3840", "m1", "m160_verify", "m256",
                 "odd_n_bias"):
        assert want in names
    assert len(set(names)) == len(names)
    for name, m, k, n, bias in bench.cases([]):
        assert 1 <= m <= iw.KERNEL_MAX_ROWS and k > 0 and n > 0, name  # the kernel's rows


@pytest.mark.parametrize("wanted,names", [
    (["flagship_15360"], ["flagship_15360x3840"]),
    (["m1", "m2"], ["m1", "m160_verify", "m256"]),
    (["no_such_case"], []),
])
def test_cases_filter_by_substring(wanted, names):
    assert [c[0] for c in bench.cases(wanted)] == names


def test_options():
    assert bench.parse([]) == dict(tag="", repeats="2", iters="50", cases="")
    assert bench.parse(["tag=change", "iters=10"])["iters"] == "10"
    with pytest.raises(SystemExit, match="unknown option"):
        bench.parse(["splits=4"])


def test_needs_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench.main(["cases=main_path", "repeats=1"])
