"""``tools/bench_grouped_bwd.py`` takes the backward cases of ``ops/smoke.py``
whose routing is a kind (a parent checkout's smoke module has only those)
and refuses what it cannot run; it needs no card to parse its options."""

import pytest

from maxtext_indextts2_tpu_torch.ops import smoke
from maxtext_indextts2_tpu_torch.tools import bench_grouped_bwd as bench


def test_cases_are_the_kind_routed_backward_cases():
    got = bench.cases([])
    assert got == [c for c in smoke.GMM_BWD_CASES if isinstance(c[5], str)]
    assert [c[0] for c in got][0] == "main_path"
    assert all(isinstance(c[5], str) for c in got)


def test_f32_cases_are_the_kind_routed_float32_cases():
    got = bench.f32_cases([])
    assert got == [c for c in smoke.GMM_F32_CASES if isinstance(c[5], str)]
    names = [c[0] for c in got]
    assert names[0] == "qwen3_parity" and "deepseek_train_wi" in names
    assert [c[0] for c in bench.f32_cases(["parity"])] == ["qwen3_parity", "qwen3_parity_wo"]
    assert bench.f32_cases(["tile_edges"]) == []  # its routing gives the groups' rows


@pytest.mark.parametrize("wanted,names", [
    (["mixtral"], ["mixtral_train_wi", "mixtral_train_wo"]),
    (["main_path", "skewed"], ["main_path", "skewed_ragged_rows"]),
    (["tile_edges"], []),  # its routing gives the groups' rows: not timed here
])
def test_cases_filter_by_substring(wanted, names):
    assert [c[0] for c in bench.cases(wanted)] == names


def test_refuses_unknown_option_and_needs_the_card(monkeypatch):
    import torch

    with pytest.raises(SystemExit, match="unknown option"):
        bench.main(["route=dgrad"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench.main(["cases=main_path", "repeats=1"])
