"""Cells are found by name from their files: the tiny cells, added as new files and entries
only, run end to end on the CPU through the harness (its look for a card skipped)."""

import filecmp
import json

import pytest

from benchmark.harness.cells import REPO
from benchmark.harness.runner import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_adding_a_cell_edits_no_file(tiny):
    """The tiny layout adds files and entries; every file of the benchmark is unchanged."""
    for path in (REPO / "benchmark").rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            twin = tiny.repo / path.relative_to(REPO)
            assert filecmp.cmp(path, twin, shallow=False), path
    old, new = json.loads((REPO / "BENCHMARK.json").read_text()), tiny.spec()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert [e["name"] for e in new[key][:len(old[key])]] == [e["name"] for e in old[key]]
    assert {w["name"] for w in new["workloads"]} - {w["name"] for w in old["workloads"]} == \
        {"tiny-train", "tiny-score"}


@pytest.mark.parametrize("cell, e2e, per_layer", [
    ("tiny-train", {"train_windows_per_s", "setup_s"}, {"train_mfu"}),
    ("tiny-score", {"score_windows_per_s", "score_batch_p95_ms", "setup_s"},
     {"score_mfu", "host_wait_ms.score"})])
@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_runs_from_its_files(tiny, cell, e2e, per_layer, trace):
    result = run_cell(cell, 2 ** 31 + 77, 3.0, trace, device="cpu", layout=tiny)
    assert list(result) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    # readers of device time find nothing to read on the CPU and stay out of the line
    assert set(result["metrics"]) == (per_layer if trace else e2e)
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["checks"]) == set(tiny.cell(cell).check["limits"])
    json.dumps(result, allow_nan=False)
