"""The control (the reference in the precision below the stated one) comes out not correct:
at the tiny cells' size on the CPU, and at each real cell's own size on the card (three
seeds; ``python -m pytest benchmark/tests -m card`` on the card machine)."""

import pytest

from benchmark.harness import compare
from benchmark.harness.cells import Layout
from benchmark.control import readings_of

SEEDS = (4_000_000_001, 4_000_000_002, 4_000_000_003)


def arms(rows):
    return {row["arm"]: {k: v for k, v in row.items() if k not in ("arm", "seed")}
            for row in rows}


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-score"])
def test_the_control_fails_and_the_program_passes_on_the_cpu(tiny, cell):
    limits = tiny.cell(cell).check["limits"]
    got = arms(readings_of(cell, SEEDS[0], 3.0, True, device="cpu", layout=tiny))
    assert compare.verdict(got["program"], limits)[0]
    assert not compare.verdict(got["control"], limits)[0]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["base-train-b96", "large-train-b96", "base-score-b96"])
def test_the_control_fails_at_the_cells_size(card, cell):
    limits = Layout().cell(cell).check["limits"]
    for seed in SEEDS:
        got = arms(readings_of(cell, seed, 25.0, True, device=card))
        assert compare.verdict(got["program"], limits)[0], got["program"]
        assert not compare.verdict(got["control"], limits)[0], got["control"]
        if "half_batch" in got:
            assert not compare.verdict(got["half_batch"], limits)[0], got["half_batch"]
