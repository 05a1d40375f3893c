#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size, in one process.

    python3 benchmark/control.py --workload base-train-b96 --seeds 12 --control-seeds 3
    python3 benchmark/control.py --workload base-score-b96 --seeds 12 --control-seeds 3 \
        --seconds 25

For each of ``--seeds`` seeds: the program's sound run (a training cell's set-up with its
checked steps; a scoring cell's set-up and a window of ``--seconds``, long enough for the
checked passes), then the
reference, and the readings of the program against it. For the first ``--control-seeds``
of them also the control's readings (the reference in the precision below the stated one,
:mod:`harness.reference`'s ``fp8``) and, in a training cell, the fault of half of the batch
left out (the reference taking the mean loss over the first half). Prints one JSON line a
run and arm, then for each number the largest program reading (the lower reading), the
smallest control reading and the smallest fault reading. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings_of(name: str, seed: int, seconds: float, control: bool, device="cuda",
                layout=None) -> list[dict]:
    """The program's readings on ``seed``, and with ``control`` the control's and the
    faults' (one dict an arm)."""
    from benchmark.harness.cells import Layout
    from benchmark.harness.runner import open_cell

    layout = layout or Layout()
    cell, drv = open_cell(layout, name, seed, device)
    drv.setup()
    if cell.traffic["kind"] == "score_passes":
        drv.window(seconds)
    drv.release()
    ref = drv.reference()
    rows = [{"arm": "program", "seed": seed, **drv.readings(ref)}]
    if control:
        rows.append({"arm": "control", "seed": seed,
                     **drv.readings(ref, drv.reference(precision="fp8"))})
        if cell.traffic["kind"] == "train_loop":
            half = cell.traffic["batch_size"] // 2
            rows.append({"arm": "half_batch", "seed": seed,
                         **drv.readings(ref, drv.reference(loss_rows=half))})
    return rows


def summary(rows: list[dict]) -> dict:
    """Per number: the largest program reading and the smallest reading of each other arm."""
    out: dict[str, dict] = {}
    for row in rows:
        for key, value in row.items():
            if key in ("arm", "seed") or key.startswith("_"):
                continue
            entry = out.setdefault(key, {})
            pick = max if row["arm"] == "program" else min
            entry[row["arm"]] = value if row["arm"] not in entry else pick(entry[row["arm"]], value)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--seconds", type=float, default=25.0)
    args = parser.parse_args(argv)
    rows = []
    for i in range(args.seeds):
        for row in readings_of(args.workload, args.first_seed + 7919 * i, args.seconds,
                               i < args.control_seeds):
            print(json.dumps(row, default=str), flush=True)
            rows.append(row)
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
