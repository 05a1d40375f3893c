#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card and print its result line.

    python3 benchmark/run.py --workload base-train-b96 --seed 12345 --seconds 30 --trace 0

``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1`` its per-layer ones (a
profiled stretch after the same window). The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, then ``checks``: each compared number beside its limit, which are also the last
lines of standard error). Exits 2 without a result when there is no CUDA card, or fewer
than the cell asks for, and 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One host thread for torch's and the BLAS libraries' pools, set before they load: with the
# default pool of one thread a core, scoring runs fell per process into a mode about 8%
# slower (see PERF.md section 2).
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark.harness.cells import Layout
    from benchmark.harness.runner import check_lines, forbidden_modules, run_cell  # the port

    chips = Layout().cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("\n".join(check_lines(result["checks"])), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
