#!/usr/bin/env python3
"""Every mode of the port's bench at its default window, each run in a process of its own as a
user runs it, repeated in rounds.

    python3 scripts/torch_bench_modes.py [--rounds 3] [--out build/bench_modes.jsonl]

Runs ``python -m wav2vec_heart_sounds_tpu_torch.bench --mode=<mode>`` for bench.py's ten modes
(``gen-train`` is ``gen-train-diffwave``) and the vest with its augmentation on the card
(``W2VHS_VEST_DEVAUG=1``), one after another in each round, so that the rounds of one mode are
spread over the call. Appends each JSON line, with its mode, round and the process's wall
seconds, to ``--out``; prints each line, then each mode's values over the rounds (smallest,
median, largest) with the card's name and power limit. Exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# (label, mode, extra environment)
RUNS = (("train", "train", {}), ("infer", "infer", {}), ("preproc", "preproc", {}),
        ("real", "real", {}), ("vest", "vest", {}),
        ("vest (W2VHS_VEST_DEVAUG=1)", "vest", {"W2VHS_VEST_DEVAUG": "1"}),
        ("fusion", "fusion", {}), ("gen", "gen", {}), ("gen-wavegrad", "gen-wavegrad", {}),
        ("gen-train-diffwave", "gen-train-diffwave", {}),
        ("gen-train-wavegrad", "gen-train-wavegrad", {}))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--out", default=str(ROOT / "build" / "bench_modes.jsonl"))
    args = parser.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    values: dict[str, list[float]] = {label: [] for label, *_ in RUNS}
    units = {}
    for round_ in range(1, args.rounds + 1):
        for label, mode, env in RUNS:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "wav2vec_heart_sounds_tpu_torch.bench",
                                   f"--mode={mode}"], cwd=ROOT, env={**os.environ, **env},
                                  capture_output=True, text=True, timeout=900)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"{label}, round {round_}: exit {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            record = {"label": label, "round": round_, "process_s": round(seconds, 1), **line}
            with out.open("a") as fh:
                fh.write(json.dumps(record) + "\n")
            print(json.dumps(record), flush=True)
            values[label].append(line["value"])
            units[label] = f"{line['unit']} ({line['metric']})"
    print(card)
    for label, got in values.items():
        print(f"[bench modes] {label}: {min(got)} / {float(np.median(got))} / {max(got)} "
              f"{units[label]}, smallest / median / largest of {len(got)} processes on {card}")


if __name__ == "__main__":
    main()
