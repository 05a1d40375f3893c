"""One run of one cell: set-up, the measured window, the traced stretch (``--trace 1``), the
program's release, the reference, and the result line."""

from __future__ import annotations

import math
import sys
import time

import torch

from . import compare
from .cells import Layout
from .score_cell import ScoreCell
from .train_cell import TrainCell

CELL_KINDS = {"train_loop": TrainCell, "score_passes": ScoreCell}
FORBIDDEN = {"jax", "jaxlib", "flax", "wav2vec_heart_sounds_tpu"}


def log(line: str) -> None:
    print(f"[benchmark] {line}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot), compared whole, is JAX's
    or the JAX package's."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def open_cell(layout: Layout, name: str, seed: int, device):
    cell = layout.cell(name)
    return cell, CELL_KINDS[cell.traffic["kind"]](cell, seed, device)


class Run:
    """What the per-layer readers get: the cell, its ``TrainCell`` or ``ScoreCell``
    (configuration, traffic, operation count), the window's observations and the traced
    stretch's summary."""

    def __init__(self, cell, measured, window: dict, summary):
        self.cell, self.measured, self.window, self.trace = cell, measured, window, summary


def device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, layout: Layout | None = None) -> dict:
    """The result line of one run (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``trace`` ``breakdown``, and last ``checks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    layout = layout or Layout()
    device = torch.device(device)
    cell, drv = open_cell(layout, name, seed, device)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    obs = drv.window(seconds)
    log(f"window {obs['seconds']:.3f} s, {obs['batches']} batches"
        + (f", passes {obs['pass_s']} s" if "pass_s" in obs else ""))
    info = device_info(device)
    clock = time.perf_counter()
    summary = drv.stretch(cell.trace["warm"], cell.trace["steps"]) if trace else None
    if trace:
        log(f"traced stretch and its summary {time.perf_counter() - clock:.3f} s")
    values = {**drv.end_to_end(obs), "setup_s": setup_s}
    metrics = {}
    for m in layout.metrics(name, per_layer=trace):
        value = (layout.reader(m["name"])(Run(cell, drv, obs, summary)) if trace
                 else values[m["name"]])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    clock = time.perf_counter()
    readings = drv.readings(drv.reference())
    log(f"reference and comparison {time.perf_counter() - clock:.3f} s; {readings.get('_worst')}")
    correct, checks = compare.verdict(readings, cell.check["limits"])
    result = {"correct": correct and obs["failed"] == 0, "attempted": obs["windows"],
              "failed": obs["failed"], "metrics": metrics, "device": info}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    """One line a compared number: its value beside its limit."""
    def fmt(v):
        return "none" if v is None else (repr(v) if isinstance(v, float) and math.isfinite(v)
                                         else str(v))
    return [f"check {name}: {fmt(c['value'])} (limit {fmt(c['limit'])})"
            for name, c in checks.items()]
