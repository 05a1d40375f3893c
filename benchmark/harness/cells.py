"""Find a cell's files by name: ``BENCHMARK.json`` at the root of the checkout, and under
``benchmark/`` the cell (``workloads/<cell>.json``), its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``) and each per-layer
metric's reader (``metrics/<metric>.py``, a ``read(run)`` function). A later cell, traffic
mix, configuration or metric is a new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    why: str
    config: dict
    traffic: dict
    check: dict
    trace: dict


class Layout:
    """The benchmark's files under ``repo`` (the checkout's root)."""

    def __init__(self, repo: Path = REPO):
        self.repo = Path(repo)
        self.root = self.repo / "benchmark"

    def spec(self) -> dict:
        return json.loads((self.repo / "BENCHMARK.json").read_text())

    def _json(self, *parts: str) -> dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def cell(self, name: str) -> Cell:
        w = self._json("workloads", f"{name}.json")
        return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                    chips=w["chips"], why=w["why"],
                    config=self._json("configs", f"{w['config']}.json"),
                    traffic=self._json("traffic", f"{w['traffic']}.json"),
                    check=w["check"], trace=w["trace"])

    def metrics(self, name: str, per_layer: bool) -> list[dict]:
        """The metrics of ``BENCHMARK.json`` that cell ``name`` reports: its end-to-end
        ones, or its per-layer ones."""
        entries = self.spec()["per_layer" if per_layer else "end_to_end"]
        return [m for m in entries if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
