"""Copy of ``wav2vec_heart_sounds_tpu/reporting.py`` (standard library only), held to the
original by ``tests/test_torch_imports.py``.

Aggregate ablation result JSONs into mean/std tables.

Contract from reference src/mpcg_wav2vec/reporting.py:13-86: per-run records (metrics nested
under ``fragment``/``patient``, or ``mlp``/``svm`` for vest runs) flatten to dotted metric
paths restricted to the paper's metric vocabulary, group by config fields, and render as a
mean±std Markdown table (population std).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

METRIC_KEYS = ("accuracy", "uar", "sensitivity", "specificity", "npv", "precision",
               "f1", "mcc")


def load_results(path: str | Path) -> list[dict]:
    data = json.loads(Path(path).read_text())
    return data if isinstance(data, list) else [data]


def flatten_metrics(record: dict, prefix: str = "") -> dict[str, float]:
    """Numeric metric leaves as dotted paths (e.g. ``patient.mcc``, ``mlp.patient.uar``)."""
    out: dict[str, float] = {}
    for key, value in record.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_metrics(value, prefix=f"{path}."))
        elif key in METRIC_KEYS and isinstance(value, (int, float)):
            out[path] = float(value)
    return out


def group_key(record: dict, group_by: list[str]) -> str:
    parts = [f"{field}={record[field]}" for field in group_by
             if field in record and not isinstance(record[field], dict)]
    return ", ".join(parts) if parts else "all"


def summarize(records: list[dict],
              group_by: list[str] | None = None) -> dict[str, dict[str, tuple]]:
    """``{group: {metric_path: (mean, std, n)}}`` across records (population std)."""
    group_by = group_by or ["run_label"]
    groups: dict[str, dict[str, list[float]]] = {}
    for record in records:
        bucket = groups.setdefault(group_key(record, group_by), {})
        for name, value in flatten_metrics(record).items():
            bucket.setdefault(name, []).append(value)

    return {key: {name: (statistics.fmean(vals),
                         statistics.pstdev(vals) if len(vals) > 1 else 0.0,
                         len(vals))
                  for name, vals in metrics.items()}
            for key, metrics in groups.items()}


def to_markdown(summary: dict, metrics: list[str] | None = None) -> str:
    """Render ``summarize`` output as a Markdown mean±std table."""
    all_metrics = sorted({m for group in summary.values() for m in group})
    if metrics:
        all_metrics = [m for m in all_metrics
                       if any(m == sel or m.endswith("." + sel) for sel in metrics)]
    header = "| condition | n | " + " | ".join(all_metrics) + " |"
    sep = "|" + "---|" * (len(all_metrics) + 2)
    lines = [header, sep]
    for key in sorted(summary):
        n = max((v[2] for v in summary[key].values()), default=0)
        cells = [f"{summary[key][m][0]:.4f}±{summary[key][m][1]:.4f}"
                 if m in summary[key] else "-" for m in all_metrics]
        lines.append(f"| {key} | {n} | " + " | ".join(cells) + " |")
    return "\n".join(lines)
