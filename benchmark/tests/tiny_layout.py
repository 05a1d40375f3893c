"""A copy of the benchmark's files in a temporary checkout, with tiny cells added by new
files only: what the CPU tests run the harness on."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "source": "https://huggingface.co/facebook/wav2vec2-base-960h", "reduced": [],
    "assumed": {"sizes": "tiny widths for CPU tests"},
    "conv_dim": [32, 32], "conv_kernel": [10, 3], "conv_stride": [5, 2], "conv_bias": False,
    "feat_extract_norm": "group", "do_stable_layer_norm": False, "hidden_act": "gelu",
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
    "intermediate_size": 64, "num_conv_pos_embeddings": 16,
    "num_conv_pos_embedding_groups": 2, "layer_norm_eps": 1e-05, "hidden_dropout": 0.1,
    "attention_dropout": 0.1, "activation_dropout": 0.1, "feat_proj_dropout": 0.1,
    "mask_time_prob": 0.05, "mask_time_length": 10, "layerdrop": 0.0,
    "classifier": {"hidden": [16], "num_classes": 2},
    "precision": {"compute": "float32", "master": "float32", "ffn_route": "K4",
                  "attention_route": "K3b", "conv_fuse": False},
}
TINY_LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap_median_leaf": 1e-3,
                         "update_gap_median_leaf": 1e-3, "prep_gap": 5e-4},
               "score": {"prep_gap": 1e-4, "logit_gap": 1e-4, "patient_prob_gap": 1e-4,
                         "verdict_mismatches": 0}}

# four 500 ms frames a 2 s window: one spike a window, in half of them, trips the despike
TINY_SPIKES = {"window_share": 0.5, "per_window": 1}


def _write(path: Path, spec: dict) -> None:
    path.write_text(json.dumps(spec, indent=1) + "\n")


def tiny_layout(tmp: Path) -> Path:
    """``tmp`` as a checkout holding the benchmark's files plus the cells ``tiny-train`` and
    ``tiny-score`` (a configuration, two traffic mixes, two cells: new files and entries)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp / "benchmark"
    _write(bench / "configs" / "tiny.json", TINY_CONFIG)
    train = json.loads((bench / "traffic" / "cinc-train-raw2k.json").read_text())
    train.update(count=64, fs_wire=1000, fs_model=4000, window_s=2.0, batch_size=4)
    train["signal"]["spikes"].update(TINY_SPIKES)
    _write(bench / "traffic" / "tiny-train.json", train)
    score = json.loads((bench / "traffic" / "cinc-score-corpus.json").read_text())
    score.update(count=12, fs_wire=1000, fs_model=4000, batch_size=4,
                 length_s={"median": 5.0, "sigma": 0.5, "min": 2.5, "max": 10.0},
                 window={"window_s": 2.0, "overlap_s": 0.25, "start_pad_s": 0.3})
    score["signal"]["spikes"].update(TINY_SPIKES)
    _write(bench / "traffic" / "tiny-score.json", score)
    _write(bench / "workloads" / "tiny-train.json",
           {"config": "tiny", "traffic": "tiny-train", "chips": 1, "why": "CPU test",
            "trace": {"warm": 1, "steps": 2},
            "check": {"block_rows": 2, "limits": TINY_LIMITS["train"]}})
    _write(bench / "workloads" / "tiny-score.json",
           {"config": "tiny", "traffic": "tiny-score", "chips": 1, "why": "CPU test",
            "trace": {"warm": 1, "steps": 2},
            "check": {"block_rows": 4, "patients_first_pass": 3, "patients_later_pass": 2,
                      "later_pass": 2,
                      "limits": TINY_LIMITS["score"]}})
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": TINY_CONFIG["source"],
                            "file": "benchmark/configs/tiny.json", "reduced": [],
                            "why": "CPU test"})
    for name in ("tiny-train", "tiny-score"):
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                  "why": "CPU test"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        cells = metric.get("workloads")
        if cells is not None:
            kind = "tiny-train" if any("train" in c for c in cells) else "tiny-score"
            cells.append(kind)
    _write(tmp / "BENCHMARK.json", spec)
    return tmp
