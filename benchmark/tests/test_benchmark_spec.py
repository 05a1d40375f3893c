"""``BENCHMARK.json`` and the cell files against the benchmark's contract."""

import json
import re

import pytest

from benchmark.harness.cells import REPO, Layout

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|dim|rank|expansion|experts_per)")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path
        assert (REPO / path).is_dir()
    for word in SPEC["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (REPO / word).is_file()
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_their_files():
    names = [c["name"] for c in SPEC["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and NAME.match(c["file"].split("/")[-1])
        spec = json.loads((REPO / c["file"]).read_text())
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


def test_workloads_and_their_files():
    pairs = set()
    layout = Layout()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = layout.cell(w["name"])
        assert (cell.config_name, cell.traffic_name, cell.chips, cell.why) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    names = list(e2e) + [m["name"] for m in SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    perf_layers = (REPO / "PERF.md").read_text().split("## 3. Layers", 1)[1].split("\n## ", 1)[0]
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert f"\n| {m['layer']} |" in perf_layers, m["layer"]     # PERF.md's name of it
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_has_limits_for_what_it_compares(cell):
    c = Layout().cell(cell)
    assert c.traffic["kind"] in ("train_loop", "score_passes")
    assert all(isinstance(v, (int, float)) for v in c.check["limits"].values())
