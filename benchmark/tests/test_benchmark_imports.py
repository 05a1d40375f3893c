"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole top-level
module names (the port's name begins with the JAX package's); the reference loads nothing
of the port."""

import ast
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmark.harness import runner
from benchmark.harness.cells import REPO

BENCH = REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "wav2vec_heart_sounds_tpu"}
PORT = "wav2vec_heart_sounds_tpu_torch"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def local_imports(path: Path) -> set[Path]:
    """The benchmark's own modules that ``path`` imports relatively (``from .x import``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            mods = [node.module] if node.module else [a.name for a in node.names]
            out |= {path.parent / f"{m}.py" for m in mods if (path.parent / f"{m}.py").exists()}
    return out


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    seen, todo = set(), [BENCH / "harness" / "reference.py"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        assert PORT not in top_level_imports(path), path
        todo += local_imports(path)
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {sorted(FORBIDDEN | {PORT})!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        import benchmark.harness.reference
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.stdout.strip() == "ok", out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("jaxfoo", "flaxen", f"{PORT}.models", "wav2vec_heart_sounds_tpu_x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in runner.forbidden_modules() if m.split(".")[0] not in FORBIDDEN]
    monkeypatch.setitem(sys.modules, "wav2vec_heart_sounds_tpu.cli", object())
    assert "wav2vec_heart_sounds_tpu.cli" in runner.forbidden_modules()


def test_a_run_loads_no_jax(tiny):
    """A run of both tiny cells in a fresh interpreter, then every loaded module."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(REPO)!r}, {str(BENCH / 'tests')!r}]
        from benchmark.harness.cells import Layout
        from benchmark.harness.runner import forbidden_modules, run_cell
        layout = Layout({str(tiny.repo)!r})
        for cell, seconds in (("tiny-train", 0.5), ("tiny-score", 3.0)):
            assert run_cell(cell, 5, seconds, True, device="cpu", layout=layout)["correct"]
        print(json.dumps({{"forbidden": forbidden_modules(),
                          "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert loaded["forbidden"] == []
    assert PORT in loaded["top"] and not FORBIDDEN & set(loaded["top"])


def test_run_gives_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "base-train-b96",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_run_fails_with_the_benchmark_alone(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and the benchmark's files: no program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base-train-b96",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 1 and out.stdout == ""
    assert f"No module named '{PORT}'" in out.stderr
