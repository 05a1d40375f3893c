"""The port stands alone: no JAX, flax, optax, pandas, click, transformers, safetensors or
JAX-package import anywhere in it or in ``chip_smoke.py`` (with them blocked it imports, trains, also through a one-rank gloo mesh, samples and runs
``make-splits`` and ``summarize`` through its CLI), and its numpy copies of the JAX package's host layers give identical
results."""

import ast
import importlib
import inspect
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from wav2vec_heart_sounds_tpu import config as jax_config
from wav2vec_heart_sounds_tpu.data import labels as jax_labels
from wav2vec_heart_sounds_tpu.data import loader as jax_loader
from wav2vec_heart_sounds_tpu.data.fragments import Fragment as JaxFragment
from wav2vec_heart_sounds_tpu.data.fragments import FragmentDataset as JaxDataset
from wav2vec_heart_sounds_tpu.data import cinc as jax_data_cinc
from wav2vec_heart_sounds_tpu.data import common as jax_data_common
from wav2vec_heart_sounds_tpu.data import generated as jax_generated
from wav2vec_heart_sounds_tpu.data import generative as jax_generative_data
from wav2vec_heart_sounds_tpu.data import vest as jax_vest
from wav2vec_heart_sounds_tpu.experiments import synthetic as jax_synthetic
from wav2vec_heart_sounds_tpu.models import registry as jax_registry
from wav2vec_heart_sounds_tpu.models.diffusion import diffwave as jax_diffwave
from wav2vec_heart_sounds_tpu.models.diffusion import samplers as jax_samplers
from wav2vec_heart_sounds_tpu.models.diffusion import schedules as jax_schedules
from wav2vec_heart_sounds_tpu.models.diffusion import wavegrad as jax_wavegrad
from wav2vec_heart_sounds_tpu.train import generative as jax_generative
from wav2vec_heart_sounds_tpu.experiments import common as jax_common
from wav2vec_heart_sounds_tpu.utils import observe as jax_observe
from wav2vec_heart_sounds_tpu import native as jax_native
from wav2vec_heart_sounds_tpu.data import splits as jax_splits
from wav2vec_heart_sounds_tpu.signal import filters as jax_filters
from wav2vec_heart_sounds_tpu.train.metrics import ConfusionMatrix as JaxConfusionMatrix
from wav2vec_heart_sounds_tpu_torch import config
from wav2vec_heart_sounds_tpu_torch.data import cinc as data_cinc
from wav2vec_heart_sounds_tpu_torch.data import common as data_common
from wav2vec_heart_sounds_tpu_torch.data import generated
from wav2vec_heart_sounds_tpu_torch.data import generative as generative_data
from wav2vec_heart_sounds_tpu_torch.data import vest
from wav2vec_heart_sounds_tpu_torch.data import loader
from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment, FragmentDataset
from wav2vec_heart_sounds_tpu_torch.experiments import common, synthetic
from wav2vec_heart_sounds_tpu_torch.models import registry
from wav2vec_heart_sounds_tpu_torch.models.diffusion import diffwave, samplers, schedules, wavegrad
from wav2vec_heart_sounds_tpu_torch.ops.kernels import build
from wav2vec_heart_sounds_tpu_torch.train import generative
from wav2vec_heart_sounds_tpu_torch.train.metrics import ConfusionMatrix
from wav2vec_heart_sounds_tpu_torch.utils import observe
from wav2vec_heart_sounds_tpu_torch import native
from wav2vec_heart_sounds_tpu_torch.data import splits

# the JAX package's signal/__init__ re-exports a function named ``segment``
jax_segment = importlib.import_module("wav2vec_heart_sounds_tpu.signal.segment")
segment = importlib.import_module("wav2vec_heart_sounds_tpu_torch.signal.segment")

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "wav2vec_heart_sounds_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "pandas", "click", "transformers", "safetensors",
           "wav2vec_heart_sounds_tpu")

_ISOLATED = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np, torch
import wav2vec_heart_sounds_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.signal.torchproc import preprocess_pcg
model = build_classifier(ClassifierConfig(head_hidden=(8,), encoder=Wav2Vec2Config.tiny()),
                         device="cpu")
x = preprocess_pcg(torch.randn(2, 1000), 2000, 4000)
with torch.inference_mode():
    logits = model(x)
assert logits.shape == (2, 2) and bool(torch.isfinite(logits).all())
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
trained = build_classifier(ClassifierConfig(head_hidden=(8,), encoder=Wav2Vec2Config.tiny()),
                           device="cpu", train=True)
batch = {{"waveform": np.random.default_rng(0).normal(size=(2, 1000)).astype(np.float32),
         "label": np.array([0, 1]), "valid": np.ones(2, bool)}}
SupervisedTrainer(trained, log=lambda s: None).fit([batch], [batch], 1)
import os, tempfile
import torch.distributed as dist
from wav2vec_heart_sounds_tpu_torch.parallel import data_parallel_mesh
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1)
    try:
        mesh = data_parallel_mesh(device="cpu")
        assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
        SupervisedTrainer(trained, mesh=mesh, log=lambda s: None).fit([batch], [batch], 1)
    finally:
        dist.destroy_process_group()
vest_cfg = ClassifierConfig(num_channels=3, lora=True, head_hidden=(8,), fs=1000,
                            encoder=Wav2Vec2Config.tiny())
vest_model = build_classifier(vest_cfg, device="cpu", train=True)
vest_batch = {{"waveform": np.random.default_rng(1).normal(size=(2, 600, 3)).astype(np.float32),
              "label": np.array([0, 1]), "valid": np.ones(2, bool)}}
SupervisedTrainer(vest_model, optimizer_name="adamw", classifier_config=vest_cfg,
                  log=lambda s: None).fit([vest_batch], [vest_batch], 1)
from wav2vec_heart_sounds_tpu_torch.models.build import build_two_branch
gated = Wav2Vec2Config.tiny(conv_dim=(128, 128), qkv_fuse=False, conv_fuse=True)
branch = ClassifierConfig(head_hidden=(8,), encoder=gated)
fusion = build_two_branch(branch, branch, device="cpu", train=True)
pair = {{"waveform": np.random.default_rng(2).normal(size=(2, 1000, 2)).astype(np.float32),
        "label": np.array([0, 1]), "valid": np.ones(2, bool)}}
SupervisedTrainer(fusion, optimizer_name="adamw", log=lambda s: None).fit([pair], [pair], 1)
import tempfile
from wav2vec_heart_sounds_tpu_torch.experiments import synthetic
from wav2vec_heart_sounds_tpu_torch.models.diffusion import (DiffWaveConfig, build_diffwave,
                                                             diffwave_sample)
from wav2vec_heart_sounds_tpu_torch.models.registry import get_spec
from wav2vec_heart_sounds_tpu_torch.train.generate import generate_dataset
from wav2vec_heart_sounds_tpu_torch.train.generative import GenerativeTrainer, diffwave_loss
vocoder = build_diffwave(DiffWaveConfig(residual_layers=2, residual_channels=8, n_mels=16,
                                        hop_length=64, step_hidden=32), device="cpu")
gen_rng = np.random.default_rng(3)
gen_batch = {{"ref_audio": gen_rng.normal(size=(2, 256)).astype(np.float32),
             "con_spec": gen_rng.uniform(size=(2, 16, 4)).astype(np.float32),
             "label": np.array([0, 1], np.int32)}}
with tempfile.TemporaryDirectory() as tmp:
    gen_trainer = GenerativeTrainer(vocoder, diffwave_loss, tmp, log=lambda s: None)
    assert np.isfinite(gen_trainer.train_step(gen_batch)) and gen_trainer.step == 1
    items = [{{"con_spec": gen_batch["con_spec"][0], "label": 1, "patient": "g"}}]
    generate_dataset(vocoder, get_spec("diffwave"), items, tmp)
audio, sr = diffwave_sample(vocoder, gen_batch["con_spec"], 0, torch.Generator())
assert audio.shape == (2, 256) and sr == 4000 and callable(synthetic.run)
import contextlib, io, json, os
from wav2vec_heart_sounds_tpu_torch import cli
with tempfile.TemporaryDirectory() as tmp:
    with open(os.path.join(tmp, "REFERENCE.csv"), "w") as fh:
        fh.write("".join(f"r{{i}},{{1 if i % 3 else -1}}\\n" for i in range(12)))
    results = os.path.join(tmp, "results.json")
    with open(results, "w") as fh:
        json.dump([{{"run_label": "x", "patient": {{"mcc": 0.5}}}}], fh)
    echo = io.StringIO()
    with contextlib.redirect_stdout(echo):
        cli.main(["make-splits", "--data-dir", tmp, "--out", os.path.join(tmp, "s.csv")])
        cli.main(["summarize", results])
    assert "Wrote 12 records x 5 fold(s)" in echo.getvalue(), echo.getvalue()
    assert "| run_label=x | 1 | 0.5000±0.0000 |" in echo.getvalue(), echo.getvalue()
print("PORT_OK", sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r}
                        and sys.modules[m] is not None))
"""


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PORT_OK []" in proc.stdout


def test_port_sources_import_no_blocked_module():
    for path in [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


def test_constants_match_originals():
    assert config.PCG_BAND == jax_filters.PCG_BAND
    assert config.ECG_BAND == jax_filters.ECG_BAND
    assert config.WIRE_SCALE == jax_loader.WIRE_SCALE
    assert config.CLASSIFY_FS_CINC == jax_config.CLASSIFY_FS_CINC
    assert config.CLASSIFY_FS_DEFAULT == jax_config.CLASSIFY_FS_DEFAULT
    assert set(config.WINDOWS) == set(jax_config.WINDOWS)
    for name, spec in jax_config.WINDOWS.items():
        ours = config.WINDOWS[name]
        assert (ours.window_s, ours.overlap_s, ours.start_pad_s) == \
            (spec.window_s, spec.overlap_s, spec.start_pad_s)
        for fs in (2000, 4125, 16000):
            assert ours.window_len(fs) == spec.window_len(fs)


def _fragments(n=11, length=50, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=length).astype(np.float32), int(rng.integers(0, 2)), f"p{i % 4}")
            for i in range(n)]


@pytest.mark.parametrize("train,wire_int16,target_len", [
    (False, False, None), (False, True, 64), (True, False, None), (True, True, 40)])
def test_batcher_matches_original(train, wire_int16, target_len):
    frags = _fragments()
    ours = loader.Batcher(FragmentDataset([Fragment(*f) for f in frags], fs=1000), 4, train,
                          seed=3, target_len=target_len, wire_int16=wire_int16)
    theirs = jax_loader.Batcher(JaxDataset([JaxFragment(*f) for f in frags], fs=1000), 4,
                                train, seed=3, target_len=target_len, wire_int16=wire_int16)
    assert len(ours) == len(theirs)
    for _ in range(2):                                   # two epochs: reseeded bootstrap
        batches = list(zip(ours, theirs, strict=True))
        for a, b in batches:
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], np.ndarray):
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])
                else:
                    assert a[key] == b[key]


def test_pad_batch_and_balance_weights_match_originals():
    waves = [np.ones(3, np.float32), np.arange(5, dtype=np.float32)]
    for target in (None, 4, 7):
        np.testing.assert_array_equal(loader.pad_batch(waves, target),
                                      jax_loader.pad_batch(waves, target))
    labels = [0, 1, 1, 1, 0, 1]
    np.testing.assert_array_equal(loader.balance_weights(labels),
                                  jax_labels.balance_weights(labels))


def test_confusion_matrix_matches_original():
    rng = np.random.default_rng(1)
    ours, theirs = ConfusionMatrix(), JaxConfusionMatrix()
    for _ in range(3):
        t, p = rng.integers(0, 2, 17), rng.integers(0, 2, 17)
        valid = rng.random(17) > 0.2
        ours.update(t, p, valid)
        theirs.update(t, p, valid)
    np.testing.assert_array_equal(ours.m, theirs.m)
    assert ours.stats() == theirs.stats()
    assert str(ours) == str(theirs)


def test_kernel_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("attention_qkv_fwd")
    assert not (tmp_path / "build").exists()


def _code(fn) -> str:
    """The function's AST without its docstring (comments are not in the AST)."""
    node = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    if ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    return ast.dump(node)


@pytest.mark.parametrize("ours,theirs", [
    (loader.prefetch_threaded, jax_loader.prefetch_threaded),
    (common.make_loader, jax_common.make_loader),
    (common.append_result, jax_common.append_result),
    (observe.ScalarLogger, jax_observe.ScalarLogger),
    (observe.stopwatch, jax_observe.stopwatch),
    (splits.SplitRatios, jax_splits.SplitRatios),
    (splits.read_cinc_labels, jax_splits.read_cinc_labels),
    (segment.window_starts, jax_segment.window_starts),
    (segment.pad_or_crop, jax_segment.pad_or_crop),
    (segment.segment, jax_segment.segment),
    (config.WindowSpec.hop_len, jax_segment.WindowSpec.hop_len),
    (config.WindowSpec.start_offset, jax_segment.WindowSpec.start_offset),
    (data_common.balanced_copy_counts, jax_data_common.balanced_copy_counts),
    (config.default_window, jax_config.default_window),
    (data_common.binary_label, jax_data_common.binary_label),
    (data_common.progress, jax_data_common.progress),
    (data_cinc.read_record, jax_data_cinc.read_record),
    (data_cinc._variants, jax_data_cinc._variants),
    (data_cinc.pcg_augment, jax_data_cinc.pcg_augment),
    (data_cinc._preprocessed, jax_data_cinc._preprocessed),
    (data_cinc.build_fragments, jax_data_cinc.build_fragments),
    (data_cinc.cinc_dataset, jax_data_cinc.cinc_dataset),
    (data_common.stack_min_length, jax_data_common.stack_min_length),
    (vest.ChannelPlan, jax_vest.ChannelPlan),
    (vest.read_vest_wav, jax_vest.read_vest_wav),
    (vest.patient_files, jax_vest.patient_files),
    (vest.build_fragments, jax_vest.build_fragments),
    (vest.multi_augment, jax_vest.multi_augment),
    (vest.multi_augment_host_residual, jax_vest.multi_augment_host_residual),
    (vest.vest_dataset, jax_vest.vest_dataset),
    *((getattr(ours, name), getattr(theirs, name)) for ours, theirs, names in (
        (generative_data, jax_generative_data, ("GenRecord", "edge_fade", "rearranged_pair",
                                                "framed", "pinned_mel", "GenerativeDataset",
                                                "cinc_generative_dataset")),
        (generated, jax_generated, ("read_manifest", "subsample", "generated_fragments")),
        (schedules, jax_schedules, ("NoiseSchedule", "step_embedding_table")),
        (samplers, jax_samplers, ("align_fast_steps", "_sigmas")),
        (diffwave, jax_diffwave, ("DiffWaveConfig",)),
        (wavegrad, jax_wavegrad, ("WaveGradConfig",)),
        (registry, jax_registry, ("MelRecipe",)),
        (generative, jax_generative, ("GenBatcher",)),
        (synthetic, jax_synthetic, ("subsample_patients", "source_fragments")),
        (native, jax_native, ("available", "_resample_plan", "_band_sos", "resample",
                              "remove_spikes", "_preprocess", "preprocess_pcg",
                              "preprocess_ecg", "preprocess_pcg_batch")))
      for name in names)])
def test_copied_functions_have_the_originals_code(ours, theirs):
    assert _code(ours) == _code(theirs)


def _module_code(module) -> str:
    """The module's AST without its docstring."""
    tree = ast.parse(inspect.getsource(module))
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


COPIED_MODULES = ("data.wfdb_io", "signal.despike", "signal.normalize", "signal.resample",
                  "signal.filters", "signal.preprocess", "augment.pipelines",
                  "augment.primitives", "augment.dsp", "augment.noise_sources", "train.svm",
                  "signal.spectrogram", "data.labels", "data.heart_cycles", "data.schedule",
                  "reporting", "train.params", "signal.envelopes")


@pytest.mark.parametrize("name", COPIED_MODULES)
def test_copied_modules_have_the_originals_code(name):
    ours = importlib.import_module(f"wav2vec_heart_sounds_tpu_torch.{name}")
    theirs = importlib.import_module(f"wav2vec_heart_sounds_tpu.{name}")
    assert _module_code(ours) == _module_code(theirs)


def test_prefetch_threaded_matches_original():
    def fail_at_3():
        for i in range(5):
            if i == 3:
                raise KeyError("worker")
            yield i

    for prefetch in (loader.prefetch_threaded, jax_loader.prefetch_threaded):
        assert list(prefetch(range(7), lambda i: i * i, depth=2)) == [i * i for i in range(7)]
        got = []
        with pytest.raises(KeyError, match="worker"):
            for item in prefetch(fail_at_3()):
                got.append(item)
        assert got == [0, 1, 2]
        before = threading.active_count()
        for i, _ in enumerate(prefetch(range(1000), depth=1)):     # abandoned early
            if i == 2:
                break
        for _ in range(50):                                         # the worker winds down
            if threading.active_count() <= before:
                break
            threading.Event().wait(0.05)
        assert threading.active_count() <= before


@pytest.mark.parametrize("train", [True, False])
def test_make_loader_matches_original(train):
    frags = _fragments(n=9)
    ours = common.make_loader(FragmentDataset([Fragment(*f) for f in frags], fs=1000), 4, train,
                              seed=2, target_len=60)
    theirs = jax_common.make_loader(JaxDataset([JaxFragment(*f) for f in frags], fs=1000), 4,
                                    train, seed=2, target_len=60)
    assert ours.wire_int16 == theirs.wire_int16 == train
    for a, b in zip(ours, theirs, strict=True):
        assert a["waveform"].dtype == b["waveform"].dtype
        np.testing.assert_array_equal(a["waveform"], b["waveform"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_vest_constants_and_ecg_chain_match_originals(monkeypatch):
    """The vest layout constants, and ``ecg_chain`` (the port runs the NumPy oracle; the JAX
    package's with its C++ library off) on the same signal."""
    assert vest.VEST_CHANNEL_MAP == jax_vest.VEST_CHANNEL_MAP
    assert vest.ECG_LEADS == jax_vest.ECG_LEADS
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    x = np.sin(2 * np.pi * 1.3 * np.arange(6000) / 2000) ** 9
    x = x + 0.05 * np.random.default_rng(3).normal(size=x.size)
    np.testing.assert_array_equal(data_common.ecg_chain(x, 2000, 500),
                                  jax_data_common.ecg_chain(x, 2000, 500))


def test_default_window_matches_original():
    for name in (*jax_config.WINDOWS, "physionet", ""):
        ours, theirs = config.default_window(name), jax_config.default_window(name)
        assert (ours.window_s, ours.overlap_s, ours.start_pad_s) == \
            (theirs.window_s, theirs.overlap_s, theirs.start_pad_s)


def test_subjects_and_labels_match_original(tmp_path):
    import pandas as pd

    path = tmp_path / "split.csv"
    path.write_text("# a comment\npatient,diagnosis,split\n7,1,train\na0002,-1,valid\n"
                    "a0003,0,train\n\nb9,1,test  # trailing\n")
    ours = data_common.subjects_and_labels(data_common.read_csv(str(path)))
    theirs = jax_data_common.subjects_and_labels(pd.read_csv(path, comment="#"))
    assert ours == theirs == [("7", 1), ("a0002", 0), ("a0003", 0), ("b9", 1)]
    numeric = tmp_path / "numeric.csv"
    numeric.write_text("patient,label\n1,1\n2,-1\n")
    assert data_common.subjects_and_labels(data_common.read_csv(str(numeric))) == \
        jax_data_common.subjects_and_labels(pd.read_csv(numeric, comment="#"))


def test_prefetch_to_device_matches_original():
    import torch

    frags = _fragments(n=10)
    batches = list(loader.Batcher(FragmentDataset([Fragment(*f) for f in frags], fs=1000), 4,
                                  False, wire_int16=True))
    for size in (1, 2, 5):
        ours = list(loader.prefetch_to_device(iter(batches), size=size, device="cpu"))
        theirs = list(jax_loader.prefetch_to_device(iter(batches), size=size))
        assert len(ours) == len(theirs) == len(batches) == 3
        for a, b, batch in zip(ours, theirs, batches):
            assert list(a) == list(b) == list(batch)
            assert {"waveform", "label", "patient", "valid"} <= set(batch)
            for key, value in batch.items():
                if key not in ("patient", "valid"):
                    assert isinstance(a[key], torch.Tensor) and a[key].device.type == "cpu"
                    np.testing.assert_array_equal(a[key].numpy(), value)
                    np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
                else:                                   # patient ids and valid stay host-side
                    assert a[key] is value and b[key] is value
    assert list(loader.prefetch_to_device(iter([]), device="cpu")) == []
