"""The port's throughput benchmark (``wav2vec_heart_sounds_tpu_torch/bench.py``) against the
root ``bench.py``, on the CPU, in one torch thread.

* ``_raw_batch`` equals ``bench.py``'s bit for bit.
* Each mode's setup: the JAX package's builders, trainers, samplers and preprocessing chain
  (and the port's) are replaced by recorders, so neither side trains or samples; then
  ``bench.py``'s ``run_bench`` and the port's run the same mode and are compared on what
  each hands its package: the classifier or vocoder config, optimizer, learning rate, batch
  size and window, the raw batch and rates, every fragment and label, the loader, the
  augmentation settings, the conditioning, and the warm-up and timed counts (the steps or
  calls done at each of the window's two syncs); the port's line carries ``bench.py``'s keys,
  metric and unit.
* Each mode end to end on ``device="cpu"`` at a tiny size (``Wav2Vec2Config.tiny()``, B = 2,
  1 step; the vocoders at full width and 2 frames): a finite positive ``value`` and the
  port's keys. ``device="cuda"`` without a card raises.
"""

import dataclasses
import importlib.util
import json
import math
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wav2vec_heart_sounds_tpu.models.build as jax_build
import wav2vec_heart_sounds_tpu.models.diffusion as jax_diffusion
import wav2vec_heart_sounds_tpu.models.diffusion.samplers as jax_samplers
import wav2vec_heart_sounds_tpu.signal.jaxproc as jaxproc
import wav2vec_heart_sounds_tpu.train.classifier as jax_classifier
import wav2vec_heart_sounds_tpu.train.generative as jax_generative
import wav2vec_heart_sounds_tpu.utils.aot as jax_aot
from wav2vec_heart_sounds_tpu_torch import bench
from wav2vec_heart_sounds_tpu_torch.experiments import cinc
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from torch_vocoder_pairs import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
jax_bench = importlib.util.module_from_spec(_spec)
_environ = dict(os.environ)            # bench.py sets a compilation-cache default on import
_spec.loader.exec_module(jax_bench)
os.environ.clear()
os.environ.update(_environ)

PORT_KEYS = {"card", "torch", "cuda", "cudnn", "world_size", "cudnn_deterministic",
             "cudnn_benchmark"}


@pytest.mark.parametrize("shape", [(3, 2000, 0.5), (96, 2000, 4.0)])
def test_raw_batch_equals_bench_py(shape):
    ours, theirs = bench._raw_batch(*shape), jax_bench._raw_batch(*shape)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


# --- the setup of each mode, with both packages' workers replaced by recorders ---------------

# The preprocessing chain's stand-in on both sides pads its input to LONG samples, longer
# than any window, so that the crop to the window shows.
LONG = 70_000


class Log:
    """What one side handed its package, in call order."""

    def __init__(self):
        self.builds, self.trainers, self.epochs, self.steps = [], [], [], []
        self.preps, self.samples, self.syncs = [], [], []

    def done(self) -> int:
        """Steps, epoch batches or calls done so far (what a sync waits for)."""
        return (len(self.steps) + sum(m for _, m, _ in self.epochs) + len(self.samples)
                + (len(self.preps) if not self.steps else 0))


def _jax_recorders(monkeypatch, log: Log):
    state = types.SimpleNamespace(params={"w": np.zeros(1)}, loss_params={}, opt_state={})

    class Model:
        def __init__(self, cfg=None):
            self.cfg = cfg

        def apply(self, variables, x):
            return x[:, :2]

        def init(self, key, *args):
            log.builds.append(("init", self.cfg, [np.shape(a) for a in args]))
            return {"params": {"w": np.zeros(1)}}

    def build_classifier(cfg, key, win_len):
        log.builds.append(("classifier", cfg, win_len))
        return Model(), {"params": {"w": np.zeros(1)}}

    def build_two_branch(a, b, key, win_len):
        log.builds.append(("two_branch", (a, b), win_len))
        return Model(), {"params": {"w": np.zeros(1)}}

    class Trainer:
        def __init__(self, model, variables, **kwargs):
            log.trainers.append(kwargs)
            self.state, self.variables, self.device_preprocess = state, variables, None

        def _run_epoch(self, loader, train, max_batches=None):
            log.epochs.append((loader, max_batches, self.device_preprocess))
            return None, 0.5

        def _train_step(self, params, loss_params, opt_state, waves, labels, valid, lr, key):
            log.steps.append((np.shape(waves), np.asarray(labels), np.asarray(valid),
                              float(lr)))
            return params, loss_params, opt_state, jnp.float32(0.5), None

    class GenTrainer:
        def __init__(self, model, variables, loss_fn, model_dir, **kwargs):
            log.trainers.append({"loss": loss_fn.__name__, **kwargs})
            self.params = {"w": np.zeros(1)}

        def train_step(self, batch):
            log.steps.append(batch)

    def head(x, fs_in, fs):
        log.preps.append((np.asarray(x), fs_in, fs))
        return x

    def tail(x, fs):
        return jnp.pad(x, ((0, 0), (0, LONG - x.shape[1])))

    def preprocess_pcg(x, fs_in, fs):
        log.preps.append((None, fs_in, fs))
        return tail(x, fs)

    def sampler(model, variables, con, labels, key, **kwargs):
        log.samples.append((np.asarray(con), np.asarray(labels), kwargs))
        n = model.cfg.hop_length * con.shape[-1]
        return jnp.zeros((con.shape[0], n)), model.cfg.sample_rate

    def device_get(x):
        log.syncs.append((log.done(), [np.shape(a) for a in jax.tree_util.tree_leaves(x)]))
        return jax.tree_util.tree_map(np.asarray, x)

    for module, name, value in (
            (jax_build, "build_classifier", build_classifier),
            (jax_build, "build_two_branch", build_two_branch),
            (jax_classifier, "SupervisedTrainer", Trainer),
            (jax_generative, "GenerativeTrainer", GenTrainer),
            (jax_diffusion, "DiffWave", Model), (jax_diffusion, "WaveGrad", Model),
            (jax_samplers, "diffwave_sample", sampler),
            (jax_samplers, "wavegrad_sample", sampler),
            (jaxproc, "_pcg_head", head), (jaxproc, "_pcg_tail", tail),
            (jaxproc, "preprocess_pcg", preprocess_pcg),
            (jax_aot, "aot_jit", lambda fn, **kw: fn), (jax, "device_get", device_get)):
        monkeypatch.setattr(module, name, value)
    monkeypatch.setenv("W2VHS_AOT", "0")


class _Stub(torch.nn.Module):
    def __init__(self, cfg=None):
        super().__init__()
        self.config = cfg
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x, *args, **kwargs):
        return x[:, :2]


def _port_recorders(monkeypatch, log: Log):
    class Trainer:
        def __init__(self, model, **kwargs):
            log.trainers.append(kwargs)
            self.device_preprocess = kwargs.get("device_preprocess")

        def _run_epoch(self, loader, train, max_batches=None):
            log.epochs.append((loader, max_batches, self.device_preprocess))
            return None, 0.5

        def _train_step(self, x, labels, valid, lr, aug=None):
            log.steps.append((tuple(x.shape), labels.numpy(), valid.numpy(), float(lr)))
            return torch.tensor(0.5), None

    class GenTrainer:
        def __init__(self, model, loss_fn, model_dir, **kwargs):
            log.trainers.append({"loss": loss_fn.__name__, **kwargs})

        def train_step(self, batch):
            log.steps.append(batch)
            return 0.5

    def build_classifier(cfg, seed=0, device="cuda", dtype=torch.float32, train=False):
        log.builds.append(("classifier", cfg, None))
        return _Stub(cfg)

    def build_two_branch(a, b, seed=0, device="cuda", dtype=torch.float32, train=False):
        log.builds.append(("two_branch", (a, b), None))
        return _Stub()

    def build_vocoder(cfg, seed=0, device="cuda"):
        log.builds.append(("init", cfg, None))
        return _Stub(cfg)

    def device_prep(fs_wire, fs, win_len, device):
        prep = real_prep(fs_wire, fs, win_len, device)

        def recorded(x):
            log.preps.append((np.asarray(torch.as_tensor(x)), fs_wire, fs, win_len))
            return prep(x)

        return recorded

    def sampler(model, con, labels, generator, **kwargs):
        log.samples.append((con.numpy(), labels.numpy(), kwargs))
        return torch.zeros(con.shape[0], model.config.hop_length * con.shape[-1]), 4000

    real_prep = cinc._device_prep
    for name, value in (("SupervisedTrainer", Trainer), ("GenerativeTrainer", GenTrainer),
                        ("build_classifier", build_classifier),
                        ("build_two_branch", build_two_branch),
                        ("build_diffwave", build_vocoder), ("build_wavegrad", build_vocoder),
                        ("_device_prep", device_prep), ("diffwave_sample", sampler),
                        ("wavegrad_sample", sampler),
                        ("_sync", lambda device, mesh=None: log.syncs.append(log.done()))):
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setattr(cinc, "preprocess_pcg",
                        lambda x, fs_wire, fs: torch.nn.functional.pad(x, (0, LONG - x.shape[1])))


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_classifier_config(theirs, ours):
    a, b = _fields(theirs), _fields(ours)
    enc_a, enc_b = _fields(a.pop("encoder")), _fields(b.pop("encoder"))
    assert a == b
    assert ours.encoder == Wav2Vec2Config()                 # wav2vec2-base on the K4 route
    assert {k: v for k, v in enc_a.items() if k in enc_b} == \
        {k: v for k, v in enc_b.items() if k in enc_a}


def _same_loader(theirs, ours):
    for key in ("batch_size", "train", "seed", "target_len", "wire_int16"):
        assert getattr(ours, key) == getattr(theirs, key), key
    a, b = theirs.dataset, ours.dataset
    assert a.fs == b.fs and len(a.fragments) == len(b.fragments)
    for fa, fb in zip(a.fragments, b.fragments):
        assert fa.waveform.dtype == fb.waveform.dtype
        assert fa.waveform.tobytes() == fb.waveform.tobytes()
        assert (fa.label, fa.patient) == (fb.label, fb.patient)
    assert np.array_equal(a.src, b.src) and np.array_equal(a.is_augmented, b.is_augmented)
    if a.augment_fn is None:
        assert b.augment_fn is None
    else:
        ka, kb = dict(a.augment_fn.keywords), dict(b.augment_fn.keywords)
        assert a.augment_fn.func.__name__ == b.augment_fn.func.__name__
        assert dataclasses.asdict(ka.pop("cfg")) == dataclasses.asdict(kb.pop("cfg"))
        assert ka == kb


def _same_line(theirs: dict, ours: dict):
    assert (ours["metric"], ours["unit"]) == (theirs["metric"], theirs["unit"])
    assert set(theirs) <= set(ours) and PORT_KEYS <= set(ours)
    assert ours["vs_baseline"] is None and ours["backend"] == "cpu"
    for key in set(theirs) - {"value", "vs_baseline", "backend", "final_fetch"}:
        assert ours[key] == theirs[key], key


def _run_both(monkeypatch, run_jax, run_port):
    theirs, ours = Log(), Log()
    _jax_recorders(monkeypatch, theirs)
    jax_line = run_jax()
    _port_recorders(monkeypatch, ours)
    port_line = run_port()
    _same_line(jax_line, port_line)
    return theirs, ours


STEPS = 2


@pytest.mark.parametrize("mode", ["train", "infer", "preproc"])
def test_classifier_modes_set_up_as_bench_py(monkeypatch, mode):
    theirs, ours = _run_both(
        monkeypatch, lambda: jax_bench.run_bench(mode=mode, steps=STEPS),
        lambda: bench.run_bench(mode=mode, steps=STEPS, device="cpu",
                                **bench.environment_options()))
    win_len = 16000 * 4
    # the raw batch and the chain's rates, once a step (bench.py perturbs it by 1e-6)
    assert len(theirs.preps) == len(ours.preps) == 3 + STEPS
    for (x, fs_in, fs), (y, fs_wire, fs_, n) in zip(theirs.preps, ours.preps):
        assert (fs_in, fs) == (fs_wire, fs_) == (2000, 16000) and n == win_len
        np.testing.assert_allclose(x, y, rtol=2e-6, atol=0)
    # warm-up and timed window: the steps done at each of the two syncs
    assert [done for done, _ in theirs.syncs] == ours.syncs == [3, 3 + STEPS]
    if mode == "preproc":
        assert theirs.syncs[-1][1] == [(96, win_len)]
        assert not ours.builds and not ours.trainers
        return
    (_, jcfg, jwin), = theirs.builds
    (_, cfg, _), = ours.builds
    assert jwin == win_len
    _same_classifier_config(jcfg, cfg)
    if mode == "train":
        (jkw,), (kw,) = theirs.trainers, ours.trainers
        assert (kw["optimizer_name"], kw["lr"]) == (jkw["optimizer_name"], jkw["lr"]) == \
            ("sgd", 1e-3)
        _same_classifier_config(jkw["classifier_config"], kw["classifier_config"])
        for (shape, y, valid, lr), (shape_, y_, valid_, lr_) in zip(theirs.steps, ours.steps,
                                                                    strict=True):
            assert shape == shape_ == (96, win_len)
            assert lr_ == 1e-3 and np.float32(lr) == np.float32(lr_)     # bench.py's is f32
            assert np.array_equal(y, y_) and np.array_equal(valid, valid_)


@pytest.mark.parametrize("wire", ["raw", "16k"])
def test_real_mode_sets_up_as_bench_py(monkeypatch, wire):
    if wire == "16k":
        monkeypatch.setenv("W2VHS_REAL_WIRE", "16k")
    theirs, ours = _run_both(
        monkeypatch, lambda: jax_bench.run_bench(mode="real", steps=STEPS),
        lambda: bench.run_bench(mode="real", steps=STEPS, device="cpu",
                                **bench.environment_options()))
    _same_classifier_config(theirs.builds[0][1], ours.builds[0][1])
    (jkw,), (kw,) = theirs.trainers, ours.trainers
    assert (kw["optimizer_name"], kw["lr"]) == (jkw["optimizer_name"], jkw["lr"])
    assert [m for _, m, _ in theirs.epochs] == [m for _, m, _ in ours.epochs] == [3, STEPS]
    for (jloader, _, jprep), (loader, _, prep) in zip(theirs.epochs, ours.epochs):
        _same_loader(jloader, loader)
        assert len(loader) == STEPS + 4            # bench.py's cover of the whole run
        if wire == "16k":
            assert jprep is None and prep is None
        else:                                      # dequantise, the chain's rates, crop
            wire_batch = (np.arange(2 * 8000).reshape(2, 8000) % 65535 - 32767).astype(np.int16)
            want = np.asarray(jprep(jnp.asarray(wire_batch)))
            got = prep(torch.as_tensor(wire_batch)).numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert theirs.preps[-1][1:] == ours.preps[-1][1:3] == (2000, 16000)


@pytest.mark.parametrize("env", [{}, {"W2VHS_VEST_DEVAUG": "1"},
                                 {"W2VHS_VEST_BATCH": "4", "W2VHS_VEST_STEPS": "3",
                                  "W2VHS_VEST_WINDOW_S": "1.0"}],
                         ids=["host-augment", "device-augment", "resized"])
def test_vest_mode_sets_up_as_bench_py(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    theirs, ours = _run_both(monkeypatch, lambda: jax_bench.run_bench(mode="vest"),
                             lambda: bench.run_bench(mode="vest", device="cpu",
                                                     **bench.environment_options()))
    (_, jcfg, jwin), (_, cfg, _) = theirs.builds[0], ours.builds[0]
    _same_classifier_config(jcfg, cfg)
    (jkw,), (kw,) = theirs.trainers, ours.trainers
    assert (kw["optimizer_name"], kw["lr"]) == (jkw["optimizer_name"], jkw["lr"]) == \
        ("adamw", 1e-4)
    _same_classifier_config(jkw["classifier_config"], kw["classifier_config"])
    if "W2VHS_VEST_DEVAUG" in env:
        jt, t = jkw["batch_transform"], kw["batch_transform"]
        assert jt.func.__name__ == t.func.__name__ == "augment_multi_pcg_batch"
        keywords = dict(jt.keywords)
        assert keywords.pop("cfg") == jax_bench_augment_config()
        assert keywords == t.keywords
    else:
        assert jkw["batch_transform"] is None and kw["batch_transform"] is None
    steps = int(env.get("W2VHS_VEST_STEPS", 6))
    assert [m for _, m, _ in theirs.epochs] == [m for _, m, _ in ours.epochs] == [2, steps]
    for (jloader, *_), (loader, *_) in zip(theirs.epochs, ours.epochs):
        _same_loader(jloader, loader)
        assert loader.target_len == jwin


def jax_bench_augment_config():
    from wav2vec_heart_sounds_tpu.augment import AugmentConfig

    return AugmentConfig()


def test_fusion_mode_sets_up_as_bench_py(monkeypatch):
    theirs, ours = _run_both(monkeypatch, lambda: jax_bench.run_bench(mode="fusion"),
                             lambda: bench.run_bench(mode="fusion", device="cpu"))
    (_, (ja, jb), jwin), (_, (a, b), _) = theirs.builds[0], ours.builds[0]
    _same_classifier_config(ja, a)
    _same_classifier_config(jb, b)
    (jkw,), (kw,) = theirs.trainers, ours.trainers
    assert (kw["optimizer_name"], kw["lr"]) == (jkw["optimizer_name"], jkw["lr"]) == \
        ("adamw", 1e-4)
    assert [m for _, m, _ in theirs.epochs] == [m for _, m, _ in ours.epochs] == [3, 10]
    for (jloader, *_), (loader, *_) in zip(theirs.epochs, ours.epochs):
        _same_loader(jloader, loader)
        assert loader.target_len == jwin == 16500


@pytest.mark.parametrize("mode", ["gen", "gen-wavegrad"])
def test_sampling_modes_set_up_as_bench_py(monkeypatch, mode):
    theirs, ours = _run_both(monkeypatch, lambda: jax_bench.run_bench(mode=mode),
                             lambda: bench.run_bench(mode=mode, device="cpu"))
    (_, jcfg, _), (_, cfg, _) = theirs.builds[0], ours.builds[0]
    assert _fields(jcfg) == _fields(cfg)
    assert len(theirs.samples) == len(ours.samples) == 11
    for (jcon, jy, jkw), (con, y, kw) in zip(theirs.samples, ours.samples):
        assert jcon.tobytes() == con.tobytes() and np.array_equal(jy, y)
        assert jkw == kw
    assert theirs.samples[0][0].shape == ((16, 80, 96) if mode == "gen" else (8, 128, 80))
    assert [done for done, _ in theirs.syncs] == ours.syncs == [1, 11]


@pytest.mark.parametrize("mode", ["gen-train", "gen-train-diffwave", "gen-train-wavegrad"])
def test_vocoder_training_modes_set_up_as_bench_py(monkeypatch, mode):
    theirs, ours = _run_both(monkeypatch, lambda: jax_bench.run_bench(mode=mode),
                             lambda: bench.run_bench(mode=mode, device="cpu"))
    (_, jcfg, _), (_, cfg, _) = theirs.builds[0], ours.builds[0]
    assert _fields(jcfg) == _fields(cfg)
    assert type(cfg).__name__ == ("WaveGradConfig" if mode.endswith("wavegrad")
                                  else "DiffWaveConfig")
    (jkw,), (kw,) = theirs.trainers, ours.trainers
    assert jkw["loss"] == kw["loss"]
    assert len(theirs.steps) == len(ours.steps) == 12
    for jbatch, batch in zip(theirs.steps, ours.steps):
        assert jbatch.keys() == batch.keys()
        for key in jbatch:
            assert jbatch[key].dtype == batch[key].dtype
            assert jbatch[key].tobytes() == batch[key].tobytes()
    assert theirs.steps[0]["con_spec"].shape[0] == 16
    assert [done for done, _ in theirs.syncs] == ours.syncs == [2, 12]


# --- every mode end to end on the CPU at a tiny size --------------------------------------------

TINY = {"encoder": Wav2Vec2Config.tiny()}
RUNS = {
    "train": lambda: bench.run_bench(2, 4000, 1.0, 1, "train", device="cpu", **TINY),
    "infer": lambda: bench.run_bench(2, 4000, 1.0, 1, "infer", device="cpu", **TINY),
    "preproc": lambda: bench.run_bench(2, 4000, 1.0, 1, "preproc", device="cpu", **TINY),
    "real": lambda: bench.run_bench(2, 4000, 1.0, 1, "real", device="cpu", **TINY),
    "real-16k": lambda: bench.run_bench(2, 4000, 1.0, 1, "real", device="cpu", wire="16k",
                                        **TINY),
    "vest": lambda: bench.run_vest_bench(2, 1, 0.25, warm=1, device="cpu", **TINY),
    "vest-device-augment": lambda: bench.run_vest_bench(2, 1, 0.25, warm=1, device_augment=True,
                                                        device="cpu", **TINY),
    "fusion": lambda: bench.run_fusion_bench(2, 1, 0.5, warm=1, device="cpu", **TINY),
    "gen": lambda: bench.run_gen_bench(2, 1, 2, device="cpu"),
    "gen-wavegrad": lambda: bench.run_wavegrad_sample_bench(2, 1, frames=2, device="cpu"),
    "gen-train-diffwave": lambda: bench.run_gen_train_bench("diffwave", 2, 1, 2, device="cpu"),
    "gen-train-wavegrad": lambda: bench.run_gen_train_bench("wavegrad", 2, 1, 2, device="cpu"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_each_mode_runs_on_the_cpu(run):
    line = RUNS[run]()
    json.dumps(line)
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert math.isfinite(line["final_fetch"])
    assert PORT_KEYS <= set(line) and line["vs_baseline"] is None
    assert (line["backend"], line["card"], line["world_size"]) == ("cpu", None, 1)
    assert line["cudnn_deterministic"] is False and line["cudnn_benchmark"] is False
    assert line["steps"] == 1 and line["batch_size"] == 2
    assert line["mode"] == run.split("-device")[0].replace("real-16k", "real")


def test_main_prints_one_line(capsys):
    bench.main(["--mode=preproc", "--steps=1", "--batch-size=2", "--device=cpu"])
    line = json.loads(capsys.readouterr().out)
    assert line["metric"] == "pcg_4s_windows_per_sec_per_chip_e2e"
    assert (line["mode"], line["steps"], line["batch_size"]) == ("preproc", 1, 2)
    with pytest.raises(SystemExit):
        bench.main(["--mode=serve"])


@pytest.mark.parametrize("mode", bench.MODES)
def test_cuda_without_a_card_raises(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.run_bench(mode=mode, device="cuda")
