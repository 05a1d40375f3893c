"""The synthetic-schedule runner end to end: the port's ``experiments.synthetic.run`` vs the
JAX package's, on the CPU.

The ``tests/test_experiments.py`` pattern: a seeded synthetic wfdb directory (6 records of
separable tones; the JAX side preprocesses on its NumPy oracle, ``W2VHS_NO_NATIVE=1``) and a
generated directory (``REFERENCE.csv`` + 1 kHz WAVs, as ``generate_dataset`` writes them),
staged by a schedule JSON: real data, then a combined set of the generated data and a
half-proportion real subsample, then a ``letskip`` stage of generated data. No stage
augments: the lazy host augmentation draws from fresh entropy (``augment_pcg`` with
``rng=None``), so it is random run to run in the JAX runner itself. A tiny encoder with every
dropout and SpecAugment at 0, float32, its JAX init carried across by ``from_jax``. The
record must equal the JAX runner's exactly (settings, skipped stages, fragment and patient
statistics), and the trained parameters sit within 2e-4 / 2e-3 (the bar of
``tests/test_torch_train.py``). Each ``fit``'s reported MCC is forced on both sides: rising
stage by stage (every stage runs), or -1 (no improvement: the ``letskip`` stage is skipped by
both).
"""

import json

import numpy as np
import jax
import pytest
import torch
from scipy.io import wavfile

from wav2vec_heart_sounds_tpu.experiments import synthetic as jax_synthetic
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu_torch.data import wfdb_io
from wav2vec_heart_sounds_tpu_torch.experiments import synthetic as runner
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from torch_vocoder_pairs import one_torch_thread  # noqa: F401

FS_RAW, FS_OUT = 1000, 1000
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)


@pytest.fixture(scope="module")
def schedule_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("synthetic")
    rng = np.random.default_rng(0)
    t = np.arange(6 * FS_RAW) / FS_RAW
    lines = ["patient,abnormality,split"]
    splits = ["train"] * 4 + ["valid", "test"]
    for i in range(6):
        lab = 1 if i % 2 else -1
        pcg = np.sin(2 * np.pi * (90 if lab == 1 else 60) * t) + 0.05 * rng.normal(size=t.size)
        wfdb_io.write_record(str(d / f"a{i:04d}"), pcg[:, None], FS_RAW, sig_names=["PCG"])
        lines.append(f"a{i:04d},{lab},{splits[i]}")
    (d / "split.csv").write_text("\n".join(lines) + "\n")
    gen = d / "gen"
    gen.mkdir()
    rows = ["patient,label,file"]
    for i in range(4):
        wave = np.sin(2 * np.pi * (90 if i % 2 else 60) * t[:4 * FS_RAW])
        wave = wave + 0.1 * rng.normal(size=wave.size)
        wavfile.write(str(gen / f"g{i}_{i}_0.wav"), FS_RAW, (wave / np.abs(wave).max())
                      .astype(np.float32))
        rows.append(f"g{i},{i % 2},g{i}_{i}_0.wav")
    (gen / "REFERENCE.csv").write_text("\n".join(rows) + "\n")
    return d, gen


def _schedule(tmp_path, d, gen, stages) -> str:
    real = {"path": str(d), "split": str(d / "split.csv"), "segment": "", "gen_data": False}
    sched = {
        "test_set": {"data": str(d), "split": str(d / "split.csv"), "segment": ""},
        "valid_set": {"data": str(d), "split": str(d / "split.csv"), "segment": ""},
        "datasets": {
            "real": dict(real, augment_num=0),
            "gen": {"path": str(gen), "split": "", "segment": "", "gen_data": True,
                    "augment_num": 0, "proportion": 1.0},
        },
        "combined_datasets": {"mixed": {"base_sets": ["gen", "real"], "proportion": [1.0, 0.5]}},
        "schedule": stages,
    }
    path = tmp_path / "schedule.json"
    path.write_text(json.dumps(sched))
    return str(path)


@pytest.mark.parametrize("letskip", [False, True])
def test_run_matches_jax_runner(schedule_dirs, tmp_path, monkeypatch, letskip):
    """``letskip``: every ``fit`` reports no improvement; else each reports a higher MCC."""
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    d, gen = schedule_dirs
    stages = [{"key": "real", "epochs": 1}, {"key": "mixed", "epochs": 1},
              {"key": "gen", "epochs": 1, "letskip": True}]
    path = _schedule(tmp_path, d, gen, stages)
    captured, fits = {}, []
    jax_build, jax_trainer_cls = jax_synthetic.build_classifier, jax_synthetic.SupervisedTrainer

    def capture_init(*args, **kwargs):
        model, variables = jax_build(*args, **kwargs)
        captured["init"] = jax.device_get(variables)
        return model, variables

    class JaxTrainer(jax_trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captured["jax_trainer"] = self

        def fit(self, *args, **kwargs):
            fits.append(("jax", kwargs.get("label")))
            super().fit(*args, **kwargs)
            return -1.0 if letskip else float(len(fits))

    class PortTrainer(runner.SupervisedTrainer):
        def fit(self, *args, **kwargs):
            fits.append(("port", kwargs.get("label")))
            super().fit(*args, **kwargs)
            return -1.0 if letskip else float(len(fits))

    port_build = runner.build_classifier

    def port_init(cfg, **kwargs):
        model = port_build(cfg, **kwargs)
        model.load_state_dict(from_jax(captured["init"]["params"]), strict=True)
        captured["port_model"] = model
        return model

    monkeypatch.setattr(jax_synthetic, "build_classifier", capture_init)
    monkeypatch.setattr(jax_synthetic, "SupervisedTrainer", JaxTrainer)
    monkeypatch.setattr(runner, "build_classifier", port_init)
    monkeypatch.setattr(runner, "SupervisedTrainer", PortTrainer)
    kw = dict(fs=FS_OUT, window_s=2.0, random_init=True, batch_size=4, max_batches=2, lr=2e-2,
              run_label="parity")
    theirs = jax_synthetic.run(path, encoder_config=JaxConfig.tiny(**NO_NOISE),
                               results_json=str(tmp_path / "jax.json"), **kw)
    ours = runner.run(path, encoder_config=Wav2Vec2Config.tiny(**NO_NOISE),
                      results_json=str(tmp_path / "port.json"), device="cpu",
                      dtype=torch.float32, **kw)
    assert ours.keys() == theirs.keys()
    assert ours == theirs                               # settings, skips and both statistics
    assert ours["skipped_stages"] == (["gen"] if letskip else [])
    labels = ["[real]", "[mixed]"] + ([] if letskip else ["[gen]"])
    assert fits == [("jax", s) for s in labels] + [("port", s) for s in labels]
    assert json.loads((tmp_path / "port.json").read_text()) == [ours]
    trained = jax.device_get(captured["jax_trainer"].state.params)
    port_params = to_jax(captured["port_model"].state_dict(), trained)
    for path_ in (("head", "dense_0", "kernel"),
                  ("encoder", "feature_projection", "projection", "kernel")):
        a, b = port_params, trained
        for key in path_:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path_))


def test_run_refuses_what_is_not_a_mesh(schedule_dirs, tmp_path):
    d, gen = schedule_dirs
    path = _schedule(tmp_path, d, gen, [{"key": "real", "epochs": 1}])
    with pytest.raises(TypeError, match="parallel.Mesh"):
        runner.run(path, mesh=object(), device="cpu")
