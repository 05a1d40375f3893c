"""The CinC runner end to end: the port's ``experiments.cinc.run`` vs the JAX package's.

On a seeded synthetic wfdb fixture (6 records of clean, separable tones with an ECG
channel, as ``tests/test_experiments.py``): the data builders give identical patient tags,
labels and waveforms (the JAX side on its NumPy oracle, ``W2VHS_NO_NATIVE=1``), host
augmentation copies included, for the synchronised PCG+ECG pair too; ``run(mode="pcg")``
on both wires, and ``run`` in the ``ecg`` and fusion ``pcg_ecg`` modes, augmentation off
and every dropout and SpecAugment at 0, from one initial state (the JAX inits, the fusion
head's too, carried across by ``from_jax`` into the port's models) give a record with the
same keys, the same fragment and patient statistics, and trained parameters within
2e-4 / 2e-3 (the bar of ``tests/test_torch_train.py``). Also: ``read_split`` against
pandas, the trainer's ``batch_transform`` and ``log_dir`` hooks, and the raw wire's refusal
of the ECG modes.
"""

import json

import numpy as np
import jax
import pandas as pd
import pytest
import torch

from wav2vec_heart_sounds_tpu.data import cinc as jax_cinc_data
from wav2vec_heart_sounds_tpu.data import common as jax_common
from wav2vec_heart_sounds_tpu.experiments import cinc as jax_cinc
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.signal import WindowSpec as JaxWindowSpec
from wav2vec_heart_sounds_tpu_torch.augment.pipelines import AugmentConfig
from wav2vec_heart_sounds_tpu_torch.config import WindowSpec
from wav2vec_heart_sounds_tpu_torch.data import cinc, common, wfdb_io
from wav2vec_heart_sounds_tpu_torch.experiments import cinc as runner
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

FS_RAW = 1000
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cinc")
    rng = np.random.default_rng(0)
    t = np.arange(6 * FS_RAW) / FS_RAW
    lines = ["# synthetic CinC split", "patient,abnormality,split,split2"]
    for i in range(6):
        lab = 1 if i % 2 else -1
        pcg = np.sin(2 * np.pi * (90 if lab == 1 else 60) * t) + 0.05 * rng.normal(size=t.size)
        wfdb_io.write_record(str(d / f"a{i:04d}"), np.stack([pcg, np.sin(2 * np.pi * 8 * t)], 1),
                             FS_RAW, sig_names=["PCG", "ECG"])
        split = ["train", "train", "train", "train", "valid", "test"][i]
        lines.append(f"a{i:04d},{lab},{split},{['test', 'train'][i % 2]}")
    (d / "split.csv").write_text("\n".join(lines) + "\n")
    return d


def _same_fragments(ours, theirs):
    assert [(f.patient, f.label) for f in ours] == [(f.patient, f.label) for f in theirs]
    for a, b in zip(ours, theirs):
        assert a.waveform.dtype == b.waveform.dtype
        np.testing.assert_array_equal(a.waveform, b.waveform)


@pytest.mark.parametrize("augment_num,ecg", [(0, False), (2, False), (0, True), (2, True)])
def test_build_fragments_match_jax(fixture_dir, monkeypatch, augment_num, ecg):
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    csv = str(fixture_dir / "split.csv")
    for subset in ("train", "test"):
        kw = dict(fs_out=500, augment_num=augment_num, ecg=ecg)
        ours = cinc.build_fragments(str(fixture_dir), csv, subset, window=WindowSpec(2.0),
                                    rng=np.random.default_rng(4), **kw)
        theirs = jax_cinc_data.build_fragments(str(fixture_dir), csv, subset,
                                               window=JaxWindowSpec(2.0),
                                               rng=np.random.default_rng(4), **kw)
        assert ours and (augment_num == 0 or any("#aug" in f.patient for f in ours))
        assert all(f.waveform.shape == ((1000, 2) if ecg else (1000,)) for f in ours)
        _same_fragments(ours, theirs)


def test_build_raw_fragments_match_jax(fixture_dir):
    csv = str(fixture_dir / "split.csv")
    for fs_wire in (FS_RAW, 500):
        ours = cinc.build_raw_fragments(str(fixture_dir), csv, "train", fs_wire=fs_wire,
                                        window=WindowSpec(2.0))
        theirs = jax_cinc_data.build_raw_fragments(str(fixture_dir), csv, "train",
                                                   fs_wire=fs_wire, window=JaxWindowSpec(2.0))
        _same_fragments(ours, theirs)


def test_read_split_matches_pandas(tmp_path):
    path = tmp_path / "split.csv"
    path.write_text("# header comment\npatient,label,split,split3\n0007,1,train,valid\n"
                    "\n0012,0,valid,train  # trailing note\nb3,-1,test,train\n# the end\n")
    for subset, fold in (("train", 1), ("valid", 1), ("test", 1), ("train", 3),
                         ("valid", 3), ("all", 1)):
        ours = common.read_split(str(path), subset, fold)
        theirs = jax_common.read_split(str(path), subset, fold)
        assert list(ours.columns) == list(theirs.columns)
        assert common.label_column(ours) == jax_common.label_column(theirs) == "label"
        assert [str(p) for p in ours["patient"]] == [str(p) for p in theirs["patient"]]
        assert [common.binary_label(v) for v in ours["label"]] == \
            [jax_common.binary_label(v) for v in theirs["label"]]
        assert len(ours) == len(theirs)
    numeric = tmp_path / "numeric.csv"
    numeric.write_text("patient,abnormality,split\n7,1,train\n12,-1,train\n")
    ours, theirs = common.read_split(str(numeric), "train"), pd.read_csv(numeric, comment="#")
    assert ours["patient"] == theirs["patient"].tolist() == [7, 12]
    with pytest.raises(KeyError):
        common.label_column(common.SplitTable(["patient"], {"patient": []}))


@pytest.mark.parametrize("wire", ["preproc", "raw"])
def test_run_matches_jax_runner(fixture_dir, tmp_path, monkeypatch, wire):
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    captured = {}
    jax_build, jax_trainer_cls = jax_cinc.build_classifier, jax_cinc.SupervisedTrainer

    def capture_init(*args, **kwargs):
        model, variables = jax_build(*args, **kwargs)
        captured["init"] = jax.device_get(variables)    # host copy: the train step donates
        return model, variables

    class CapturingTrainer(jax_trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captured["jax_trainer"] = self

    monkeypatch.setattr(jax_cinc, "build_classifier", capture_init)
    monkeypatch.setattr(jax_cinc, "SupervisedTrainer", CapturingTrainer)
    port_build = runner.build_classifier

    def port_init(cfg, **kwargs):
        model = port_build(cfg, **kwargs)
        model.load_state_dict(from_jax(captured["init"]["params"]), strict=True)
        captured["port_model"] = model
        return model

    monkeypatch.setattr(runner, "build_classifier", port_init)
    kw = dict(mode="pcg", fs=1000 if wire == "preproc" else 2000, window_s=2.0, epochs=2,
              augment=False, random_init=True, batch_size=4, max_batches=2, lr=2e-2,
              wire=wire, fs_wire=500)
    csv = str(fixture_dir / "split.csv")
    theirs = jax_cinc.run(str(fixture_dir), csv, encoder_config=JaxConfig.tiny(**NO_NOISE),
                          results_json=str(tmp_path / "jax.json"), **kw)
    ours = runner.run(str(fixture_dir), csv, encoder_config=Wav2Vec2Config.tiny(**NO_NOISE),
                      results_json=str(tmp_path / "port.json"), device="cpu",
                      dtype=torch.float32, **kw)
    assert ours.keys() == theirs.keys()
    assert ours == theirs                                   # settings and both statistics
    assert json.loads((tmp_path / "port.json").read_text()) == [ours]
    trained = jax.device_get(captured["jax_trainer"].state.params)
    port_params = to_jax(captured["port_model"].state_dict(), trained)
    for path in (("head", "dense_0", "kernel"),
                 ("encoder", "feature_projection", "projection", "kernel")):
        a, b = port_params, trained
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))


@pytest.mark.parametrize("mode", ["ecg", "pcg_ecg"])
def test_run_ecg_modes_match_jax_runner(fixture_dir, tmp_path, monkeypatch, mode):
    """One branch on the ECG channel, and the three trainings of the fusion mode (PCG
    branch, ECG branch, then the two-branch model with every parameter training)."""
    monkeypatch.setenv("W2VHS_NO_NATIVE", "1")
    inits, captured = [], {}
    jax_build, jax_fuse = jax_cinc.build_classifier, jax_cinc.two_branch_pcg_ecg
    jax_trainer_cls = jax_cinc.SupervisedTrainer

    def capture_init(*args, **kwargs):
        model, variables = jax_build(*args, **kwargs)
        inits.append(jax.device_get(variables))
        return model, variables

    def capture_fusion(*args, **kwargs):
        fusion, variables = jax_fuse(*args, **kwargs)
        captured["fusion_init"] = jax.device_get(variables)
        return fusion, variables

    class CapturingTrainer(jax_trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            captured["jax_trainer"] = self                  # the last one: fusion's, if any

    monkeypatch.setattr(jax_cinc, "build_classifier", capture_init)
    monkeypatch.setattr(jax_cinc, "two_branch_pcg_ecg", capture_fusion)
    monkeypatch.setattr(jax_cinc, "SupervisedTrainer", CapturingTrainer)
    port_build, port_fuse, built = runner.build_classifier, runner.two_branch_pcg_ecg, []

    def port_init(cfg, **kwargs):
        model = port_build(cfg, **kwargs)
        model.load_state_dict(from_jax(inits[len(built)]["params"]), strict=True)
        built.append(model)
        captured["port_model"] = model
        return model

    def port_fusion(*args, **kwargs):
        fusion = port_fuse(*args, **kwargs)
        head = from_jax(captured["fusion_init"]["params"])
        fusion.head.load_state_dict({k[len("head."):]: v for k, v in head.items()
                                     if k.startswith("head.")}, strict=True)
        captured["port_model"] = fusion
        return fusion

    monkeypatch.setattr(runner, "build_classifier", port_init)
    monkeypatch.setattr(runner, "two_branch_pcg_ecg", port_fusion)
    kw = dict(mode=mode, fs=500, window_s=2.0, epochs=1, augment=False, random_init=True,
              batch_size=4, max_batches=2, lr=2e-2)
    csv = str(fixture_dir / "split.csv")
    theirs = jax_cinc.run(str(fixture_dir), csv, encoder_config=JaxConfig.tiny(**NO_NOISE),
                          results_json=str(tmp_path / "jax.json"), **kw)
    ours = runner.run(str(fixture_dir), csv, encoder_config=Wav2Vec2Config.tiny(**NO_NOISE),
                      results_json=str(tmp_path / "port.json"), device="cpu",
                      dtype=torch.float32, **kw)
    assert len(built) == len(inits) == (2 if mode == "pcg_ecg" else 1)
    assert ours["topology"] == ("big_rnn:2:wav2vec" if mode == "pcg_ecg" else "wav2vec")
    assert ours == theirs                                   # settings and both statistics
    trained = jax.device_get(captured["jax_trainer"].state.params)
    port_params = to_jax(captured["port_model"].state_dict(), trained)
    paths = [("head", "dense_0", "kernel")]
    prefixes = [("branch_0",), ("branch_1",)] if mode == "pcg_ecg" else [()]
    paths += [p + ("encoder", "feature_projection", "projection", "kernel") for p in prefixes]
    for path in paths:
        a, b = port_params, trained
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))


def test_run_modes_waiting_for_the_fusion_slice(fixture_dir):
    """The fusion slice is in: the ECG modes build the synchronised pair; only the raw
    wire, which carries mono PCG, still refuses them."""
    csv = str(fixture_dir / "split.csv")
    for mode in ("ecg", "pcg_ecg"):
        with pytest.raises(ValueError, match="mono"):
            runner.run(str(fixture_dir), csv, mode=mode, wire="raw", device="cpu")
    pairs = cinc.build_fragments(str(fixture_dir), csv, "train", fs_out=500,
                                 window=WindowSpec(2.0), ecg=True)
    assert pairs and all(f.waveform.shape == (1000, 2) for f in pairs)


def test_trainer_batch_transform_and_scalar_log(tmp_path):
    """The transform sees the dequantised batch, the trainer's generator and the loader's
    replica flags (all ones without them); every epoch's statistics reach ``log_dir``."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig

    model = build_classifier(ClassifierConfig(head_hidden=(8,), random_init=True, fs=1000,
                                              encoder=Wav2Vec2Config.tiny(**NO_NOISE)),
                             device="cpu", train=True)
    calls = []

    def transform(generator, x, row_mask=None):
        calls.append((generator, x.dtype, row_mask.tolist()))
        return x

    rng = np.random.default_rng(0)
    wave = np.round(rng.uniform(-1, 1, size=(4, 1000)) * 32767).astype(np.int16)
    batches = [{"waveform": wave, "label": np.array([0, 1, 0, 1]), "valid": np.ones(4, bool),
                "augmented": np.array([False, True, True, False])},
               {"waveform": wave, "label": np.array([0, 1, 0, 1]), "valid": np.ones(4, bool)}]
    trainer = SupervisedTrainer(model, batch_transform=transform, log=lambda s: None,
                                log_dir=str(tmp_path / "logs"))
    trainer.fit(batches, batches, 1, label="[pcg]")
    assert [(c[0] is trainer.generator, c[1], c[2]) for c in calls] == [
        (True, torch.float32, [0.0, 1.0, 1.0, 0.0]), (True, torch.float32, [1.0] * 4)]
    rows = [json.loads(line) for line in (tmp_path / "logs" / "scalars.jsonl").read_text()
            .splitlines()]
    tags = {r["tag"] for r in rows}
    assert {"pcg/train/mcc", "pcg/train_loss", "pcg/valid/mcc"} <= tags
    assert {r["step"] for r in rows} == {1}


def test_augment_config_is_the_original():
    from wav2vec_heart_sounds_tpu.augment import AugmentConfig as JaxAugmentConfig

    assert AugmentConfig() == AugmentConfig(**vars(JaxAugmentConfig()))
