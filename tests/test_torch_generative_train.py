"""The port's generative trainer, dataset writer and registry vs the JAX package's, on the CPU.

``GenerativeTrainer``: two steps of the tiny DiffWave (``tests/torch_vocoder_pairs.py``) from
the same weights, the JAX trainer's own draws injected (its key splits), against the JAX
trainer: each loss at 1e-5 relative, then every parameter through ``to_jax`` at 1e-5 absolute
(two Adam steps move a weight by ~2 lr = 2e-3; float32 rounding of the gradient moves the
update far less), and Adam's two moments, each tensor within 1e-4 of its largest element.
Adam's update barely depends on the gradient's scale, but its moments do, so they show the
clip: once on the weights as drawn (every pre-clip global norm below 1.0, no clip) and once
with the output projection five times larger (every norm between 1.0 and 5.0, so the clip at
1.0 acts and the classifier's clip at 5.0 would not). Then the ``weights`` / ``weights-best``
checkpoints with the step, optimizer and validation bookkeeping, the sample WAV and
``scalars.jsonl``, and the non-finite-loss raise. ``GenBatcher`` against the original.
``generate_dataset``'s manifest against the JAX writer's (rows and file names; the audio is
random on both sides and not compared) and its batched tasks. The registry's specs and mel
configs field by field.
"""

import csv
import os

import numpy as np
import jax
import optax
import pytest
import torch
from scipy.io import wavfile

from wav2vec_heart_sounds_tpu.models import registry as jax_registry
from wav2vec_heart_sounds_tpu.models.diffusion import samplers as jax_samplers
from wav2vec_heart_sounds_tpu.train import generate as jax_generate
from wav2vec_heart_sounds_tpu.train import generative as jax_generative
from wav2vec_heart_sounds_tpu_torch.models import registry
from wav2vec_heart_sounds_tpu_torch.models.diffusion import DiffWave, WaveGrad, samplers
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.train import generate, generative
from torch_vocoder_pairs import (FRAMES, TINY, diffwave_pair, jax_draws_diffwave,  # noqa: F401
                                 make_batch, one_torch_thread)


class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _items(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    hop = TINY["hop_length"]
    return [{"ref_audio": (0.5 * rng.normal(size=hop * FRAMES)).astype(np.float32),
             "con_spec": rng.uniform(0, 1, (TINY["n_mels"], FRAMES)).astype(np.float32),
             "label": i % 2, "patient": f"p{i}"} for i in range(n)]


def _adam_moments(opt_state) -> tuple:
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return adam[0].mu, adam[0].nu


def _leaf_pairs(ported: dict, tree: dict):
    """(path, the port's array, the JAX array) for every leaf of the flax tree ``tree``."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        node = ported
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), node, np.asarray(leaf)


@pytest.mark.parametrize("projection_scale,norms_within", [(1.0, (0.0, 1.0)), (5.0, (1.0, 5.0))],
                         ids=["unclipped", "clipped"])
def test_train_step_matches_jax_trainer(tmp_path, projection_scale, norms_within):
    jmodel, params, model = diffwave_pair(TINY)
    params["output_projection"]["kernel"] = params["output_projection"]["kernel"] * projection_scale
    model.load_state_dict(from_jax(params), strict=True)
    theirs = jax_generative.GenerativeTrainer(jmodel, {"params": params},
                                              jax_generative.diffwave_loss,
                                              str(tmp_path / "jax"), lr=1e-3, seed=3,
                                              log=lambda s: None)
    ours = generative.GenerativeTrainer(model, generative.diffwave_loss, str(tmp_path / "port"),
                                        lr=1e-3, seed=3, log=lambda s: None)
    key = jax.random.key(3)                           # the JAX trainer's own key
    for seed in (8, 9):
        batch = make_batch(TINY["n_mels"], TINY["hop_length"], seed=seed)
        key, sub = jax.random.split(key)
        draws = jax_draws_diffwave(sub, batch["ref_audio"].shape, 50)
        want = theirs.train_step(batch)
        got = ours.train_step(batch, draws)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
        assert norms_within[0] < norm < norms_within[1], norm       # the pre-clip global norm
    trained = jax.device_get(theirs.params)
    names = [name for name, _ in model.named_parameters()]
    moments = [dict(zip(names, m)) for m in ours.optimizer.state]
    for path, got, want in _leaf_pairs(to_jax(model.state_dict(), trained), trained):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=path)
    for ours_m, theirs_m in zip(moments, _adam_moments(theirs.opt_state), strict=True):
        for path, got, want in _leaf_pairs(to_jax(ours_m, trained), jax.device_get(theirs_m)):
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), path
    assert ours.step == theirs.step == 2


def test_checkpoints_sample_log_and_nonfinite_raise(tmp_path):
    _, _, model = diffwave_pair(TINY)
    items = _items(4)
    trainer = generative.GenerativeTrainer(
        model, generative.diffwave_loss, str(tmp_path / "model"), lr=1e-3,
        sampler=samplers.diffwave_sample, sample_every=1, log_dir=str(tmp_path / "logs"),
        log=lambda s: None)
    batcher = generative.GenBatcher(_ListDataset(items), batch_size=2, shuffle=True)
    valid = generative.GenBatcher(_ListDataset(items[:2]), batch_size=2, shuffle=False)

    def restored_from(name: str, seed: int):
        _, _, fresh = diffwave_pair(TINY, seed=seed)
        other = generative.GenerativeTrainer(fresh, generative.diffwave_loss,
                                             str(tmp_path / f"from-{name}"), log=lambda s: None)
        assert other.restore(str(tmp_path / "model" / f"{name}.pt"))
        return other

    trainer.train(batcher, epochs=1, valid_batcher=valid)      # the first best: weights-best
    best = restored_from("weights-best", 5)
    assert best.step == trainer.step == 2 and trainer.best_valid < float("inf")
    for key, value in model.state_dict().items():
        assert torch.equal(best.model.state_dict()[key], value), key
    trainer.train(batcher, epochs=1, valid_batcher=valid)
    assert trainer.step == 4
    sr, wave = wavfile.read(tmp_path / "logs" / "sample_e1.wav")
    assert sr == 4000 and wave.shape == (TINY["hop_length"] * FRAMES,)
    assert np.isclose(np.abs(wave).max(), 1.0)
    tags = [line.split('"tag": "')[1].split('"')[0]
            for line in (tmp_path / "logs" / "scalars.jsonl").read_text().splitlines()]
    assert tags == ["gen/train_L1", "gen/valid_L1"] * 2

    restored = restored_from("weights", 6)
    assert not restored.restore(str(tmp_path / "model" / "missing.pt"))
    assert restored.step == trainer.step
    for key, value in model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[key], value), key
    saved, loaded = trainer.optimizer.state_dict(), restored.optimizer.state_dict()
    assert loaded["count"] == saved["count"] == 4
    for a, b in zip([*saved["master"], *saved["state"][0], *saved["state"][1]],
                    [*loaded["master"], *loaded["state"][0], *loaded["state"][1]]):
        assert torch.equal(a, b)

    bad = make_batch(TINY["n_mels"], TINY["hop_length"])
    bad["ref_audio"][0, 0] = np.nan
    bad_items = [{"ref_audio": bad["ref_audio"][i], "con_spec": bad["con_spec"][i],
                  "label": int(bad["label"][i]), "patient": f"b{i}"} for i in range(2)]
    with pytest.raises(RuntimeError, match="non-finite loss at step 5"):
        trainer.train(generative.GenBatcher(_ListDataset(bad_items), 2, shuffle=False), 1)


def test_gen_batcher_matches_original():
    items = _items(7, seed=1)
    for batch_size, shuffle in ((3, True), (2, False), (9, True)):
        ours = generative.GenBatcher(_ListDataset(items), batch_size, shuffle, seed=4)
        theirs = jax_generative.GenBatcher(_ListDataset(items), batch_size, shuffle, seed=4)
        assert len(ours) == len(theirs)
        for _ in range(2):                              # two epochs: reseeded shuffles
            for a, b in zip(ours, theirs, strict=True):
                assert a.keys() == b.keys() and a["patient"] == b["patient"]
                for key in ("ref_audio", "con_spec", "label"):
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])


def _rows(path) -> list[list[str]]:
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("per_item,batch_size", [(2, 8), (3, 4)])
def test_generate_dataset_manifest_matches_jax(tmp_path, per_item, batch_size):
    jmodel, params, model = diffwave_pair(TINY)
    ds = _ListDataset(_items(2))

    class JaxSpec:
        sample = staticmethod(jax_samplers.diffwave_sample)

    seen = []

    class Spec:
        @staticmethod
        def sample(m, con, labels, generator, **kw):
            seen.append(con.shape[0])
            return samplers.diffwave_sample(m, con, labels, generator, **kw)

    want = jax_generate.generate_dataset(jmodel, {"params": params}, JaxSpec, ds,
                                         str(tmp_path / "jax"), per_item=per_item,
                                         batch_size=batch_size)
    got = generate.generate_dataset(model, Spec, ds, str(tmp_path / "port"), per_item=per_item,
                                    batch_size=batch_size)
    assert _rows(got) == _rows(want)
    rows = _rows(got)
    assert rows[0] == ["patient", "label", "file"] and len(rows) == 1 + 2 * per_item
    tasks = 2 * per_item
    assert seen == [min(batch_size, tasks - s) for s in range(0, tasks, batch_size)]
    for patient, label, name in rows[1:]:
        sr, wave = wavfile.read(tmp_path / "port" / name)
        assert sr == 4000 and wave.shape == (TINY["hop_length"] * FRAMES,)
        assert wave.dtype == np.float32 and np.abs(wave).max() == 1.0


def test_generate_dataset_samples_ragged_mels_one_at_a_time(tmp_path):
    _, _, model = diffwave_pair(TINY)
    items = _items(2)
    items[1] = dict(items[1], con_spec=np.concatenate([items[1]["con_spec"]] * 2, axis=1))
    seen = []

    class Spec:
        @staticmethod
        def sample(m, con, labels, generator, **kw):
            seen.append(tuple(con.shape))
            return samplers.diffwave_sample(m, con, labels, generator, **kw)

    path = generate.generate_dataset(model, Spec, _ListDataset(items), str(tmp_path))
    mels = TINY["n_mels"]
    assert seen == [(1, mels, FRAMES), (1, mels, 2 * FRAMES)]
    assert [r[2] for r in _rows(path)[1:]] == ["p0_0_0.wav", "p1_1_0.wav"]


@pytest.mark.parametrize("name", ["diffwave", "wavegrad"])
def test_registry_matches_jax(name):
    ours, theirs = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("sample_rate", "hop_length", "crop_frames"):
        assert getattr(ours, field) == getattr(theirs, field), field
    for signal in ("pcg", "ecg", "pcg_ref", "other"):
        assert vars(ours.mel(signal)) == vars(theirs.mel(signal)), signal
    assert registry.GENERATIVE_FS == jax_registry.GENERATIVE_FS
    assert registry.CONDITIONING_F_MAX == jax_registry.CONDITIONING_F_MAX
    loss, sample = {"diffwave": (generative.diffwave_loss, samplers.diffwave_sample),
                    "wavegrad": (generative.wavegrad_loss, samplers.wavegrad_sample)}[name]
    assert ours.loss is loss and ours.sample is sample
    model = ours.build_model(3, seed=1, device="cpu", dtype=torch.bfloat16)
    assert isinstance(model, {"diffwave": DiffWave, "wavegrad": WaveGrad}[name])
    assert model.config.num_classes == 3
    first, out = ((model.input_projection, model.output_projection) if name == "diffwave"
                  else (model.init_conv, model.last_conv))
    assert first.compute_dtype == torch.bfloat16 and out.compute_dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in (*model.parameters(), *model.buffers()))
    with pytest.raises(ValueError, match="Unknown generator"):
        registry.get_spec("nope")
