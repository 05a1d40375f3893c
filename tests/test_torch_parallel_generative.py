"""Data parallelism in the generative trainer and the synthetic-schedule runner at two gloo
ranks on the CPU, and the classifier trainer's on-disk checkpoints.

One two-rank group (``tests/torch_parallel_ranks.py``) takes two ``GenerativeTrainer``
steps of the tiny DiffWave (its output projection five times larger, so the clip at 1.0
acts on the global gradient) and one of the full-size WaveGrad, on global batches of 2 with
the JAX trainer's own draws injected, each rank on its row of the batch and of the draws;
then a ``weights`` checkpoint under the mesh, two epochs of ``train`` with a sampler and a
``log_dir``, and ``synthetic.run`` on a two-stage schedule. This process runs the same in one
process (``mesh=None``) and the JAX ``GenerativeTrainer`` on ``data_parallel_mesh(2)``.
Adam's step is about lr * sign(g), so an element whose gradient is rounding noise (a
near-cancelling sum) may move either way. Bars: two ranks against one process, losses and
parameters at 1e-6 but for the elements whose one-process gradient is such noise (a rule
on that gradient, ``torch_parallel_ranks.noise_elements``), each moment within 1e-5 of its
norm (the gradient is the mean of the ranks' gradients of their L1 means). Against the JAX
mesh, DiffWave at ``tests/test_torch_generative_train.py``'s bars (losses 1e-5 relative,
parameters 1e-5, moments 1e-4 of each tensor's largest element); WaveGrad's loss at 1e-5
relative, its first moment within 1e-3 of its norm (``tests/test_torch_diffusion.py``'s
gradient bar) and at most one element in 10^4 stepping the other way.
"""

import json

import numpy as np
import jax
import optax
import pytest
import torch

from wav2vec_heart_sounds_tpu.parallel import data_parallel_mesh as jax_mesh
from wav2vec_heart_sounds_tpu.train import generative as jax_generative
from wav2vec_heart_sounds_tpu_torch.data.fragments import Fragment, FragmentDataset
from wav2vec_heart_sounds_tpu_torch.data.loader import Batcher
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
from wav2vec_heart_sounds_tpu_torch.train.losses import ContrastiveFocalConfig
import torch_parallel_ranks as ranks
from torch_parallel_ranks import NO_NOISE, noise_elements
from torch_vocoder_pairs import (FRAMES, TINY, diffwave_pair, jax_draws_diffwave,  # noqa: F401
                                 jax_draws_wavegrad, make_batch, make_wavegrad_pair,
                                 one_torch_thread)

LEFT_OUT = {"diffwave": 1e-2, "wavegrad": 3e-2}      # at most, of the elements (0.42%, 2.14%)
JAX_LOSSES = {"diffwave": (jax_generative.diffwave_loss, jax_draws_diffwave, 50),
              "wavegrad": (jax_generative.wavegrad_loss, jax_draws_wavegrad, 1000)}


def _jax_draws(name, batches) -> list[tuple]:
    """The draws of the JAX trainer's steps: its key (seed 3), split once a step."""
    _, draw, steps = JAX_LOSSES[name]
    key, draws = jax.random.key(3), []
    for batch in batches:
        key, sub = jax.random.split(key)
        draws.append(draw(sub, batch["ref_audio"].shape, steps))
    return draws


def _jax_steps(name, jmodel, params, batches, tmp):
    trainer = jax_generative.GenerativeTrainer(jmodel, {"params": params}, JAX_LOSSES[name][0],
                                               str(tmp), lr=1e-3, seed=3, mesh=jax_mesh(2),
                                               log=lambda s: None)
    losses = [trainer.train_step(batch) for batch in batches]
    adam = [s for s in jax.tree_util.tree_leaves(
        trainer.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return {"losses": losses, "params": jax.device_get(trainer.params),
            "moments": jax.device_get((adam[0].mu, adam[0].nu))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    tmp = tmp_path_factory.mktemp("parallel_generative")
    djmodel, dparams, dmodel = diffwave_pair(TINY)
    out = dparams["output_projection"]
    out["kernel"] = out["kernel"] * 5.0
    dmodel.load_state_dict(from_jax(dparams), strict=True)
    wjmodel, wparams, wmodel = make_wavegrad_pair()
    pairs = {"diffwave": (djmodel, dparams, make_batch(TINY["n_mels"], TINY["hop_length"], 8),
                          make_batch(TINY["n_mels"], TINY["hop_length"], 9)),
             "wavegrad": (wjmodel, wparams, make_batch(128, 300, 8))}
    theirs, inputs = {}, {"schedule": ranks.synthetic_schedule(tmp / "schedule")}
    inputs["diffwave_init"] = {"fields": TINY, "state": ranks.state(dmodel)}
    rng = np.random.default_rng(4)
    inputs["vocoder_items"] = [
        {"ref_audio": (0.5 * rng.normal(size=TINY["hop_length"] * FRAMES)).astype(np.float32),
         "con_spec": rng.uniform(0, 1, (TINY["n_mels"], FRAMES)).astype(np.float32),
         "label": i % 2, "patient": f"p{i}"} for i in range(8)]
    inputs["wavegrad_init"] = {"fields": {}, "state": ranks.state(wmodel)}
    for name, (_, _, *batches) in pairs.items():
        inputs[f"{name}_batches"], inputs[f"{name}_draws"] = batches, _jax_draws(name, batches)
    (tmp / "ranks").mkdir()
    wait = ranks.start("generative", inputs, tmp / "ranks")
    try:
        for name, (jmodel, params, *batches) in pairs.items():
            theirs[name] = _jax_steps(name, jmodel, params, batches, tmp / f"jax_{name}")
        one = {}
        for name, scenario in ranks.SCENARIOS["generative"].items():
            (tmp / "one" / name).mkdir(parents=True)
            one[name] = scenario(None, inputs, tmp / "one" / name)
    finally:
        got = wait()
    return inputs, got, one, theirs, {name: p for name, (_, p, *_) in pairs.items()}


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _moment_gaps(ours: list, ref: list) -> list[float]:
    """Each tensor's distance between two runs' Adam moments, as a share of its norm."""
    return [float((a - b).norm() / b.norm()) for m, n in zip(ours, ref, strict=True)
            for a, b in zip(m, n, strict=True) if b.norm() > 0]


@pytest.mark.parametrize("name", ["diffwave", "wavegrad"])
def test_train_step_at_two_ranks_matches_one_process(runs, name):
    """Losses and parameters within 1e-6 of one process, Adam's moments within 1e-5 of each
    tensor's norm, both ranks bit for bit. The parameters' elements left out are
    ``noise_elements`` of the one-process gradients (not 0 but below 1e-5 of the step's
    largest element), which Adam may step either way: 50 of DiffWave's 11,875 and 341,820
    of WaveGrad's 15,956,161 when written, spread over most tensors."""
    inputs, got, one, _, _ = runs
    ours, ref = got[0][name], one[name]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=0, atol=1e-6)
    assert got[1][name]["losses"] == ours["losses"]                   # the averaged loss
    # validation draws its own noise, from each rank's stream: the ranks agree on the mean
    assert got[1][name]["valid"] == ours["valid"] and np.isfinite(ours["valid"])
    assert max(_moment_gaps(ours["moments"], ref["moments"])) <= 1e-5
    _equal(got[1][name]["params"], ours["params"])
    noise = noise_elements(ref["grads"])
    for key, mask in zip(ours["names"], noise, strict=True):
        torch.testing.assert_close(ours["params"][key][~mask], ref["params"][key][~mask],
                                   rtol=0, atol=1e-6, msg=key)
    left_out = sum(int(mask.sum()) for mask in noise)
    assert left_out <= LEFT_OUT[name] * sum(m.numel() for m in noise), left_out


def _leaves(tree: dict, like: dict):
    """(path, the flax-layout leaf of ``tree``, that of ``like``) for every leaf of ``like``."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(like):
        node = tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), np.asarray(node), np.asarray(leaf)


def test_diffwave_at_two_ranks_matches_the_jax_mesh(runs):
    _, got, _, theirs, _ = runs
    ours, ref = got[0]["diffwave"], theirs["diffwave"]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5)
    trained = ref["params"]
    for path, mine, want in _leaves(to_jax(ours["params"], trained), trained):
        np.testing.assert_allclose(mine, want, atol=1e-5, rtol=0, err_msg=path)
    names = ours["names"]
    for moment, want_tree in zip(ours["moments"], ref["moments"], strict=True):
        for path, mine, want in _leaves(to_jax(dict(zip(names, moment)), trained), want_tree):
            assert np.abs(mine - want).max() <= 1e-4 * np.abs(want).max(), path


def test_wavegrad_at_two_ranks_matches_the_jax_mesh(runs):
    """One step: the loss at 1e-5 relative, Adam's first moment (a tenth of the gradient)
    within 1e-3 of its norm (``tests/test_torch_diffusion.py``'s gradient bar), and at most
    one element in 10^4 stepping the other way (the step is about lr * sign(g))."""
    _, got, _, theirs, jax_init = runs
    ours, ref = got[0]["wavegrad"], theirs["wavegrad"]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5)
    init = jax_init["wavegrad"]
    names = ours["names"]
    for path, mine, want in _leaves(to_jax(dict(zip(names, ours["moments"][0])), init),
                                    ref["moments"][0]):
        assert np.linalg.norm(mine - want) <= 1e-3 * np.linalg.norm(want), path
    start = {path: leaf for path, _, leaf in _leaves(init, init)}
    flips, total = 0, 0
    for path, mine, want in _leaves(to_jax(ours["params"], init), ref["params"]):
        flips += int((np.sign(mine - start[path]) != np.sign(want - start[path])).sum())
        total += want.size
    assert flips <= 1e-4 * total, flips


@pytest.mark.parametrize("name", ["diffwave", "wavegrad"])
def test_one_checkpoint_under_the_mesh_written_by_rank_0(runs, name):
    _, got, _, _, _ = runs
    assert [len(r[name]["saves"]) for r in got] == [1, 0]
    assert got[0][name]["saves"][0].endswith("weights.pt")
    for results in got:
        assert results[name]["restored"]
        for key, value in results[name]["params"].items():
            assert torch.equal(results[name]["restored_params"][key], value), key


def test_synthetic_run_at_two_ranks_writes_one_record(runs):
    _, got, one, _, _ = runs
    ours = got[0]["synthetic_runner"]
    assert ours["written"] == [ours["record"]]
    assert got[1]["synthetic_runner"]["record"] == ours["record"]
    assert ours["record"] == one["synthetic_runner"]["record"]
    assert all(np.isfinite(v) for level in ("fragment", "patient")
               for v in ours["record"][level].values())


def test_train_under_the_mesh_samples_and_logs_on_rank_0_only(runs):
    """``train`` for two epochs with a sampler and a ``log_dir``: every rank draws the sample
    batch (which advances the shuffling batcher), so each step trains on the global batch of
    the one-process run; rank 0 alone writes the scalars and the samples, and both ranks end
    bit for bit equal."""
    _, got, one, _, _ = runs
    ours, ref = got[0]["diffwave_train"], one["diffwave_train"]
    assert len(ref["patients"]) == 4
    assert got[1]["diffwave_train"]["patients"] == ours["patients"] == ref["patients"]
    _equal(got[1]["diffwave_train"]["params"], ours["params"])
    assert ours["logs"] == ref["logs"] == ["sample_e1.wav", "sample_e2.wav", "scalars.jsonl"]
    assert [json.loads(row)["tag"] for row in ours["scalars"]] == ["gen/train_L1"] * 2
    assert got[1]["diffwave_train"]["scalars"] == ours["scalars"]      # one shared file
    assert ours["models"] == ref["models"] == ["weights.pt"]


def _tiny_trainer(**kw):
    """``tests/test_observe.py``'s tiny classifier (Adam at 1e-3 under the freeze mask of
    its config), here with the contrastive-focal loss so that the checkpoint carries the
    loss's class centres too, and every dropout and SpecAugment at 0."""
    cfg = ClassifierConfig(num_classes=2, head_hidden=(8,), fs=1000,
                           encoder=Wav2Vec2Config.tiny(**NO_NOISE))
    model = build_classifier(cfg, seed=0, device="cpu", train=True)
    trainer = SupervisedTrainer(model, optimizer_name="adam", lr=1e-3, classifier_config=cfg,
                                criterion=ContrastiveFocalConfig(feature_dim=32),
                                log=lambda s: None, **kw)
    rng = np.random.default_rng(0)
    frags = [Fragment(rng.normal(size=500).astype(np.float32), i % 2, f"p{i}")
             for i in range(8)]
    return trainer, FragmentDataset(frags, fs=1000)


def test_trainer_checkpoint_roundtrip(tmp_path):
    trainer, ds = _tiny_trainer()
    trainer.fit(Batcher(ds, 4, True), None, epochs=1)
    path = trainer.save(str(tmp_path / "clf.pt"))
    trainer2, _ = _tiny_trainer(seed=4)
    assert trainer2.restore(path)
    assert trainer2.epoch == trainer.epoch == 1
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(trainer2.model.state_dict()[key], value), key
    assert torch.equal(trainer2.loss_params["centers"], trainer.loss_params["centers"])
    assert not trainer2.restore(str(tmp_path / "missing.pt"))


def test_restore_after_fit_continues_like_an_uninterrupted_run(tmp_path):
    """Two epochs in one run, against one epoch, a checkpoint, a fresh trainer restoring it
    and a second epoch on the batcher's next epoch: equal bit for bit (the parameters, the
    centres, Adam's moments and step count, the epoch)."""
    whole, ds = _tiny_trainer()
    whole.fit(Batcher(ds, 4, True, seed=2), None, epochs=2)
    first, _ = _tiny_trainer()
    first.fit(Batcher(ds, 4, True, seed=2), None, epochs=1)
    path = first.save(str(tmp_path / "ckpt" / "clf.pt"))
    second, _ = _tiny_trainer(seed=9)
    assert second.restore(path)
    batcher = Batcher(ds, 4, True, seed=2)
    batcher.epoch = 1
    second.fit(batcher, None, epochs=1)
    assert second.epoch == whole.epoch == 2
    for key, value in whole.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[key], value), key
    assert torch.equal(second.loss_params["centers"], whole.loss_params["centers"])
    a, b = whole.optimizer.state_dict(), second.optimizer.state_dict()
    assert a["count"] == b["count"] == 4
    for x, y in zip([*a["master"], *a["state"][0], *a["state"][1]],
                    [*b["master"], *b["state"][0], *b["state"][1]], strict=True):
        assert torch.equal(x, y)
