"""Data parallelism (``parallel/mesh.py``) in the classifier trainer and the CinC runner, at two
gloo ranks on the CPU, against one process and against the JAX package's ``dp`` mesh.

One two-rank group (``tests/torch_parallel_ranks.py``) runs every scenario while this process
runs the references: the port in one process on the same global batches (``mesh=None``) and
the JAX trainer on ``data_parallel_mesh(2)`` over the virtual CPU devices of
``tests/conftest.py``, from one ``from_jax`` init. Every dropout and SpecAugment is at 0
(but in the scenario that checks the streams), so the runs are deterministic. The CinC fit
takes two epochs of two global batches of 8 (4 rows a rank), SGD with momentum; the first
batch has its last 3 rows invalid, so rank 1 holds one valid row: its loss is the mean over
the 5 valid rows of the whole batch, which a mean of the ranks' own means would miss. Bars:
two ranks against one process 1e-6 (the gradient is a mean of two partial sums instead of
one sum); against the JAX mesh those of ``tests/test_torch_train.py`` (losses 1e-4,
parameters 2e-4 / 2e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.experiments.cinc import _device_prep as jax_device_prep
from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.parallel import data_parallel_mesh as jax_mesh
from wav2vec_heart_sounds_tpu.parallel.mesh import maybe_shard_batch as jax_shard
from wav2vec_heart_sounds_tpu.train.classifier import SupervisedTrainer as JaxTrainer
from wav2vec_heart_sounds_tpu_torch.experiments import cinc, multichannel
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.parallel import Mesh, data_parallel_mesh
from wav2vec_heart_sounds_tpu_torch.parallel.mesh import mesh_device
from wav2vec_heart_sounds_tpu_torch.train.losses import cross_entropy
import torch_parallel_ranks as ranks
from torch_parallel_ranks import FS, FS_WIRE, NO_NOISE, WIN, noise_elements
from torch_vocoder_pairs import one_torch_thread  # noqa: F401


def _jax_fit(model, variables, train, valid, epochs):
    trainer = JaxTrainer(model, variables, optimizer_name="sgd", lr=5e-3, weight_decay=1e-5,
                         device_preprocess=jax_device_prep(FS_WIRE, FS, WIN),
                         mesh=jax_mesh(2), log=lambda s: None)
    losses, run = [], trainer._run_epoch

    def record(batcher, is_train, max_batches, *args):
        cm, loss = run(batcher, is_train, max_batches, *args)
        if is_train:
            losses.append(loss)
        return cm, loss

    trainer._run_epoch = record
    trainer.fit(train, valid, epochs)
    return {"epochs": losses, "params": jax.device_get(trainer.state.params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    tmp = tmp_path_factory.mktemp("parallel")
    jcfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), random_init=True, fs=FS,
                               encoder=JaxConfig.tiny(**NO_NOISE))
    jmodel = Wav2VecClassifier(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.key(3), jnp.zeros((1, WIN))))
    valid = ranks.cinc_batches(2, seed=3, int16=False)
    valid[1]["valid"][5:] = False                                 # an eval tail
    train = ranks.cinc_batches(2, seed=0)
    train[0]["valid"][5:] = False
    rng = np.random.default_rng(1)
    inputs = {
        "gather_x": rng.normal(size=(4, 3)).astype(np.float32),
        "gather_w": torch.from_numpy(rng.normal(size=(2, 4, 3)).astype(np.float32)),
        "cinc_init": from_jax(variables["params"]),
        "cinc_train": train, "cinc_valid": valid,
        "vest_init": ranks.state(build_classifier(ranks.vest_config(), seed=0, device="cpu",
                                                  train=True)),
        "vest_train": ranks.vest_batches(2, seed=2),
        "cinc_dir": ranks.cinc_dir(tmp / "cinc_data"),
    }
    (tmp / "ranks").mkdir()
    wait = ranks.start("classifier", inputs, tmp / "ranks")
    try:
        one = {}
        for name in ("cinc_fit", "vest_sgd", "vest_adamw", "dropout", "cinc_runner"):
            (tmp / "one" / name).mkdir(parents=True)
            one[name] = ranks.SCENARIOS["classifier"][name](None, inputs, tmp / "one" / name)
        theirs = _jax_fit(jmodel, variables, train, valid, 2)
    finally:
        got = wait()
    return inputs, got, one, theirs


def _equal(a: dict, b: dict, atol: float = 0.0) -> None:
    assert a.keys() == b.keys()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=atol, msg=key)


def _close_to_jax(params: dict, trained) -> None:
    ours = to_jax(params, trained)
    for path in (("head", "dense_0", "kernel"), ("head", "logits", "kernel"),
                 ("encoder", "feature_projection", "projection", "kernel"),
                 ("encoder", "layers_1", "attention", "out_proj", "kernel")):
        a, b = ours, trained
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))


def test_maybe_shard_batch_gives_each_rank_its_rows_and_refuses_like_jax(runs):
    _, got, _, _ = runs
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    for rank, results in enumerate(got):
        for key in ("rows", "tensor_rows"):                 # a host array, a tensor
            np.testing.assert_array_equal(results["helpers"][key].numpy(),
                                          table[3 * rank:3 * rank + 3])
    with pytest.raises(ValueError) as theirs:
        jax_shard(np.zeros((5, 2), np.float32), jax_mesh(2))
    assert got[0]["helpers"]["refusal"] == got[1]["helpers"]["refusal"] == str(theirs.value)
    assert "not divisible" in str(theirs.value)


def test_gather_rows_backward_is_the_transpose(runs):
    """The gather maps the ranks' rows to one replicated tensor; its transpose sends each
    rank the sum over ranks of the incoming gradients, cut to its rows."""
    inputs, got, _, _ = runs
    w = inputs["gather_w"]
    for rank, results in enumerate(got):
        torch.testing.assert_close(results["helpers"]["gathered"],
                                   torch.from_numpy(inputs["gather_x"]), rtol=0, atol=0)
        torch.testing.assert_close(results["helpers"]["grad"], (w[0] + w[1])[2 * rank:2 * rank + 2],
                                   rtol=0, atol=0)


def test_fit_at_two_ranks_matches_one_process(runs):
    _, got, one, _ = runs
    ours, ref = got[0]["cinc_fit"], one["cinc_fit"]
    assert len(ours["steps"]) == 4 and ours["best"] == ref["best"]
    np.testing.assert_allclose(ours["steps"], ref["steps"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours["epochs"], ref["epochs"], rtol=0, atol=1e-6)
    _equal(ours["params"], ref["params"], atol=1e-6)


def test_fit_at_two_ranks_matches_the_jax_mesh(runs):
    _, got, _, theirs = runs
    ours, ref = got[0]["cinc_fit"], theirs
    np.testing.assert_allclose(ours["epochs"], ref["epochs"], atol=1e-4)
    assert ours["epochs"][-1] < ours["epochs"][0]
    _close_to_jax(ours["params"], ref["params"])


def test_ranks_hold_equal_parameters_after_the_best_mcc_restore(runs):
    _, got, _, _ = runs
    assert got[0]["cinc_fit"]["best"] == got[1]["cinc_fit"]["best"]
    assert got[0]["cinc_fit"]["steps"] == got[1]["cinc_fit"]["steps"]
    _equal(got[0]["cinc_fit"]["params"], got[1]["cinc_fit"]["params"])


def test_padded_batch_trains_on_the_global_loss(runs):
    """The first step's batch: 8 rows, the last 3 invalid, split 4 / 4. Its loss is the
    cross-entropy over the 5 valid rows of the whole batch at the initial weights, on both
    ranks; the mean of the two halves' own means is another number."""
    inputs, got, _, _ = runs
    batch = inputs["cinc_train"][0]
    model = ranks.cinc_model(inputs["cinc_init"])
    x = ranks.cinc_trainer(model, None).device_preprocess(torch.from_numpy(batch["waveform"]))
    with torch.no_grad():
        logits = model(x)
    y, valid = torch.from_numpy(batch["label"]), torch.from_numpy(batch["valid"]).float()
    whole = float(cross_entropy(logits, y, valid))
    halves = np.mean([float(cross_entropy(logits[s], y[s], valid[s]))
                      for s in (slice(0, 4), slice(4, 8))])
    for results in got:
        assert abs(results["cinc_fit"]["steps"][0] - whole) < 1e-5
    assert abs(halves - whole) > 1e-3, (halves, whole)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_vest_with_the_contrastive_focal_loss_at_two_ranks(runs, optimizer):
    """LoRA under the freeze mask, two steps: the batch-coupled contrastive term sees the
    whole batch, so the losses and the trained tensors (the class centres among them) hold
    to one process at 1e-6; the frozen base does not move; both ranks agree bit for bit.
    Under SGD every element is held. Under AdamW, ``noise_elements`` of the one-process
    gradients are left out: all of the delay predictor's key biases, whose true gradient is
    0 (a softmax ignores a shift of every score of a query), and under 1% of the other
    elements (64 and 30 of 19,709 when written)."""
    inputs, got, one, _ = runs
    ours, ref = got[0][f"vest_{optimizer}"], one[f"vest_{optimizer}"]
    np.testing.assert_allclose(ours["steps"], ref["steps"], rtol=0, atol=1e-6)
    assert ours["trained"] == ref["trained"] and len(ref["grads"]) == 2
    params = {**ours["params"], "centers": ours["centers"]}
    want = {**ref["params"], "centers": ref["centers"]}
    noise = (noise_elements(ref["grads"]) if optimizer == "adamw"
             else [torch.zeros_like(g, dtype=torch.bool) for g in ref["grads"][0]])
    keys = [n for n in ref["trained"] if n.endswith("key.bias")]
    assert len(keys) == 2
    wholly = {name for name, mask in zip(ref["trained"], noise) if mask.all()}
    assert wholly == (set(keys) if optimizer == "adamw" else set())
    others = [mask for name, mask in zip(ref["trained"], noise) if name not in keys]
    assert sum(int(m.sum()) for m in others) <= 1e-2 * sum(m.numel() for m in others)
    for name, mask in zip(ref["trained"], noise):
        torch.testing.assert_close(params[name][~mask], want[name][~mask], rtol=0, atol=1e-6,
                                   msg=name)
    if optimizer == "sgd":                      # the frozen and the trained alike
        _equal(ours["params"], ref["params"], atol=1e-6)
    torch.testing.assert_close(got[1][f"vest_{optimizer}"]["centers"], ours["centers"],
                               rtol=0, atol=0)
    _equal(got[1][f"vest_{optimizer}"]["params"], ours["params"])
    assert ours["frozen"] and ours["frozen"] == ref["frozen"]
    for name in ours["frozen"]:
        torch.testing.assert_close(ours["params"][name], inputs["vest_init"][name],
                                   rtol=0, atol=0)
    moved = [n for n in ours["params"] if n.endswith("lora_b")]
    assert moved and all(ours["params"][n].abs().max() > 0 for n in moved)


def test_each_rank_draws_from_its_own_stream(runs):
    """At dropout 0.1 and SpecAugment 0.3: rank 0 draws the one-process step's dropout seed
    and the first rows of its SpecAugment spans; rank 1 draws other ones."""
    _, got, one, _ = runs
    r0, r1, ref = got[0]["dropout"], got[1]["dropout"], one["dropout"]
    assert len(ref["seeds"]) == len(r0["seeds"]) == len(r1["seeds"]) == 1     # one step
    assert r0["seeds"] == ref["seeds"]
    assert r1["seeds"][0] != ref["seeds"][0]
    rows = ref["masks"][0].shape[0] // 2
    torch.testing.assert_close(r0["masks"][0], ref["masks"][0][:rows], rtol=0, atol=0)
    assert r1["masks"][0].shape == r0["masks"][0].shape
    assert not torch.equal(r1["masks"][0], ref["masks"][0][rows:])
    assert not torch.equal(r1["masks"][0], r0["masks"][0])


def test_checkpoint_under_the_mesh_is_written_once_and_restored_everywhere(runs):
    _, got, _, _ = runs
    assert len(got[0]["cinc_fit"]["saves"]) == 1 and got[1]["cinc_fit"]["saves"] == []
    for results in got:
        fit = results["cinc_fit"]
        assert fit["restored"] and fit["restored_epoch"] == 2
        _equal(fit["restored_params"], fit["params"])


def test_cinc_run_at_two_ranks_writes_one_record(runs):
    _, got, one, _ = runs
    ours = got[0]["cinc_runner"]
    assert ours["written"] == [ours["record"]]
    assert got[1]["cinc_runner"]["record"] == ours["record"] == one["cinc_runner"]["record"]
    assert all(np.isfinite(v) for level in ("fragment", "patient")
               for v in ours["record"][level].values())


@pytest.mark.parametrize("run", [cinc.run, cinc.run_leave_out_db, multichannel.run],
                         ids=["cinc", "leave_out_db", "multichannel"])
def test_runners_refuse_what_is_not_a_mesh(run, tmp_path):
    with pytest.raises(TypeError, match="parallel.Mesh"):
        run(str(tmp_path), str(tmp_path / "split.csv"), mesh=object(), device="cpu")


def test_a_mesh_and_a_contradicting_device_are_refused():
    mesh = Mesh(0, 1, torch.device("cpu"))
    assert mesh_device(mesh, "cpu") == torch.device("cpu")
    assert mesh_device(None, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="contradicts"):
        mesh_device(mesh, "cuda")
    with pytest.raises(ValueError, match="contradicts"):
        mesh_device(Mesh(0, 1, torch.device("cuda", 1)), "cuda:0")


def test_data_parallel_mesh_needs_a_group_or_torchrun(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        data_parallel_mesh(device="cpu")
