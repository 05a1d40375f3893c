"""The rank side of the data-parallel tests (``tests/test_torch_parallel*.py``).

:func:`start` spawns one two-rank gloo group (a ``file://`` store in the test's temporary
directory, one intra-op thread a rank) that runs every scenario of one test file on the same
inputs and writes each rank's results to ``rank<r>.pt``. The scenarios' builders are shared
with the one-process references that the test process runs (``mesh=None``). This module
imports torch, numpy and the port only: the ranks never load JAX.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

FS_WIRE, FS, WIN = 2000, 4000, 4000         # raw 2 kHz windows of 1 s, preprocessed to 4 kHz
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)
WORLD = 2


def cinc_batches(n: int, seed: int, batch: int = 8, int16: bool = True) -> list[dict]:
    """``n`` global batches of raw 2 kHz windows (tones and noise), labels alternating."""
    rng = np.random.default_rng(seed)
    t = np.arange(FS_WIRE) / FS_WIRE
    out = []
    for _ in range(n):
        x = (np.sin(2 * np.pi * rng.uniform(30, 200, size=(batch, 1)) * t)
             + 0.2 * rng.normal(size=(batch, FS_WIRE)))
        x = x / np.abs(x).max(axis=1, keepdims=True)
        wave = np.round(x * 32767).astype(np.int16) if int16 else x.astype(np.float32)
        out.append({"waveform": wave, "label": np.arange(batch, dtype=np.int32) % 2,
                    "valid": np.ones(batch, dtype=bool)})
    return out


def cinc_dir(d: Path) -> str:
    """Six 6 s PCG records at 1 kHz and their ``split.csv`` (4 train, 1 valid, 1 test;
    ``tests/test_torch_experiment.py``'s fixture)."""
    from wav2vec_heart_sounds_tpu_torch.data import wfdb_io

    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    t = np.arange(6 * 1000) / 1000
    lines = ["patient,abnormality,split"]
    for i in range(6):
        lab = 1 if i % 2 else -1
        pcg = np.sin(2 * np.pi * (90 if lab == 1 else 60) * t) + 0.05 * rng.normal(size=t.size)
        wfdb_io.write_record(str(d / f"a{i:04d}"), pcg[:, None], 1000, sig_names=["PCG"])
        lines.append(f"a{i:04d},{lab},{(['train'] * 4 + ['valid', 'test'])[i]}")
    (d / "split.csv").write_text("\n".join(lines) + "\n")
    return str(d)


def synthetic_schedule(d: Path) -> str:
    """A schedule of two stages over :func:`cinc_dir`'s records and four generated 4 s WAVs
    (``REFERENCE.csv`` as ``generate_dataset`` writes it); returns the schedule's path."""
    from scipy.io import wavfile

    real = cinc_dir(d / "real")
    gen = d / "gen"
    gen.mkdir()
    rng = np.random.default_rng(1)
    t = np.arange(4 * 1000) / 1000
    rows = ["patient,label,file"]
    for i in range(4):
        wave = np.sin(2 * np.pi * (90 if i % 2 else 60) * t) + 0.1 * rng.normal(size=t.size)
        wavfile.write(str(gen / f"g{i}_{i}_0.wav"), 1000,
                      (wave / np.abs(wave).max()).astype(np.float32))
        rows.append(f"g{i},{i % 2},g{i}_{i}_0.wav")
    (gen / "REFERENCE.csv").write_text("\n".join(rows) + "\n")
    split = os.path.join(real, "split.csv")
    sched = {"test_set": {"data": real, "split": split, "segment": ""},
             "valid_set": {"data": real, "split": split, "segment": ""},
             "datasets": {"real": {"path": real, "split": split, "segment": "",
                                   "gen_data": False, "augment_num": 0},
                          "gen": {"path": str(gen), "split": "", "segment": "",
                                  "gen_data": True, "augment_num": 0, "proportion": 1.0}},
             "schedule": [{"key": "real", "epochs": 1}, {"key": "gen", "epochs": 1}]}
    path = d / "schedule.json"
    path.write_text(json.dumps(sched))
    return str(path)


def cinc_model(state: dict | None = None, **encoder):
    """The tiny classifier of ``tests/test_torch_train.py`` (every dropout and SpecAugment
    at 0 unless ``encoder`` says otherwise), float32 on the CPU."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    cfg = Wav2Vec2Config.tiny(**{**NO_NOISE, **encoder})
    model = build_classifier(ClassifierConfig(head_hidden=(16,), fs=FS, encoder=cfg),
                             device="cpu", train=True)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def cinc_trainer(model, mesh, **kw):
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

    return SupervisedTrainer(model, optimizer_name="sgd", lr=5e-3, weight_decay=1e-5,
                             device_preprocess=_device_prep(FS_WIRE, FS, WIN, "cpu"),
                             mesh=mesh, log=lambda s: None, **kw)


def vest_config():
    from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    return ClassifierConfig(num_channels=3, lora=True, head_hidden=(8,), fs=1000,
                            encoder=Wav2Vec2Config.tiny(**NO_NOISE, lora_dropout=0.0))


def vest_batches(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"waveform": rng.normal(size=(4, 600, 3)).astype(np.float32),
             "label": np.array([0, 1, 0, 1], np.int32), "valid": np.ones(4, bool)}
            for _ in range(n)]


def vest_trainer(state: dict, mesh, optimizer_name: str, lr: float):
    """The tiny LoRA vest classifier under its freeze mask and the contrastive-focal loss."""
    from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
    from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer
    from wav2vec_heart_sounds_tpu_torch.train.losses import ContrastiveFocalConfig

    cfg = vest_config()
    model = build_classifier(cfg, device="cpu", train=True)
    model.load_state_dict(state, strict=True)
    return model, SupervisedTrainer(
        model, optimizer_name=optimizer_name, lr=lr, classifier_config=cfg, mesh=mesh, seed=5,
        criterion=ContrastiveFocalConfig(num_classes=2, feature_dim=cfg.encoder.hidden_size),
        log=lambda s: None)


def recorded_fit(trainer, train, valid, epochs: int) -> dict:
    """``fit``, with every train step's loss and every epoch's mean train loss recorded."""
    steps, epochs_seen, run_epoch, train_step = [], [], trainer._run_epoch, trainer._train_step

    def record_step(*args):
        loss, preds = train_step(*args)
        steps.append(float(loss))
        return loss, preds

    def record_epoch(batcher, is_train, max_batches):
        cm, loss = run_epoch(batcher, is_train, max_batches)
        if is_train:
            epochs_seen.append(loss)
        return cm, loss

    trainer._train_step, trainer._run_epoch = record_step, record_epoch
    best = trainer.fit(train, valid, epochs)
    return {"steps": steps, "epochs": epochs_seen, "best": best}


def state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def record_gradients(optimizer) -> list[list[torch.Tensor]]:
    """From now on, each ``optimizer.step`` first records the gradients it is handed (this
    process's own: under a mesh, before the all-reduce); returns the list it fills."""
    seen, step = [], optimizer.step

    def recording(lr):
        seen.append(optimizer._grads())
        return step(lr)

    optimizer.step = recording
    return seen


def noise_elements(grads: list[list[torch.Tensor]], share: float = 1e-5) -> list[torch.Tensor]:
    """For each trained tensor, the elements whose reference gradient, at some step, is not 0
    but below ``share`` of that step's largest gradient element: rounding noise, which Adam
    turns into a step of up to lr of either sign, so that two runs differing only in the
    order of a sum may step them apart. (A gradient of exactly 0, such as LoRA's ``lora_a``
    at the first step, where ``lora_b`` is 0, makes a step of exactly 0.)"""
    masks = None
    for step in grads:
        top = max(float(g.abs().max()) for g in step)
        small = [(g != 0) & (g.abs() < share * top) for g in step]
        masks = small if masks is None else [a | b for a, b in zip(masks, small)]
    return masks


# --- scenarios: (mesh, inputs, directory) -> results ------------------------------------

def helpers(mesh, inputs, tmp: Path) -> dict:
    from wav2vec_heart_sounds_tpu_torch.parallel import gather_rows, maybe_shard_batch

    rows = maybe_shard_batch(np.arange(12, dtype=np.float32).reshape(6, 2), mesh, "cpu")
    tensor_rows = maybe_shard_batch(torch.arange(12.0).reshape(6, 2), mesh, "cpu")
    try:
        maybe_shard_batch(np.zeros((5, 2), np.float32), mesh, "cpu")
        refusal = None
    except ValueError as exc:
        refusal = str(exc)
    x = maybe_shard_batch(inputs["gather_x"], mesh, "cpu").requires_grad_()
    y = gather_rows(x, mesh)
    (y * inputs["gather_w"][mesh.rank]).sum().backward()
    return {"rows": rows, "tensor_rows": tensor_rows, "refusal": refusal,
            "gathered": y.detach(), "grad": x.grad}


def cinc_fit(mesh, inputs, tmp: Path) -> dict:
    """``fit`` of two epochs (two steps and a validation epoch each), then a checkpoint
    written under the mesh and restored by every rank into a fresh trainer."""
    model = cinc_model(inputs["cinc_init"])
    trainer = cinc_trainer(model, mesh)
    out = recorded_fit(trainer, inputs["cinc_train"], inputs["cinc_valid"], 2)
    out["params"] = state(model)
    real_save, saves = torch.save, []

    def counting_save(*args, **kw):
        saves.append(args[1])
        return real_save(*args, **kw)

    with mock.patch.object(torch, "save", counting_save):
        path = trainer.save(str(tmp / "checkpoint" / "clf.pt"))
    fresh = cinc_trainer(cinc_model(inputs["cinc_init"]), mesh)
    out.update(saves=saves, restored=fresh.restore(path), restored_epoch=fresh.epoch,
               restored_params=state(fresh.model))
    return out


def vest(mesh, inputs, tmp: Path, optimizer_name: str, lr: float) -> dict:
    """Two steps of the vest trainer; with the trained parameters' names in the optimizer's
    order and the gradients each step was handed."""
    model, trainer = vest_trainer(inputs["vest_init"], mesh, optimizer_name, lr)
    grads = record_gradients(trainer.optimizer)
    out = recorded_fit(trainer, inputs["vest_train"], None, 1)
    by_id = {id(p): n for n, p in model.named_parameters()}
    out.update(params=state(model), centers=trainer.loss_params["centers"].detach().clone(),
               frozen=[n for n, p in model.named_parameters() if not p.requires_grad],
               trained=[by_id.get(id(p), "centers") for p in trainer.optimizer.params],
               grads=grads)
    return out


def dropout_draws(mesh, inputs, tmp: Path) -> dict:
    """One training step at dropout 0.1 and SpecAugment 0.3: the step's dropout seed and
    SpecAugment mask as this rank drew them."""
    from wav2vec_heart_sounds_tpu_torch.models import wav2vec2

    seeds, masks = [], []
    real_seed, real_mask = wav2vec2.step_seed, wav2vec2.sample_time_mask

    def seed_spy(generator):
        seeds.append(real_seed(generator))
        return seeds[-1]

    def mask_spy(*args, **kw):
        masks.append(real_mask(*args, **kw))
        return masks[-1]

    noisy = dict(hidden_dropout=0.1, attention_dropout=0.1, activation_dropout=0.1,
                 feat_proj_dropout=0.1, mask_time_prob=0.3)
    model = cinc_model(inputs["cinc_init"], **noisy)
    with mock.patch.object(wav2vec2, "step_seed", seed_spy), \
            mock.patch.object(wav2vec2, "sample_time_mask", mask_spy):
        cinc_trainer(model, mesh, seed=11).fit(inputs["cinc_train"][:1], None, 1)
    return {"seeds": seeds, "masks": masks}


def cinc_runner(mesh, inputs, tmp: Path, results: str | None = None) -> dict:
    from wav2vec_heart_sounds_tpu_torch.experiments import cinc
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    results = results or str(tmp / "cinc.json")
    record = cinc.run(inputs["cinc_dir"], os.path.join(inputs["cinc_dir"], "split.csv"),
                      mode="pcg", fs=1000, window_s=2.0, epochs=1, augment=False,
                      random_init=True, batch_size=4, max_batches=2, lr=2e-2,
                      encoder_config=Wav2Vec2Config.tiny(**NO_NOISE), results_json=results,
                      mesh=mesh, device="cpu", dtype=torch.float32)
    return {"record": record, "written": json.loads(Path(results).read_text())
            if Path(results).exists() else None}


def synthetic_runner(mesh, inputs, tmp: Path, results: str | None = None) -> dict:
    from wav2vec_heart_sounds_tpu_torch.experiments import synthetic
    from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    results = results or str(tmp / "synthetic.json")
    record = synthetic.run(inputs["schedule"], fs=1000, window_s=2.0, random_init=True,
                           batch_size=4, max_batches=2, lr=2e-2,
                           encoder_config=Wav2Vec2Config.tiny(**NO_NOISE),
                           results_json=results, mesh=mesh, device="cpu",
                           dtype=torch.float32)
    return {"record": record, "written": json.loads(Path(results).read_text())
            if Path(results).exists() else None}


def vocoder_steps(mesh, inputs, tmp: Path, name: str) -> dict:
    """``GenerativeTrainer.train_step`` of one vocoder from the given weights on each of the
    given global batches and draws, then a ``weights`` checkpoint (with ``torch.save``
    counted) restored by every rank into a fresh trainer."""
    from wav2vec_heart_sounds_tpu_torch.train import generative

    model, loss = vocoder(name, inputs[f"{name}_init"])
    trainer = generative.GenerativeTrainer(model, loss, str(tmp / name), lr=1e-3, seed=3,
                                           mesh=mesh, log=lambda s: None)
    grads = record_gradients(trainer.optimizer) if mesh is None else None
    losses = [trainer.train_step(b, d) for b, d in zip(inputs[f"{name}_batches"],
                                                       inputs[f"{name}_draws"])]
    real_save, saves = torch.save, []

    def counting_save(*args, **kw):
        saves.append(args[1])
        return real_save(*args, **kw)

    with mock.patch.object(torch, "save", counting_save):
        path = trainer.save("weights")
    fresh = generative.GenerativeTrainer(vocoder(name, inputs[f"{name}_init"])[0], loss,
                                         str(tmp / name), seed=3, mesh=mesh,
                                         log=lambda s: None)
    return {"losses": losses, "params": state(model), "moments": trainer.optimizer.state,
            "grads": grads,
            "names": [n for n, _ in model.named_parameters()],
            "saves": saves, "restored": fresh.restore(path),
            "restored_params": state(fresh.model), "valid": trainer.validate(
                [inputs[f"{name}_batches"][0]])}


class ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def vocoder_train(mesh, inputs, tmp: Path) -> dict:
    """``GenerativeTrainer.train`` of the tiny DiffWave for two epochs on a shuffling batcher
    of global batches of 4, with a ``log_dir`` and a sampler (a sample every epoch): the
    patients of every step's batch and what each rank left in the two directories."""
    from wav2vec_heart_sounds_tpu_torch.models.diffusion import samplers
    from wav2vec_heart_sounds_tpu_torch.train import generative

    model, loss = vocoder("diffwave", inputs["diffwave_init"])
    trainer = generative.GenerativeTrainer(
        model, loss, str(tmp / "model"), lr=1e-3, sampler=samplers.diffwave_sample,
        sample_every=1, log_dir=str(tmp / "logs"), mesh=mesh, log=lambda s: None)
    patients, step = [], trainer.train_step

    def recording(batch, draws=None):
        patients.append(list(batch["patient"]))
        return step(batch, draws)

    trainer.train_step = recording
    trainer.train(generative.GenBatcher(ListDataset(inputs["vocoder_items"]), 4, shuffle=True),
                  epochs=2)
    # train's last act is the "weights" checkpoint, which every rank leaves only once rank 0
    # has written it, after its scalars and samples
    return {"patients": patients, "params": state(model),
            "logs": sorted(p.name for p in (tmp / "logs").glob("*")),
            "scalars": (tmp / "logs" / "scalars.jsonl").read_text().splitlines(),
            "models": sorted(p.name for p in (tmp / "model").glob("*"))}


def vocoder(name: str, weights: dict):
    """(model, loss strategy) of ``name`` on the CPU from ``weights``."""
    from wav2vec_heart_sounds_tpu_torch.models.diffusion import diffwave, wavegrad
    from wav2vec_heart_sounds_tpu_torch.train import generative

    if name == "diffwave":
        model = diffwave.DiffWave(diffwave.DiffWaveConfig(**weights["fields"]))
        loss = generative.diffwave_loss
    else:
        model = wavegrad.WaveGrad(wavegrad.WaveGradConfig())
        loss = generative.wavegrad_loss
    model.load_state_dict(weights["state"], strict=True)
    return model, loss


SCENARIOS = {
    "classifier": {"helpers": helpers, "cinc_fit": cinc_fit,
                   "vest_sgd": lambda m, i, t: vest(m, i, t, "sgd", 1e-2),
                   "vest_adamw": lambda m, i, t: vest(m, i, t, "adamw", 1e-3),
                   "dropout": dropout_draws, "cinc_runner": cinc_runner},
    "generative": {"diffwave": lambda m, i, t: vocoder_steps(m, i, t, "diffwave"),
                   "wavegrad": lambda m, i, t: vocoder_steps(m, i, t, "wavegrad"),
                   "diffwave_train": vocoder_train,
                   "synthetic_runner": synthetic_runner},
}


def _rank_main(rank: int, tmp: str, which: str) -> None:
    torch.set_num_threads(1)
    os.environ["W2VHS_NO_NATIVE"] = "1"
    import torch.distributed as dist

    from wav2vec_heart_sounds_tpu_torch.parallel import data_parallel_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    try:
        mesh = data_parallel_mesh(device="cpu")
        assert mesh.world_size == WORLD
        inputs = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        results = {}
        for name, scenario in SCENARIOS[which].items():
            shared = Path(tmp) / name             # the scenario's files: one directory
            shared.mkdir(exist_ok=True)           # for both ranks, as on one host
            results[name] = scenario(mesh, inputs, shared)
        torch.save(results, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(which: str, inputs: dict, tmp: Path, timeout: float = 300.0):
    """Spawn the two ranks on ``inputs``; returns ``wait()``, which joins them and returns
    both ranks' results (a rank's exception re-raises there)."""
    import torch.multiprocessing as mp

    torch.save(inputs, tmp / "inputs.pt")
    context = mp.start_processes(_rank_main, args=(str(tmp), which), nprocs=WORLD,
                                 join=False, start_method="spawn")

    def wait() -> list[dict]:
        deadline = time.monotonic() + timeout
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for process in context.processes:
                    process.kill()
                raise TimeoutError(f"the {which} ranks took more than {timeout} s")
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    return wait
