"""A training cell: the port's CinC training loop, closed loop, for ``--seconds``.

Set-up builds the classifier from the benchmark's weights, the windows from the seed, and
one ``SupervisedTrainer`` (the traffic's optimizer, the port's ``_device_prep`` as its
device preprocessing) fed by the port's training ``Batcher`` (int16 wire). It then drives
that trainer through its first ``checked_steps`` steps, one ``_run_epoch`` of one batch
each (the window's own call and feed), recording the indices of every batch, the model's
input (the preprocessed windows) and each step's loss, and from the optimizer's state the
norms of every leaf's first clipped gradient (momentum buffer minus the decay) and of its
change after the last step. These steps compile and warm every kernel the window runs. The
window then runs ``_run_epoch`` over the same trainer until the deadline.

After the window and the program's release, :meth:`TrainCell.reference` repeats the
checked steps with the plain reference from the same windows, weights and seed.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep
from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

from . import compare, reference, traffic
from .configs import ModelConfig
from .flops import train_flops
from .program import ArrayDataset, Feed, build_model, port_config, sync
from .trace import PosConvRange, Stretch, summarise
from .weights import make_weights

POS_CONV_RANGE = "benchmark::pos_conv_embed"


def wire(waves: np.ndarray, scale: float) -> np.ndarray:
    """The int16 wire of ``[-1, 1]`` windows, dequantised to float64."""
    q = np.clip(np.round(waves.astype(np.float64) * scale), -scale, scale).astype(np.int16)
    return q.astype(np.float64) / scale


class TrainCell:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg = ModelConfig.from_file(cell.config)
        self.traffic = t = cell.traffic
        self.samples = traffic.window_len(t["window_s"], t["fs_model"])
        self.wire_len = traffic.window_len(t["window_s"], t["fs_wire"])
        self.flops_per_window = train_flops(self.cfg, self.samples)
        self.program: dict = {}

    # ---- the program ---------------------------------------------------------------------

    def setup(self) -> None:
        cfg, t, opt = self.cfg, self.traffic, self.traffic["optimizer"]
        ccfg = port_config(cfg, self.cell.config, t["fs_model"])
        self.model = build_model(ccfg, make_weights(cfg, self.seed, self.device),
                                 cfg.compute_dtype, self.device, train=True)
        waves, labels = traffic.train_windows(t, self.seed, self.device)
        self.data = ArrayDataset(waves, labels)
        self.trainer = SupervisedTrainer(
            self.model, optimizer_name=opt["name"], lr=opt["lr"],
            weight_decay=opt["weight_decay"], classifier_config=ccfg, seed=self.seed,
            device_preprocess=_device_prep(t["fs_wire"], t["fs_model"], self.samples,
                                           self.device),
            log=lambda line: None)
        self.loader = make_loader(self.data, t["batch_size"], True, self.seed, self.wire_len)
        self._checked_steps(t["checked_steps"], opt["weight_decay"])

    def _checked_steps(self, steps: int, weight_decay: float) -> None:
        names = [n for n, _ in self.model.named_parameters()]
        optim = self.trainer.optimizer
        if len(optim.params) != len(names):
            raise RuntimeError("the optimizer does not train every leaf")
        master0 = [m.detach().to("cpu", copy=True) for m in optim.master]
        inputs: list[np.ndarray] = []
        hook = self.model.register_forward_pre_hook(
            lambda module, args: inputs.append(args[0].detach().float().cpu().numpy()))
        self.data.taken = []
        losses, grad = [], {}
        for step in range(steps):
            _, loss = self.trainer._run_epoch(self.loader, True, max_batches=1)
            losses.append(float(loss))
            if step == 0:         # the first clipped gradient: momentum buffer minus the decay
                grad = {n: float(torch.linalg.vector_norm(
                    b - weight_decay * m0.to(b.device)))
                    for n, b, m0 in zip(names, optim.state, master0)}
        delta = {n: float(torch.linalg.vector_norm(m - m0.to(m.device)))
                 for n, m, m0 in zip(names, optim.master, master0)}
        hook.remove()
        self.batches, self.data.taken = self.data.taken, None
        self.program = {"losses": losses, "grad": grad, "delta": delta, "inputs": inputs}

    def window(self, seconds: float) -> dict:
        """``_run_epoch`` over the training feed until ``seconds`` have passed; every step
        queued by then completes inside the window."""
        sync(self.device)
        t0 = time.perf_counter()
        feed = Feed(self.loader, deadline=t0 + seconds)
        failed = 0
        while time.perf_counter() < feed.deadline:
            before = feed.valid_rows
            _, loss = self.trainer._run_epoch(feed, True, None)
            if not math.isfinite(loss):
                failed += feed.valid_rows - before
        sync(self.device)
        return {"seconds": time.perf_counter() - t0, "windows": feed.valid_rows,
                "batches": feed.batches, "failed": failed, "wait_s": feed.wait_s}

    def end_to_end(self, obs: dict) -> dict:
        return {"train_windows_per_s": obs["windows"] / obs["seconds"]}

    def stretch(self, warm: int, steps: int):
        """A profiled stretch of ``steps`` steps inside one ``_run_epoch``, after ``warm``."""
        rng = PosConvRange(self.model.encoder.encoder.pos_conv_embed, POS_CONV_RANGE)
        prof = Stretch(self.model, warm, steps, self.device, ranges=(POS_CONV_RANGE,))
        self.trainer._run_epoch(Feed(self.loader, limit=warm + steps + 1), True, None)
        rng.remove()
        return summarise(prof)

    def release(self) -> None:
        del self.trainer, self.model, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference -------------------------------------------------------------------

    def reference(self, precision: str = "float32", loss_rows: int | None = None) -> dict:
        """The checked steps again in the plain reference: losses, first clipped gradient and
        last change per leaf (norms), and the preprocessed windows of each step."""
        cfg, t, opt = self.cfg, self.traffic, self.traffic["optimizer"]
        prep = {**t["preprocessing"], "fs_wire": t["fs_wire"], "fs_model": t["fs_model"],
                "win_len": self.samples}
        xs, batches = [], []
        for idx in self.batches:
            x = reference.chain(wire(self.data.waves[idx], t["wire_scale"]), prep, precision)
            xs.append(x)
            batches.append((torch.as_tensor(x, dtype=torch.float32, device=self.device),
                            torch.as_tensor(self.data.labels[idx], device=self.device)))
        draws = reference.step_draws(self.seed, len(batches), t["batch_size"],
                                     cfg.frames(self.samples), cfg.mask_time_prob,
                                     cfg.mask_time_length)
        weights = make_weights(cfg, self.seed, self.device)
        out = reference.train(cfg, {n: v.float() for n, v in weights.items()}, batches, draws,
                              reference.Optimizer(opt["lr"], opt["momentum"],
                                                  opt["weight_decay"], opt["clip"]),
                              self.cell.check["block_rows"],
                              {n: v.dtype for n, v in weights.items()}, precision, loss_rows)
        return {"losses": out["losses"], "grad": compare.leaf_norms(out["grad"]),
                "delta": compare.leaf_norms(out["delta"]), "inputs": xs}

    def readings(self, ref: dict, candidate: dict | None = None) -> dict:
        """Readings of ``candidate`` (the program's record by default, or a control's
        :meth:`reference`) against the reference ``ref``."""
        cand = self.program if candidate is None else candidate
        gap = max(float(np.abs(np.asarray(a, dtype=np.float64) - b).max())
                  for a, b in zip(cand["inputs"], ref["inputs"]))
        return compare.train_readings({**cand, "prep_gap": gap}, ref)
