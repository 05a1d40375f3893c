"""A scoring cell: ``experiments.cinc.score`` over a seeded corpus, pass after pass.

Set-up builds the classifier (eval) from the benchmark's weights, the corpus from the seed,
and the port's eval ``Batcher`` (float32 wire, the last batch of a pass padded); it scores
``warm_batches`` batches to build and warm every kernel. Before the window it draws the
checked sample from the seed: for the first pass ``patients_first_pass`` recordings from the
whole pass, among them the longest and the one that ends in the padded last batch; for pass
``later_pass`` another ``patients_later_pass``. In the window, ``score`` runs on a feed that
ends at the deadline, again from the first batch each time; a forward pre-hook copies the
model's input rows of the sampled windows of those passes, without a sync, into pinned
host buffers made in set-up.

After the window, :meth:`ScoreCell.reference` scores the sampled windows with the plain
reference from the same raw windows and weights; every pass's verdicts are also recounted
from the program's own logits.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from wav2vec_heart_sounds_tpu_torch.experiments.cinc import score
from wav2vec_heart_sounds_tpu_torch.experiments.common import make_loader

from . import compare, reference, traffic
from .configs import ModelConfig
from .flops import forward_flops
from .program import ArrayDataset, Feed, build_model, port_config, sync
from .trace import Stretch, summarise
from .weights import make_weights


class ScoreCell:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg = ModelConfig.from_file(cell.config)
        self.traffic = t = cell.traffic
        self.samples = traffic.window_len(t["window"]["window_s"], t["fs_model"])
        self.wire_len = traffic.window_len(t["window"]["window_s"], t["fs_wire"])
        self.flops_per_window = forward_flops(self.cfg, self.samples)

    def _score(self, feed: Feed) -> dict:
        t = self.traffic
        return score(self.model, feed, t["fs_wire"], t["fs_model"], self.samples)

    def setup(self) -> None:
        cfg, t = self.cfg, self.traffic
        ccfg = port_config(cfg, self.cell.config, t["fs_model"])
        self.model = build_model(ccfg, make_weights(cfg, self.seed, self.device),
                                 cfg.compute_dtype, self.device, train=False)
        self.corpus = c = traffic.score_corpus(t, self.seed, self.device)
        self.data = ArrayDataset(c["waves"], c["labels"], c["patients"])
        self.loader = make_loader(self.data, t["batch_size"], False, self.seed, self.wire_len)
        self._score(Feed(self.loader, limit=t["warm_batches"]))
        self._draw_sample()

    def _draw_sample(self) -> None:
        """``self.sample``: per checked pass (0-based), its sampled windows' rows."""
        check, patients = self.cell.check, self.corpus["patients"]
        count = len(self.corpus["offsets"]) - 1
        rng = np.random.default_rng(self.seed)
        fixed = np.unique([np.argmax(np.diff(self.corpus["offsets"])), patients[-1]])
        first = np.concatenate([fixed, rng.choice(np.setdiff1d(np.arange(count), fixed),
                                                  check["patients_first_pass"] - len(fixed),
                                                  replace=False)])
        later = rng.choice(np.setdiff1d(np.arange(count), first), check["patients_later_pass"],
                           replace=False)
        self.sample = {0: np.flatnonzero(np.isin(patients, first)),
                       check["later_pass"] - 1: np.flatnonzero(np.isin(patients, later))}

    def _capture_plan(self) -> tuple[dict, dict]:
        """Pinned host buffers, one a checked pass, and per model call (pass x batches + batch)
        the device index of its sampled rows and where they go in the pass's buffer."""
        bs, n = self.traffic["batch_size"], len(self.corpus["patients"])
        per_pass = -(-n // bs)
        pinned = self.device.type == "cuda"
        buffers, plan = {}, {}
        for p, rows in self.sample.items():
            buffers[p] = torch.empty((len(rows), self.samples), dtype=torch.float32,
                                     pin_memory=pinned)
            for b in np.unique(rows // bs):
                at = np.flatnonzero(rows // bs == b)
                plan[p * per_pass + int(b)] = (
                    p, torch.as_tensor(rows[at] - b * bs, device=self.device),
                    int(at[0]), int(at[-1]) + 1)
        return buffers, plan

    def window(self, seconds: float) -> dict:
        buffers, plan = self._capture_plan()
        done: set[int] = set()
        calls = [0]

        def keep_inputs(module, args):
            call = calls[0]
            calls[0] += 1
            if call in plan:
                p, index, k0, k1 = plan[call]
                buffers[p][k0:k1].copy_(args[0].index_select(0, index).float(),
                                        non_blocking=True)
                done.add(call)

        hook = self.model.register_forward_pre_hook(keep_inputs)
        sync(self.device)
        t0 = time.perf_counter()
        feed = Feed(self.loader, deadline=t0 + seconds)
        passes, ends = [], []
        while time.perf_counter() < feed.deadline:
            passes.append(self._score(feed))
            ends.append(time.perf_counter() - t0)
            if len(passes) > max(self.sample):
                hook.remove()                       # the checked passes are done
        sync(self.device)
        seconds_run = time.perf_counter() - t0
        hook.remove()
        self.passes = passes
        self.kept = {p: buf.numpy() for p, buf in buffers.items()
                     if all(c in done for c, entry in plan.items() if entry[0] == p)}
        failed = sum(int((~np.isfinite(p["logits"])).any(axis=1).sum()) for p in passes)
        return {"seconds": seconds_run, "windows": feed.valid_rows, "batches": feed.batches,
                "failed": failed, "wait_s": feed.wait_s, "latency_s": feed.latency_s,
                "pass_s": np.diff([0.0] + ends).round(3).tolist()}

    def end_to_end(self, obs: dict) -> dict:
        """The rate, and the 95th percentile over every batch of the window of the time from
        the batch leaving the port's ``Batcher`` to the loop asking for the next one (its
        logits on the host and counted by ``evaluate``): what one screening request of up to
        a batch of windows waits."""
        return {"score_windows_per_s": obs["windows"] / obs["seconds"],
                "score_batch_p95_ms": 1e3 * float(np.percentile(obs["latency_s"], 95))}

    def stretch(self, warm: int, steps: int):
        prof = Stretch(self.model, warm, steps, self.device)
        self._score(Feed(self.loader, limit=warm + steps + 1))
        return summarise(prof)

    def release(self) -> None:
        del self.model, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference -------------------------------------------------------------------

    def reference(self, precision: str = "float32") -> dict:
        """The sampled windows through the reference chain and model: their preprocessed
        windows and logits, pass after checked pass, and each sampled patient's verdict
        probability (keyed by pass and patient)."""
        t = self.traffic
        prep = {**t["preprocessing"], "fs_wire": t["fs_wire"], "fs_model": t["fs_model"],
                "win_len": self.samples}
        rows = np.concatenate(list(self.sample.values()))
        x = reference.chain(self.corpus["waves"][rows].astype(np.float64), prep, precision)
        w = {n: v.float() for n, v in make_weights(self.cfg, self.seed, self.device).items()}
        z = reference.logits(self.cfg, w, torch.as_tensor(x, dtype=torch.float32,
                                                          device=self.device),
                             self.cell.check["block_rows"], precision).cpu().numpy()
        return {"inputs": x, "logits": z, "probs": self._probs(z)}

    def _probs(self, logits: np.ndarray) -> dict:
        out, at = {}, 0
        for p, rows in self.sample.items():
            probs = compare.patient_probabilities(logits[at:at + len(rows)],
                                                  self.corpus["patients"][rows])
            out.update({(p, patient): v for patient, v in probs.items()})
            at += len(rows)
        return out

    def program_record(self) -> dict | None:
        """The program's preprocessed windows, logits and patient probabilities of the
        sample, pass after checked pass (``None`` when the window did not score every
        sampled window of the checked passes)."""
        if any(p >= len(self.passes) or p not in self.kept
               or len(self.passes[p]["logits"]) <= rows.max()
               for p, rows in self.sample.items()):
            return None
        z = np.concatenate([self.passes[p]["logits"][rows] for p, rows in self.sample.items()])
        return {"inputs": np.concatenate([self.kept[p] for p in self.sample]), "logits": z,
                "probs": self._probs(z)}

    def verdict_mismatches(self) -> int:
        """Passes whose fragment or patient verdicts differ from those recounted from the
        pass's own logits."""
        n = len(self.corpus["labels"])
        bad = 0
        for p in self.passes:
            rows = min(n, len(p["logits"]))
            labels, patients = self.corpus["labels"][:rows], self.corpus["patients"][:rows]
            ours = compare.verdict_counts(p["logits"][:rows], labels, patients)
            first = np.unique(patients, return_index=True)[1]
            theirs = {"fragment": compare.counts_of(p["fragment"], labels),
                      "patient": compare.counts_of(p["patient"], labels[first])}
            bad += ours != theirs
        return bad

    def readings(self, ref: dict, candidate: dict | None = None) -> dict:
        cand = self.program_record() if candidate is None else candidate
        if cand is None:
            return {"prep_gap": float("nan"), "logit_gap": float("nan"),
                    "patient_prob_gap": float("nan"), "verdict_mismatches": float("nan")}
        return {
            "prep_gap": float(np.abs(cand["inputs"] - ref["inputs"]).max()),
            "logit_gap": float(np.abs(cand["logits"] - ref["logits"]).max()
                               / np.abs(ref["logits"]).max()),
            "patient_prob_gap": max(abs(cand["probs"][p] - ref["probs"][p])
                                    for p in ref["probs"]),
            "verdict_mismatches": float(self.verdict_mismatches() if candidate is None else 0),
        }
