"""A run with the timed path broken underneath comes out not correct: the harness driven on
the CPU at the tiny cells' size (its look for a card skipped), once for each fault the cells
can have. No cell spans chips, so no exchange between chips can be left out."""

import pytest
import torch

from benchmark.harness.runner import run_cell
from wav2vec_heart_sounds_tpu_torch.models.classifier import MLPHead
from wav2vec_heart_sounds_tpu_torch.train import classifier as trainer_module
from wav2vec_heart_sounds_tpu_torch.train.optim import MasterOptimizer


def failing(result) -> set[str]:
    assert result["correct"] is False
    return {name for name, c in result["checks"].items()
            if not isinstance(c["value"], float) or c["value"] > c["limit"]}


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(MasterOptimizer, "step", lambda self, lr: None)
    bad = failing(run_cell("tiny-train", 21, 0.5, False, device="cpu", layout=tiny))
    assert "update_gap_median_leaf" in bad


def test_half_of_the_batch_left_out(tiny, monkeypatch):
    full = trainer_module.cross_entropy

    def half(logits, labels, valid=None):
        n = len(logits) // 2
        return full(logits[:n], labels[:n], None if valid is None else valid[:n])

    monkeypatch.setattr(trainer_module, "cross_entropy", half)
    bad = failing(run_cell("tiny-train", 22, 0.5, False, device="cpu", layout=tiny))
    assert {"loss_gap", "grad_gap_median_leaf"} <= bad


def altered_head(monkeypatch):
    forward = MLPHead.forward

    def altered(self, x):
        out = forward(self, x)
        shift = torch.zeros_like(out)
        shift[0, 0] = 0.5                                   # the first row's first class
        return out + shift

    monkeypatch.setattr(MLPHead, "forward", altered)


def test_an_answer_altered_where_it_is_produced_in_training(tiny, monkeypatch):
    altered_head(monkeypatch)
    assert "loss_gap" in failing(run_cell("tiny-train", 23, 0.5, False, device="cpu",
                                          layout=tiny))


def test_an_answer_altered_where_it_is_produced_in_scoring(tiny, monkeypatch):
    altered_head(monkeypatch)
    result = run_cell("tiny-score", 24, 3.0, False, device="cpu", layout=tiny)
    gap = result["checks"]["logit_gap"]
    assert "logit_gap" in failing(result) and isinstance(gap["value"], float)


@pytest.mark.parametrize("cell, seconds", [("tiny-train", 0.5), ("tiny-score", 3.0)])
def test_spikes_left_in_the_windows(tiny, monkeypatch, cell, seconds):
    """The despike stage skipped: the planted spikes reach the model."""
    from wav2vec_heart_sounds_tpu_torch.signal import torchproc

    monkeypatch.setattr(torchproc, "remove_spikes", lambda x, fs, *args, **kwargs: x)
    assert "prep_gap" in failing(run_cell(cell, 25, seconds, False, device="cpu",
                                          layout=tiny))
