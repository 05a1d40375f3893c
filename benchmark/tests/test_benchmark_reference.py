"""The plain reference against the port's plain (CPU) path at small sizes."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import reference, traffic
from benchmark.harness.cells import REPO
from benchmark.harness.configs import ModelConfig
from benchmark.harness.program import build_model, port_config
from benchmark.harness.train_cell import wire
from benchmark.harness.weights import make_weights


@pytest.mark.parametrize("start, n", [(0, 17), (3, 10), (4096 * 4 + 2, 33), (2 ** 33 + 1, 9)])
def test_philox_bits_are_the_ports(start, n):
    """The port's bits of elements ``start ..``: its ``bits`` from 0, cut, where that is
    small; its counter arithmetic (``philox4x32`` at counter ``i // 4``) everywhere."""
    from wav2vec_heart_sounds_tpu_torch.ops import philox

    ours = reference.philox_bits(123456789, 7, start, n, "cpu")
    g = torch.arange(start // 4, (start + n + 3) // 4, dtype=torch.int64)
    zero = torch.zeros_like(g)
    words = philox.philox4x32(g & philox.MASK32, g >> 32, zero, zero, 123456789, 7)
    assert torch.equal(ours, torch.stack(words, dim=1).reshape(-1)[start % 4:start % 4 + n])
    if start < 2 ** 20:
        assert torch.equal(ours, philox.bits(123456789, 7, start + n)[start:])


def test_chain_agrees_with_the_ports_chain():
    from wav2vec_heart_sounds_tpu_torch.experiments.cinc import _device_prep

    t = json.loads((REPO / "benchmark" / "traffic" / "cinc-train-raw2k.json").read_text())
    waves, _ = traffic.train_windows({**t, "count": 6}, 31, "cpu")
    q = np.clip(np.round(waves * 32767.0), -32767, 32767).astype(np.int16)
    port = _device_prep(2000, 16000, 64000, "cpu")(torch.as_tensor(q)).numpy()
    prep = {**t["preprocessing"], "fs_wire": 2000, "fs_model": 16000, "win_len": 64000}
    ours = reference.chain(wire(waves, 32767.0), prep)
    assert port.shape == ours.shape == (6, 64000)
    assert np.abs(port - ours).max() < 1e-4
    control = reference.chain(wire(waves, 32767.0), prep, precision="fp8")
    assert np.abs(control - ours).max() > 10 * np.abs(port - ours).max()


def test_eval_logits_agree_with_the_ports_model(tiny):
    cell = tiny.cell("tiny-score")
    cfg = ModelConfig.from_file(cell.config)
    weights = make_weights(cfg, 99, "cpu")
    model = build_model(port_config(cfg, cell.config, 4000), weights, torch.float32, "cpu",
                        train=False)
    x = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (5, 4000)), dtype=torch.float32)
    with torch.no_grad():
        port = model(x)
    ours = reference.logits(cfg, weights, x, block_rows=2)
    torch.testing.assert_close(ours, port, rtol=1e-4, atol=1e-5)
