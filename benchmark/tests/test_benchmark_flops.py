"""The operation count against hand arithmetic at the published widths."""

import json

import pytest

from benchmark.harness.cells import REPO
from benchmark.harness.configs import ModelConfig
from benchmark.harness.flops import forward_flops, products, train_flops


def config(name):
    return ModelConfig.from_file(
        json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text()))


def conv_by_hand():
    # lengths of a 4 s window at 16 kHz through kernels 10,3,3,3,3,2,2 / strides 5,2,...,2
    lengths = (12799, 6399, 3199, 1599, 799, 399, 199)
    return (2 * 12799 * 512 * 1 * 10
            + sum(2 * n * 512 * 512 * 3 for n in lengths[1:5])
            + sum(2 * n * 512 * 512 * 2 for n in lengths[5:]))


@pytest.mark.parametrize("name, d, layers, f, g", [("wav2vec2-base-cinc", 768, 12, 3072, 16),
                                                   ("wav2vec2-large-cinc", 1024, 24, 4096, 16)])
def test_counts_match_hand_arithmetic(name, d, layers, f, g):
    cfg = config(name)
    t = 199
    conv = sum(ops for n, ops, _ in products(cfg, 64000) if n.startswith("conv_"))
    assert conv == conv_by_hand()
    assert conv / 1e9 == pytest.approx(19.6, abs=0.05)
    layer = 2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d + 2 * 2 * t * d * f
    head = 2 * (d * 512 + 512 * 512 + 512 * 512 + 512 * 2)
    forward = conv + 2 * t * 512 * d + 2 * t * d * (d // g) * 128 + layers * layer + head
    assert forward_flops(cfg, 64000) == forward
    conv0 = 2 * 12799 * 512 * 10
    assert train_flops(cfg, 64000) == 3 * forward - conv0


def test_whole_window_counts():
    assert forward_flops(config("wav2vec2-base-cinc"), 64000) / 1e9 == pytest.approx(56.9, abs=0.1)
    assert train_flops(config("wav2vec2-base-cinc"), 64000) / 1e9 == pytest.approx(170.6, abs=0.2)
    assert train_flops(config("wav2vec2-large-cinc"), 64000) / 1e9 == pytest.approx(441.5, abs=0.3)
