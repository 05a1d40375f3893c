"""Operations of the model, counted from the configuration's shapes (the yardstick of the
``*_mfu`` metrics and of the kernels' bounds).

A product of an ``[m, k]`` by a ``[k, n]`` matrix counts ``2 m n k``; a convolution counts
its products the same way. Counted: the conv feature encoder, the feature projection, the
positional convolution, each layer's q/k/v and output projections, the attention's two
score-shaped products, the FFN, and the head. Not counted: norms, activations, softmax,
dropout, the optimizer and the preprocessing chain. A training step counts the forward, the
input gradient of every product whose input needs one (all but the first convolution, whose
input is the waveform) and every weight gradient, each as many operations as the forward
product; nothing recomputed. The count is the same in both architectures of
:mod:`.configs`: where the norms sit and the conv layers' biases are no products.
"""

from __future__ import annotations

from .configs import ModelConfig


def products(cfg: ModelConfig, samples: int) -> list[tuple[str, float, bool]]:
    """(name, forward operations, input needs a gradient) of each product of one window of
    ``samples`` samples at the model's rate."""
    out = []
    cin = (1,) + tuple(cfg.conv_dim[:-1])
    n = samples
    for i, (ci, co, k, s) in enumerate(zip(cin, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
        n = (n - k) // s + 1
        out.append((f"conv_{i}", 2.0 * n * co * ci * k, i > 0))
    t, d, f = n, cfg.hidden_size, cfg.intermediate_size
    out.append(("feature_projection", 2.0 * t * cfg.conv_dim[-1] * d, True))
    out.append(("pos_conv", 2.0 * t * d * (d // cfg.pos_conv_groups) * cfg.pos_conv_kernel, True))
    for layer in range(cfg.num_layers):
        out += [(f"layer_{layer}.qkv", 2.0 * t * d * 3 * d, True),
                (f"layer_{layer}.scores", 2.0 * t * t * d, True),
                (f"layer_{layer}.values", 2.0 * t * t * d, True),
                (f"layer_{layer}.out_proj", 2.0 * t * d * d, True),
                (f"layer_{layer}.ffn", 2.0 * 2 * t * d * f, True)]
    width = d
    for i, hidden in enumerate(cfg.head_hidden):
        out.append((f"head.dense_{i}", 2.0 * width * hidden, True))
        width = hidden
    out.append(("head.logits", 2.0 * width * cfg.num_classes, True))
    return out


def forward_flops(cfg: ModelConfig, samples: int) -> float:
    """Operations of one window's forward."""
    return sum(ops for _, ops, _ in products(cfg, samples))


def train_flops(cfg: ModelConfig, samples: int) -> float:
    """Operations of one window's training step: forward, input and weight gradients."""
    return sum(ops * (3.0 if needs_input_grad else 2.0)
               for _, ops, needs_input_grad in products(cfg, samples))
