"""FFN sublayer (K4) as the bfloat16 kernels run it: stages, and the layouts they take.

``csrc/ffn_mega.cu`` computes the forward as (A) ``x W1^T`` with the bias, GELU and the
activation mask in its epilogue, (B) ``h W2^T`` whose epilogue forms ``s``, then a row
LayerNorm pass over ``s``; the backward as (C) K2's row pass and (D) ``dhid W2`` whose
epilogue forms ``dpre``, ``h`` and the db1 sums. The plain versions of those stages,
composed as the kernels compose them, equal the two plain versions of the whole sublayer
bit for bit (float32 and bfloat16, rates 0.1 and 0, 1, 127 and 400 rows), which
``test_torch_megakernel.py`` holds to the JAX package. The wrappers raise ``ValueError`` on
what the TMA loads and 16-byte epilogue accesses cannot take, before any CUDA call. The
kernels themselves are held to the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from wav2vec_heart_sounds_tpu_torch.ops import philox
from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk
from wav2vec_heart_sounds_tpu_torch.ops.kernels.resid import (layer_norm_reference,
                                                              resid_bwd_reference)

D, F = 768, 384
EPS = 1e-5
SEED, S_ACT, S_HID = 2024, 4, 5


def _tensors(rows, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, dt=dtype):
        return torch.from_numpy((std * rng.normal(size=shape)).astype(np.float32)).to(dt)

    return dict(x=t(rows, D), w1=t(F, D, std=D ** -0.5), b1=t(F, std=0.1),
                w2=t(D, F, std=F ** -0.5), b2=t(D, std=0.1),
                lw=1.0 + t(D, std=0.1, dt=torch.float32), lb=t(D, std=0.1, dt=torch.float32),
                g=t(rows, D))


@pytest.mark.parametrize("rows", [1, 127, 400])
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stages_compose_to_the_plain_sublayer(dtype, rate, rows):
    a = _tensors(rows, dtype, seed=rows)
    # forward: (A), (B), the row LayerNorm
    pre, h = mk.ffn_up_reference(a["x"], a["w1"], a["b1"], SEED, S_ACT, rate)
    s = mk.ffn_down_reference(h, a["w2"], a["b2"], a["x"], SEED, S_HID, rate)
    y = layer_norm_reference(s, a["lw"], a["lb"], EPS)
    whole = mk.ffn_mega_fwd_reference(a["x"], a["w1"], a["b1"], a["w2"], a["b2"], a["lw"],
                                      a["lb"], SEED, S_ACT, S_HID, rate, rate, EPS)
    for name, got, want in zip(("y", "s", "pre"), (y, s, pre), whole):
        assert got.dtype == want.dtype and torch.equal(got, want), name
    if rate:
        keep = philox.keep_mask(SEED, S_ACT, (rows, F), rate)
        assert not bool(h[~keep].any())                       # (A)'s mask is the act site's

    # backward: (C), then (D)
    dhid, ds, dweight, dbias = resid_bwd_reference(a["g"], s, a["lw"], SEED, S_HID, rate, EPS)
    dpre, h_again, db1 = mk.ffn_dgrad_reference(dhid, a["w2"], pre, SEED, S_ACT, rate)
    got = (ds, dhid, dpre, h_again, db1, dhid.sum(0), dweight, dbias)
    whole = mk.ffn_mega_bwd_reference(a["g"], s, pre, a["w2"], a["lw"], SEED, S_ACT, S_HID,
                                      rate, rate, EPS)
    names = ("ds", "dhid", "dpre", "h", "db1", "db2", "dweight", "dbias")
    for name, g, w in zip(names, got, whole):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(h_again, h)                            # (D) recomputes (A)'s h


def _misaligned(rows, cols):
    """A [rows, cols] bf16 view whose base is 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 8, dtype=torch.bfloat16)
    off = (-(flat.data_ptr() // 2) + 1) % 8
    return flat[off:off + rows * cols].view(rows, cols)


def _strided(rows, cols, pad):
    """A [rows, cols] bf16 view of [rows, cols + pad] (row stride (cols + pad) * 2 bytes)."""
    return torch.zeros(rows, cols + pad, dtype=torch.bfloat16)[:, :cols]


def _fwd_args(**over):
    a = _tensors(8, torch.bfloat16)
    args = dict(x=a["x"], w1=a["w1"], b1=a["b1"], w2=a["w2"], b2=a["b2"], lw=a["lw"],
                lb=a["lb"])
    args.update(over)
    return (args["x"], args["w1"], args["b1"], args["w2"], args["b2"], args["lw"], args["lb"],
            SEED, S_ACT, S_HID, 0.1, 0.1, EPS)


def _bwd_args(**over):
    a = _tensors(8, torch.bfloat16)
    args = dict(g=a["g"], s=a["x"], pre=torch.zeros(8, F, dtype=torch.bfloat16), w2=a["w2"],
                lw=a["lw"])
    args.update(over)
    return (args["g"], args["s"], args["pre"], args["w2"], args["lw"], SEED, S_ACT, S_HID,
            0.1, 0.1, EPS)


@pytest.mark.parametrize("case", ["ffn_width", "row_width", "fwd_base", "fwd_row_stride",
                                  "bwd_base", "bwd_row_stride"])
def test_wrappers_reject_what_tma_cannot_take(case):
    """Each refusal is a ValueError naming the reason, raised from the argument checks on
    CPU tensors, so it comes before any CUDA call (and counts no launch)."""
    calls = {
        "ffn_width": (mk.ffn_mega_fwd_kernel, _fwd_args(
            w1=torch.zeros(204, D, dtype=torch.bfloat16), b1=torch.zeros(204, dtype=torch.bfloat16),
            w2=torch.zeros(D, 204, dtype=torch.bfloat16)), "multiples of 8"),
        "row_width": (mk.ffn_mega_fwd_kernel, _fwd_args(
            x=torch.zeros(8, 1032, dtype=torch.bfloat16)), "at most 1024"),
        "fwd_base": (mk.ffn_mega_fwd_kernel, _fwd_args(x=_misaligned(8, D)), "16-byte aligned"),
        "fwd_row_stride": (mk.ffn_mega_fwd_kernel, _fwd_args(x=_strided(8, D, 4)),
                           "row strides must be multiples of 16 bytes, got 1544"),
        "bwd_base": (mk.ffn_mega_bwd_kernel, _bwd_args(g=_misaligned(8, D)), "16-byte aligned"),
        "bwd_row_stride": (mk.ffn_mega_bwd_kernel, _bwd_args(pre=_strided(8, F, 4)),
                           "row strides must be multiples of 16 bytes, got 776"),
    }
    fn, args, reason = calls[case]
    before = (mk.ffn_mega_fwd_kernel.launches, mk.ffn_mega_bwd_kernel.launches)
    with pytest.raises(ValueError, match=reason):
        fn(*args)
    assert (mk.ffn_mega_fwd_kernel.launches, mk.ffn_mega_bwd_kernel.launches) == before
