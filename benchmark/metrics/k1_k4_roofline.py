"""``k1_k4_roofline``: the port's training kernels K1-K4 against their bound, in %.

The least time the card could take for the work K1-K4 do in one training step, summed,
over the device time a step of the kernels that do it (the traced stretch's, per step).
The work comes from the configuration's shapes, not from launch counts: K1 the feature
projection's and the encoder's dropout, forward and backward; per layer K2 the attention
tail ``LN(x + dropout(h))``, K3b the packed-QKV attention, K4 the FFN sublayer (its (A)/(B)
products, the row LayerNorm, and in the backward (C) and (D)), each forward and backward.
Each call's bound is the larger of its bytes over 3.35 TB/s (each input read once, each
output written once; partial sums left out) and its products over 989 TFLOP/s (bf16): the
bound arithmetic of the port's ``chip_smoke.py`` (``bound``, ``attention_work``, phase 5's
bytes), copied here. Philox's integer work is not bounded here, so K1 and K2 are held to
their bytes alone."""

import re

from benchmark.harness.peaks import bound_s

KERNELS = re.compile(r"\b(dropout_kernel|resid_fwd_kernel|resid_bwd_kernel|ln_rows_kernel|"
                     r"attention_fwd_kernel|attention_bwd_dkdv_kernel|attention_bwd_dq_kernel|"
                     r"ffn_(up|down|dgrad)(_wgmma)?_kernel)\b")


def bound_per_step(cfg, batch: int, frames: int) -> float:
    """Seconds: the summed bound of one training step's K1-K4 calls."""
    dtype = cfg.compute_dtype
    size = dtype.itemsize
    n, d, f, h = batch * frames, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads
    rows_d, rows_f = n * d * size, n * f * size
    vectors = 2 * d * 4                                   # LayerNorm scale and shift, float32
    k1 = 4 * bound_s(2 * rows_d, 0.0, dtype)
    k2 = bound_s(4 * rows_d + vectors, 0.0, dtype) + bound_s(4 * rows_d + vectors // 2, 0.0, dtype)
    qkv, out, lse = 3 * rows_d, rows_d, batch * h * frames * 4
    scores = 4.0 * batch * h * frames * frames * (d // h)
    k3 = bound_s(qkv + out + lse, scores, dtype) + bound_s(2 * qkv + 2 * out + lse, 2.5 * scores,
                                                           dtype)
    weights, products = 2 * d * f * size, 2.0 * n * d * f
    k4 = (bound_s(3 * rows_d + weights + rows_f, 2 * products, dtype)
          + bound_s(4 * rows_d + weights // 2 + 3 * rows_f, products, dtype))
    return k1 + cfg.num_layers * (k2 + k3 + k4)


def read(run):
    t = run.trace
    if t is None:
        return None
    ns = sum(end - start for name, start, end in t.device if KERNELS.search(name))
    if not ns:
        return None
    drv = run.measured
    bound = bound_per_step(drv.cfg, drv.traffic["batch_size"], drv.cfg.frames(drv.samples))
    return 100.0 * bound / (ns / 1e9 / t.steps)
