"""``attention_roofline.train``: K3b, the packed-QKV attention (``csrc/attention_qkv_fwd.cu``,
``attention_qkv_bwd.cu``), against its bound, in %.

The least time the card could take for one training step of its work (each layer's forward
and backward at the configuration's heads and head dim), over the device time a step of its
kernels in the traced stretch (``attention_fwd_kernel``, ``attention_bwd_dq_kernel``,
``attention_bwd_dkdv_kernel``). Each call's bound is the larger of its bytes over 3.35 TB/s
(q, k, v, the output and the row log-sum-exp read or written once) and its score-shaped
products over 989 TFLOP/s (bf16): ``k1_k4_roofline``'s attention count, copied here."""

import re

from benchmark.harness.peaks import bound_s

KERNELS = re.compile(r"\battention_(fwd|bwd_dq|bwd_dkdv)_kernel\b")


def bound_per_step(cfg, batch: int, frames: int) -> float:
    """Seconds: the summed bound of one training step's K3b calls."""
    dtype = cfg.compute_dtype
    d, h = cfg.hidden_size, cfg.num_heads
    rows_d = batch * frames * d * dtype.itemsize
    qkv, out, lse = 3 * rows_d, rows_d, batch * h * frames * 4
    scores = 4.0 * batch * h * frames * frames * (d // h)
    return cfg.num_layers * (bound_s(qkv + out + lse, scores, dtype)
                             + bound_s(2 * qkv + 2 * out + lse, 2.5 * scores, dtype))


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
