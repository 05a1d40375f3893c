"""``prenorm_roofline.train``: the pre-norm forms of K2 and K4 (the stable-layer-norm
encoder's sublayer tails, ``ops/kernels/resid.py::dropout_add_layernorm_prenorm`` and
``ops/kernels/megakernel.py::ffn_block_prenorm``) against their bound, in %.

The least time the card could take for one training step of their work, summed, over the
device time a step of their kernels in the traced stretch (``resid_fwd_kernel``,
``resid_bwd_kernel``, ``ln_rows_kernel``, ``ffn_up`` / ``ffn_down`` / ``ffn_dgrad``: in a
stable-layer-norm cell every launch of them is a pre-norm form). The work comes from the
configuration's shapes: K2's form once on the encoder's input and once a layer, K4's once a
layer, each forward and backward. Each call's bound is the larger of its bytes over 3.35
TB/s (each input read once, each output written once, partial sums left out) and its
products over 989 TFLOP/s (bf16):

- K2 forward reads h and x, writes the stream s and LN(s); backward reads both cotangents
  and s, writes dh and dx (the LayerNorm's float32 vectors beside them);
- K4 forward reads x (the normalised stream), the residual r and both weights, writes pre,
  s and y, two products of 2 N D F; backward reads both cotangents, s, pre and W2, writes
  ds, dhid, dpre and h, one product (dhid W2).

Philox's integer work is not bounded here, as in ``k1_k4_roofline``."""

import re

from benchmark.harness.peaks import bound_s

KERNELS = re.compile(r"\b(resid_fwd_kernel|resid_bwd_kernel|ln_rows_kernel|"
                     r"ffn_(up|down|dgrad)(_wgmma)?_kernel)\b")


def bound_per_step(cfg, batch: int, frames: int) -> float:
    """Seconds: the summed bound of one training step's pre-norm K2 and K4 calls."""
    dtype = cfg.compute_dtype
    size = dtype.itemsize
    n, d, f = batch * frames, cfg.hidden_size, cfg.intermediate_size
    rows_d, rows_f = n * d * size, n * f * size
    vectors = 2 * d * 4                                   # LayerNorm scale and shift, float32
    k2 = bound_s(4 * rows_d + vectors, 0.0, dtype) + bound_s(5 * rows_d + vectors // 2, 0.0,
                                                             dtype)
    weights, products = 2 * d * f * size, 2.0 * n * d * f
    k4 = (bound_s(4 * rows_d + weights + rows_f, 2 * products, dtype)
          + bound_s(5 * rows_d + weights // 2 + 3 * rows_f, products, dtype))
    return (cfg.num_layers + 1) * k2 + cfg.num_layers * k4


def read(run):
    t = run.trace
    if t is None or not run.measured.cfg.do_stable_layer_norm:
        return None
    ns = sum(end - start for name, start, end in t.device if KERNELS.search(name))
    if not ns:
        return None
    drv = run.measured
    bound = bound_per_step(drv.cfg, drv.traffic["batch_size"], drv.cfg.frames(drv.samples))
    return 100.0 * bound / (ns / 1e9 / t.steps)
