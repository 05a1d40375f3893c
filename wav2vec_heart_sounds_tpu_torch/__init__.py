"""PyTorch + CUDA port of ``wav2vec_heart_sounds_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference. This package mirrors its module names so each
counterpart is easy to find, but imports only ``torch``, ``numpy`` and ``scipy``: it never
imports JAX, Flax, pandas or the JAX package, so it runs on a machine that has none of them.

Ported so far: the scoring path (raw PCG windows -> preprocessing -> wav2vec2-base ->
fragment and patient verdicts), with the packed-QKV attention forward as a hand-written
CUDA kernel (``csrc/attention_qkv_fwd.cu``).
"""
