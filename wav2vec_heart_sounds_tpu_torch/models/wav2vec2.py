"""Wav2Vec 2.0 encoder in PyTorch (port of ``models/wav2vec2.py``), eval and training.

wav2vec2-base: a 7-layer strided conv feature encoder (GroupNorm on conv_0), the feature
projection, a weight-normed grouped positional conv (materialised at load), and 12
post-norm encoder layers. By default the attention is the packed-QKV kernel (K3b, one
``[D, 3D]`` projection); ``Wav2Vec2Config.qkv_fuse=False`` (the JAX package's
``W2VHS_NO_QKVFUSE=1``) takes the unpacked route: three products and the unpacked kernel
(K3a) on head views of them. ``Wav2Vec2Config.conv_fuse=True`` (the JAX package's
``W2VHS_CONVFUSE=1``) runs each conv layer that JAX's gate picks (:func:`conv_fuse_layers`:
k = 3, s = 2, 128-multiple channels, at least 4096 output frames; conv_1 of wav2vec2-base
on 4 s at 16 kHz) as K8, the fused ``gelu(conv)`` kernel (:mod:`..ops.kernels.conv`),
whose GELU is the erf form in every dtype. Both fields leave the parameters as they are.

Parameter names follow HF's ``Wav2Vec2Model`` state-dict keys, so an HF checkpoint loads
nearly as-is (:mod:`.hf_port`). The compute dtype is the caller's choice: matmul and conv
parameters live in it, norm parameters stay float32, and every norm takes float32
statistics and emits the compute dtype (the JAX package's ``_ln_apply`` and
``ChannelGroupNorm``). GELU follows the JAX package per dtype: the conv cascade uses the
tanh form in bfloat16 (``_cascade_gelu``), the FFN and the positional conv keep erf, and
float32 is erf throughout.

Training (``forward(x, train=True, generator=g)``) follows the JAX package's accelerator
path (``wav2vec2.py:760-789``), through the port's kernels at any rate: feature-projection
and encoder dropout (K1, :mod:`..ops.kernels.dropout`), attention with dropout (K3b), the
attention tail ``LN(x + dropout(h))`` (K2, :mod:`..ops.kernels.resid`) and the FFN
sublayer. By default (``Wav2Vec2Config.ffn_mega``, the JAX package's ``W2VHS_FFN_MEGA=1``)
the FFN sublayer is one op, K4 (:mod:`..ops.kernels.megakernel`); with ``ffn_mega=False``
it is the decomposed route, the activation ``dropout(gelu(x W1 + b1))`` (K5,
:mod:`..ops.kernels.ffn`), ``output_dense`` and K2. Both routes draw the same masks.
SpecAugment time masking fills masked frames with ``masked_spec_embed``. One base seed per forward is drawn from
``g`` (a CPU ``torch.Generator``), then the SpecAugment span starts; each dropout site
keys its Philox mask with that seed and its own site index (:func:`layer_sites`).

LoRA (``Wav2Vec2Config.lora_rank > 0``, the JAX package's ``LoraDense`` params): ``q_proj``
and ``v_proj`` carry ``lora_a [in, r]`` and ``lora_b [r, out]`` (the flax layout), and the
packed projection adds ``(alpha / r) * (dropout(x) @ lora_a) @ lora_b`` to its q and v
thirds; in training each bypass draws its own mask at its own site (:func:`lora_sites`),
through K1 like every dropout of the port.

Rematerialisation (the JAX package's ``nn.remat``): in a training forward with gradients on,
``Wav2Vec2Config.remat`` runs each encoder layer and ``remat_conv`` the conv feature
encoder under ``torch.utils.checkpoint`` (non-reentrant): only their inputs are kept, and
the backward runs their forward again. The recompute draws nothing: the step seed and the
SpecAugment spans are drawn before the encoder, and every mask inside is Philox of
``(seed, site)``, so it regenerates the same masks and the same saved tensors.

Not ported: ``conv_time_plan``'s tile padding, which gives the same numbers as the exact
lengths used here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import attention as _attention
from ..ops.kernels.conv import conv_gelu
from ..ops.kernels.dropout import dropout
from ..ops.kernels.ffn import dense_gelu_dropout
from ..ops.kernels.megakernel import ffn_block
from ..ops.kernels.pos_conv import pos_conv_gelu
from ..ops.kernels.resid import dropout_add_layernorm

HIDDEN = 768  # wav2vec2-base hidden size

# Dropout sites: each keys its Philox mask with (step seed, site).
SITE_FEATURE_PROJECTION, SITE_ENCODER = 0, 1


def layer_sites(index: int) -> tuple[int, int, int, int]:
    """Sites of encoder layer ``index``: attention, attention tail, FFN activation, FFN tail."""
    base = 2 + 4 * index
    return base, base + 1, base + 2, base + 3


def lora_sites(index: int, num_layers: int) -> tuple[int, int]:
    """LoRA dropout sites of layer ``index`` (q and v bypass), after every layer's sites."""
    base = 2 + 4 * num_layers + 2 * index
    return base, base + 1


@dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture fields of the JAX package's ``Wav2Vec2Config`` (defaults: wav2vec2-base)."""
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = HIDDEN
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.1
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    lora_rank: int = 0          # 0 disables LoRA; the vest runs use r=8
    lora_alpha: float = 16.0
    lora_dropout: float = 0.05
    # Training FFN sublayer: K4 (True, the JAX package's default W2VHS_FFN_MEGA=1) or the
    # decomposed K5 + output_dense + K2 route (False, the A/B control).
    ffn_mega: bool = True
    # Attention: the packed-QKV route, K3b (True, the JAX default), or three products and
    # the unpacked kernel, K3a (False, the JAX package's W2VHS_NO_QKVFUSE=1).
    qkv_fuse: bool = True
    # The conv layers of conv_fuse_layers as K8, gelu(conv) fused (the JAX W2VHS_CONVFUSE=1).
    conv_fuse: bool = False
    # Rematerialise each encoder layer / the conv feature encoder in training (memory for
    # one more forward of them in the backward), the JAX package's nn.remat.
    remat: bool = False
    remat_conv: bool = False

    @classmethod
    def tiny(cls, **kw) -> "Wav2Vec2Config":
        """Small config for tests (the JAX package's ``Wav2Vec2Config.tiny()``)."""
        base = dict(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                    hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                    pos_conv_kernel=16, pos_conv_groups=2)
        base.update(kw)
        return cls(**base)


def cascade_gelu(x: torch.Tensor) -> torch.Tensor:
    """Conv-cascade GELU: tanh form in bfloat16 (as the JAX package's default), erf otherwise."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis: float32 statistics (E[x^2] - E[x]^2), ``dtype`` out."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(dtype)


class LayerNorm(nn.Module):
    """:func:`layer_norm` with float32 ``weight``/``bias`` (HF's LayerNorm keys)."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


class ChannelGroupNorm(nn.Module):
    """Per-channel GroupNorm over time on ``[B, C, T]`` (HF's ``GroupNorm(C, C)`` keys).

    Statistics in float32 as E[x^2] - E[x]^2; normalise and affine in the compute dtype.
    """

    def __init__(self, channels: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.dtype = eps, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2]
        xf = x.float()
        mean = xf.sum(dim=2, keepdim=True) / n                          # [B, C, 1]
        var = (xf * xf).sum(dim=2, keepdim=True) / n - mean * mean
        inv = (torch.rsqrt(var + self.eps) * self.weight[None, :, None]).to(self.dtype)
        return (x.to(self.dtype) - mean.to(self.dtype)) * inv \
            + self.bias[None, :, None].to(self.dtype)


def conv_fuse_layers(cfg: Wav2Vec2Config, num_samples: int) -> list[bool]:
    """Which conv layers run as K8 on a ``num_samples`` waveform: the JAX package's
    ``fused`` rule (``wav2vec2.py:454-458``): ``conv_fuse`` and k = 3, s = 2, both channel
    counts multiples of 128 and at least 4096 real output frames."""
    cin = (1,) + cfg.conv_dim[:-1]
    fused, n = [], num_samples
    for ci, co, k, s in zip(cin, cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
        fused.append(cfg.conv_fuse and k == 3 and s == 2 and ci % 128 == 0 and co % 128 == 0
                     and n >= 4096)
    return fused


def step_seed(generator: torch.Generator | None) -> int:
    """A training step's dropout seed, drawn from ``generator`` (a CPU generator)."""
    return int(torch.randint(0, 2 ** 32, (1,), generator=generator))


class ConvLayer(nn.Module):
    """``gelu(norm?(conv(x)))`` on ``[B, C, T]``: one layer of the feature encoder; with
    ``fused`` (a layer without norm) K8's ``gelu(conv(x))`` with the erf GELU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, group_norm: bool,
                 eps: float, dtype: torch.dtype):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=False, dtype=dtype)
        self.layer_norm = ChannelGroupNorm(cout, eps, dtype) if group_norm else None

    def forward(self, x: torch.Tensor, fused: bool = False) -> torch.Tensor:
        if fused:
            return conv_gelu(x, self.conv.weight)
        h = self.conv(x)
        if self.layer_norm is not None:
            h = self.layer_norm(h)
        return cascade_gelu(h)


class FeatureEncoder(nn.Module):
    """Raw waveform ``[B, T]`` -> conv features ``[B, C, T']`` (group-norm variant)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        cin = (1,) + cfg.conv_dim[:-1]
        self.cfg, self.dtype = cfg, dtype
        self.conv_layers = nn.ModuleList(
            ConvLayer(ci, co, k, s, i == 0, cfg.layer_norm_eps, dtype)
            for i, (ci, co, k, s) in enumerate(zip(cin, cfg.conv_dim, cfg.conv_kernel,
                                                   cfg.conv_stride)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None, :].to(self.dtype)
        for layer, fused in zip(self.conv_layers, conv_fuse_layers(self.cfg, x.shape[1])):
            h = layer(h, fused)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], cfg.layer_norm_eps, dtype)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped conv positional embedding on ``[B, T, D]``: pad k//2 both sides, drop the
    trailing frame for an even kernel, erf GELU. ``conv`` holds the parameters
    (``nn.Conv1d``'s names and layout); the op is :func:`..ops.kernels.pos_conv.pos_conv_gelu`
    (bfloat16 on the card: ``csrc/pos_conv.cu``; else ``nn.Conv1d``'s own call)."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        k = cfg.pos_conv_kernel
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.pos_conv_groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pos_conv_gelu(x, self.conv.weight, self.conv.bias, self.conv.groups)


class SelfAttention(nn.Module):
    """Self-attention, then ``out_proj``. Packed (``qkv_fuse``, K3b): one ``[D, 3D]``
    projection plus the LoRA bypasses of q and v, the kernel on the ``[B, 3H, T, d]`` heads.
    Unpacked (K3a, the JAX package's bhtd route, ``wav2vec2.py:695-729``): three products,
    the bypasses added to q and v, the kernel on their ``[B, H, T, d]`` head views."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype,
                 lora_sites: tuple[int, int] = (0, 0)):
        super().__init__()
        d = cfg.hidden_size
        self.cfg, self.lora_sites = cfg, lora_sites
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d, dtype=dtype)
        self.k_proj = nn.Linear(d, d, dtype=dtype)
        self.v_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)
        if cfg.lora_rank > 0:
            for proj in (self.q_proj, self.v_proj):
                proj.lora_a = nn.Parameter(torch.zeros(d, cfg.lora_rank, dtype=dtype))
                proj.lora_b = nn.Parameter(torch.zeros(cfg.lora_rank, d, dtype=dtype))

    def _bypass(self, x: torch.Tensor, proj: nn.Linear, seed: int | None,
                site: int) -> torch.Tensor:
        cfg = self.cfg
        h = x if seed is None else dropout(x, seed, site, cfg.lora_dropout)
        return (cfg.lora_alpha / cfg.lora_rank) * ((h @ proj.lora_a) @ proj.lora_b)

    def forward(self, x: torch.Tensor, seed: int | None = None, site: int = 0,
                rate: float = 0.0) -> torch.Tensor:
        """Eval with ``seed=None``; else training attention with dropout ``rate``."""
        if not self.cfg.qkv_fuse:
            return self._unpacked(x, seed, site, rate)
        B, T, D = x.shape
        H = self.num_heads
        projs = (self.q_proj, self.k_proj, self.v_proj)
        w = torch.cat([p.weight for p in projs])
        b = torch.cat([p.bias for p in projs])
        qkv = F.linear(x, w, b)
        if self.cfg.lora_rank > 0:
            zq = self._bypass(x, self.q_proj, seed, self.lora_sites[0])
            zv = self._bypass(x, self.v_proj, seed, self.lora_sites[1])
            qkv = qkv + torch.cat([zq, torch.zeros_like(zq), zv], dim=-1)
        qkv = qkv.view(B, T, 3 * H, D // H).transpose(1, 2)            # a view, no copy
        if seed is None:
            out = _attention.flash_attention_qkv(qkv, T)                # [B, H, T, d]
        else:
            out = _attention.attention_qkv_train(qkv, T, rate, seed, site)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))

    def _unpacked(self, x: torch.Tensor, seed: int | None, site: int,
                  rate: float) -> torch.Tensor:
        B, T, D = x.shape
        q, k, v = (F.linear(x, p.weight, p.bias) for p in (self.q_proj, self.k_proj,
                                                           self.v_proj))
        if self.cfg.lora_rank > 0:
            q = q + self._bypass(x, self.q_proj, seed, self.lora_sites[0])
            v = v + self._bypass(x, self.v_proj, seed, self.lora_sites[1])
        q, k, v = (z.view(B, T, self.num_heads, -1).transpose(1, 2) for z in (q, k, v))
        if seed is None:
            out = _attention.flash_attention(q, k, v, T)                 # [B, H, T, d]
        else:
            out = _attention.attention_train(q, k, v, T, rate, seed, site)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x), approximate="none"))


class EncoderLayer(nn.Module):
    """Post-norm transformer block: LN(x + attn(x)), then LN(x + ffn(x)).

    In training (``seed`` given) the attention tail is ``LN(x + dropout(h))`` (K2) and the
    FFN sublayer is K4, or with ``ffn_mega=False`` the activation kernel
    ``dropout(gelu(.))`` (K5) after the first product, then the second product and K2."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype, index: int = 0):
        super().__init__()
        self.cfg = cfg
        self.sites = layer_sites(index)
        self.attention = SelfAttention(cfg, dtype, lora_sites(index, cfg.num_layers))
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.feed_forward = FeedForward(cfg, dtype)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        if seed is None:
            x = self.layer_norm(x + self.attention(x))
            return self.final_layer_norm(x + self.feed_forward(x))
        cfg, (s_attn, s_tail1, s_act, s_tail2) = self.cfg, self.sites
        eps, rate = cfg.layer_norm_eps, cfg.hidden_dropout
        attn = self.attention(x, seed, s_attn, cfg.attention_dropout)
        x = dropout_add_layernorm(attn, x, self.layer_norm.weight, self.layer_norm.bias, seed,
                                  s_tail1, rate, eps)
        ffn, ln = self.feed_forward, self.final_layer_norm
        if cfg.ffn_mega:
            return ffn_block(x, ffn.intermediate_dense.weight, ffn.intermediate_dense.bias,
                             ffn.output_dense.weight, ffn.output_dense.bias, ln.weight, ln.bias,
                             seed, s_act, s_tail2, cfg.activation_dropout, rate, eps)
        h = dense_gelu_dropout(x, ffn.intermediate_dense.weight, ffn.intermediate_dense.bias,
                               seed, s_act, cfg.activation_dropout)
        h = ffn.output_dense(h)
        return dropout_add_layernorm(h, x, ln.weight, ln.bias, seed, s_tail2, rate, eps)


def rematerialised(module: nn.Module, *args) -> torch.Tensor:
    """``module(*args)`` keeping only its inputs for the backward, which runs it again. The
    module draws from no RNG state (its masks are Philox of (seed, site)), so none is kept."""
    return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)


class Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.rate, self.remat = cfg.hidden_dropout, cfg.remat
        self.pos_conv_embed = PositionalConvEmbedding(cfg, dtype)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, i) for i in range(cfg.num_layers))

    def forward(self, h: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        h = self.layer_norm(h + self.pos_conv_embed(h))
        if seed is not None:
            h = dropout(h, seed, SITE_ENCODER, self.rate)
        remat = self.remat and seed is not None and torch.is_grad_enabled()
        for layer in self.layers:
            h = rematerialised(layer, h, seed) if remat else layer(h, seed)
        return h


class Wav2Vec2Model(nn.Module):
    """Raw waveform ``[B, T]`` -> contextual representations ``[B, T', hidden]``."""

    def __init__(self, config: Wav2Vec2Config | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = cfg = config or Wav2Vec2Config()
        self.dtype = dtype
        self.feature_extractor = FeatureEncoder(cfg, dtype)
        self.feature_projection = FeatureProjection(cfg, dtype)
        self.encoder = Encoder(cfg, dtype)
        # Kept so HF checkpoints load strictly; used only by SpecAugment in training.
        self.masked_spec_embed = nn.Parameter(torch.zeros(cfg.hidden_size))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                seed: int | None = None) -> torch.Tensor:
        """``train=True`` draws the step's dropout seed (unless ``seed`` gives it), then the
        SpecAugment spans, from ``generator`` (a CPU ``torch.Generator``; ``None`` takes
        torch's default)."""
        if train and self.config.remat_conv and torch.is_grad_enabled():
            h = rematerialised(self.feature_extractor, x)
        else:
            h = self.feature_extractor(x)
        h = h.transpose(1, 2)                                           # [B, T', C]
        h = self.feature_projection(h)
        if not train:
            return self.encoder(h)
        cfg = self.config
        seed = step_seed(generator) if seed is None else seed
        h = dropout(h, seed, SITE_FEATURE_PROJECTION, cfg.feat_proj_dropout)
        if cfg.mask_time_prob > 0:
            mask = sample_time_mask(generator, h.shape[0], h.shape[1], cfg.mask_time_prob,
                                    cfg.mask_time_length).to(h.device)
            h = torch.where(mask[:, :, None], self.masked_spec_embed.to(h.dtype), h)
        return self.encoder(h, seed)


def sample_time_mask(generator: torch.Generator | None, batch: int, length: int, prob: float,
                     span: int) -> torch.Tensor:
    """SpecAugment boolean time mask ``[B, T']`` on the CPU (``_sample_time_mask`` of the
    JAX package): ``max(1, int(prob * T'))`` span starts per row, uniform in
    ``[0, max(1, T' - span))``, each masking ``span`` frames."""
    num_spans = max(1, int(prob * length))
    starts = torch.randint(0, max(1, length - span), (batch, num_spans), generator=generator)
    pos = torch.arange(length)
    hit = (pos >= starts[:, :, None]) & (pos < starts[:, :, None] + span)
    return hit.any(dim=1)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from a CPU ``generator``, so every device gets the same weights.

    Follows the JAX package's initialisers: matmul and conv weights ~ N(0, 1/fan_in) (flax
    lecun_normal, without its truncation), biases 0, norm scales 1, ``masked_spec_embed``
    ~ U(0, 1), LoRA ``lora_a [in, r]`` ~ U(+-sqrt(6 / in)) (he_uniform) and ``lora_b`` 0.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("masked_spec_embed"):
            v = torch.rand(p.shape, generator=generator)
        elif leaf == "lora_a":
            limit = math.sqrt(6.0 / p.shape[0])
            v = (2.0 * torch.rand(p.shape, generator=generator) - 1.0) * limit
        elif leaf == "lora_b":
            v = torch.zeros(p.shape)
        elif "norm" in name:
            v = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
        elif leaf == "bias":
            v = torch.zeros(p.shape)
        else:                                   # [out, in(, k)]: fan_in = prod(shape[1:])
            fan_in = math.prod(p.shape[1:])
            v = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        p.copy_(v)
