"""The plain reference: what the port computes, written again from the stated semantics.

NumPy/SciPy in float64 for the preprocessing chain, plain PyTorch in float32 for the model
(TF32 off for products and convolutions). It imports nothing of the port and takes nothing
the port made: the benchmark hands it the same raw windows and the same starting weights
(:mod:`.weights`), and it works out again what the port derives from the seed:

* the dropout masks: Philox4x32-10 keyed by ``(step seed, site)`` at each element's
  row-major index in the whole batch's tensor (:func:`philox_bits`, a frozen copy of that
  arithmetic), kept where the 32-bit draw is at least ``uint32(rate * (2^32 - 1))``, kept
  values scaled by the float32 ``1 / (1 - rate)``, at the sites of :class:`PlainModel`;
* the step seed and the SpecAugment span starts, drawn from a CPU ``torch.Generator``
  seeded with the trainer's seed, in the trainer's order (:func:`step_draws`).

``precision="fp8"`` is the control: every product's two operands rounded to float8 (e4m3
forward, e5m2 for the gradients, one scale a tensor), in both architectures, and every stage
of the chain rounded to TF32's 10-bit mantissa: the precisions below the ones the
configuration states.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps

from .configs import ModelConfig

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
SITE_FEATURE_PROJECTION, SITE_ENCODER = 0, 1
SPIKE_FLOOR = 1e-4
# The feature encoder's norms take torch's default eps, as HF builds them (``nn.GroupNorm``,
# ``nn.LayerNorm`` without an eps), not the configuration's ``layer_norm_eps``.
FEATURE_NORM_EPS = 1e-5


# ---- dropout masks ----------------------------------------------------------------------

def threshold(rate: float) -> int:
    return int(np.uint32(min(1.0, rate) * np.iinfo(np.uint32).max))


def keep_scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lo16, hi16 = a * (b & 0xFFFF), a * (b >> 16)
    mid = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (mid >> 32), mid & MASK32


def philox_bits(seed: int, site: int, start: int, n: int, device) -> torch.Tensor:
    """32-bit draws (int64) of elements ``start .. start + n - 1``: element ``i`` takes word
    ``i % 4`` of Philox4x32-10 at counter ``(i // 4 mod 2^32, i // 4 div 2^32, 0, 0)``."""
    g = torch.arange(start // 4, (start + n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = g & MASK32, g >> 32
    c2 = c3 = torch.zeros_like(g)
    k0, k1 = seed & MASK32, site & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = torch.stack((c0, c1, c2, c3), dim=1).reshape(-1)
    return words[start % 4:start % 4 + n]


def step_draws(seed: int, steps: int, batch: int, frames: int, prob: float,
               span: int) -> list[tuple[int, torch.Tensor]]:
    """(dropout seed, SpecAugment span starts ``[batch, spans]``) of each training step."""
    gen = torch.Generator().manual_seed(seed)
    spans = max(1, int(prob * frames))
    out = []
    for _ in range(steps):
        step_seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
        starts = (torch.randint(0, max(1, frames - span), (batch, spans), generator=gen)
                  if prob > 0 else torch.zeros((batch, 0), dtype=torch.int64))
        out.append((step_seed, starts))
    return out


def time_mask(starts: torch.Tensor, frames: int, span: int) -> torch.Tensor:
    """``[batch, frames]``: the frames that a span of ``span`` from one of ``starts`` covers."""
    pos = torch.arange(frames)
    return ((pos >= starts[:, :, None]) & (pos < starts[:, :, None] + span)).any(dim=1)


# ---- preprocessing chain ----------------------------------------------------------------

def tf32_round(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to float32 with a 10-bit mantissa (TF32), to nearest even."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x0FFF) + ((bits >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return bits.view(np.float32).astype(np.float64)


def despike(x: np.ndarray, fs: float, threshold_x: float = 3.0,
            max_iterations: int = 1000) -> np.ndarray:
    """Schmidt spike removal, row by row: while some 500 ms frame's peak exceeds
    ``threshold_x`` times the median frame peak, flatten the span around the worst frame's
    peak (between the zero crossings before and after it) to ``SPIKE_FLOOR``; stop when a
    pass changes nothing."""
    win = round(fs / 2.0)
    out = x.copy()
    if x.shape[1] < win:
        return out
    usable = x.shape[1] - x.shape[1] % win
    for row in out:
        frames = row[:usable].reshape(-1, win)
        for _ in range(max_iterations):
            maa = np.abs(frames).max(axis=1)
            if not (maa > threshold_x * np.median(maa)).any():
                break
            window = frames[int(np.argmax(maa))]
            peak = int(np.argmax(np.abs(window)))
            flips = np.flatnonzero(np.abs(np.diff(np.sign(window))) > 1)
            before, after = flips[flips < peak], flips[flips >= peak]
            start = int(before[-1]) + 1 if len(before) else 0
            end = int(after[0]) if len(after) else win - 1
            if np.all(window[start:end] == SPIKE_FLOOR):
                break
            window[start:end] = SPIKE_FLOOR
    return out


def chain(wire: np.ndarray, prep: dict, precision: str = "float32") -> np.ndarray:
    """The PCG chain on ``[B, n]`` wire windows (float64): resample ``fs_wire`` ->
    ``fs_model`` (SciPy's polyphase resampler, Kaiser 5.0), despike, causal Butterworth
    low-pass then high-pass (``Wn = cutoff / fs_model``, the cutoff convention the
    configuration states), zero mean and peak 1 per row, the first ``win_len`` samples."""
    stage = tf32_round if precision == "fp8" else (lambda v: v)
    fs_in, fs = prep["fs_wire"], prep["fs_model"]
    g = math.gcd(fs, fs_in)
    y = stage(sps.resample_poly(wire, fs // g, fs_in // g, axis=-1))
    y = stage(despike(y, fs, prep["despike_threshold"]))
    low, high = prep["band_hz"]
    for cutoff, kind in ((high, "lowpass"), (low, "highpass")):
        sos = sps.butter(prep["order"], cutoff / fs, btype=kind, output="sos")
        y = stage(sps.sosfilt(sos, y, axis=-1))
    y = np.nan_to_num(y)
    y = y - y.mean(axis=-1, keepdims=True)
    y = np.clip(y / np.maximum(np.abs(y).max(axis=-1, keepdims=True), 1e-12), -1.0, 1.0)
    return stage(y)[:, :prep["win_len"]]


# ---- the model --------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


@dataclass
class StepMasks:
    """What a training forward of a block of rows starting at batch row ``row0`` needs: the
    step's dropout seed and the block's SpecAugment frames."""
    seed: int
    spec: torch.Tensor       # [rows, frames] bool
    row0: int


@contextlib.contextmanager
def exact_float32():
    """Products and convolutions in full float32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class PlainModel:
    """wav2vec2 + mean pool + MLP head over float32 leaves ``w`` (named as :mod:`.weights`
    names them), in HF ``Wav2Vec2Model``'s two architectures, as the configuration's keys
    choose (:mod:`.configs`):

    * the feature encoder: conv (with its bias under ``conv_bias``), then under
      ``feat_extract_norm="group"`` GroupNorm with a group a channel on the first layer only,
      under ``"layer"`` LayerNorm over channels on every layer; then GELU;
    * the encoder, post-norm: ``LN(h + gelu(pos))``, dropout, then layers of
      ``h = LN1(h + drop(attn(h)))``, ``h = LN2(h + drop(ffn(h)))``;
    * the encoder under ``do_stable_layer_norm``: ``h + gelu(pos)`` with no norm, dropout,
      then pre-norm layers of ``h = h + drop(attn(LN1(h)))``, ``h = h + drop(ffn(LN2(h)))``,
      and the encoder's LayerNorm after the last layer.

    Dropout sites, the same in both architectures (the contract the port is held to):
    ``SITE_FEATURE_PROJECTION`` (0) after the feature projection, ``SITE_ENCODER`` (1) on the
    encoder's input after the positional conv is added, then four a layer from
    ``2 + 4 * layer``: the attention probabilities, the attention's output projection, the
    FFN's activation and the FFN's output."""

    def __init__(self, cfg: ModelConfig, w: dict[str, torch.Tensor], precision: str = "float32"):
        self.cfg, self.w = cfg, w
        self.q = _Float8.apply if precision == "fp8" else (lambda t: t)

    def _linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[f"{name}.weight"]), self.w[f"{name}.bias"])

    def _ln(self, x, name, eps=None):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            self.cfg.layer_norm_eps if eps is None else eps)

    def _drop(self, x, masks: StepMasks | None, site: int, rate: float):
        if masks is None or rate <= 0:
            return x
        per_row = x[0].numel()
        bits = philox_bits(masks.seed, site, masks.row0 * per_row, x.numel(), x.device)
        keep = (bits >= threshold(rate)).view(x.shape)
        return torch.where(keep, x * keep_scale(rate), 0.0)

    def forward(self, x: torch.Tensor, masks: StepMasks | None = None) -> torch.Tensor:
        """Logits ``[rows, classes]`` of float32 waveforms ``[rows, samples]``; a training
        forward (dropout, SpecAugment) with ``masks``."""
        return self.head(self.encode(x, masks))

    def encode(self, x: torch.Tensor, masks: StepMasks | None = None) -> torch.Tensor:
        """The encoder's output ``[rows, frames, hidden]`` (HF's ``last_hidden_state``)."""
        cfg, w = self.cfg, self.w
        h = x[:, None, :]
        fe = "encoder.feature_extractor.conv_layers"
        for i, s in enumerate(cfg.conv_stride):
            p = f"{fe}.{i}"
            h = F.conv1d(self.q(h), self.q(w[f"{p}.conv.weight"]),
                         w[f"{p}.conv.bias"] if cfg.conv_bias else None, stride=s)
            if cfg.feat_extract_norm == "layer":
                h = self._ln(h.transpose(1, 2), f"{p}.layer_norm",
                             FEATURE_NORM_EPS).transpose(1, 2)
            elif i == 0:
                h = F.group_norm(h, h.shape[1], w[f"{p}.layer_norm.weight"],
                                 w[f"{p}.layer_norm.bias"], FEATURE_NORM_EPS)
            h = F.gelu(h)
        h = self._ln(h.transpose(1, 2), "encoder.feature_projection.layer_norm")
        h = self._linear(h, "encoder.feature_projection.projection")
        h = self._drop(h, masks, SITE_FEATURE_PROJECTION, cfg.feat_proj_dropout)
        if masks is not None and cfg.mask_time_prob > 0:
            h = torch.where(masks.spec[:, :, None].to(h.device), w["encoder.masked_spec_embed"], h)
        enc = "encoder.encoder"
        k = cfg.pos_conv_kernel
        pos = F.conv1d(self.q(h.transpose(1, 2)), self.q(w[f"{enc}.pos_conv_embed.conv.weight"]),
                       w[f"{enc}.pos_conv_embed.conv.bias"], padding=k // 2,
                       groups=cfg.pos_conv_groups)
        if k % 2 == 0:
            pos = pos[:, :, :-1]
        h = h + F.gelu(pos).transpose(1, 2)
        if not cfg.do_stable_layer_norm:
            h = self._ln(h, f"{enc}.layer_norm")
        h = self._drop(h, masks, SITE_ENCODER, cfg.hidden_dropout)
        layer_of = self._stable_layer if cfg.do_stable_layer_norm else self._layer
        for layer in range(cfg.num_layers):
            h = layer_of(h, f"{enc}.layers.{layer}", 2 + 4 * layer, masks)
        return self._ln(h, f"{enc}.layer_norm") if cfg.do_stable_layer_norm else h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Logits ``[rows, classes]`` of the encoder's output ``[rows, frames, hidden]``."""
        h = h.mean(dim=1)
        for i in range(len(self.cfg.head_hidden)):
            h = torch.relu(self._linear(h, f"head.dense_{i}"))
        return self._linear(h, "head.logits")

    def _attention(self, h, p, site, masks):
        """The attention's output projection, before its dropout (probabilities at ``site``)."""
        b, t, d = h.shape
        heads = self.cfg.num_heads

        def split(name):
            return self._linear(h, f"{p}.attention.{name}").view(b, t, heads, -1).transpose(1, 2)

        q, k, v = split("q_proj"), split("k_proj"), split("v_proj")
        scores = self.q(q) @ self.q(k).transpose(2, 3) / math.sqrt(d // heads)
        probs = self._drop(torch.softmax(scores, dim=-1), masks, site, self.cfg.attention_dropout)
        a = (self.q(probs) @ self.q(v)).transpose(1, 2).reshape(b, t, d)
        return self._linear(a, f"{p}.attention.out_proj")

    def _ffn(self, h, p, site, masks):
        """The FFN's output, before its dropout (the activation's at ``site + 2``)."""
        f = F.gelu(self._linear(h, f"{p}.feed_forward.intermediate_dense"))
        f = self._drop(f, masks, site + 2, self.cfg.activation_dropout)
        return self._linear(f, f"{p}.feed_forward.output_dense")

    def _layer(self, h, p, site, masks):
        rate = self.cfg.hidden_dropout
        h = self._ln(h + self._drop(self._attention(h, p, site, masks), masks, site + 1, rate),
                     f"{p}.layer_norm")
        return self._ln(h + self._drop(self._ffn(h, p, site, masks), masks, site + 3, rate),
                        f"{p}.final_layer_norm")

    def _stable_layer(self, h, p, site, masks):
        rate = self.cfg.hidden_dropout
        a = self._attention(self._ln(h, f"{p}.layer_norm"), p, site, masks)
        h = h + self._drop(a, masks, site + 1, rate)
        f = self._ffn(self._ln(h, f"{p}.final_layer_norm"), p, site, masks)
        return h + self._drop(f, masks, site + 3, rate)


@dataclass
class Optimizer:
    """SGD with momentum and coupled decay behind a global-norm clip (the traffic's job)."""
    lr: float
    momentum: float
    weight_decay: float
    clip: float


def train(cfg: ModelConfig, w0: dict[str, torch.Tensor], batches, draws, opt: Optimizer,
          block_rows: int, live: dict[str, torch.dtype], precision: str = "float32",
          loss_rows: int | None = None) -> dict:
    """Train ``len(batches)`` steps from float32 leaves ``w0`` (left unchanged) on
    ``(x [B, samples] float32, labels [B])`` batches with ``draws`` (:func:`step_draws`).

    The optimizer keeps a float32 master of every leaf; the forward reads each leaf as the
    configuration stores it, the master rounded to its ``live`` dtype after every step (so
    a bfloat16 leaf sees only the updates that move it by half a bfloat16 step or more), and
    computes in float32. Returns each step's ``losses``, the first step's clipped gradient
    ``grad`` and the change ``delta`` of every leaf's master after the last step. Rows go
    through in blocks of ``block_rows``; the loss is the mean cross-entropy over the batch,
    or over its first ``loss_rows`` rows (a fault to read)."""
    names = list(w0)
    master = {n: v.detach().clone() for n, v in w0.items()}
    buf = {n: torch.zeros_like(v) for n, v in master.items()}
    losses, grad1 = [], None
    with exact_float32():
        for (x, y), (seed, starts) in zip(batches, draws):
            params = {n: m.to(live[n]).to(torch.float32, copy=True).requires_grad_(True)
                      for n, m in master.items()}
            model = PlainModel(cfg, params, precision)
            rows = len(x) if loss_rows is None else loss_rows
            spec = time_mask(starts, cfg.frames(x.shape[1]), cfg.mask_time_length)
            total = 0.0
            for r0 in range(0, rows, block_rows):
                r1 = min(rows, r0 + block_rows)
                logits = model.forward(x[r0:r1], StepMasks(seed, spec[r0:r1], r0))
                loss = F.cross_entropy(logits, y[r0:r1], reduction="sum") / rows
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            with torch.no_grad():
                grads = [params[n].grad for n in names]
                norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
                if norm >= opt.clip:
                    torch._foreach_mul_(grads, opt.clip / norm)
                if grad1 is None:
                    grad1 = {n: g.clone() for n, g in zip(names, grads)}
                for n, g in zip(names, grads):
                    buf[n].mul_(opt.momentum).add_(g + opt.weight_decay * master[n])
                    master[n].sub_(opt.lr * buf[n])
    return {"losses": losses, "grad": grad1,
            "delta": {n: master[n] - w0[n] for n in names}}


def logits(cfg: ModelConfig, w: dict[str, torch.Tensor], x: torch.Tensor, block_rows: int,
           precision: str = "float32") -> torch.Tensor:
    """Eval logits ``[rows, classes]`` of float32 waveforms ``[rows, samples]``."""
    model = PlainModel(cfg, w, precision)
    with exact_float32(), torch.no_grad():
        return torch.cat([model.forward(x[r0:r0 + block_rows])
                          for r0 in range(0, len(x), block_rows)])
