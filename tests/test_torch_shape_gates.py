"""The widths each kernel takes, and the route every op takes on the card.

Each kernel wrapper checks its shapes with a pure predicate beside it (``kernel_takes``: the
widths and dtypes the kernel is built for) and raises on anything else. The autograd ops and
the eval entry points never give way to a plain version on the card: a CPU tensor takes the
plain version, a CUDA tensor the kernel wrapper (``on_card``). The predicates take
wav2vec2-base's widths, wav2vec2-large's and the test config's (hidden 32, head dim 16, FFN
64). Here on the CPU the card is stood in for by patching each module's ``on_card`` to say
yes, so the ops take the card's branch on CPU tensors and reach the kernel wrappers, replaced
by spies that run the plain versions. Then ``Wav2Vec2Config.tiny()`` through that routing,
every kernel on its spy: its eval forward against the JAX package at f32 atol 2e-5, and one
``fit`` step at rate 0 against the JAX trainer at the bars of
``tests/test_torch_gated_route.py`` (the loss at 1e-4, the trained weights at 2e-4 / 2e-3),
on both FFN routes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.models.classifier import ClassifierConfig as JaxClassifierConfig
from wav2vec_heart_sounds_tpu.models.classifier import Wav2VecClassifier
from wav2vec_heart_sounds_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_heart_sounds_tpu.train.classifier import SupervisedTrainer as JaxTrainer
from wav2vec_heart_sounds_tpu_torch.models.build import build_classifier
from wav2vec_heart_sounds_tpu_torch.models.classifier import ClassifierConfig
from wav2vec_heart_sounds_tpu_torch.models.from_jax import from_jax, to_jax
from wav2vec_heart_sounds_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from wav2vec_heart_sounds_tpu_torch.ops.kernels import attention, dropout, ffn, resid
from wav2vec_heart_sounds_tpu_torch.ops.kernels import megakernel as mk
from wav2vec_heart_sounds_tpu_torch.train.classifier import SupervisedTrainer

BASE = Wav2Vec2Config()
TINY = Wav2Vec2Config.tiny()
LARGE = Wav2Vec2Config(hidden_size=1024, num_heads=16, intermediate_size=4096)
XLSR_1B = Wav2Vec2Config(hidden_size=1280, num_heads=16, intermediate_size=5120)
# The row counts the base paths run: CinC training (96 x 199), fusion (64 x 51), the vest
# (16 x 25) and a ragged count.
BASE_ROWS = (19104, 3264, 400, 127)
DTYPES = (torch.bfloat16, torch.float32)


def _gates(cfg: Wav2Vec2Config, dtype: torch.dtype) -> dict:
    return {"resid": resid.kernel_takes(cfg.hidden_size, dtype),
            "attention": attention.kernel_takes(cfg.hidden_size // cfg.num_heads, dtype),
            "megakernel": mk.kernel_takes(cfg.hidden_size, cfg.intermediate_size, dtype),
            "ffn": ffn.kernel_takes(cfg.intermediate_size, dtype)}


@pytest.mark.parametrize("rows", BASE_ROWS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_gate_takes_the_base_shapes(rows, dtype):
    """At wav2vec2-base's widths every kernel runs, whatever the row count: the gates read
    only widths and dtype."""
    x = torch.empty(rows, BASE.hidden_size, dtype=dtype, device="meta")
    assert x.shape[-1] == 768 and BASE.hidden_size // BASE.num_heads == 64
    assert _gates(BASE, x.dtype) == dict.fromkeys(("resid", "attention", "megakernel", "ffn"),
                                                  True)


@pytest.mark.parametrize("cfg", [TINY, LARGE, XLSR_1B], ids=["tiny", "large", "xlsr1b"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_kernel_takes_the_tiny_and_large_widths(cfg, dtype):
    """hidden 32, head dim 16, FFN 64; wav2vec2-large's 1024, 64, 4096; and XLS-R 1B's
    1280, 80, 5120."""
    assert _gates(cfg, dtype) == dict.fromkeys(("resid", "attention", "megakernel", "ffn"), True)


def test_gates_refuse_other_widths_and_dtypes():
    assert resid.kernel_takes(384, torch.float32) and resid.kernel_takes(40, torch.bfloat16)
    assert resid.kernel_takes(36, torch.float32) and not resid.kernel_takes(36, torch.bfloat16)
    assert not resid.kernel_takes(1032, torch.float32) and not resid.kernel_takes(0, torch.float32)
    assert mk.kernel_takes(768, 3000, torch.float32) and mk.kernel_takes(40, 72, torch.bfloat16)
    assert not mk.kernel_takes(1032, 4096, torch.float32)
    assert not mk.kernel_takes(768, 3004, torch.bfloat16)
    assert not mk.kernel_takes(36, 64, torch.float32)
    assert attention.kernel_takes(128, torch.bfloat16) and attention.kernel_takes(32, torch.float32)
    assert attention.kernel_takes(80, torch.bfloat16)
    assert not attention.kernel_takes(96, torch.bfloat16)
    assert not attention.kernel_takes(8, torch.float32)
    assert not ffn.kernel_takes(14, torch.bfloat16) and ffn.kernel_takes(12, torch.float32)
    for gates in (_gates(BASE, torch.float16), _gates(BASE, torch.float64)):
        assert not any(gates.values())


# One shape each kernel does not take, and the message its wrapper's check raises: 36 bf16
# columns are no whole 16-byte runs (K2, K4), head dim 9 no built width (K3), 34 columns no
# four-column groups (K5).
REFUSALS = {
    "resid": (lambda t: resid._check("resid_fwd_kernel", t), "row width 36"),
    "megakernel": (lambda t: mk._check("ffn_mega_fwd_kernel", t, 64), "multiples of 8"),
    "attention": (lambda t: attention._check("attention_fwd", 4, t.view(1, 4, 4, 9)),
                  "d in"),
    "ffn": (lambda t: ffn.ffn_act_bwd_kernel(t[:, :34], t[:, :34], 0, 0, 0.1),
            "four-column groups")}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrappers_refuse_widths_their_kernels_do_not_take(name):
    """Each wrapper's shape check raises on a width its kernel does not take, before it looks
    at the device (so here on the CPU too)."""
    check, message = REFUSALS[name]
    with pytest.raises(ValueError, match=message):
        check(torch.zeros(4, 36, dtype=torch.bfloat16))


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's branch of every op; the kernel wrappers are spies that
    count their calls and run the plain versions (a wrapper itself refuses CPU tensors)."""
    for module in (dropout, resid, ffn, mk, attention):     # each module's route
        monkeypatch.setattr(module, "on_card", lambda t: True)
    calls = {}

    def spy(module, name, plain):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args, **kwargs)
        monkeypatch.setattr(module, name, run)

    for module, name, plain in (
            (dropout, "dropout_kernel", dropout.dropout_reference),
            (ffn, "ffn_act_fwd_kernel", ffn.ffn_act_fwd_reference),
            (ffn, "ffn_act_bwd_kernel", ffn.ffn_act_bwd_reference),
            (resid, "resid_fwd_kernel", resid.resid_fwd_reference),
            (resid, "resid_bwd_kernel", resid.resid_bwd_reference),
            (mk, "ffn_mega_fwd_kernel", mk.ffn_mega_fwd_reference),
            (mk, "ffn_mega_bwd_kernel", mk.ffn_mega_bwd_reference),
            (attention, "attention_qkv_fwd", attention.attention_qkv_reference),
            (attention, "attention_qkv_bwd", attention.attention_qkv_bwd_reference),
            (attention, "attention_fwd", attention.attention_reference),
            (attention, "attention_bwd", attention.attention_bwd_reference)):
        spy(module, name, plain)
    return calls


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _leaf(*shape, seed=0):
    return _randn(*shape, seed=seed).requires_grad_()


def _run_resid():
    h, x = _leaf(6, 32), _leaf(6, 32, seed=1)
    out = resid.dropout_add_layernorm(h, x, torch.ones(32), torch.zeros(32), 5, 3, 0.1)
    out.backward(_randn(6, 32, seed=2))
    return ("resid_fwd_kernel", "resid_bwd_kernel")


def _run_ffn():
    x, w, b = _leaf(6, 16), _leaf(64, 16, seed=1), _leaf(64, seed=2)
    ffn.dense_gelu_dropout(x, w, b, 5, 3, 0.1).backward(_randn(6, 64, seed=3))
    return ("ffn_act_fwd_kernel", "ffn_act_bwd_kernel")


def _run_megakernel():
    x, w1, b1 = _leaf(2, 3, 32), _leaf(64, 32, seed=1), _leaf(64, seed=2)
    w2, b2 = _leaf(32, 64, seed=3), _leaf(32, seed=4)
    out = mk.ffn_block(x, w1, b1, w2, b2, torch.ones(32), torch.zeros(32), 5, 3, 4, 0.1, 0.1)
    out.backward(_randn(2, 3, 32, seed=5))
    return ("ffn_mega_fwd_kernel", "ffn_mega_bwd_kernel")


def _run_packed():
    qkv = _leaf(2, 6, 5, 16)
    attention.attention_qkv_train(qkv, 4, 0.1, 5, 3).backward(_randn(2, 2, 5, 16, seed=1))
    return ("attention_qkv_fwd", "attention_qkv_bwd")


def _run_unpacked():
    q, k, v = (_leaf(2, 2, 5, 16, seed=i) for i in range(3))
    attention.attention_train(q, k, v, 4, 0.1, 5, 3).backward(_randn(2, 2, 5, 16, seed=4))
    return ("attention_fwd", "attention_bwd")


def _run_eval_packed():
    attention.flash_attention_qkv(_randn(2, 6, 5, 16), 4)
    return ("attention_qkv_fwd",)


def _run_eval_unpacked():
    attention.flash_attention(*(_randn(2, 2, 5, 16, seed=i) for i in range(3)), 4)
    return ("attention_fwd",)


# What runs each op once, at the test config's widths.
ROUTES = {"resid": _run_resid, "ffn": _run_ffn, "megakernel": _run_megakernel,
          "packed": _run_packed, "unpacked": _run_unpacked, "eval_packed": _run_eval_packed,
          "eval_unpacked": _run_eval_unpacked}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_card_route_reaches_the_kernel_wrappers(card, route):
    """On the card each op calls its kernel wrappers, once a pass, and nothing else."""
    wrappers = ROUTES[route]()
    assert card == dict.fromkeys(wrappers, 1), card


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cpu_tensors_take_the_plain_versions(monkeypatch, route):
    """Off the card no op reaches a kernel wrapper (each would refuse a CPU tensor)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    for module, name in ((dropout, "dropout_kernel"), (ffn, "ffn_act_fwd_kernel"),
                         (ffn, "ffn_act_bwd_kernel"), (resid, "resid_fwd_kernel"),
                         (resid, "resid_bwd_kernel"), (mk, "ffn_mega_fwd_kernel"),
                         (mk, "ffn_mega_bwd_kernel"), (attention, "attention_qkv_fwd"),
                         (attention, "attention_qkv_bwd"), (attention, "attention_fwd"),
                         (attention, "attention_bwd")):
        monkeypatch.setattr(module, name, refuse)
    ROUTES[route]()


N = 4000                        # 1 s at 4 kHz: 399 frames after the tiny conv encoder
NO_NOISE = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                feat_proj_dropout=0.0, mask_time_prob=0.0)
BATCH = 2
# One train step of the tiny config on the card's routing: the kernel wrappers it reaches,
# forward and backward (K1 at the feature projection and the encoder input; in each of the
# two layers K3b, K2 at the end of the attention sublayer, and K4, or on the decomposed route
# K5 and K2 at the end of the FFN sublayer).
TINY_STEP = {True: {"dropout_kernel": 4, "attention_qkv_fwd": 2, "attention_qkv_bwd": 2,
                    "resid_fwd_kernel": 2, "resid_bwd_kernel": 2, "ffn_mega_fwd_kernel": 2,
                    "ffn_mega_bwd_kernel": 2},
             False: {"dropout_kernel": 4, "attention_qkv_fwd": 2, "attention_qkv_bwd": 2,
                     "resid_fwd_kernel": 4, "resid_bwd_kernel": 4, "ffn_act_fwd_kernel": 2,
                     "ffn_act_bwd_kernel": 2}}


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX tiny classifier's init, its eval forward, and one ``fit`` step's loss and
    trained parameters (SGD at 5e-2, rate 0)."""
    cfg = JaxClassifierConfig(num_classes=2, head_hidden=(16,), random_init=True, fs=N,
                              encoder=JaxConfig.tiny(**NO_NOISE))
    model = Wav2VecClassifier(cfg, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(model.init)(jax.random.key(7),
                                                   jnp.zeros((1, N), jnp.float32)))
    logits = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(_waves(0))))
    trainer = JaxTrainer(model, variables, optimizer_name="sgd", lr=5e-2, weight_decay=1e-5,
                         log=lambda s: None)
    losses = _record(trainer)
    trainer.fit(_batches(), None, 1)
    return variables, logits, losses, jax.device_get(trainer.state.params)


def _waves(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / N
    x = np.sin(2 * np.pi * rng.uniform(30, 200, size=(BATCH, 1)) * t) \
        + 0.2 * rng.normal(size=(BATCH, N))
    return (x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


def _batches():
    return [{"waveform": _waves(1), "label": np.array([0, 1], np.int32),
             "valid": np.ones(BATCH, bool)}]


def _record(trainer):
    losses, run = [], trainer._run_epoch

    def record(batcher, train, max_batches, *args):
        cm, loss = run(batcher, train, max_batches, *args)
        losses.append(loss)
        return cm, loss

    trainer._run_epoch = record
    return losses


def _port_model(variables, ffn_mega):
    encoder = Wav2Vec2Config.tiny(**NO_NOISE, ffn_mega=ffn_mega)
    model = build_classifier(ClassifierConfig(head_hidden=(16,), fs=N, encoder=encoder),
                             device="cpu", train=True)
    model.load_state_dict(from_jax(variables["params"]), strict=True)
    return model


@pytest.mark.parametrize("ffn_mega", [True, False])
def test_tiny_eval_forward_through_the_gates_matches_jax(jax_tiny, card, ffn_mega):
    variables, logits, _, _ = jax_tiny
    port = _port_model(variables, ffn_mega).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(_waves(0))).numpy()
    assert card == {"attention_qkv_fwd": 2}             # K3b once a layer
    np.testing.assert_allclose(got, logits, atol=2e-5)


@pytest.mark.parametrize("ffn_mega", [True, False])
def test_tiny_fit_step_through_the_gates_matches_jax(jax_tiny, card, ffn_mega):
    variables, _, jax_losses, trained = jax_tiny
    port = _port_model(variables, ffn_mega)
    trainer = SupervisedTrainer(port, optimizer_name="sgd", lr=5e-2, weight_decay=1e-5,
                                log=lambda s: None)
    losses = _record(trainer)
    trainer.fit(_batches(), None, 1)
    assert card == TINY_STEP[ffn_mega]
    np.testing.assert_allclose(losses, jax_losses, atol=1e-4)
    ours = to_jax(port.state_dict(), trained)
    for path in (("head", "dense_0", "kernel"),
                 ("encoder", "feature_projection", "projection", "kernel"),
                 ("encoder", "layers_0", "intermediate_dense", "kernel"),
                 ("encoder", "layers_1", "attention", "q_proj", "base", "kernel")):
        a, b, before = ours, trained, variables["params"]
        for key in path:
            a, b, before = a[key], b[key], before[key]
        assert not np.array_equal(np.asarray(b), np.asarray(before))          # it trained
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=2e-3, err_msg=str(path))
