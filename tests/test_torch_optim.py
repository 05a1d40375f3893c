"""The port's float32-master optimizer vs the JAX package's ``build_master_optimizer``.

The quadratic of ``tests/test_train_dynamics_parity.py`` over two leaves: gradients large
enough that the global-norm clip at 5.0 is active on every step, and, for sgd, enough
epochs (2 steps each) to cross the StepLR(7, 0.1) boundary. Both sides are float32; the
trajectories agree to float32 rounding (atol/rtol 1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wav2vec_heart_sounds_tpu.train.optim import build_master_optimizer
from wav2vec_heart_sounds_tpu.train.optim import lr_schedule as jax_lr_schedule
from wav2vec_heart_sounds_tpu_torch.train.optim import MasterOptimizer, lr_schedule

INIT = {"a": np.linspace(-3.0, 3.0, 32, dtype=np.float32).reshape(8, 4),
        "b": np.linspace(2.0, -1.0, 6, dtype=np.float32)}


def _jax_run(name, lr, wd, epochs):
    tx, schedule = build_master_optimizer(name, lr, weight_decay=wd, max_grad_norm=5.0)
    params = {k: jnp.asarray(v) for k, v in INIT.items()}
    state = tx.init(params)
    loss = lambda p: jnp.sum(p["a"] ** 2) + 3.0 * jnp.sum(p["b"] ** 2)
    traj = []
    for epoch in range(epochs):
        lr_now = jnp.asarray(schedule(epoch), jnp.float32)
        for _ in range(2):
            params, state = tx.step(jax.grad(loss)(params), state, lr_now, params)
        traj.append({k: np.asarray(v) for k, v in params.items()})
    return traj


def _port_run(name, lr, wd, epochs):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in INIT.items()}
    opt = MasterOptimizer(params.values(), name, wd)
    schedule = lr_schedule(name, lr)
    traj = []
    for epoch in range(epochs):
        for _ in range(2):
            opt.zero_grad()
            loss = (params["a"] ** 2).sum() + 3.0 * (params["b"] ** 2).sum()
            loss.backward()
            assert float(opt.global_norm([p.grad for p in params.values()])) > 5.0
            opt.step(schedule(epoch))
        traj.append({k: v.detach().numpy().copy() for k, v in params.items()})
    return traj


@pytest.mark.parametrize("name,lr,wd,epochs", [
    ("sgd", 1e-2, 1e-5, 9), ("adam", 1e-3, 1e-2, 4), ("adamw", 1e-3, 1e-2, 4)])
def test_matches_jax_master_optimizer(name, lr, wd, epochs):
    ours, ref = _port_run(name, lr, wd, epochs), _jax_run(name, lr, wd, epochs)
    for e, (a, b) in enumerate(zip(ours, ref)):
        for k in INIT:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name}: leaf {k}, epoch {e}")


def test_lr_schedule_matches_jax():
    for name in ("sgd", "adam", "adamw"):
        ours, ref = lr_schedule(name, 1e-3), jax_lr_schedule(name, 1e-3)
        for epoch in range(16):
            assert np.isclose(ours(epoch), ref(epoch), rtol=1e-12, atol=0)
    assert np.isclose(lr_schedule("sgd", 1.0)(7), 0.1)


def test_bf16_live_params_follow_the_f32_master_and_refresh():
    lin = torch.nn.Linear(6, 4, dtype=torch.bfloat16)
    norm = torch.nn.Parameter(torch.ones(4))                 # float32: its own master
    opt = MasterOptimizer([lin.weight, lin.bias, norm], "sgd", 1e-5)
    assert opt.master[2] is not None and opt.master[2].data_ptr() == norm.data_ptr()
    for _ in range(3):
        opt.zero_grad()
        (lin(torch.ones(2, 6, dtype=torch.bfloat16)).float() * norm).sum().backward()
        opt.step(0.3)
        assert opt.master[0].dtype == torch.float32
        torch.testing.assert_close(lin.weight, opt.master[0].to(torch.bfloat16), rtol=0, atol=0)
    # the master holds what bf16 cannot: the live weight is its rounding
    assert not torch.equal(opt.master[0], lin.weight.float())
    with torch.no_grad():
        lin.weight.fill_(0.5)                               # a restore outside the optimizer
    opt.refresh()
    torch.testing.assert_close(opt.master[0], torch.full((4, 6), 0.5), rtol=0, atol=0)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        MasterOptimizer([torch.nn.Parameter(torch.ones(2))], "lamb")


def test_bf16_live_params_round_the_master_as_the_jax_optimizer_does():
    """bf16 live leaves under a float32 master, the same gradients on both sides: after
    every step the port's live leaves equal the JAX package's bit for bit. Steps far below
    half a bf16 ulp move both masters but leave both live leaves as they were, until the
    masters cross a rounding boundary; so a bf16 run that learns slower than float32 at a
    small learning rate does so in the reference's design too."""
    init = {k: v.astype(jnp.bfloat16) for k, v in INIT.items()}
    tx, _ = build_master_optimizer("sgd", 1e-3, weight_decay=0.0, max_grad_norm=5.0)
    theirs = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(theirs)
    grad = jax.grad(lambda p: jnp.sum(p["a"].astype(jnp.float32) ** 2)
                    + 3.0 * jnp.sum(p["b"].astype(jnp.float32) ** 2))
    ours = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v.astype(jnp.float32)))
                                  .to(torch.bfloat16)) for k, v in init.items()}
    opt = MasterOptimizer(ours.values(), "sgd", 0.0)
    start = opt.master[0].clone()
    unchanged, moved = [], []
    for lr in [1e-5] * 4 + [3e-2] * 2:
        theirs, state = tx.step(grad(theirs), state, jnp.asarray(lr, jnp.float32), theirs)
        opt.zero_grad()
        ((ours["a"].float() ** 2).sum() + 3.0 * (ours["b"].float() ** 2).sum()).backward()
        opt.step(lr)
        for k in INIT:
            mine = ours[k].detach().float().numpy()
            np.testing.assert_array_equal(mine, np.asarray(theirs[k].astype(jnp.float32)),
                                          err_msg=f"{k} at lr {lr}")
        unchanged.append(all(np.array_equal(ours[k].detach().float().numpy(),
                                            np.asarray(init[k].astype(jnp.float32)))
                             for k in INIT))
        moved.append(not torch.equal(opt.master[0], start))
    assert unchanged == [True] * 4 + [False] * 2 and all(moved)
