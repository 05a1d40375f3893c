"""Optimizers with a float32 master (port of ``train/optim.py``'s semantics, not its form).

The JAX package's trainer runs SGD (momentum 0.9, coupled weight decay) + StepLR(7, 0.1),
Adam (coupled decay) or AdamW (decoupled decay) as optax chains behind a global-norm clip
at 5.0, with the float32 master packed inside the optimizer state and bfloat16 live
parameters on an accelerator (``build_master_optimizer``, ``train/classifier.py:113-131``).
:class:`MasterOptimizer` keeps those semantics per parameter:

* the master is float32 for every parameter: a float32 live parameter is its own master
  (the tensor is shared), any other dtype gets a float32 copy and is rewritten from it
  after each step, rounded to its dtype;
* per step: gradients to float32; the global norm over all of them; optax's clip
  (``g / norm * max_norm`` when ``norm >= max_norm``); then the rule, on the master:
  - sgd:   ``u = g + wd * p``; ``buf = momentum * buf + u``; ``p -= lr * buf``
  - adam:  ``u = g + wd * p``; Adam moments of ``u`` (b1 0.9, b2 0.999, eps 1e-8, bias
    corrected); ``p -= lr * m_hat / (sqrt(v_hat) + eps)``
  - adamw: Adam moments of ``g``; ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
* under a data-parallel ``mesh`` (:mod:`..parallel.mesh`), the float32 gradients are
  replaced by their mean over the ranks (one flat all-reduce) before the clip, so the clip
  and the rule see the global gradient, as under the JAX package's ``psum``; at one rank the
  mean is the gradient itself, bit for bit. Every trainable gradient takes part, the loss's
  parameters' too, and a missing one counts as zeros;
* :meth:`MasterOptimizer.refresh` re-reads the master from the live parameters after the
  trainer overwrites them (the best-MCC restore); moments and momentum are kept, as the
  JAX package's ``refresh``.

The optimizer sees only the parameters it trains: under a freeze mask (the frozen encoder,
or LoRA's frozen base) the trainer passes the trainable ones, so frozen weights enter
neither the clip's norm nor the decay, as the JAX package's masked optimizer
(``train/optim.py:202-243``). The updates run as ``torch._foreach_*`` ops over the
parameter list, with no host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import all_reduce_mean

NAMES = ("sgd", "adam", "adamw")
MAX_GRAD_NORM = 5.0                       # the JAX trainer's clip (its train/classifier.py:104)
MOMENTUM = 0.9
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8      # optax.scale_by_adam's defaults


def lr_schedule(name: str, lr: float):
    """Per-epoch learning rate (the trainer passes the epoch index): StepLR(7, 0.1) for
    sgd, constant otherwise."""
    if name == "sgd":
        return lambda epoch: lr * (0.1 ** (epoch // 7))
    return lambda epoch: lr


class MasterOptimizer:
    """sgd / adam / adamw over ``params`` with a float32 master and a global-norm clip
    at ``max_grad_norm``. The generative trainer takes plain Adam (decay 0) behind a clip at
    1.0, as its JAX counterpart's optax chain. ``mesh``: average the gradients over its
    ranks first."""

    def __init__(self, params, name: str = "sgd", weight_decay: float = 1e-5,
                 max_grad_norm: float = MAX_GRAD_NORM, mesh=None):
        if name not in NAMES:
            raise ValueError(f"Unknown optimizer '{name}'")
        self.params = [p for p in params]
        self.name, self.weight_decay, self.max_grad_norm = name, weight_decay, max_grad_norm
        self.mesh = mesh
        self.master = [p.detach() if p.dtype == torch.float32 else p.detach().float()
                       for p in self.params]
        # live parameters that are not their own master, with their masters
        self._copied = [(p, m) for p, m in zip(self.params, self.master)
                        if p.dtype != torch.float32]
        self.count = 0
        if name == "sgd":
            self.state = [torch.zeros_like(m) for m in self.master]
        else:
            self.state = ([torch.zeros_like(m) for m in self.master],
                          [torch.zeros_like(m) for m in self.master])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> list[torch.Tensor]:
        """Float32 copies of the gradients (zeros where a parameter got none)."""
        return [torch.zeros_like(m) if p.grad is None
                else p.grad.detach().to(torch.float32, copy=True)
                for p, m in zip(self.params, self.master)]

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = self._grads()
        if self.mesh is not None:
            all_reduce_mean(grads, self.mesh)
        norm = self.global_norm(grads)
        clip = norm >= self.max_grad_norm
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, self.max_grad_norm, 1.0))
        wd, master = self.weight_decay, self.master
        if self.name == "sgd":
            torch._foreach_add_(grads, master, alpha=wd)
            torch._foreach_mul_(self.state, MOMENTUM)
            torch._foreach_add_(self.state, grads)
            torch._foreach_add_(master, self.state, alpha=-lr)
        else:
            if self.name == "adam":
                torch._foreach_add_(grads, master, alpha=wd)
            m, v = self.state
            self.count += 1
            torch._foreach_mul_(m, BETA1)
            torch._foreach_add_(m, grads, alpha=1.0 - BETA1)
            torch._foreach_mul_(v, BETA2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - BETA2)
            bc1 = float(1.0 - np.float32(BETA1) ** np.float32(self.count))
            bc2 = float(1.0 - np.float32(BETA2) ** np.float32(self.count))
            upd = torch._foreach_div(m, bc1)
            den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
            torch._foreach_add_(den, EPS)
            torch._foreach_div_(upd, den)
            if self.name == "adamw":
                torch._foreach_add_(upd, master, alpha=wd)
            torch._foreach_add_(master, upd, alpha=-lr)
        if self._copied:
            torch._foreach_copy_([p.data for p, _ in self._copied],
                                 [m for _, m in self._copied])

    def state_dict(self) -> dict:
        """The step count, the float32 master and the moments (or momentum), for a
        checkpoint."""
        return {"count": self.count, "master": self.master, "state": self.state}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in place and rewrite the live parameters from the
        master."""
        self.count = int(state["count"])
        torch._foreach_copy_(self.master, list(state["master"]))
        moments = self.state if self.name == "sgd" else [*self.state[0], *self.state[1]]
        saved = state["state"] if self.name == "sgd" else [*state["state"][0],
                                                            *state["state"][1]]
        torch._foreach_copy_(moments, list(saved))
        if self._copied:
            torch._foreach_copy_([p.data for p, _ in self._copied],
                                 [m for _, m in self._copied])

    @torch.no_grad()
    def refresh(self) -> None:
        """Re-read the master from the live parameters (after a restore)."""
        for p, m in self._copied:
            m.copy_(p.detach())
