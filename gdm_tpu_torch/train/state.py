"""Train state and the Adam(W) optimizer with a non-finite-update guard.

Counterpart of gdm_tpu/train/state.py.  :func:`make_optimizer` gives the
update of ``optax.adam`` (or ``optax.adamw`` when ``weight_decay`` is set),
optionally wrapped like ``optax.apply_if_finite``, written out over the
model's named parameters:

    mu    = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
    c     = count + 1                    (bias correction by the new count)
    u     = (mu / (1 - b1^c)) / (sqrt(nu / (1 - b2^c)) + eps)
    u    += weight_decay * p             (AdamW only)
    p    += -lr(count) * u               (lr read at the old count)

eps sits outside the square root.  With the guard, gradients holding a
NaN or an inf leave params, moments and count untouched and count a skip
(``notfinite_count`` in a row, ``total_notfinite`` in all); after
``max_consecutive_errors`` skips in a row the update passes through, so
the NaN surfaces instead of the run stalling.  Every decision is taken
on the device (``torch.where``), so a step never waits for the host.

The state dict keeps the reference parameter names: {count, mu {name:
tensor}, nu {name: tensor}} and, with the guard, notfinite_count,
last_finite and total_notfinite.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

# optax.adam's defaults, which the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """Adam(W) over named parameters (their ``.grad`` feeds each step)."""

    def __init__(self, params: dict[str, nn.Parameter], lr_schedule:
                 Callable, weight_decay: float = 0.0,
                 max_consecutive_errors: int = 0):
        self.params = dict(params)
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.max_errors = max_consecutive_errors
        dev = next(iter(self.params.values())).device
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def guarded(self) -> bool:
        return self.max_errors > 0

    @torch.no_grad()
    def step(self) -> None:
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        dev = self.count.device
        ok = None
        if self.guarded:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads.values()]).all()
            self.notfinite_count = torch.where(
                finite, torch.zeros_like(self.notfinite_count),
                self.notfinite_count + 1)
            self.total_notfinite = torch.where(
                finite, self.total_notfinite, self.total_notfinite + 1)
            self.last_finite = finite
            ok = finite | (self.notfinite_count > self.max_errors)
        count_inc = self.count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(B1, device=dev), c)
        bc2 = 1 - torch.pow(torch.tensor(B2, device=dev), c)
        neg_lr = -torch.as_tensor(self.lr_schedule(self.count),
                                  dtype=torch.float32).to(dev)
        for k, p in self.params.items():
            g = grads[k]
            mu = (1 - B1) * g + B1 * self.mu[k]
            nu = (1 - B2) * (g * g) + B2 * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            new_p = p + neg_lr * u
            if ok is None:
                p.copy_(new_p)
                self.mu[k], self.nu[k] = mu, nu
            else:
                p.copy_(torch.where(ok, new_p, p))
                self.mu[k] = torch.where(ok, mu, self.mu[k])
                self.nu[k] = torch.where(ok, nu, self.nu[k])
        self.count = count_inc if ok is None else torch.where(
            ok, count_inc, self.count)

    def state_dict(self) -> dict:
        out = {"count": self.count.detach().cpu().clone(),
               "mu": {k: v.detach().cpu().clone() for k, v in self.mu.items()},
               "nu": {k: v.detach().cpu().clone() for k, v in self.nu.items()}}
        if self.guarded:
            out.update(notfinite_count=self.notfinite_count.cpu().clone(),
                       last_finite=self.last_finite.cpu().clone(),
                       total_notfinite=self.total_notfinite.cpu().clone())
        return out

    def load_state_dict(self, state: dict) -> None:
        """Load a state written with or without the guard: guard counters
        missing from ``state`` restart at zero, as gdm_tpu's
        load_checkpoint resets them across the two layouts."""
        dev = self.count.device

        def tensor(v):             # a copy: numpy inputs may be read-only
            return v.clone() if isinstance(v, torch.Tensor) \
                else torch.tensor(np.asarray(v))

        def t(v, dtype):
            return tensor(v).to(device=dev, dtype=dtype).reshape(())

        for name in ("mu", "nu"):
            got = state[name]
            missing = set(self.params) - set(got)
            if missing:
                raise KeyError(f"optimizer state lacks {name} of "
                               f"{sorted(missing)[:5]}")
            for k, p in self.params.items():
                getattr(self, name)[k] = tensor(got[k]).to(
                    device=dev, dtype=p.dtype).reshape(p.shape)
        self.count = t(state["count"], torch.int32)
        self.notfinite_count = t(state.get("notfinite_count", 0), torch.int32)
        self.last_finite = t(state.get("last_finite", True), torch.bool)
        self.total_notfinite = t(state.get("total_notfinite", 0), torch.int32)


def make_optimizer(params: dict[str, nn.Parameter], lr_schedule: Callable,
                   weight_decay: float = 0.0,
                   skip_nonfinite: int = 0) -> Adam:
    """Adam, or AdamW when ``weight_decay`` is set, with the non-finite
    guard when ``skip_nonfinite`` > 0 (its max_consecutive_errors)."""
    return Adam(params, lr_schedule, weight_decay=weight_decay,
                max_consecutive_errors=skip_nonfinite)


@dataclasses.dataclass
class TrainState:
    """The model in training, its optimizer and the step count (every
    call of the train step, skipped updates included: it drives the BN
    momentum schedule and the dropout seed, as TrainState.step does)."""

    model: nn.Module
    optimizer: Adam
    step: int = 0


def create_train_state(model: nn.Module, lr_schedule: Callable,
                       weight_decay: float = 0.0,
                       skip_nonfinite: int = 0) -> TrainState:
    """A TrainState over every parameter of ``model`` (reference names)."""
    return TrainState(model, make_optimizer(
        dict(model.named_parameters()), lr_schedule, weight_decay,
        skip_nonfinite))
