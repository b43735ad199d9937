"""Optimizer and learning-rate schedule with optax's semantics, in torch.

Port of ``coral_tpu/training/optimizer.py``: ``create_learning_rate_schedule``
(optax ``warmup_cosine_decay_schedule`` from 0) and ``create_optimizer``
(``clip_by_global_norm`` followed by ``adamw`` with ``mu_dtype``). The JAX
package has no kernel here; the update is plain ``torch._foreach_*`` ops over
the parameter list. Where optax and ``torch.optim`` differ, this follows optax:

- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``clip_grad_norm_`` uses ``max_norm / (norm + 1e-6)``);
- eps sits outside the square root, both moments are bias-corrected, and a
  bf16 first moment is updated as ``(1 - b1) g + bf16(b1 mu)`` with b1 itself
  rounded to bf16 (JAX's weak typing casts the Python constant to the
  moment's dtype: 0.9 becomes 0.8984375), and stored rounded to bf16;
- the schedule starts at 0, so the first update has learning rate 0, and the
  update of step n uses ``schedule(n)``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name; ``update`` changes the parameters and the state in place (optax returns
new arrays; in place saves a copy of the 300M-parameter tree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def create_learning_rate_schedule(
    learning_rate: float, warmup_steps: int, max_steps: int
) -> Callable[[int], float]:
    """Linear warmup from 0 to ``learning_rate``, cosine decay to 0 at
    ``max_steps`` (optax ``warmup_cosine_decay_schedule``, fp32 arithmetic)."""
    peak = np.float32(learning_rate)
    decay = max(max_steps, warmup_steps + 1) - warmup_steps

    def schedule(count: int) -> float:
        count = int(count)
        if count < warmup_steps:
            frac = np.float32(1.0) - np.float32(count) / np.float32(warmup_steps)
            return float((np.float32(0.0) - peak) * frac + peak)
        c = np.float32(min(count - warmup_steps, decay))
        cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * c
                                                             / np.float32(decay)))
        return float(peak * cosine)

    return schedule


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and both moments."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32 (optax ``global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(...))``."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float | None = 1.0, mu_dtype: torch.dtype | None = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = mu_dtype

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        mu = {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        return AdamWState(0, mu, nu)

    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor]) -> None:
        """One step: clip, Adam moments, bias correction, weight decay, the
        scheduled learning rate; ``params`` and ``state`` change in place."""
        names = list(params)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        if self.max_grad_norm is not None:
            norm = global_norm(g)
            clip = norm >= self.max_grad_norm
            g = torch._foreach_div(g, torch.where(clip, norm, torch.ones_like(norm)))
            torch._foreach_mul_(g, torch.where(clip, self.max_grad_norm,
                                               torch.ones_like(norm)))
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = self.b1, self.b2
        mu = [state.mu[n] for n in names]
        b1_mu = float(torch.tensor(b1, dtype=mu[0].dtype)) if mu else b1
        mu = torch._foreach_mul(mu, b1_mu)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1), [m.float() for m in mu])
        nu = torch._foreach_mul([state.nu[n] for n in names], b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(state.count))
        bc2 = float(one - np.float32(b2) ** np.float32(state.count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        for n, m, v in zip(names, mu, nu):
            state.mu[n] = m.to(state.mu[n].dtype)
            state.nu[n] = v


def create_optimizer(
    learning_rate: float,
    warmup_steps: int,
    max_steps: int,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.98,
    adam_eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float | None = 1.0,
    mu_dtype: str | None = None,
) -> tuple[AdamW, Callable[[int], float]]:
    """The training optimizer and its schedule (``mu_dtype`` e.g. "bfloat16"
    for a bf16 first moment; the second stays fp32)."""
    schedule = create_learning_rate_schedule(learning_rate, warmup_steps, max_steps)
    tx = AdamW(schedule, adam_beta1, adam_beta2, adam_eps, weight_decay, max_grad_norm,
               getattr(torch, mu_dtype) if mu_dtype else None)
    return tx, schedule
