"""The optax chains of the JAX trainers, in PyTorch.

The JAX trainers build ``optax.chain(optax.clip_by_global_norm(c),
optax.adamw(schedule, weight_decay=1e-4))`` (and ``make_train_state`` a
plain ``optax.adamw(lr)``).  PyTorch's stock pieces differ from optax in
three places, each of which this module follows optax in:

  * ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
    1e-6)``; optax leaves the gradients alone below ``max_norm`` and scales
    them by ``max_norm / norm`` at or above it;
  * ``torch.optim.AdamW`` defaults to ``weight_decay=1e-2``; optax's adamw
    to 1e-4, which the trainers pass explicitly;
  * optax evaluates the schedule at the update count *before* it increments
    (the first update uses ``schedule(0)``), and decays every parameter,
    biases and norm scales included (an unmasked adamw).

The decoupled update ``p <- p - lr * (adam(g) + wd * p)`` is the same in
both; ``AdamW`` below drives ``torch.optim.AdamW`` with the schedule's
value at each step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (a constant ``end_value`` for no steps)."""

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return end_value
        frac = 1 - min(max(float(count), 0.0), float(transition_steps)) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (counted from step 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place as ``optax.clip_by_global_norm``: unchanged
    where their global norm is below `max_norm`, else times ``max_norm /
    norm``.  Returns the norm (a device scalar: no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class AdamW:
    """``optax.chain([clip_by_global_norm(clip_norm),] adamw(schedule,
    b1, b2, eps, weight_decay))`` over `params`, stepped after
    ``loss.backward()``.

    A parameter that received no gradient gets a zero one, as a JAX
    gradient tree has a zero leaf there (optax still decays it).
    ``count`` is optax's update count."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Schedule], weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.clip_norm = clip_norm
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(b1, b2), eps=eps,
                                     weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.clip_norm)
        self.opt.param_groups[0]["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.count += 1
