"""BatchNorm with flax's training arithmetic.

``nn.BatchNorm2d`` and flax's ``nn.BatchNorm`` normalise a batch alike in
eval mode, but differ in train mode in what they store:

  * flax's ``momentum`` weighs the old statistic (0.99 by default, 0.97 in
    YOLOv8's block); PyTorch's weighs the new one: PyTorch momentum is
    ``1 - flax_momentum``;
  * flax stores the biased batch variance; PyTorch the unbiased one
    (n / (n - 1) larger).

``FlaxBatchNorm2d`` keeps ``nn.BatchNorm2d``'s parameters, buffers and
state-dict keys (so ``weights/convert.py`` and every checkpoint still map)
and, in train mode, computes what flax computes: statistics in float32 with
flax's fast variance ``max(E[x^2] - E[x]^2, 0)``, the batch normalised with
it, and both running statistics updated with flax's momentum.  Under
``dp_shard`` (the data-parallel train step) the statistics are those of
the global batch, summed over the shards.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn as nn

# the data-parallel shard this thread computes, where one is set
_shard = threading.local()


class ShardAllReduce:
    """A barrier all-reduce between the threads that run the dp shards of
    one batch (``train/train_step.make_sharded_train_step``): each thread
    hands in its partial sums, and every thread gets their total on its own
    device.  The partials stay in the autograd graph: the copy to another
    device is a differentiable op, so the backward reaches every shard."""

    def __init__(self, n: int, timeout: float = 600.0):
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: List[Optional[Sequence[torch.Tensor]]] = [None] * n

    def all_reduce(self, rank: int, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        self._slots[rank] = parts
        self._barrier.wait()  # every shard's partials are in
        dev = parts[0].device
        total = [sum(p[k].to(dev) for p in self._slots) for k in range(len(parts))]
        self._barrier.wait()  # every shard has read them: the slots may be reused
        return total

    def abort(self) -> None:
        """Wake every waiting thread with BrokenBarrierError (a shard failed)."""
        self._barrier.abort()


@contextlib.contextmanager
def dp_shard(reducer: ShardAllReduce, rank: int) -> Iterator[None]:
    """In this thread, train-mode BatchNorm takes its statistics over all
    the dp shards of the batch, and only rank 0 updates the running
    statistics (once, with the global values)."""
    _shard.ctx = (reducer, rank)
    try:
        yield
    finally:
        _shard.ctx = None


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over NCHW whose train mode is flax's.

    flax_momentum: flax's ``momentum`` (the old statistic's weight);
    eps: flax's ``epsilon``.  Inside ``dp_shard`` the statistics are the
    global batch's, from every shard's sums."""

    def __init__(self, features: int, eps: float = 1e-5, flax_momentum: float = 0.99):
        super().__init__(features, eps=eps, momentum=1.0 - flax_momentum)
        self.flax_momentum = flax_momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        shard = getattr(_shard, "ctx", None)
        if shard is None:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            update = True
        else:
            reducer, rank = shard
            count = torch.full((), float(x.shape[0] * x.shape[2] * x.shape[3]),
                               dtype=torch.float32, device=x.device)
            s, ss, n = reducer.all_reduce(rank, (x.sum(dim=(0, 2, 3)),
                                                 (x * x).sum(dim=(0, 2, 3)), count))
            mean = s / n
            var = torch.clamp(ss / n - mean * mean, min=0.0)
            update = rank == 0
        if update:
            with torch.no_grad():
                m = self.flax_momentum
                self.running_mean.mul_(m).add_(mean.detach() * (1.0 - m))
                self.running_var.mul_(m).add_(var.detach() * (1.0 - m))
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None]
        return y + self.bias.float()[None, :, None, None]
