"""Normalisation layers (port of ``evflow/models/norm.py``).

Channels-last ``[..., C]`` like the reference package. Parameter and buffer
names follow ``torch.nn.BatchNorm2d`` (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so reference
``.pth`` state dicts load as they are.

In training mode the layers follow flax's ``nn.BatchNorm`` rather than
``torch.nn.BatchNorm2d``: the batch mean and the biased variance over every
axis but the last, the variance as ``E[x^2] - E[x]^2`` (clipped at 0), and
running statistics decayed by 0.9 towards the batch's (biased) ones.
``GroupNorm`` is flax's ``nn.GroupNorm`` (eps 1e-6, torch's is 1e-5; the
variance as ``E[x^2] - E[x]^2`` clipped at 0) under
``torch.nn.GroupNorm``'s parameter names. Inside ``frozen_running_stats(model)`` the model's running statistics are
left as they are: the trainer recomputes a checkpointed forward in it, so
that each pass updates them once. Under ``global_batch_stats(model, group)``
(data-parallel training) the training-mode moments are those of the global
batch: each rank's ``sum x``, ``sum x^2`` and count are summed over the
process group by a differentiable collective, so every rank normalises,
updates its running statistics and back-propagates exactly as one process
over the whole batch would.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

__all__ = ["BatchNorm", "TEBN", "MPBN", "GroupNorm", "frozen_running_stats",
           "global_batch_stats"]

MOMENTUM = 0.9  # flax's decay of the running statistics (torch momentum 0.1)


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """The model's train-mode norms normalise with batch statistics but
    leave their running statistics unchanged (a checkpointed pass's
    recompute)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


def global_batch_stats(model: nn.Module, group) -> None:
    """Make the model's train-mode norms take their moments over ``group``'s
    global batch (None: this process's batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (eps 1e-5): running statistics in eval
    mode, batch statistics (updating the running ones) in training mode."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.frozen = False
        self.group = None  # global_batch_stats

    def _moments(self, x: torch.Tensor):
        dims = tuple(range(x.dim() - 1))
        if self.group is None:
            return x.mean(dims), (x * x).mean(dims)
        from evflow_torch.parallel.mesh import all_reduce_sum

        C = x.shape[-1]
        sums = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims),
                                         x.new_full((1,), float(x.numel() // C))]), self.group)
        return sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, sq = self._moments(x)
            var = torch.maximum(torch.zeros_like(mean), sq - mean * mean)
            if not self.frozen:
                with torch.no_grad():
                    self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
                    self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        # flax's order of operations: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class TEBN(nn.Module):
    """Temporal Effective BN: BN, then the per-timestep scale ``p [T, C, 1,
    1]`` at ``timestep`` (clipped into [0, T-1]), or without a timestep
    the mean of ``p`` over time (PARITY.md divergence 10)."""

    def __init__(self, num_features: int, num_timesteps: int = 4):
        super().__init__()
        self.bn = BatchNorm(num_features)
        self.p = nn.Parameter(torch.ones(num_timesteps, num_features, 1, 1))

    def forward(self, x: torch.Tensor, timestep: Optional[int] = None) -> torch.Tensor:
        if timestep is None:
            p_t = self.p.mean(dim=0)
        else:
            p_t = self.p[min(max(int(timestep), 0), self.p.shape[0] - 1)]
        return self.bn(x) * p_t.reshape(-1)


class MPBN(nn.Module):
    """Membrane-potential BN: BN applied to the membrane after the update."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, mem: torch.Tensor) -> torch.Tensor:
        return self.bn(mem)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` over channels-last ``[B, ..., C]``: each
    sample's groups of ``C / num_groups`` channels normalised over every
    other axis, then the per-channel affine map."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xg = x.reshape(B, -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (xg - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)
