"""Inference normalisation layers (port of ``evflow/models/norm.py``).

Channels-last ``[..., C]`` like the reference package. Parameter and buffer
names follow ``torch.nn.BatchNorm2d`` (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so reference
``.pth`` state dicts load as they are. This slice runs the running
statistics only; the training-mode statistics come with the training slice,
and a module in training mode raises rather than silently using them.
"""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["BatchNorm", "TEBN", "MPBN"]


class BatchNorm(nn.Module):
    """``BatchNorm2d`` at inference over the last axis (eps 1e-5)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm comes with the training slice; call .eval()")
        # flax's order of operations: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class TEBN(nn.Module):
    """Temporal Effective BN at inference: BN, then the mean over time of
    the per-timestep scale ``p [T, C, 1, 1]`` (PARITY.md divergence 10)."""

    def __init__(self, num_features: int, num_timesteps: int = 4):
        super().__init__()
        self.bn = BatchNorm(num_features)
        self.p = nn.Parameter(torch.ones(num_timesteps, num_features, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x) * self.p.mean(dim=0).reshape(-1)


class MPBN(nn.Module):
    """Membrane-potential BN: BN applied to the membrane after the update."""

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, mem: torch.Tensor) -> torch.Tensor:
        return self.bn(mem)
