"""Surrogate-gradient spike functions (port of ``evflow/ops/surrogate.py``).

Forward is an exact Heaviside step; backward substitutes a smooth
surrogate derivative (``torch.autograd.Function``). The port has the step
and the snntorch ATan surrogate that the ``snn.Leaky`` cells use; the other
four surrogates come with the sigmoid-family cells (ROADMAP.md queue 1
item 5).
"""

from __future__ import annotations

import math

import torch

__all__ = ["heaviside", "atanspike_snn"]


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Exact step ``x > 0`` in ``x``'s dtype, no gradient."""
    return (x > 0).to(x.dtype)


class _ATanSNN(torch.autograd.Function):
    """H(x > 0) forward; ``(alpha/2) / (1 + (pi/2 * alpha * x)^2)`` backward
    (snntorch.surrogate.atan)."""

    @staticmethod
    def forward(ctx, x, alpha: float):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return heaviside(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = ctx.alpha
        return g * ((a / 2.0) / (1.0 + (math.pi / 2.0 * a * x) ** 2)), None


def atanspike_snn(x: torch.Tensor, thresh=0.0, alpha: float = 2.0) -> torch.Tensor:
    """snntorch-style ATan spike of ``x - thresh`` (the snn.Leaky default)."""
    return _ATanSNN.apply(x - thresh, alpha)
