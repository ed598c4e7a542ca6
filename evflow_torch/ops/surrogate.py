"""Surrogate-gradient spike functions (port of ``evflow/ops/surrogate.py``).

Forward is an exact Heaviside step; backward substitutes a smooth
surrogate derivative (``torch.autograd.Function``). The gradient flows to
``x`` (and so to the threshold, through ``x - thresh``), never to the
width, which is a hyperparameter. ``atanspike_snn`` is the snntorch ATan
surrogate of the ``snn.Leaky`` cells; ``superspike``, ``mgspike``,
``trianglespike`` and ``arctanspike`` are the sigmoid-family cells'
(``activation`` in the config), looked up by ``spike_fn``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["heaviside", "superspike", "mgspike", "trianglespike", "arctanspike",
           "atanspike_snn", "spike_fn", "SURROGATES"]


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Exact step ``x > 0`` in ``x``'s dtype, no gradient."""
    return (x > 0).to(x.dtype)


def _gaussian(x, mu, sigma):
    return torch.exp(-((x - mu) ** 2) / (2.0 * sigma * sigma)) / (
        sigma * math.sqrt(2.0 * math.pi))


def _make_spike(sg: Callable, name: str):
    """A ``torch.autograd.Function`` ``f(x, width) -> H(x > 0)`` whose
    backward is ``g * sg(x, width)``."""

    def forward(ctx, x, width):
        ctx.save_for_backward(x)
        ctx.width = width
        return heaviside(x)

    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * sg(x, ctx.width), None

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward), "backward": staticmethod(backward)})


# surrogate derivative shapes (the reference's spiking_util.py:39-93)
_SuperSpike = _make_spike(lambda x, w: 1.0 / (1.0 + w * x.abs()) ** 2, "_SuperSpike")
_MGSpike = _make_spike(lambda x, w: (1.15 * _gaussian(x, 0.0, w)
                                     - 0.15 * _gaussian(x, w, 6.0 * w)
                                     - 0.15 * _gaussian(x, -w, 6.0 * w)), "_MGSpike")
_TriangleSpike = _make_spike(lambda x, w: torch.relu(1.0 - w * x.abs()), "_TriangleSpike")
_ArctanSpike = _make_spike(lambda x, w: 1.0 / (1.0 + w * x * x), "_ArctanSpike")
# snntorch.surrogate.atan(alpha): d/dx = (alpha/2) / (1 + (pi/2 * alpha * x)^2)
_ATanSNN = _make_spike(lambda x, a: (a / 2.0) / (1.0 + (math.pi / 2.0 * a * x) ** 2),
                       "_ATanSNN")


def superspike(x: torch.Tensor, thresh=1.0, width: float = 10.0) -> torch.Tensor:
    """SuperSpike (Zenke et al. 2018) of ``x - thresh``."""
    return _SuperSpike.apply(x - thresh, width)


def mgspike(x: torch.Tensor, thresh=1.0, width: float = 0.5) -> torch.Tensor:
    """Multi-Gaussian surrogate (Yin et al. 2021) of ``x - thresh``."""
    return _MGSpike.apply(x - thresh, width)


def trianglespike(x: torch.Tensor, thresh=1.0, width: float = 1.0) -> torch.Tensor:
    """Triangular surrogate (Bellec et al. 2020) of ``x - thresh``."""
    return _TriangleSpike.apply(x - thresh, width)


def arctanspike(x: torch.Tensor, thresh=1.0, width: float = 10.0) -> torch.Tensor:
    """Arctan-derivative surrogate (Fang et al. 2021) of ``x - thresh``."""
    return _ArctanSpike.apply(x - thresh, width)


def atanspike_snn(x: torch.Tensor, thresh=0.0, alpha: float = 2.0) -> torch.Tensor:
    """snntorch-style ATan spike of ``x - thresh`` (the snn.Leaky default)."""
    return _ATanSNN.apply(x - thresh, alpha)


SURROGATES = {
    "superspike": superspike,
    "mgspike": mgspike,
    "trianglespike": trianglespike,
    "arctanspike": arctanspike,
    "atanspike_snn": atanspike_snn,
}


def spike_fn(name: str):
    """The surrogate spike function called ``name``."""
    try:
        return SURROGATES[name]
    except KeyError as e:
        raise KeyError(f"Unknown surrogate '{name}'. Available: {sorted(SURROGATES)}") from e
