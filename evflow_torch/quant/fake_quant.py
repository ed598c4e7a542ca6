"""Int8 fake quantization: weights, conv activations, membrane state (port
of ``evflow/quant/fake_quant.py``).

The reference's brevitas/snntorch stack: per-tensor symmetric int8 conv
quantisation (narrow range, +-127) and snntorch's uniform membrane
quantiser over ``[-threshold (1 + lower), threshold (1 + upper)]``,
``[-250, 1]`` by default. Rounding is straight-through (identity in the
backward) so the ops drop into QAT training.

The operations keep the reference's order, so results are bit-equal:
``x / s`` (a true division: on the card a division by a host scalar would
run as a multiplication by its reciprocal, so every divisor is a 0-d
tensor on ``x``'s device), round half to even, clip, then ``* s``; and
``qmin + round((x - qmin) / step) * step``. The clips split their gradient
at a tie, as ``jnp.clip`` does. The dynamic scale stays a detached tensor
on the device: nothing here makes the host wait for the card, so a QAT
step and a CUDA graph capture of ``evaluate(chunk>1)`` take the hooks.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

__all__ = ["ste_round", "fake_quant_symmetric", "fake_quant_minmax", "state_quant_fn",
           "state_quant_from_range", "dynamic_conv_quant", "static_conv_quant",
           "quantize_weights_symmetric"]

_CONSTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device, filled there
    (no copy from the host). Kept for reuse unless made inside a CUDA graph
    capture, where the fill only runs at the graph's replay."""
    key = (float(value), like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.full((), value, dtype=torch.float32, device=like.device)
        if not (like.is_cuda and torch.cuda.is_current_stream_capturing()):
            _CONSTS[key] = t
    return t


class _STERound(torch.autograd.Function):
    """Round half to even; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _STERound.apply(x)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: half the gradient to each side at a tie."""
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def fake_quant_symmetric(x: torch.Tensor, scale, num_bits: int = 8) -> torch.Tensor:
    """``clip(round(x / s), -qmax, qmax) * s`` with ``qmax = 2^(b-1) - 1``
    and ``s = max(scale, 1e-12)`` (brevitas Int8*PerTensorFloat: the
    narrow signed range)."""
    qmax = 2 ** (num_bits - 1) - 1
    if not torch.is_tensor(scale):
        scale = _const(scale, x)
    s = torch.maximum(scale, _const(1e-12, x))
    return _clip(ste_round(x / s), -qmax, qmax) * s


def fake_quant_minmax(x: torch.Tensor, qmin: float, qmax: float,
                      num_bits: int = 8) -> torch.Tensor:
    """Uniform fake quant over a fixed ``[qmin, qmax]``: the nearest of
    ``2^b`` evenly spaced levels (snntorch's uniform state quant)."""
    levels = 2 ** num_bits - 1
    step = (qmax - qmin) / levels
    x = _clip(x, qmin, qmax)
    return qmin + ste_round((x - qmin) / _const(step, x)) * step


def state_quant_fn(num_bits: int = 8, threshold: float = 1.0, lower_limit: float = 249.0,
                   upper_limit: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The membrane quantiser, over ``[-threshold (1 + lower_limit),
    threshold (1 + upper_limit)]`` (``[-250, 1]`` by default)."""
    qmin = -threshold * (1.0 + lower_limit)
    qmax = threshold * (1.0 + upper_limit)
    return lambda mem: fake_quant_minmax(mem, qmin, qmax, num_bits)


def state_quant_from_range(qmin: float, qmax: float, num_bits: int = 8):
    """The membrane quantiser over a profiled per-layer range."""
    return lambda mem: fake_quant_minmax(mem, qmin, qmax, num_bits)


def dynamic_conv_quant(num_bits: int = 8) -> Callable[[torch.Tensor, str], torch.Tensor]:
    """The QAT conv hook: ``hook(x, tag)`` (tag "input" or "output")
    fake-quantises ``x`` per tensor at the scale ``max|x| / qmax`` of
    ``x`` itself, detached."""
    qmax = 2 ** (num_bits - 1) - 1

    def hook(x: torch.Tensor, tag: str) -> torch.Tensor:
        scale = x.detach().abs().amax() / _const(qmax, x)
        return fake_quant_symmetric(x, scale, num_bits)

    return hook


def static_conv_quant(scales: Mapping[str, float], layer: str = "",
                      num_bits: int = 8) -> Callable[[torch.Tensor, str], torch.Tensor]:
    """The PTQ conv hook at calibrated scales: ``scales["<layer>/<tag>"]``
    (else ``scales[tag]``); a tensor without a scale passes unchanged."""

    def hook(x: torch.Tensor, tag: str) -> torch.Tensor:
        s = scales.get(f"{layer}/{tag}") or scales.get(tag)
        if s is None:
            return x
        return fake_quant_symmetric(x, _const(s, x), num_bits)

    return hook


@torch.no_grad()
def quantize_weights_symmetric(state_dict: Mapping[str, torch.Tensor], num_bits: int = 8
                               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Fake-quantise every conv kernel of a state dict (the 4-d
    ``*.weight`` tensors) per tensor at ``max|w| / qmax``; returns the new
    state dict and the scales by key (for the PTQ weights and the export
    metadata)."""
    qmax = 2 ** (num_bits - 1) - 1
    out, scales = {}, {}
    for key, v in state_dict.items():
        if key.endswith(".weight") and v.ndim == 4:
            s = float(v.abs().max()) / qmax
            scales[key] = s
            out[key] = fake_quant_symmetric(v, torch.tensor(s, dtype=torch.float32,
                                                            device=v.device), num_bits)
        else:
            out[key] = v
    return out, scales
