"""Leaky integrate-and-fire update (port of ``evflow/ops/lif.py``).

``leaky_step`` is the snntorch ``snn.Leaky`` update with
``reset_delay=False`` that the default FireNet cells use. State is an
explicit ``LIFState(mem, spk)`` of tensors. The cells detach the membrane
carry after every step (unless ``detach=False``); the spike carry is not
detached, so recurrent-spike gradients flow within a loss window (the
trainer detaches at window boundaries). ``sigmoid_lif_step`` is the
update of the sigmoid-family cells (``ConvLIF``), ``export_lif_step`` the
deployment operator's inference update.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from evflow_torch.ops.surrogate import atanspike_snn, heaviside, spike_fn

__all__ = ["LIFState", "leaky_step", "sigmoid_lif_step", "export_lif_step", "THRESH_MIN"]

# learnable thresholds are clamped to >= 0.01 before every forward
THRESH_MIN = 0.01


class LIFState(NamedTuple):
    """Per-unit recurrent state: membrane potential and previous spikes."""

    mem: torch.Tensor
    spk: torch.Tensor


def leaky_step(
    ff: torch.Tensor,
    mem: torch.Tensor,
    beta: torch.Tensor,
    threshold: torch.Tensor,
    *,
    reset: str = "zero",
    alpha: float = 2.0,
    state_quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One snn.Leaky update (``reset_delay=False``)::

      reset_prev = H(mem - theta)                 (detached)
      u   = clip(beta, 0, 1)*mem + ff  - reset_prev*(u | theta)
      u   = state_quant(u)                        (optional)
      spk = ATan_surrogate(u - theta)
      mem_out = u - (spk - reset_prev)*(u | theta)

    ``beta`` and ``threshold`` broadcast against ``ff`` (the threshold is
    already clamped to ``THRESH_MIN`` by the caller). ``reset`` is "zero"
    (hard) or "subtract" (soft). Returns ``(spk, mem_out)``.
    """
    if reset not in ("zero", "subtract"):
        raise ValueError(f"reset must be 'zero' or 'subtract', got {reset!r}")

    # jnp.clip's gradient: half to each side at a bound (clamp passes it whole)
    beta_c = torch.minimum(torch.maximum(beta, beta.new_zeros(())), beta.new_ones(()))
    reset_prev = heaviside(mem - threshold).detach()

    base = beta_c * mem + ff
    if reset == "zero":
        u = base - reset_prev * base
    else:
        u = base - reset_prev * threshold

    if state_quant is not None:
        u = state_quant(u)

    spk = atanspike_snn(u, thresh=threshold, alpha=alpha)

    do_reset = spk - reset_prev  # gradient flows through the surrogate spike
    if reset == "zero":
        mem_out = u - do_reset * u
    else:
        mem_out = u - do_reset * threshold
    return spk, mem_out


def sigmoid_lif_step(
    ff: torch.Tensor,
    mem: torch.Tensor,
    spk_prev: torch.Tensor,
    leak: torch.Tensor,
    thresh: torch.Tensor,
    *,
    hard_reset: bool = True,
    detach_reset: bool = True,
    activation: str = "arctanspike",
    act_width: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One update of the sigmoid-family cell::

      leak_s = sigmoid(leak)
      hard:  v' = v * leak_s * (1 - z) + (1 - leak_s) * ff
      soft:  v' = v * leak_s + (1 - leak_s) * ff - z * max(thresh, 0.01)
      z' = surrogate(v' - max(thresh, 0.01))

    ``z`` is the previous spike output (detached when ``detach_reset``);
    ``activation`` names the surrogate (``spike_fn``), ``act_width`` its
    width. The threshold clamp splits its gradient at a tie, as
    ``jnp.maximum`` does. Returns ``(z', v')``.
    """
    thresh_c = torch.maximum(thresh, thresh.new_full((), THRESH_MIN))
    leak_s = torch.sigmoid(leak)
    z = spk_prev.detach() if detach_reset else spk_prev

    if hard_reset:
        v_out = mem * leak_s * (1.0 - z) + (1.0 - leak_s) * ff
    else:
        v_out = mem * leak_s + (1.0 - leak_s) * ff - z * thresh_c

    z_out = spike_fn(activation)(v_out, thresh_c, act_width)
    return z_out, v_out


def export_lif_step(
    x: torch.Tensor,
    mem: torch.Tensor,
    beta: torch.Tensor,
    threshold: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The deployment operator's LIF update, inference only::

      u = beta * mem + x
      spike = (u >= threshold);  mem_out = where(spike, 0, u)

    It differs from the training cells on purpose: the raw ``beta`` (no
    sigmoid, no clip), no ``(1 - beta)`` input scaling, a spike at ``>=``.
    Returns ``(spike, mem_out)``.
    """
    u = beta * mem + x
    spike = (u >= threshold).to(x.dtype)
    mem_out = torch.where(spike > 0, torch.zeros_like(u), u)
    return spike, mem_out
