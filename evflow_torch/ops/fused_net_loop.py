"""The whole FireNet step in one launch, units unrolled at compile time,
recurrent units' spikes only (port of
``benchmarks/pallas_archive/fused_net_loop.py``, K4).

The same function as ``evflow_torch.ops.fused_net`` over the layout of
``LoopFusedFireNet`` without its row padding: membranes ``[L, B, C, H, W]``
and one spike slot per recurrent unit, ``[max(R, 1), B, C, H, W]`` (a
feedforward net keeps one zero slot, as the TPU layout does). The CUDA
kernel (``evflow_torch/csrc/fused_net_loop.cu``) runs K5's grid of (b, 16 x
16) items (``evflow_torch.ops.fused_net_item``) with the unit loop unrolled
for the unit layouts of the FireNet family; CPU tensors run
``firenet_step_plain``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from evflow_torch.ops.fused_net_loop2 import LoopFireNet, slotted_step

__all__ = ["fused_firenet_step_loop", "UnrolledLoopFireNet", "recurrent_slots", "LAYOUTS"]

# (units, recurrent units) compiled into the kernel: LIFFireNet, its _short
# variant, and the two without recurrence
LAYOUTS = ((7, (1, 4)), (5, (1, 3)), (7, ()), (5, ()))


def recurrent_slots(recurrent) -> List[Optional[int]]:
    """The unit whose spikes each slot holds: the recurrent units in order,
    or one empty slot when there are none."""
    return [l for l, r in enumerate(recurrent) if r] or [None]


def fused_firenet_step_loop(x: torch.Tensor, mem_stack: torch.Tensor, spk_slots: torch.Tensor,
                            w_stack: torch.Tensor, weights):
    """One window (K4 schedule).

    Args:
      x: ``[B, H, W, Cin]`` window.
      mem_stack: ``[L, B, C, H, W]`` membranes (f32 or bf16 state).
      spk_slots: ``[max(R, 1), B, C, H, W]`` spikes of the R recurrent
        units (``recurrent_slots``), in the state dtype.
      w_stack: ``stack_weights(weights)``.
    Returns:
      ``(flow [B, H, W, 2], mem_stack', spk_slots')``.

    CPU tensors run ``firenet_step_plain``; CUDA tensors launch the kernel
    (counted in ``fused_firenet_step_loop.launches``) or raise, also for a
    unit layout outside ``LAYOUTS``.
    """
    layout = (weights.num_units, tuple(l for l, r in enumerate(weights.recurrent) if r))
    if x.device.type == "cuda" and layout not in LAYOUTS:
        raise ValueError(f"the unrolled kernel is compiled for (units, recurrent units) in "
                         f"{LAYOUTS}, got {layout}")
    return slotted_step("fused_net_loop", fused_firenet_step_loop, x, mem_stack, spk_slots,
                        w_stack, weights, layout=recurrent_slots)


fused_firenet_step_loop.launches = 0


class UnrolledLoopFireNet(LoopFireNet):
    """Runner over ``fused_firenet_step_loop`` (counterpart of
    ``LoopFusedFireNet``): states ``(mem_stack [L, ...], spk_slots [R, ...])``
    in ``state_dtype``."""

    step_fn = staticmethod(fused_firenet_step_loop)
    slot_layout = staticmethod(recurrent_slots)
