"""The whole FireNet step in one launch, a runtime loop over units (port of
``benchmarks/pallas_archive/fused_net_loop2.py``, K5).

The same function as ``evflow_torch.ops.fused_net`` over the layout of
``LoopFusedFireNet2`` without its row padding: membranes ``[L, B, C, H, W]``
and three spike slots ``[3, B, C, H, W]``: slots 0 and 1 hold the recurrent
units' spikes, slot 2 the spikes of the last feedforward unit (the TPU
kernel writes every feedforward unit there in turn). Slot 2 is never read.
The CUDA kernel (``evflow_torch/csrc/fused_net_loop2.cu``) runs one conv+LIF
body in a runtime loop over the stacked weights; CPU tensors run
``firenet_step_plain``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from evflow_torch.ops.fused_net import (WholeNetFireNet, check_device, firenet_step_plain,
                                        launch_wholenet, stack_weights, unit_weights)

__all__ = ["fused_firenet_step_loop2", "LoopFireNet", "slot_units"]

N_SLOTS = 3


def slot_units(recurrent) -> List[Optional[int]]:
    """The unit whose spikes each slot holds: the recurrent units in order
    (at most two), then the last feedforward unit."""
    rec = [l for l, r in enumerate(recurrent) if r]
    ff = [l for l, r in enumerate(recurrent) if not r]
    if len(rec) > 2:
        raise ValueError(f"the slot layout holds two recurrent units, got {len(rec)}")
    return rec + [None] * (2 - len(rec)) + [ff[-1]]


def slotted_step(entry: str, fn, x, mem_stack, spk_slots, w_stack, weights):
    """One window over the slot layout: the plain version on the CPU, the
    ``entry`` kernel on CUDA."""
    cuda = check_device(x, entry)
    units = slot_units(weights.recurrent)
    prevs: List[Optional[torch.Tensor]] = [None] * weights.num_units
    for s, l in enumerate(units[:2]):
        if l is not None:
            prevs[l] = spk_slots[s]
    if not cuda:
        flow, mems, spikes = firenet_step_plain(x, list(mem_stack), prevs, weights)
        slots = torch.stack([torch.zeros_like(mems[0]) if l is None else spikes[l]
                             for l in units])
        return flow, torch.stack(mems), slots
    mem_out = torch.empty_like(mem_stack)
    slots = torch.empty((N_SLOTS,) + tuple(mem_stack.shape[1:]), device=mem_stack.device,
                        dtype=mem_stack.dtype)
    spk_outs: List[Optional[torch.Tensor]] = [None] * weights.num_units
    for s, l in enumerate(units):
        if l is None:
            slots[s].zero_()
        else:
            spk_outs[l] = slots[s]
    flow = launch_wholenet(entry, x.float().contiguous(), list(mem_stack), prevs,
                           unit_weights(w_stack, weights), weights, list(mem_out), spk_outs)
    fn.launches += 1
    return flow, mem_out, slots


def fused_firenet_step_loop2(x: torch.Tensor, mem_stack: torch.Tensor, spk_slots: torch.Tensor,
                             w_stack: torch.Tensor, weights):
    """One window (K5 schedule).

    Args:
      x: ``[B, H, W, Cin]`` window.
      mem_stack: ``[L, B, C, H, W]`` membranes (f32 or bf16 state).
      spk_slots: ``[3, B, C, H, W]`` spikes (``slot_units``).
      w_stack: ``stack_weights(weights)``.
    Returns:
      ``(flow [B, H, W, 2], mem_stack', spk_slots')``.

    CPU tensors run ``firenet_step_plain``; CUDA tensors launch the kernel
    (counted in ``fused_firenet_step_loop2.launches``) or raise.
    """
    return slotted_step("fused_net_loop2", fused_firenet_step_loop2, x, mem_stack, spk_slots,
                        w_stack, weights)


fused_firenet_step_loop2.launches = 0


class LoopFireNet(WholeNetFireNet):
    """Runner over ``fused_firenet_step_loop2`` (counterpart of
    ``LoopFusedFireNet2``): states ``(mem_stack [L, ...], spk_slots [3, ...])``
    in ``state_dtype``."""

    step_fn = staticmethod(fused_firenet_step_loop2)

    def __init__(self, fused, state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(fused, state_dtype)
        self.w_stack = stack_weights(self.weights)
        self.slots = slot_units(self.weights.recurrent)

    def init_states(self, batch: int, height: int, width: int):
        return (self.zeros(self.num_units, batch=batch, height=height, width=width),
                self.zeros(N_SLOTS, batch=batch, height=height, width=width))

    def unit_states(self, states):
        mems, slots = states
        spikes: List[Optional[torch.Tensor]] = [None] * self.num_units
        for s, l in enumerate(self.slots):
            if l is not None:
                spikes[l] = slots[s]
        return list(mems), spikes

    @torch.no_grad()
    def step(self, x: torch.Tensor, states):
        flow, mems, slots = self.step_fn(x, *states, self.w_stack, self.weights)
        return flow, (mems, slots)
