"""The whole FireNet step in one launch, layer as the outer axis (port of
``benchmarks/pallas_archive/fused_net_lgrid.py``, K6).

The same function as ``evflow_torch.ops.fused_net`` over stacked states:
membranes ``[L, B, C, H, W]`` and every unit's spikes ``[L, B, C, H, W]``
(only the recurrent units' slices are read next window), the layout of
``LayerGridFusedFireNet`` without its row padding. The CUDA kernel
(``evflow_torch/csrc/fused_net_lgrid.cu``) is one cooperative launch that
runs unit l over the whole image in 16 x 16 tiles with no halo recompute
(the item body's pieces, ``evflow_torch.ops.fused_net_item``), waits at a
grid barrier, then runs unit l+1; CPU tensors run ``firenet_step_plain``.
"""

from __future__ import annotations

import torch

from evflow_torch.ops.fused_net import (WholeNetFireNet, check_device, firenet_step_plain,
                                        launch_wholenet, stack_weights, unit_weights)

__all__ = ["fused_firenet_step_lgrid", "LayerGridFireNet"]


def fused_firenet_step_lgrid(x: torch.Tensor, mem_stack: torch.Tensor, spk_stack: torch.Tensor,
                             w_stack: torch.Tensor, weights):
    """One window (K6 schedule).

    Args:
      x: ``[B, H, W, Cin]`` window.
      mem_stack, spk_stack: ``[L, B, C, H, W]`` membranes and last window's
        spikes of every unit (f32 or bf16 state).
      w_stack: ``stack_weights(weights)``.
    Returns:
      ``(flow [B, H, W, 2], mem_stack', spk_stack')``.

    CPU tensors run ``firenet_step_plain``; CUDA tensors launch the kernel
    (counted in ``fused_firenet_step_lgrid.launches``) or raise.
    """
    cuda = check_device(x, "fused_firenet_step_lgrid")
    prevs = [spk_stack[l] if r else None for l, r in enumerate(weights.recurrent)]
    if not cuda:
        flow, mems, spikes = firenet_step_plain(x, list(mem_stack), prevs, weights)
        return flow, torch.stack(mems), torch.stack(spikes)
    mem_out = torch.empty_like(mem_stack)
    spk_out = torch.empty_like(mem_stack)
    flow = launch_wholenet("fused_net_lgrid", x.float().contiguous(), list(mem_stack), prevs,
                           unit_weights(w_stack, weights), weights, list(mem_out),
                           list(spk_out))
    fused_firenet_step_lgrid.launches += 1
    return flow, mem_out, spk_out


fused_firenet_step_lgrid.launches = 0


class LayerGridFireNet(WholeNetFireNet):
    """Runner over ``fused_firenet_step_lgrid`` (counterpart of
    ``LayerGridFusedFireNet``): states ``(mem_stack, spk_stack)``, both
    ``[L, B, C, H, W]`` in ``state_dtype``."""

    def __init__(self, fused, state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(fused, state_dtype)
        self.w_stack = stack_weights(self.weights)

    def init_states(self, batch: int, height: int, width: int):
        z = self.zeros(self.num_units, batch=batch, height=height, width=width)
        return z, torch.zeros_like(z)

    def unit_states(self, states):
        mems, spks = states
        return list(mems), list(spks)

    @torch.no_grad()
    def step(self, x: torch.Tensor, states):
        flow, mems, spks = fused_firenet_step_lgrid(x, *states, self.w_stack, self.weights)
        return flow, (mems, spks)
