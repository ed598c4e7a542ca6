"""The whole FireNet step in one launch, persistent CTAs over (b, tile)
items (port of ``benchmarks/pallas_archive/fused_net_batch.py``, K7).

The same function and state layout as ``evflow_torch.ops.fused_net_loop2``
(``BatchFusedFireNet`` shares ``LoopFusedFireNet2``'s layout). The CUDA
kernel (``evflow_torch/csrc/fused_net_batch.cu``) launches one CTA per SM,
each walking (b, tile) items and running the unit loop inside; CPU tensors
run ``firenet_step_plain``.
"""

from __future__ import annotations

import torch

from evflow_torch.ops.fused_net_loop2 import LoopFireNet, slotted_step

__all__ = ["fused_firenet_step_batch", "BatchFireNet"]


def fused_firenet_step_batch(x: torch.Tensor, mem_stack: torch.Tensor, spk_slots: torch.Tensor,
                             w_stack: torch.Tensor, weights):
    """One window (K7 schedule); arguments and results as
    ``fused_firenet_step_loop2``. CPU tensors run ``firenet_step_plain``;
    CUDA tensors launch the kernel (counted in
    ``fused_firenet_step_batch.launches``) or raise."""
    return slotted_step("fused_net_batch", fused_firenet_step_batch, x, mem_stack, spk_slots,
                        w_stack, weights)


fused_firenet_step_batch.launches = 0


class BatchFireNet(LoopFireNet):
    """Runner over ``fused_firenet_step_batch`` (counterpart of
    ``BatchFusedFireNet``), with ``LoopFireNet``'s states."""

    step_fn = staticmethod(fused_firenet_step_batch)
