"""The whole FireNet step in one launch, persistent CTAs over (b, tile)
items (port of ``benchmarks/pallas_archive/fused_net_batch.py``, K7).

The same function and state layout as ``evflow_torch.ops.fused_net_loop2``
(``BatchFusedFireNet`` shares ``LoopFusedFireNet2``'s layout). The CUDA
kernel (``evflow_torch/csrc/fused_net_batch.cu``) launches one CTA per SM,
each walking (b, tile) items and running the unit loop inside; CPU tensors
run ``firenet_step_plain``.

Its schedule, mirrored here for the tests: an item is a 16 x 16 tile of one
batch element (``batch_items``, ``batch_item``); unit l of L computes the
tile grown by L-1-l pixels a side (``batch_extent``), so the last unit's
extent is the owned tile; the CTA's shared memory is ``batch_smem``.
"""

from __future__ import annotations

import torch

from evflow_torch.ops.fused_net_loop2 import LoopFireNet, slotted_step

__all__ = ["fused_firenet_step_batch", "BatchFireNet", "BATCH_TILE", "batch_items",
           "batch_item", "batch_extent", "batch_smem"]

BATCH_TILE = (16, 16)  # the owned tile of an item (csrc/fused_net_batch.cu: K7_TH, K7_TW)
_C, _PAD = 32, 8      # channels of every unit; bf16 padding of a staged row
_SPITCH = _C + _PAD   # bf16 per pixel of a staged spike tile


def batch_items(batch: int, height: int, width: int) -> int:
    """(b, tile) items of a K7 launch: B x ceil(H/16) x ceil(W/16)."""
    th, tw = BATCH_TILE
    return batch * -(-height // th) * -(-width // tw)


def batch_item(item: int, height: int, width: int):
    """``(b, th0, tw0)``: the batch element and the image position of the
    owned tile of K7's item ``item``."""
    th, tw = BATCH_TILE
    ntw, nth = -(-width // tw), -(-height // th)
    b, t = divmod(item, nth * ntw)
    return b, (t // ntw) * th, (t % ntw) * tw


def batch_extent(l: int, L: int):
    """``(height, width, grow)`` of unit ``l``'s output extent in a net of
    ``L`` units: the owned tile grown by ``grow = L-1-l`` pixels a side."""
    grow = L - 1 - l
    return BATCH_TILE[0] + 2 * grow, BATCH_TILE[1] + 2 * grow, grow


def batch_smem(recurrent) -> int:
    """Dynamic shared memory of a K7 CTA for units of ``recurrent`` flags
    (``csrc/fused_net_batch.cu::k7_layout``): two spike tiles of unit 0's
    extent (the second holds the event input first), a third for the
    previous spikes where a unit is recurrent, the weight buffer of the
    widest unit (packed input channels 16, 32 or 64), the ``[L, 3, C]``
    parameters, pred_w ``[C, 2]`` and pred_b ``[2]``, the weights' mbarrier
    and a count of warps."""
    L = len(recurrent)
    eh, ew, _ = batch_extent(0, L)
    tile = eh * ew * _SPITCH * 2
    ck_max = max(16 if l == 0 else (2 * _C if r else _C) for l, r in enumerate(recurrent))
    return (tile * (3 if any(recurrent) else 2) + _C * (9 * ck_max + _PAD) * 2
            + (L * 3 * _C + 2 * _C + 2) * 4 + 16)


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
