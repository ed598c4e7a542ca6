"""The item geometry of K4, K5 and K7 (``csrc/fused_net_item.cuh``), mirrored
for the tests and for ``chip_smoke.issued_flops``.

An item is a 16 x 16 tile of one batch element (``item_count``,
``item_origin``); unit l of L computes the tile grown by L-1-l pixels a side
(``item_extent``), so the last unit's extent is the owned tile; a CTA that
runs items takes ``item_smem`` bytes of dynamic shared memory. K7
(``ops/fused_net_batch.py``) walks the items in persistent CTAs, K5
(``ops/fused_net_loop2.py``) and K4 (``ops/fused_net_loop.py``) launch a CTA
an item.
"""

from __future__ import annotations

__all__ = ["ITEM_TILE", "item_count", "item_origin", "item_extent", "item_smem"]

ITEM_TILE = (16, 16)  # the owned tile of an item (csrc/fused_net_item.cuh: ITEM_TH, ITEM_TW)
_C, _PAD = 32, 8      # channels of every unit; bf16 padding of a staged row
_SPITCH = _C + _PAD   # bf16 per pixel of a staged spike tile


def item_count(batch: int, height: int, width: int) -> int:
    """(b, tile) items of a launch: B x ceil(H/16) x ceil(W/16)."""
    th, tw = ITEM_TILE
    return batch * -(-height // th) * -(-width // tw)


def item_origin(item: int, height: int, width: int):
    """``(b, th0, tw0)``: the batch element and the image position of the
    owned tile of item ``item``."""
    th, tw = ITEM_TILE
    ntw, nth = -(-width // tw), -(-height // th)
    b, t = divmod(item, nth * ntw)
    return b, (t // ntw) * th, (t % ntw) * tw


def item_extent(l: int, L: int):
    """``(height, width, grow)`` of unit ``l``'s output extent in a net of
    ``L`` units: the owned tile grown by ``grow = L-1-l`` pixels a side."""
    grow = L - 1 - l
    return ITEM_TILE[0] + 2 * grow, ITEM_TILE[1] + 2 * grow, grow


def item_smem(recurrent) -> int:
    """Dynamic shared memory of an item CTA for units of ``recurrent`` flags
    (``csrc/fused_net_item.cuh::item_layout``): two spike tiles of unit 0's
    extent (the second holds the event input first), a third for the
    previous spikes where a unit is recurrent, the weight buffer of the
    widest unit (packed input channels 16, 32 or 64), the ``[L, 3, C]``
    parameters, pred_w ``[C, 2]`` and pred_b ``[2]``, the weights' mbarrier
    and a count of warps."""
    L = len(recurrent)
    eh, ew, _ = item_extent(0, L)
    tile = eh * ew * _SPITCH * 2
    ck_max = max(16 if l == 0 else (2 * _C if r else _C) for l, r in enumerate(recurrent))
    return (tile * (3 if any(recurrent) else 2) + _C * (9 * ck_max + _PAD) * 2
            + (L * 3 * _C + 2 * _C + 2) * 4 + 16)
