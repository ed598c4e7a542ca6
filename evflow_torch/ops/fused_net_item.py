"""The item geometry of K3, K4, K5 and K7 (``csrc/fused_net_item.cuh``) and
of K6's tiles (``csrc/fused_net_lgrid.cu``), mirrored for the tests and for
``chip_smoke.issued_flops``.

An item is a 16 x 16 tile of one batch element (``item_count``,
``item_origin``); unit l of L computes the tile grown by L-1-l pixels a side
(``item_extent``), so the last unit's extent is the owned tile; a CTA that
runs items takes ``item_smem`` bytes of dynamic shared memory. K7
(``ops/fused_net_batch.py``) walks the items in persistent CTAs, K5
(``ops/fused_net_loop2.py``), K4 (``ops/fused_net_loop.py``) and K3
(``ops/fused_net.py``) launch a CTA an item. K6 (``ops/fused_net_lgrid.py``)
runs a unit at a time over the same tiles with no halo (grow 0), in CTAs of
``lgrid_smem`` bytes, two an SM.
"""

from __future__ import annotations

__all__ = ["ITEM_TILE", "item_count", "item_origin", "item_extent", "item_smem",
           "lgrid_smem"]

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


def _after_tiles(tiles: int, recurrent, head: int) -> int:
    """The weight buffer of the widest unit (packed input channels 16 or 32
    for the head, 32, 64 recurrent), the ``[L, 3, C]`` parameters, pred_w
    ``[C, 2]`` and pred_b ``[2]``, the weights' mbarrier and a count of
    warps, after ``tiles`` bytes (``place_after_tiles``)."""
    L = len(recurrent)
    ck_max = max(head if l == 0 else (2 * _C if r else _C) for l, r in enumerate(recurrent))
    return tiles + _C * (9 * ck_max + _PAD) * 2 + (L * 3 * _C + 2 * _C + 2) * 4 + 16


def item_smem(recurrent, head: int = 16) -> int:
    """Dynamic shared memory of an item CTA for units of ``recurrent`` flags
    and a head of ``head`` packed input channels (16 or 32;
    ``csrc/fused_net_item.cuh::item_layout``): two spike tiles of unit 0's
    extent (the second holds the event input first), a third for the
    previous spikes where a unit is recurrent, or, if larger, the first
    tile and the event tile (unit 0's extent and a pixel a side at
    ``head`` + 8 bf16 a pixel, which runs past the second tile into the
    third), then ``_after_tiles``."""
    eh, ew, _ = item_extent(0, len(recurrent))
    tile = eh * ew * _SPITCH * 2
    events = (eh + 2) * (ew + 2) * (head + _PAD) * 2
    return _after_tiles(max(tile * (3 if any(recurrent) else 2), tile + events), recurrent, head)


def lgrid_smem(recurrent, head: int = 16) -> int:
    """Dynamic shared memory of a K6 CTA (``csrc/fused_net_lgrid.cu::
    lgrid_layout``): the 18 x 18 input tile, the last unit's 16 x 16 spike
    tile, an 18 x 18 tile of previous spikes where a unit is recurrent,
    then ``_after_tiles``."""
    th, tw = ITEM_TILE
    halo = (th + 2) * (tw + 2) * _SPITCH * 2
    return _after_tiles(halo * (2 if any(recurrent) else 1) + th * tw * _SPITCH * 2, recurrent,
                        head)
