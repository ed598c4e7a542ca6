"""K7's schedule (``csrc/fused_net_batch.cu``) as its Python mirror in
``evflow_torch.ops.fused_net_batch`` states it, on the CPU: every owned
pixel of every (b, tile) item written once per unit, the last unit's
extent the owned tile, the shared memory within a CTA's for every unit
count and recurrent mask, the mirror's constants those of the source, and
``chip_smoke.issued_flops``'s count of K7's mma work on the shrinking
extent beside K5's on the uniform one, and the parts that
``probes/wholenet_slope.py --split`` takes out declared and tested in the
source."""

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from evflow_torch.ops import fused_net_batch as K7
from evflow_torch.ops.fused_net import WholeNetArgs, WholeNetWeights
from evflow_torch.probes import wholenet_slope as S

CSRC = Path(K7.__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232448  # shared memory of one CTA on an H100
L_MAX = 7


def owned_writes(B, H, W, L):
    """How often the kernel's epilogue writes each (unit, b, h, w) of the
    membranes: for every item, unit l's extent pixels that lie in the image
    and in the item's owned tile (``batch_item``, ``batch_extent``)."""
    th, tw = K7.BATCH_TILE
    seen = np.zeros((L, B, H, W), np.int32)
    for item in range(K7.batch_items(B, H, W)):
        b, th0, tw0 = K7.batch_item(item, H, W)
        for l in range(L):
            eh, ew, grow = K7.batch_extent(l, L)
            h0, w0 = th0 - grow, tw0 - grow
            rows = range(max(h0, th0, 0), min(h0 + eh, th0 + th, H))
            cols = range(max(w0, tw0, 0), min(w0 + ew, tw0 + tw, W))
            seen[l, b, rows.start:rows.stop, cols.start:cols.stop] += 1
    return seen


@pytest.mark.parametrize("W", [256, 40, 17])
@pytest.mark.parametrize("H", [256, 40, 17])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_every_owned_pixel_is_written_once(B, H, W):
    """Each unit's extent holds its item's owned tile, and the owned tiles
    of the B x ceil(H/16) x ceil(W/16) items cover the image once: every
    membrane and kept spike of every unit is written exactly once."""
    assert K7.batch_items(B, H, W) == B * -(-H // 16) * -(-W // 16)
    assert (owned_writes(B, H, W, L_MAX) == 1).all()


@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_extents_shrink_to_the_owned_tile(L):
    """Unit l's output extent is the owned 16 x 16 tile grown by L-1-l a
    side: each unit's extent is the next one's input (one pixel a side
    more than its output), and the last unit's is the owned tile."""
    assert K7.batch_extent(L - 1, L) == (16, 16, 0)
    for l in range(L - 1):
        eh, ew, grow = K7.batch_extent(l, L)
        nh, nw, ngrow = K7.batch_extent(l + 1, L)
        assert (eh, ew, grow) == (nh + 2, nw + 2, ngrow + 1)
    assert K7.batch_extent(0, L)[:2] == (16 + 2 * (L - 1), 16 + 2 * (L - 1))


@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_shared_memory_fits_every_mask(L):
    """The CTA's dynamic shared memory and its ``WholeNetArgs`` copy stay
    within an H100 CTA's 232,448 bytes for every recurrent mask of L units
    (unit 0 feedforward); LIFFireNet's seven units take 228,504 bytes."""
    worst = 0
    for mask in itertools.product((False, True), repeat=L - 1):
        rec = (False,) + mask
        worst = max(worst, K7.batch_smem(rec))
        assert K7.batch_smem(rec) + ctypes.sizeof(WholeNetArgs) <= SMEM_LIMIT
    if L == L_MAX:
        assert K7.batch_smem((False, True, False, False, True, False, False)) == 228_504
        assert worst == 228_504


def test_mirror_constants_match_the_source():
    """The owned tile is the source's ``K7_TH`` x ``K7_TW``, the row
    padding ``PAD`` that of the conv+LIF header, and the K7 layout's pieces
    are the ones ``batch_smem`` counts."""
    src = (CSRC / "fused_net_batch.cu").read_text()
    th, tw = re.search(r"constexpr int K7_TH = (\d+), K7_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == K7.BATCH_TILE
    pad = re.search(r"constexpr int PAD = (\d+);", (CSRC / "conv_lif_common.cuh").read_text())
    assert int(pad.group(1)) == 8
    layout = re.search(r"inline K7Layout k7_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.tile = extent_h(0, a.L) * extent_w(0, a.L) * SPITCH * 2;",
                  "s.wbuf = s.spk + (any_rec ? s.tile : 0);",
                  "s.prm = s.wbuf + C * (9 * ck_max + PAD) * 2;",
                  "s.bars = s.prm + (a.L * 3 * C + 2 * C + 2) * 4;",
                  "s.total = s.bars + 16;"):
        assert piece in layout


@pytest.mark.parametrize("variant", sorted(set(S.VARIANTS) - {"full"}))
def test_split_variant_has_its_hook(variant):
    """Each variant of ``wholenet_slope --split`` takes out a part that the
    K7 source declares (``enum K7Cut``) and tests (``k7_keeps``), so that
    its build times a kernel without that part; the full build takes out
    nothing, and no declared part lacks a variant."""
    src = (CSRC / "fused_net_batch.cu").read_text()
    declared = re.findall(r"^\s+(K7_CUT_\w+),", re.search(r"enum K7Cut \{(.*?)\};", src, re.S)
                          .group(1), re.M)
    cut = S.VARIANTS[variant]
    assert cut in declared and f"k7_keeps({cut})" in src
    assert S.VARIANTS["full"] is None and declared[0] == "K7_CUT_NONE"
    assert sorted(declared[1:]) == sorted(c for c in S.VARIANTS.values() if c)
    assert S.missing_hooks(CSRC.parents[1]) == []


def runner_of(mask):
    """A runner-like object over random units of ``mask`` (what
    ``chip_smoke.issued_flops`` reads: the weights)."""
    rec = tuple(m == "T" for m in mask)
    wk = tuple(torch.zeros(32, 9 * (16 if l == 0 else (64 if r else 32)), dtype=torch.bfloat16)
               for l, r in enumerate(rec))
    weights = WholeNetWeights(recurrent=rec, wk=wk, params=torch.zeros(len(rec), 3, 32),
                              pred_w=torch.zeros(32, 2), pred_b=torch.zeros(2), hard_reset=True)
    return type("Runner", (), {"weights": weights})()


def test_issued_flops_counts_the_shrinking_extent():
    """K7 issues each unit's own extent in 16-pixel fragments (3,536 pixels
    an item of 16 x 16 at L=7: 39.94 GFLOP a window at B=2, 256x256), K5
    (and K4) the uniform 20 x 28 extent of 8 x 16 tiles in 32-pixel pairs
    at every unit (4,032 an item: 92.4 GFLOP), as before."""
    import chip_smoke

    net = runner_of("FTFFTFF")
    per_item = [-(-(K7.batch_extent(l, 7)[0] * K7.batch_extent(l, 7)[1]) // 16) * 16
                for l in range(7)]
    assert per_item == [784, 688, 576, 496, 400, 336, 256] and sum(per_item) == 3536
    ck = [16, 64, 32, 32, 64, 32, 32]
    items = K7.batch_items(2, 256, 256)
    k7 = chip_smoke.issued_flops("fused_firenet_step_batch", net, 2)
    assert k7 == sum(2 * p * items * 32 * 9 * k for p, k in zip(per_item, ck)) == 39_938_162_688
    uniform = 2 * 576 * 2 * 32 * 16 * 32 * 9 * sum(ck)  # 8 x 16 tiles: 2 x 32 x 16 items
    for kname in ("fused_firenet_step_loop2", "fused_firenet_step_loop"):
        assert chip_smoke.issued_flops(kname, net, 2) == uniform
    assert chip_smoke.issued_flops("fused_firenet_step_loop2", net, 2) == 92_408_905_728
    assert chip_smoke.issued_flops("fused_firenet_step_batch", net, 8) == 4 * k7
