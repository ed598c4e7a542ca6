"""The item schedule of K4, K5 and K7 (``csrc/fused_net_item.cuh``) as its
Python mirror in ``evflow_torch.ops.fused_net_item`` states it, on the CPU:
every owned pixel of every (b, tile) item written once per unit, the last
unit's extent the owned tile, the shared memory within a CTA's for every
unit count and recurrent mask and for each of K4's compiled layouts, the
mirror's constants those of the header, ``chip_smoke.issued_flops``'s count
of the three kernels' mma work on the shrinking extent, and the parts that
``probes/wholenet_slope.py --split`` takes out declared and tested in the
header that K7's and K5's sources run."""

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from evflow_torch.ops import fused_net_item as I
from evflow_torch.ops.fused_net import WholeNetArgs, WholeNetWeights
from evflow_torch.ops.fused_net_loop import LAYOUTS
from evflow_torch.probes import wholenet_slope as S

CSRC = Path(I.__file__).resolve().parents[1] / "csrc"
SMEM_LIMIT = 232448  # shared memory of one CTA on an H100
L_MAX = 7


def owned_writes(B, H, W, L):
    """How often the kernel's epilogue writes each (unit, b, h, w) of the
    membranes: for every item, unit l's extent pixels that lie in the image
    and in the item's owned tile (``item_origin``, ``item_extent``)."""
    th, tw = I.ITEM_TILE
    seen = np.zeros((L, B, H, W), np.int32)
    for item in range(I.item_count(B, H, W)):
        b, th0, tw0 = I.item_origin(item, H, W)
        for l in range(L):
            eh, ew, grow = I.item_extent(l, L)
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
    assert I.item_count(B, H, W) == B * -(-H // 16) * -(-W // 16)
    assert (owned_writes(B, H, W, L_MAX) == 1).all()


@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_extents_shrink_to_the_owned_tile(L):
    """Unit l's output extent is the owned 16 x 16 tile grown by L-1-l a
    side: each unit's extent is the next one's input (one pixel a side
    more than its output), and the last unit's is the owned tile."""
    assert I.item_extent(L - 1, L) == (16, 16, 0)
    for l in range(L - 1):
        eh, ew, grow = I.item_extent(l, L)
        nh, nw, ngrow = I.item_extent(l + 1, L)
        assert (eh, ew, grow) == (nh + 2, nw + 2, ngrow + 1)
    assert I.item_extent(0, L)[:2] == (16 + 2 * (L - 1), 16 + 2 * (L - 1))


@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_shared_memory_fits_every_mask(L):
    """The CTA's dynamic shared memory and its ``WholeNetArgs`` copy stay
    within an H100 CTA's 232,448 bytes for every recurrent mask of L units
    (unit 0 feedforward); LIFFireNet's seven units take 228,504 bytes."""
    worst = 0
    for mask in itertools.product((False, True), repeat=L - 1):
        rec = (False,) + mask
        worst = max(worst, I.item_smem(rec))
        assert I.item_smem(rec) + ctypes.sizeof(WholeNetArgs) <= SMEM_LIMIT
    if L == L_MAX:
        assert I.item_smem((False, True, False, False, True, False, False)) == 228_504
        assert worst == 228_504


@pytest.mark.parametrize("units,rec_units", LAYOUTS)
def test_unrolled_layouts_fit_the_card(units, rec_units):
    """Each unit layout that K4 compiles (LIFFireNet, LIFFireNet_short and
    their feedforward variants) takes the item CTA's shared memory within
    an H100 CTA's 232,448 bytes, its ``WholeNetArgs`` copy included."""
    rec = tuple(l in rec_units for l in range(units))
    assert I.item_smem(rec) + ctypes.sizeof(WholeNetArgs) <= SMEM_LIMIT


def test_mirror_constants_match_the_source():
    """The owned tile is the header's ``ITEM_TH`` x ``ITEM_TW``, the row
    padding ``PAD`` that of the conv+LIF header, and the item layout's
    pieces are the ones ``item_smem`` counts."""
    src = (CSRC / "fused_net_item.cuh").read_text()
    th, tw = re.search(r"constexpr int ITEM_TH = (\d+), ITEM_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == I.ITEM_TILE
    pad = re.search(r"constexpr int PAD = (\d+);", (CSRC / "conv_lif_common.cuh").read_text())
    assert int(pad.group(1)) == 8
    layout = re.search(r"inline ItemLayout item_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.tile = extent_h(0, a.L) * extent_w(0, a.L) * SPITCH * 2;",
                  "s.wbuf = s.spk + (any_rec ? s.tile : 0);",
                  "s.prm = s.wbuf + C * (9 * ck_max + PAD) * 2;",
                  "s.bars = s.prm + (a.L * 3 * C + 2 * C + 2) * 4;",
                  "s.total = s.bars + 16;"):
        assert piece in layout


@pytest.mark.parametrize("kernel", sorted(S.KERNELS))
@pytest.mark.parametrize("variant", sorted(set(S.VARIANTS) - {"full"}))
def test_split_variant_has_its_hook(kernel, variant):
    """Each variant of ``wholenet_slope --split`` takes out a part that the
    item header declares (``enum ItemCut``) and tests (``item_keeps``), and
    the kernel's source (K7's, K5's) runs that header, so that its build
    times the kernel without that part; the full build takes out nothing,
    and no declared part lacks a variant."""
    src = (CSRC / S.ITEM_HEADER).read_text()
    declared = re.findall(r"^\s+(ITEM_CUT_\w+),", re.search(r"enum ItemCut \{(.*?)\};", src, re.S)
                          .group(1), re.M)
    cut = S.VARIANTS[variant]
    assert cut in declared and f"item_keeps({cut})" in src
    assert S.VARIANTS["full"] is None and declared[0] == "ITEM_CUT_NONE"
    assert sorted(declared[1:]) == sorted(c for c in S.VARIANTS.values() if c)
    module = S.KERNELS[kernel][0]
    kernel_src = (CSRC / f"{module}.cu").read_text()
    assert f'#include "{S.ITEM_HEADER}"' in kernel_src and "run_item<" in kernel_src
    assert S.missing_hooks(CSRC.parents[1]) == []


def test_split_refuses_a_tree_without_the_hooks(tmp_path):
    """``wholenet_slope --split`` refuses a checkout whose item header lacks
    a part's ``item_keeps`` test (that variant would time the full kernel),
    or whose K7 or K5 source does not include the header (a tree from
    before the shared item body): ``missing_hooks`` names each."""
    csrc = tmp_path / "evflow_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name in ("fused_net_batch.cu", "fused_net_loop2.cu", S.ITEM_HEADER):
        (csrc / name).write_text((CSRC / name).read_text())
    assert S.missing_hooks(tmp_path) == []
    header = (CSRC / S.ITEM_HEADER).read_text()
    (csrc / S.ITEM_HEADER).write_text(header.replace("item_keeps(ITEM_CUT_FLOW)", "true"))
    assert S.missing_hooks(tmp_path) == ["no_pred"]
    (csrc / S.ITEM_HEADER).unlink()
    (csrc / "fused_net_loop2.cu").write_text('#include "fused_net_common.cuh"\n')
    assert S.missing_hooks(tmp_path) == [v for v in S.VARIANTS if v != "full"] + ["K5"]
    with pytest.raises(RuntimeError, match="cannot be split"):
        S.build_variants(tmp_path)


def test_item_kernels_are_gated():
    """Every item kernel instantiation the entry points can launch is in
    ``chip_smoke.REDESIGNED`` under the name ptxas's mangled one gives
    (``cuda_build.kernel_name``): K7's and K5's for both state dtypes, K4's
    for each layout it compiles (``fused_net_loop.LAYOUTS``: units and the
    recurrent-unit mask) and both state dtypes; phase ``build`` fails on a
    missing one."""
    import chip_smoke
    from evflow_torch.ops.cuda_build import kernel_name

    text = (CSRC / "fused_net_loop.cu").read_text()
    launched = re.findall(r"if \(a\.L == (\d) && rec == (0x[0-9A-F]+u|0u)\) return "
                          r"go\(fused_net_loop_kernel<(\d), \2, S>\)", text)
    layouts = [(int(n), int(m.rstrip("u"), 16)) for n, m, _ in launched]
    assert layouts == [(units, sum(1 << l for l in rec)) for units, rec in LAYOUTS]
    states = (("f", "float"), ("13__nv_bfloat16", "__nv_bfloat16"))
    mangled = [f"_ZN6evflow8wholenet21fused_net_loop_kernelILi{n}ELj{m}E{t}EEvNS0_12WholeNetArgsE"
               for n, m in layouts for t, _ in states]
    assert chip_smoke.REDESIGNED["fused_net_loop"] == tuple(kernel_name(x) for x in mangled)
    for source in ("fused_net_batch", "fused_net_loop2"):
        assert chip_smoke.REDESIGNED[source] == tuple(
            f"{source}_kernel<{name}>" for _, name in states)


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
    """K4, K5 and K7 run the same item body: each unit's own extent in
    16-pixel fragments (3,536 pixels an item of 16 x 16 at L=7: 39.94 GFLOP
    a window at B=2, 256x256, where K4 and K5 issued 92.4 on the uniform
    extent of 8 x 16 tiles before they took the item body)."""
    import chip_smoke

    net = runner_of("FTFFTFF")
    per_item = [-(-(I.item_extent(l, 7)[0] * I.item_extent(l, 7)[1]) // 16) * 16
                for l in range(7)]
    assert per_item == [784, 688, 576, 496, 400, 336, 256] and sum(per_item) == 3536
    ck = [16, 64, 32, 32, 64, 32, 32]
    items = I.item_count(2, 256, 256)
    expected = sum(2 * p * items * 32 * 9 * k for p, k in zip(per_item, ck))
    assert expected == 39_938_162_688
    for kname in ("fused_firenet_step_batch", "fused_firenet_step_loop2",
                  "fused_firenet_step_loop"):
        assert chip_smoke.issued_flops(kname, net, 2) == expected, kname
        assert chip_smoke.issued_flops(kname, net, 8) == 4 * expected, kname
