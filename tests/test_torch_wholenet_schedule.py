"""The item schedule of K3, K4, K5 and K7 (``csrc/fused_net_item.cuh``) and
K6's tiles (``csrc/fused_net_lgrid.cu``) as their Python mirror in
``evflow_torch.ops.fused_net_item`` states them, on the CPU: every owned
pixel of every (b, tile) item written once per unit, the last unit's extent
the owned tile, the shared memory within a CTA's for every unit count,
recurrent mask and head width (16 or 32 packed channels) and for each of
K4's compiled layouts, two K6 CTAs within an SM's, the mirror's constants
those of the sources, ``chip_smoke.issued_flops``'s count of the kernels'
mma work (the shrinking extent; K6's tiles without a halo), and the parts
that ``probes/wholenet_slope.py --split`` takes out declared and tested in
the header (K6's own in its source) that the four split kernels run."""

import contextlib
import ctypes
import itertools
import re
import shutil
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
SM_SMEM, CTA_RESERVED = 233472, 1024  # an H100 SM's shared memory; the runtime's share a CTA
L_MAX = 7
LIFFIRENET = (False, True, False, False, True, False, False)


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
        assert I.item_smem(LIFFIRENET) == 228_504
        assert worst == 228_504


@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_shared_memory_fits_a_32_channel_head(L):
    """With a head of 32 packed channels (Cin 17..32) the event tile (unit
    0's extent and a pixel a side, 40 bf16 a pixel) outgrows spike tile B
    and runs into tile P: every recurrent mask and the feedforward net of L
    units still fit an H100 CTA's 232,448 bytes with the ``WholeNetArgs``
    copy, LIFFireNet's at the 228,504 bytes of its 16-channel head, the
    seven feedforward units at 156,632."""
    eh, ew, _ = I.item_extent(0, L)
    tile, events = eh * ew * 40 * 2, (eh + 2) * (ew + 2) * 40 * 2
    assert events > tile  # the event tile outgrows tile B
    for mask in itertools.product((False, True), repeat=L - 1):
        rec = (False,) + mask
        smem = I.item_smem(rec, head=32)
        assert I.item_smem(rec) <= smem
        assert smem + ctypes.sizeof(WholeNetArgs) <= SMEM_LIMIT
        assert tile + events <= smem  # tile A, then the event tile
    if L == L_MAX:
        assert I.item_smem(LIFFIRENET, head=32) == 228_504
        assert I.item_smem((False,) * L, head=32) == 156_632


@pytest.mark.parametrize("head", [16, 32])
@pytest.mark.parametrize("L", range(1, L_MAX + 1))
def test_two_lgrid_ctas_share_an_sm(L, head):
    """K6's CTA (an 18 x 18 input tile, the last unit's 16 x 16 spike tile,
    an 18 x 18 previous-spike tile in a recurrent net, the weights of the
    widest unit) takes at most 112,664 bytes, so that two CTAs, each with
    its ``WholeNetArgs`` copy and the runtime's 1 KB, share an H100 SM's
    233,472 bytes for every recurrent mask and head width."""
    for mask in itertools.product((False, True), repeat=L - 1):
        smem = I.lgrid_smem((False,) + mask, head)
        assert smem <= 112_664
        assert 2 * (smem + ctypes.sizeof(WholeNetArgs) + CTA_RESERVED) <= SM_SMEM
    assert I.lgrid_smem(LIFFIRENET) == 112_664


@pytest.mark.parametrize("units,rec_units", LAYOUTS)
def test_unrolled_layouts_fit_the_card(units, rec_units):
    """Each unit layout that K4 compiles (LIFFireNet, LIFFireNet_short and
    their feedforward variants) takes the item CTA's shared memory within
    an H100 CTA's 232,448 bytes, its ``WholeNetArgs`` copy included."""
    rec = tuple(l in rec_units for l in range(units))
    assert I.item_smem(rec) + ctypes.sizeof(WholeNetArgs) <= SMEM_LIMIT


def test_mirror_constants_match_the_source():
    """The owned tile is the header's ``ITEM_TH`` x ``ITEM_TW``, the row
    padding ``PAD`` that of the conv+LIF header, and the item layout's and
    K6's layout's pieces are the ones ``item_smem`` and ``lgrid_smem``
    count."""
    src = (CSRC / "fused_net_item.cuh").read_text()
    th, tw = re.search(r"constexpr int ITEM_TH = (\d+), ITEM_TW = (\d+);", src).groups()
    assert (int(th), int(tw)) == I.ITEM_TILE
    pad = re.search(r"constexpr int PAD = (\d+);", (CSRC / "conv_lif_common.cuh").read_text())
    assert int(pad.group(1)) == 8
    layout = re.search(r"inline ItemLayout item_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.tile = extent_h(0, a.L) * extent_w(0, a.L) * SPITCH * 2;",
                  "s.spk = 2 * s.tile;",
                  "(extent_h(0, a.L) + 2) * (extent_w(0, a.L) + 2) * (a.ck[0] + PAD) * 2;",
                  "const int tiles = s.spk + (any_recurrent(a) ? s.tile : 0);",
                  "place_after_tiles(a, tiles > s.tile + events ? tiles : s.tile + events, s);"):
        assert piece in layout
    after = re.search(r"inline void place_after_tiles\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.wbuf = tiles;",
                  "s.prm = s.wbuf + C * (9 * ck_max + PAD) * 2;",
                  "s.bars = s.prm + (a.L * 3 * C + 2 * C + 2) * 4;",
                  "s.total = s.bars + 16;"):
        assert piece in after
    lgrid = (CSRC / "fused_net_lgrid.cu").read_text()
    assert "constexpr int LG_IN = ITEM_TH + 2;" in lgrid
    layout = re.search(r"inline ItemLayout lgrid_layout\(.*?\n\}", lgrid, re.S).group(0)
    for piece in ("s.tile = LG_IN * LG_IN * SPITCH * 2;",
                  "s.spk = s.tile + ITEM_TH * ITEM_TW * SPITCH * 2;",
                  "place_after_tiles(a, s.spk + (any_recurrent(a) ? s.tile : 0), s);"):
        assert piece in layout


@pytest.mark.parametrize("kernel,variant", [
    (k, v) for k in sorted(S.KERNELS) for v in sorted(set(S.variants_of(k)) - {"full"})])
def test_split_variant_has_its_hook(kernel, variant):
    """Each variant of ``wholenet_slope --split`` takes out a part that the
    item header declares (``enum ItemCut``) and tests (``item_keeps``; K6's
    own parts in its source), and the kernel's source (K7's, K5's, K3's,
    K6's) runs that header, so that its build times the kernel without that
    part; the full build takes out nothing, and no declared part lacks a
    variant."""
    src = (CSRC / S.ITEM_HEADER).read_text()
    declared = re.findall(r"^\s+(ITEM_CUT_\w+),", re.search(r"enum ItemCut \{(.*?)\};", src, re.S)
                          .group(1), re.M)
    module = S.KERNELS[kernel][0]
    kernel_src = (CSRC / f"{module}.cu").read_text()
    cut = S.variants_of(kernel)[variant]
    assert cut in declared
    assert f"item_keeps({cut})" in (src if variant in S.VARIANTS else kernel_src)
    assert S.VARIANTS["full"] is None and declared[0] == "ITEM_CUT_NONE"
    assert sorted(declared[1:]) == sorted(
        c for c in {**S.VARIANTS, **S.OWN_VARIANTS}.values() if c)
    assert f'#include "{S.ITEM_HEADER}"' in kernel_src
    assert "run_item<" in kernel_src or "conv_lif_unit<" in kernel_src
    assert S.missing_hooks(CSRC.parents[1]) == []


def test_split_refuses_a_tree_without_the_hooks(tmp_path):
    """``wholenet_slope --split`` refuses a checkout whose item header lacks
    a part's ``item_keeps`` test (that variant would time the full kernel),
    or whose K7 or K5 source does not include the header (a tree from
    before the shared item body): ``missing_hooks`` names each."""
    csrc = tmp_path / "evflow_torch" / "csrc"
    csrc.mkdir(parents=True)
    sources = [f"{module}.cu" for module, _, _ in S.KERNELS.values()]
    for name in sources + [S.ITEM_HEADER]:
        (csrc / name).write_text((CSRC / name).read_text())
    assert S.missing_hooks(tmp_path) == []
    header = (CSRC / S.ITEM_HEADER).read_text()
    (csrc / S.ITEM_HEADER).write_text(header.replace("item_keeps(ITEM_CUT_FLOW)", "true"))
    assert S.missing_hooks(tmp_path) == ["no_pred"]
    lgrid = (CSRC / "fused_net_lgrid.cu").read_text()
    (csrc / "fused_net_lgrid.cu").write_text(
        lgrid.replace("item_keeps(ITEM_CUT_GRID_BARRIER)", "true"))
    assert S.missing_hooks(tmp_path) == ["no_pred", "K6/no_grid_barrier"]
    (csrc / S.ITEM_HEADER).unlink()
    (csrc / "fused_net_loop2.cu").write_text('#include "fused_net_common.cuh"\n')
    assert S.missing_hooks(tmp_path) == ([v for v in S.VARIANTS if v != "full"]
                                         + ["K6/no_grid_barrier", "K5"])
    with pytest.raises(RuntimeError, match="cannot be split"):
        S.build_variants(tmp_path)


def test_item_kernels_are_gated():
    """Every item kernel instantiation the entry points can launch is in
    ``chip_smoke.REDESIGNED`` under the name ptxas's mangled one gives
    (``cuda_build.kernel_name``): K7's, K5's and K6's for both state
    dtypes, K4's for each layout it compiles (``fused_net_loop.LAYOUTS``:
    units and the recurrent-unit mask) and K3's for each unit count it
    launches (1..7), each in both state dtypes; phase ``build`` fails on a
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
    for source in ("fused_net_batch", "fused_net_loop2", "fused_net_lgrid"):
        assert chip_smoke.REDESIGNED[source] == tuple(
            f"{source}_kernel<{name}>" for _, name in states)
    text = (CSRC / "fused_net.cu").read_text()
    units = [int(n) for n, m in re.findall(r"case (\d): return go\(fused_net_kernel<(\d), S>\);",
                                           text) if n == m]
    assert units == list(range(1, L_MAX + 1))
    mangled = [f"_ZN6evflow8wholenet16fused_net_kernelILi{n}E{t}EEvNS0_12WholeNetArgsE"
               for n in units for t, _ in states]
    assert chip_smoke.REDESIGNED["fused_net"] == tuple(kernel_name(x) for x in mangled)


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
    """K3, K4, K5 and K7 run the same item body: each unit's own extent in
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
                  "fused_firenet_step_loop", "fused_firenet_step"):
        assert chip_smoke.issued_flops(kname, net, 2) == expected, kname
        assert chip_smoke.issued_flops(kname, net, 8) == 4 * expected, kname


def test_issued_flops_counts_k6_tiles_without_halo():
    """K6 runs every unit over the 16 x 16 tiles alone, no halo recomputed:
    256 pixels x 512 tiles x 2 x 32 x 9 x the packed input channels summed
    over the units (272 for LIFFireNet) = 20.54 GFLOP a window at B=2,
    256x256, about half of the item kernels' 39.94."""
    import chip_smoke

    net = runner_of("FTFFTFF")
    assert sum(t.shape[1] // 9 for t in net.weights.wk) == 272
    expected = 256 * I.item_count(2, 256, 256) * 2 * 32 * 9 * 272
    assert expected == 20_535_312_384
    assert chip_smoke.issued_flops("fused_firenet_step_lgrid", net, 2) == expected
    assert chip_smoke.issued_flops("fused_firenet_step_lgrid", net, 8) == 4 * expected


def test_split_old_refuses_a_tree_with_the_item_body(tmp_path):
    """``probes/wholenet_split_old.py`` patches the text of K3 and K6 as
    they were before they ran the item body; on this tree, whose K3 and K6
    run it, the first patch whose text is missing refuses the tree before
    any build."""
    from evflow_torch.probes import wholenet_split_old as old

    shutil.copytree(CSRC, tmp_path / "evflow_torch" / "csrc")
    with pytest.raises(RuntimeError, match="not the ones this script patches"):
        old.patched_sources(tmp_path)


LAYER = "conv_lif_layer.cuh"


def test_layer_mirror_matches_the_source():
    """``ops/conv_lif.py::layer_smem`` counts the pieces of K1's and K2's
    ``layer_layout`` (``csrc/conv_lif_layer.cuh``), with its tile width,
    channel limit and the card's shared memory."""
    from evflow_torch.ops import conv_lif as K

    src = (CSRC / LAYER).read_text()
    assert f"constexpr int LT = 16, MAX_CH = 64, SMEM_MAX = {SMEM_LIMIT};" in src
    assert (K._TILE, K.MAX_CHANNELS, K.SMEM_LIMIT) == (16, 64, SMEM_LIMIT)
    layout = re.search(r"inline LayerLayout layer_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.wbuf = (th + 2) * (LT + 2) * (ck + PAD) * 2;",
                  "s.prm = s.wbuf + ch * (9 * ck + PAD) * 2;",
                  "s.bar = s.prm + 3 * ch * 4;",
                  "s.total = s.bar + 16;"):
        assert piece in layout
    assert "layer_layout(a.Ck, ch, LT).total > SMEM_MAX" in src  # the launch's refusal
    # a recurrent LIFFireNet unit: 324 halo pixels x 72 bf16, 32 x 584 bf16 of weights
    assert K.layer_smem(32, 32, True) == 324 * 72 * 2 + 32 * 584 * 2 + 3 * 32 * 4 + 16 == 84432


@pytest.mark.parametrize("recurrent", [False, True])
def test_layer_smem_fits_every_width(recurrent):
    """Every unit of C = 1..64 channels (Cin = C, and the 2-channel head)
    fits a CTA's 232,448 bytes but the recurrent ones of C > 56, whose
    [x | prev_spk] packs to 128 channels: those the launch refuses. Two
    CTAs of a LIFFireNet unit (C = 32) share an SM."""
    from evflow_torch.ops.conv_lif import layer_smem

    over = [c for c in range(1, 65) if layer_smem(c, c, recurrent) > SMEM_LIMIT]
    assert over == (list(range(57, 65)) if recurrent else [])
    assert all(layer_smem(2, c, False) <= SMEM_LIMIT for c in range(1, 65))
    assert 2 * (layer_smem(32, 32, recurrent) + CTA_RESERVED) <= SM_SMEM


def test_layer_refuses_before_launch(monkeypatch):
    """The wrapper's checks run before the kernel's entry point is looked
    up: C = 65 and the recurrent units that do not fit raise ``ValueError``
    (naming the bytes) without a launch; the widths that fit reach the
    launch with their packed channel count."""
    from evflow_torch.ops import conv_lif as K
    from evflow_torch.ops import cuda_build

    launched = []

    def entry_point(name):
        def launch(*args):
            launched.append((name, args[-5], args[-4], args[-3]))  # Cin, C, Ck
            return 0
        return launch

    monkeypatch.setattr(cuda_build, "entry_point", entry_point)
    # CPU tensors stand in for the card's: no device or stream to enter
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())

    def run(cin, c, recurrent, cmajor):
        shape = (1, c, 4, 5) if cmajor else (1, 4, 5, c)
        x = torch.zeros((1, cin, 4, 5) if cmajor else (1, 4, 5, cin))
        mem = torch.zeros(shape)
        wk = K.pack_weights(torch.zeros(3, 3, cin, c), torch.zeros(3, 3, c, c) if recurrent
                            else None)
        vec = torch.zeros(c)
        return K.check_and_launch("conv_lif_cmajor" if cmajor else "conv_lif", cmajor, x, mem,
                                  wk, vec, vec, vec, torch.zeros(shape) if recurrent else None,
                                  True)

    for cmajor in (False, True):
        for c, recurrent in ((65, False), (65, True), (57, True), (64, True)):
            with pytest.raises(ValueError, match="channels|bytes"):
                run(c, c, recurrent, cmajor)
        assert not launched
        with pytest.raises(ValueError, match="237392 bytes"):
            run(64, 64, True, cmajor)
        for cin, c, recurrent in ((2, 24, False), (24, 24, True), (56, 56, True), (64, 64, False),
                                  (3, 5, True)):
            spk, mem_out = run(cin, c, recurrent, cmajor)
            assert spk.shape == mem_out.shape
            assert launched.pop() == ("conv_lif_cmajor" if cmajor else "conv_lif", cin, c,
                                      K.packed_channels(cin, c, recurrent))


def test_layer_kernels_are_gated():
    """Every K1 and K2 instantiation the launch can choose (one a padded
    output width: 16, 32, 48, 64) is in ``chip_smoke.REDESIGNED`` under the
    name ptxas's mangled one gives; phase ``build`` fails on a missing one,
    a stack frame or a spill."""
    import chip_smoke
    from evflow_torch.ops.cuda_build import kernel_name

    src = (CSRC / LAYER).read_text()
    widths = [int(n) for n, m in re.findall(r"case (\d+): return launch_ch<(\d+), PIXEL>", src)
              if n == m]
    widths += [int(n) for n in re.findall(r"default: return launch_ch<(\d+), PIXEL>", src)]
    assert "const auto kernel = conv_lif_kernel<CH, PIXEL>;" in src
    assert widths == [16, 32, 48, 64]
    for source, pixel in (("conv_lif", 1), ("conv_lif_cmajor", 0)):
        assert f"EVFLOW_CONV_LIF_ENTRY({source}, {'true' if pixel else 'false'})" in (
            CSRC / f"{source}.cu").read_text()
        mangled = [f"_ZN6evflow5layer15conv_lif_kernelILi{w}ELb{pixel}EEEvNS0_11ConvLIFArgsE"
                   for w in widths]
        assert chip_smoke.REDESIGNED[source] == tuple(kernel_name(m) for m in mangled)


def test_conv_lif_split_variants_have_their_hooks():
    """Each variant of ``conv_lif_times`` (``wholenet_slope --split``'s K1
    and K2) takes out a part that the item header declares and that K1's and
    K2's header tests (``item_keeps``), and both sources include
    ``conv_lif_layer.cuh``."""
    from evflow_torch.probes import conv_lif_times as T

    declared = re.search(r"enum ItemCut \{(.*?)\};", (CSRC / S.ITEM_HEADER).read_text(),
                         re.S).group(1)
    text = (CSRC / LAYER).read_text()
    for cut in filter(None, T.VARIANTS.values()):
        assert cut in declared and f"item_keeps({cut})" in text
    assert T.missing_hooks(CSRC.parents[1]) == []

