"""The port's unit-loop probes (``evflow_torch.probes.unit_loop``, plain
versions on the CPU) against the JAX probe kernels of
``benchmarks/probe_loop_dyn4.py`` (K8i, ``make_kernel``, cases 13, 14, 15)
and ``probe_loop_dyn5.py`` (K8j, ``k16``) in interpret mode, on the same
numpy-made operands at a small size (L=4, C=8, E=24, W=16, TH=8).

The probe files run their cases when imported, so each is parsed and only
its imports and ``def``s are executed, with its size constants rebound
(``tests/_torch_port.py::probe_namespace``); each ``pallas_call`` is built
here with the file's own specs (``probe_loop_dyn4.py:73-79``,
``probe_loop_dyn5.py:81-94``, with ``pl.ANY`` for the deprecated
``pltpu.ANY``).

Tolerance: equality. The operands (``unit_loop.draw_operands``) make every
sum exact at this size, so the JAX kernel's f32 sums and the plain
version's float64 sums round to the same values.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_port import probe_namespace
from evflow_torch.probes import unit_loop as U

L, C, E, W, TH = 4, 8, 24, 16, 8
SIZES = dict(L=L, C=C, E=E, W=W, TH=TH)


def jax_of(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # bf16 values: exact
    return jnp.asarray(t.numpy())


def vmem(*shape):
    return pltpu.VMEM(shape, jnp.bfloat16)


OUT = dict(out_specs=pl.BlockSpec((L, C, TH, W), lambda i: (0, 0, 0, 0)),
           out_shape=jax.ShapeDtypeStruct((L, C, TH, W), jnp.float32))


@pytest.mark.parametrize("with_lif,dyn_out", [(True, True), (False, True), (True, False)],
                         ids=["13-full-body", "14-no-lif", "15-no-dyn-out"])
def test_unit_loop_matches_jax_probe_loop_dyn4(with_lif, dyn_out):
    ns = probe_namespace("probe_loop_dyn4", **SIZES)
    ops = U.draw_operands(np.random.default_rng(0), L, C, E, W, with_lif=with_lif)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(ns["make_kernel"](with_lif, dyn_out), grid=(1,),
                              in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 4, **OUT,
                              scratch_shapes=[vmem(C, E, W), vmem(L, C, TH, W)])
        ref = np.asarray(call(*(jax_of(t) for t in ops)))
    out = U.unit_loop(*ops, with_lif=with_lif, dyn_out=dyn_out, th=TH)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (L, C, TH, W)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).mean() > 0.1  # the draw fires: the comparison is not of zeros


def test_unit_loop_dma_matches_jax_probe_loop_dyn5():
    ns = probe_namespace("probe_loop_dyn5", **SIZES)
    x, mem, spk, w, p = U.draw_operands(np.random.default_rng(1), L, C, E, W, dma=True)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            ns["k16"], grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3
            + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 2, **OUT,
            scratch_shapes=[vmem(C, E, W), vmem(L, C, E, W), vmem(3, C, E, W), vmem(L, C, TH, W),
                            vmem(3, C, TH, W)]
            + [pltpu.SemaphoreType.DMA] * (3 + L))
        ref = np.asarray(call(*(jax_of(t) for t in (x, mem, spk, w, p))))
    out = U.unit_loop_dma(x, mem, spk, w, p, th=TH)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    # the slots change the function: with other spikes in slots 0 and 1 the output moves
    other = U.unit_loop_dma(x, mem, 1 - spk, w, p, th=TH)
    assert not torch.equal(other, out)


def test_spike_slots_hold_each_layers_spikes():
    """The CPU wrapper returns the plain version's slots beside its output:
    slot s(l) holds layer l's spikes (rows 8:8+TH), so slot 0 layer 1's,
    slot 1 layer 2's and slot 2 layer 3's (layer 0's is overwritten). A
    layer loop cut to L' layers computes the same first L' layers, so its
    slots agree with the full run's where they were written last by the
    same layer; and where a layer's spike is 1, its membrane output is 0
    (the hard reset)."""
    x, mem, spk, w, p = U.draw_operands(np.random.default_rng(2), L, C, E, W, dma=True)
    out, slots = U.unit_loop_dma(x, mem, spk, w, p, th=TH, spike_slots=True)
    assert torch.equal(out, U.unit_loop_dma(x, mem, spk, w, p, th=TH))
    _, plain_slots = U.unit_loop_dma_plain(x, mem, spk, w, p, th=TH, spike_slots=True)
    assert slots.dtype == torch.bfloat16 and tuple(slots.shape) == (3, C, TH, W)
    assert torch.equal(slots, plain_slots)
    assert set(slots.unique().tolist()) == {0.0, 1.0}
    def cut(layers):
        return U.unit_loop_dma(x, mem[:layers], spk, w[:layers], p[:layers], th=TH,
                               spike_slots=True)[1]

    two, three = cut(2), cut(3)
    assert torch.equal(two[0], slots[0]) and torch.equal(three[1], slots[1])
    assert not bool(two[1].any())  # slot 1 is first written by layer 2
    for slot, layer in ((0, 1), (1, 2), (2, 3)):
        fired = slots[slot] == 1
        assert bool(fired.any()) and bool((out[layer][fired] == 0).all())


def test_unit_loop_cases_follow_the_files():
    """The cases carry the JAX files' shapes (L=4, C=32, E=24, W=256, TH=8);
    what each function needs (the cone of rows that reaches the output:
    layer l's conv on 14, 12, 10, 8 rows, x on 16; without LIF the membranes
    only on the output rows; K8j's aux on 14 and 12 rows and only the
    weight halves of its non-zero slots), which sets the bound; and the TPU
    probe's whole-window counts."""
    cases = U.probe_cases("meta")
    assert [c.fn for c in cases] == [U.unit_loop] * 3 + [U.unit_loop_dma]
    x, w, p, mem = cases[0].args
    assert (tuple(x.shape), tuple(w.shape), tuple(p.shape), tuple(mem.shape)) == (
        (32, 24, 256), (4, 32, 576), (4, 32, 3), (4, 32, 24, 256))
    xd, md, sd, _, _ = cases[3].args
    assert (tuple(xd.shape), tuple(md.shape), tuple(sd.shape)) == (
        (1, 32, 24, 256), (4, 1, 32, 24, 256), (3, 1, 32, 24, 256))
    assert [c.nbytes for c in cases] == [2_180_608, 1_984_000, 2_180_608, 2_569_728]
    assert [c.flops for c in cases] == [415_236_096] * 3 + [311_427_072]
    assert [c.staged_bytes for c in cases] == [3_163_648] * 3 + [3_950_080]
    assert [c.issued_flops for c in cases] == [905_969_664] * 4
    assert [U.bound(c)[1] for c in cases] == ["bytes"] * 4
    assert U.bound(cases[0])[0] == pytest.approx(2_180_608 / 3.35e9)
    assert U.bound(cases[3])[0] == pytest.approx(2_569_728 / 3.35e9)
    assert all(U.tolerance(c, torch.full((1,), 512.0)) == 0.0 for c in cases)
    assert all(c.fn.launches == 0 for c in cases)  # building cases launches nothing


def test_draw_is_exact_and_fires():
    """The full-size draw keeps every sum of the LIF cases exact in f32 (x
    and spikes 0/1, weights k/16, so each conv's terms are multiples of 1/16
    and their sums stay far below 2^24 / 16) and fires: a share of the
    final spikes and of the membranes is non-zero."""
    case = U.probe_cases("cpu", seed=0)[0]
    x, w, p, mem = case.args
    assert set(x.unique().tolist()) == {0.0, 1.0}
    assert bool(((w.float() * 16).frac() == 0).all()) and float(w.float().abs().max()) <= 0.25
    assert bool((p[..., 1] == 0.5).all()) and bool((((p[..., 2] * 128) % 2) == 1).all())
    worst = 2 * 9 * C * 0.25 + 0.25  # every |term| and the bias, h in {0, 1}
    assert worst * 16 < 2 ** 24
    out = case.plain(*case.args, **case.kwargs)
    spikes = U.probe_cases("cpu", seed=0)[2]
    final = spikes.plain(*spikes.args, **spikes.kwargs)
    assert 0.2 < float((out != 0).float().mean()) < 0.9
    assert 0.05 < float(final.mean()) < 0.5


@pytest.mark.parametrize("seed,shape", [(0, (4, 32, 24, 256, 8)), (1, (4, 32, 24, 256, 8)),
                                        (1, (4, 32, 20, 40, 6)), (1, (2, 32, 16, 24, 8))],
                         ids=["smoke", "full", "ragged", "two-layers"])
def test_no_lif_draw_is_exact_and_shows_the_membrane(seed, shape):
    """Case 14's draws, at the shapes and seeds that ``chip_smoke.py`` and
    the GPU test hold to equality: every h, bias and membrane is an integer
    and, at every pixel of every layer, the sum of the conv's |terms| and
    |bias| and the sum |ff| + |mem| stay below 2^24, so every partial sum in
    any order is an exact f32 integer. And the membrane shows: with the
    membranes zeroed, or each layer reading another layer's, most outputs of
    every layer change."""
    case = U.probe_cases("cpu", seed=seed, shape=shape)[1]
    assert not case.kwargs["with_lif"]
    x, w, p, mem = case.args
    layers, c = w.shape[:2]
    h = x
    for l in range(layers):
        wt = w[l].double().reshape(c, 2, 3, 3, c).permute(0, 1, 4, 2, 3).reshape(c, 2 * c, 3, 3)
        src = torch.cat([h, h])[None].double()
        bias = p[l, :, 0].double()[:, None, None]
        ff = torch.nn.functional.conv2d(src, wt, padding=1)[0] + bias
        terms = torch.nn.functional.conv2d(src.abs(), wt.abs(), padding=1)[0] + bias.abs()
        m = mem[l].double()
        assert bool((wt == wt.round()).all()) and bool((bias == bias.round()).all())
        assert bool((ff == ff.round()).all()) and bool((m == m.round()).all())
        assert float(terms.max()) < 2 ** 24 and float((ff.abs() + m.abs()).max()) < 2 ** 24
        h = ff.to(torch.bfloat16)
    out = case.plain(*case.args, **case.kwargs)
    other = [(l + 1) % layers for l in range(layers)]
    for moved in (torch.zeros_like(mem), mem[other]):
        changed = (case.plain(x, w, p, moved, **case.kwargs) != out).flatten(1).float().mean(1)
        assert bool((changed > 0.9).all()), changed


BAD = dict(x=torch.zeros(8, 24, 16, dtype=torch.bfloat16),
           w=torch.zeros(2, 8, 144, dtype=torch.bfloat16), p=torch.zeros(2, 8, 3),
           mem=torch.zeros(2, 8, 24, 16, dtype=torch.bfloat16))


@pytest.mark.parametrize("bad,match", [
    (dict(x=BAD["x"].to("meta"), w=BAD["w"].to("meta"), p=BAD["p"].to("meta"),
          mem=BAD["mem"].to("meta")), "cpu or cuda"),
    (dict(mem=BAD["mem"].float()), "bf16"),
    (dict(p=BAD["p"].double()), "f32 p"),
    (dict(w=torch.zeros(2, 8, 72, dtype=torch.bfloat16)), "do not agree"),
    (dict(mem=torch.zeros(3, 8, 24, 16, dtype=torch.bfloat16)), "do not agree"),
    (dict(x=torch.zeros(8, 14, 16, dtype=torch.bfloat16),
          mem=torch.zeros(2, 8, 14, 16, dtype=torch.bfloat16)), "must lie in"),
    (dict(x=BAD["x"][None]), r"x \[C, E, W\]"),
], ids=["meta", "mem-dtype", "p-dtype", "w-shape", "layers", "rows", "x-rank"])
def test_unit_loop_refuses(bad, match):
    kw = dict(BAD, **bad)
    before = U.unit_loop.launches
    with pytest.raises(ValueError, match=match):
        U.unit_loop(kw["x"], kw["w"], kw["p"], kw["mem"])
    assert U.unit_loop.launches == before


@pytest.mark.parametrize("bad,match", [
    (dict(spk=torch.zeros(2, 1, 8, 24, 16, dtype=torch.bfloat16)), r"spk \[3, 1"),
    (dict(spk=torch.zeros(3, 1, 8, 24, 16)), "bf16 spk"),
    (dict(x=BAD["x"]), r"x \[1, C, E, W\]"),
    (dict(mem=BAD["mem"]), r"mem \[L, 1"),
], ids=["slots", "spk-dtype", "x-rank", "mem-rank"])
def test_unit_loop_dma_refuses(bad, match):
    kw = dict(x=BAD["x"][None], mem=BAD["mem"][:, None], spk=torch.zeros(3, 1, 8, 24, 16,
                                                                         dtype=torch.bfloat16),
              w=BAD["w"], p=BAD["p"], **{})
    kw.update(bad)
    before = U.unit_loop_dma.launches
    with pytest.raises(ValueError, match=match):
        U.unit_loop_dma(kw["x"], kw["mem"], kw["spk"], kw["w"], kw["p"])
    assert U.unit_loop_dma.launches == before


# --- the launch's layout (``launch_layout``, the source's ``make_layout``) ----

CSRC = Path(U.__file__).resolve().parents[1] / "csrc" / "probe_unit_loop.cu"


def earlier_launch_took(layers, e, slots):
    """What the unit-loop kernel took before its cone design (its launch's
    limits, beyond C = 32, W a multiple of 8 and R0 + TH <= E <= 256): every
    CTA 16 columns and a halo of L rounded up to 8 on each side, all E rows;
    at most 16 warps of two 32-pixel pairs over E (16 + 2(L-1)) pixels, a
    box at most 256 columns wide, and h (K8j: and aux) pixel-major at 40
    bf16 a pixel, one channel-major box and one layer's weights (584 bf16
    rows) within 232,448 bytes of shared memory."""
    halo = -(-layers // 8) * 8
    bw = 16 + 2 * halo
    pairs = -(-(e * (16 + 2 * (layers - 1))) // 32)
    if -(-pairs // 2) > 16 or bw > 256:
        return False
    def up(v):
        return -(-v // 128) * 128

    hbytes = up((e + 2) * bw * 40 * 2)
    total = 128 + hbytes * (2 if slots else 1) + up(32 * e * bw * 2) + 32 * 584 * 2
    return total <= 232448


@pytest.mark.parametrize("slots", [False, True], ids=["K8i", "K8j"])
def test_launch_layout_fits_a_cta(slots):
    """Every layout ``launch_layout`` gives for L in 1..16 and every E up to
    256 (the first and the last output row count, a narrow and a wide
    window) fits one CTA: its shared bytes within 232,448, its threads
    within 16 warps, layer 0's cone (the largest) within the kernel's
    fragments a warp (2 on 8 warps, else 4 on 16); the probes' shapes take
    128 CTAs x 256 threads and two ring stages."""
    taken = 0
    for layers in range(1, 17):
        for e in range(9, 257):
            for th in (1, e - 8):
                for w in (8, 256):
                    lay = U.launch_layout(layers, e, th, w, slots)
                    if lay is None:
                        continue
                    taken += 1
                    assert lay["smem"] <= 232448 and lay["threads"] <= 512
                    assert lay["frags"] <= 4 * lay["threads"] // 32
                    assert lay["stages"] in (1, 2) and 1 <= lay["t"] <= min(th, 8)
                    assert lay["threads"] == (256 if lay["fpw"] == 2 else 512)
                    assert lay["frags"] <= 2 * lay["threads"] // 32 or lay["fpw"] == 4
                    assert lay["grid"] == w // 8 * -(-th // lay["t"])
    assert taken > 1000
    probe = U.launch_layout(4, 24, 8, 256, slots)
    assert (probe["grid"], probe["threads"], probe["t"], probe["stages"]) == (128, 256, 2, 2)
    assert probe["smem"] == (168_832 if slots else 123_264)


@pytest.mark.parametrize("slots", [False, True], ids=["K8i", "K8j"])
def test_launch_layout_takes_what_the_earlier_launch_took(slots):
    """Every (L, E) the earlier launch took (``earlier_launch_took``, for L up
    to 60 and every E up to 256), at one, eight and E - 8 output rows and
    windows of 1, 5, 32 and 132 column tiles: the new layout takes it too,
    so the wrapper refuses nothing new."""
    taken = 0
    for layers in range(1, 61):
        for e in range(9, 257):
            if not earlier_launch_took(layers, e, slots):
                continue
            for th in sorted({1, min(8, e - 8), e - 8}):
                for w in (8, 40, 256, 1056):
                    assert U.launch_layout(layers, e, th, w, slots) is not None, (
                        layers, e, th, w)
                    taken += 1
    assert taken > 1000


def test_layout_mirror_constants_match_the_source():
    """The mirror's constants are the source's, and the source's layout has
    the pieces ``launch_layout`` counts."""
    src = CSRC.read_text()
    for name, value in (("TW", U.TW), ("TMAX", U.TMAX), ("FPW", U.FPW),
                        ("MIN_WARPS", U.MIN_WARPS), ("MAX_WARPS", U.MAX_WARPS),
                        ("SMEM_LIMIT", U.SMEM_LIMIT), ("R0", U.R0)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
    assert (U.SPITCH, U.WPITCH) == (40, 584)
    fill = re.search(r"inline bool fill_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("s.HR = E + 2 < t + 2 * L ? E + 2 : t + 2 * L;",
                  "s.HC = TW + 2 * L;",
                  "s.BX = TW + 2 * ceil8(L);",
                  "s.MR = E < t + 2 * (L - 1) ? E : t + 2 * (L - 1);",
                  "s.BM = TW + 2 * ceil8(L - 1);",
                  "s.stage = DATA_OFF + area + (slots && !alias ? up128(s.xbytes) : 0);",
                  "const int hbytes = up128(s.HR * s.HC * SPITCH * 2);",
                  "int off = 128;",
                  "off += stages * s.stage;",
                  "s.tile = up128(C * t * TW * 4);",
                  "off += 2 * s.tile;",
                  "s.stile = up128(C * t * TW * 2);",
                  "off += slots ? 2 * s.stile : 0;",
                  "const int frags = (s.MR * cols + 15) / 16;",
                  "s.fpw = frags <= 2 * MIN_WARPS ? 2 : FPW;",
                  "s.warps = s.fpw == 2 ? MIN_WARPS : MAX_WARPS;",
                  "s.total = off;",
                  "return s.total <= SMEM_LIMIT && frags <= FPW * s.warps && s.HR <= 256 && "
                  "s.BX <= 256 &&"):
        assert piece in fill, piece
    make = re.search(r"inline bool make_layout\(.*?\n\}", src, re.S).group(0)
    for piece in ("const int rings[4][2] = {{2, 0}, {2, 1}, {1, 0}, {1, 1}};",
                  "for (int t = t0; t >= 1; --t) {",
                  "n_rt = n_rt < TH ? n_rt : TH;"):
        assert piece in make, piece
    assert "constexpr int DATA_OFF = WREGION + (PBYTES + 127) / 128 * 128;" in src
    assert U.DATA_OFF == -(-32 * 584 * 2 // 128) * 128 + 384


def test_unit_loop_split_variants_have_their_hooks(tmp_path):
    """Each variant of ``unit_loop --split`` takes out a part that the
    source tests (``keeps(UL_CUT_<part>)``) or fixes the rows (``UL_ROWS``);
    a source without those hooks (as before this design) is refused for
    every variant but the full one."""
    from pathlib import Path as P

    assert U.split_missing(P(U.__file__).resolve().parents[2]) == []
    src = CSRC.read_text()
    for flags in U.SPLIT_VARIANTS.values():
        if flags and flags[0].startswith("-DUL_CUT="):
            part = flags[0][len("-DUL_CUT="):]
            assert f"keeps({part})" in src and f"  {part}," in src
    csrc = tmp_path / "evflow_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "probe_unit_loop.cu").write_text("// no hooks\n")
    assert U.split_missing(tmp_path) == [v for v in U.SPLIT_VARIANTS if v != "full"]


def test_unit_loop_instantiations_are_gated():
    """Every ``unit_loop_kernel<LIF, DYN, SLOTS, FPW>`` the entry point can
    launch (FPW 2 or 4 fragments a warp) is in ``chip_smoke.REDESIGNED``,
    whose ptxas gate fails on a missing one, a stack frame or spills."""
    import chip_smoke

    src = CSRC.read_text()
    launched = re.findall(r"launch<(true|false), (true|false), (true|false)>\(\*a, s\)", src)
    assert ("s.fpw == 2 ? unit_loop_kernel<LIF, DYN, SLOTS, 2>\n"
            "                           : unit_loop_kernel<LIF, DYN, SLOTS, 4>;") in src
    names = {"unit_loop_kernel<" + ",".join("1" if b == "true" else "0" for b in t) + f",{fpw}>"
             for t in launched for fpw in (2, 4)}
    assert len(names) == 10
    assert set(chip_smoke.REDESIGNED["probe_unit_loop"]) == names
