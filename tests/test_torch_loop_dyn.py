"""The port's runtime-indexed loop probes (``evflow_torch.probes.loop_dyn``,
plain versions on the CPU) against the JAX probe kernels of
``benchmarks/probe_loop_dyn.py`` (K8f: ``k1``-``k5``),
``probe_loop_dyn3.py`` (K8h: ``k10``-``k12``) and ``probe_loop_dyn2.py``
(K8g: ``k6``-``k8``, and ``k9``, the bulk store's reference, since ``k4``
does not run) in interpret mode, on the same numpy-made operands at a
small size (L=4, C=8, E=8, W=16; ``k8``, which stores rows 8..8+TH, at
E=16 with TH=4).

The probe files run their cases when imported, so each is parsed and only
its imports and ``def``s are executed, with its size constants rebound
(``tests/_torch_port.py::probe_namespace``); each ``pallas_call`` is built
here with the file's own specs (``probe_loop_dyn.py:21-30``,
``probe_loop_dyn3.py:29-64``, ``probe_loop_dyn2.py:31-97``, with
``pl.ANY`` for the deprecated ``pltpu.ANY``).

Tolerance: equality. The operands (``loop_dyn.draw_operands``) make every
sum an exact integer, so any order of f32 sums and the plain version's
float64 sums give the same values; the roundings to bf16 are alike. The
f32 dots k2 and k7 are also run on f32 normals, within
``loop_dyn.f32_tolerance``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_port import probe_namespace
from evflow_torch.device import BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S
from evflow_torch.probes import loop_dyn as D

L, C, E, W = 4, 8, 8, 16
SIZES = dict(L=L, C=C, E=E, W=W)


def jax_of(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # bf16 values: exact
    return jnp.asarray(t.numpy())


def vmem_in(n):
    return [pl.BlockSpec(memory_space=pltpu.VMEM)] * n


OUT = dict(out_specs=pl.BlockSpec((C, E, W), lambda i: (0, 0, 0)),
           out_shape=jax.ShapeDtypeStruct((C, E, W), jnp.float32))
ANY_OUT = dict(out_specs=pl.BlockSpec(memory_space=pl.ANY),
               out_shape=jax.ShapeDtypeStruct((L, C, E, W), jnp.float32))


def k8f_call(kernel, any_out=False):
    """``probe_loop_dyn.py::run``'s ``pallas_call`` (x and w in VMEM, a
    scratch, a stage and a DMA semaphore)."""
    return pl.pallas_call(kernel, grid=(1,), in_specs=vmem_in(2), **(ANY_OUT if any_out else OUT),
                          scratch_shapes=[pltpu.VMEM((L, C, E, W), jnp.float32),
                                          pltpu.VMEM((C, E, W), jnp.float32),
                                          pltpu.SemaphoreType.DMA])


def jax_probe(body, args):
    """The JAX body's output in interpret mode on the port's operands."""
    if body in ("k10", "k11", "k12"):
        ns = probe_namespace("probe_loop_dyn3", **SIZES)
        scratch = [] if body == "k12" else [pltpu.VMEM((L, C, E, W), jnp.bfloat16)]
        with pltpu.force_tpu_interpret_mode():
            call = pl.pallas_call(ns[body], grid=(1,), in_specs=vmem_in(len(args)), **OUT,
                                  **({"scratch_shapes": scratch} if scratch else {}))
            return np.asarray(call(*(jax_of(t) for t in args)))
    ns = probe_namespace("probe_loop_dyn", **SIZES)
    # run() passes x and w to every body; the ones that take no w get zeros
    w = args[1] if body == "k2" else torch.zeros(L, C, 3 * C)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(k8f_call(ns[body])(jax_of(args[0]), jax_of(w)))


@pytest.mark.parametrize("body", ["k1", "k2", "k3", "k5", "k10", "k11", "k12"])
def test_body_matches_jax_probe(body):
    _, _, fn, _, kwargs, _ = D.BODIES[body]
    args = D.draw_operands(np.random.default_rng(0), body, L, C, E, W)
    ref = jax_probe(body, args)
    before = fn.launches
    out = fn(*args, **kwargs)
    assert fn.launches == before  # the CPU runs the plain version: no launch
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (C, E, W)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).mean() > 0.5


def test_bulk_store_matches_jax_k9():
    """k4's port against ``k9`` (``probe_loop_dyn2.py:83-97``), the same
    function with the fixed ``.at[l]``; into a NaN-filled ``out`` as well."""
    ns = probe_namespace("probe_loop_dyn2", **SIZES, TH=8)
    (x,) = D.draw_operands(np.random.default_rng(1), "k4", L, C, E, W)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(ns["k9"], grid=(1,), in_specs=vmem_in(1), **ANY_OUT,
                              scratch_shapes=[pltpu.VMEM((C, E, W), jnp.float32),
                                              pltpu.SemaphoreType.DMA])
        ref = np.asarray(call(jax_of(x)))
    np.testing.assert_array_equal(D.dyn_store_bulk(x).numpy(), ref)
    out = torch.full((L, C, E, W), float("nan"))
    assert D.dyn_store_bulk(x, out=out) is out
    np.testing.assert_array_equal(out.numpy(), ref)


K8G_E, K8G_TH = 16, 4  # k8 stores rows 8..8+TH: E must reach past them


def k8g_probe(body, args):
    """``probe_loop_dyn2.py``'s ``k6``, ``k7`` or ``k8`` in interpret mode
    with the file's specs (``:31-36``, ``:60-65``, ``:75-80``)."""
    e = K8G_E if body == "k8" else E
    ns = probe_namespace("probe_loop_dyn2", L=L, C=C, E=e, W=W, TH=K8G_TH)
    if body == "k8":
        out = dict(out_specs=pl.BlockSpec((L, 1, C, K8G_TH, W), lambda i: (0, 0, 0, 0, 0)),
                   out_shape=jax.ShapeDtypeStruct((L, 1, C, K8G_TH, W), jnp.float32))
    else:
        out = OUT
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(ns[body], grid=(1,), in_specs=vmem_in(len(tensors)), **out)
        return np.asarray(call(*(jax_of(t) for t in tensors)))


@pytest.mark.parametrize("body", ["k6", "k7", "k8"])
def test_k8g_body_matches_jax_probe(body):
    """K8g's ``k6`` (the narrow ``[L, C, 3]`` load), ``k7`` (patches and
    three dots per layer: a SAME conv) and ``k8`` (the 5-D windowed store)
    against the port's plain versions: equal."""
    _, _, fn, _, kwargs, _ = D.BODIES[body]
    e = K8G_E if body == "k8" else E
    args = D.draw_operands(np.random.default_rng(4), body, L, C, e, W)
    if body == "k8":
        kwargs = dict(kwargs, rows=K8G_TH)
    ref = k8g_probe(body, args)
    before = fn.launches
    out = fn(*args, **kwargs)
    assert fn.launches == before  # the CPU runs the plain version: no launch
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).mean() > 0.5


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (to nearest)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("body", ["k2", "k7"])
def test_f32_dot_matches_jax_probe_on_normals(body):
    """The f32 dots k2 and k7 on f32 normals: the JAX body in interpret mode
    within ``loop_dyn.f32_tolerance`` of the port's plain version, and the
    same dots on operands rounded to TF32 ten times past it, so the check
    the card's kernels are held to (``chip_smoke.py`` phase ``loopdyn``)
    tells an exact-f32 dot from a TF32 one."""
    _, _, fn, plain, _, _ = D.BODIES[body]
    args = D.draw_operands(np.random.default_rng(8), body, L, C, E, W, normals=True)
    assert all(t.dtype == torch.float32 for t in args)
    assert float((tf32(args[0]) != args[0]).float().mean()) > 0.9
    ref = jax_probe(body, args) if body == "k2" else k8g_probe(body, args)
    out = fn(*args)
    tol = D.f32_tolerance(*args, out)
    assert np.abs(out.numpy() - ref).max() <= tol
    assert float((plain(*(tf32(t) for t in args)) - out).abs().max()) > 10 * tol


def test_narrow_sum_reads_column_1_of_every_layer():
    p, e, w = D.draw_operands(np.random.default_rng(5), "k6", L, C, E, W)
    out = D.dyn_narrow_sum(p, e, w)
    assert torch.equal(out, p[:, :, 1].sum(0)[:, None, None].expand(C, E, W))
    moved = p.clone()
    moved[:, :, 0] += 5
    moved[:, :, 2] -= 3
    assert torch.equal(D.dyn_narrow_sum(moved, e, w), out)
    moved[3, :, 1] += 1
    assert torch.equal(D.dyn_narrow_sum(moved, e, w), out + 1)


def test_conv_sum_zero_pads_rows_and_columns():
    """k7 is a SAME conv whose outside rows and columns are zeros: on ones
    with ones for weights each output counts the taps inside the image (4
    at a corner, 6 on an edge, 9 inside) over C channels and L layers; and
    its weight layout ``w[l][co, (dy 3 + dx) C + ci]`` is ``conv_weights``'s."""
    x, w = torch.ones(L, C, E, W), torch.ones(L, C, 9 * C)
    out = D.dyn_conv_sum(x, w)
    taps = torch.full((E, W), 9.0)
    taps[[0, -1], :] = 6
    taps[:, [0, -1]] = 6
    taps[[0, 0, -1, -1], [0, -1, 0, -1]] = 4
    assert torch.equal(out, (L * C * taps).expand(C, E, W))
    x, w = D.draw_operands(np.random.default_rng(6), "k7", L, C, E, W)
    by_layer = sum(F.conv2d(x[l:l + 1].double(),
                            w[l].double().reshape(C, 3, 3, C).permute(0, 3, 1, 2), padding=1)[0]
                   for l in range(L))
    assert torch.equal(D.dyn_conv_sum(x, w), by_layer.float())


def test_store_window_is_the_bulk_store_of_a_row_window():
    """k8's plain version stores ``scale x[l][:, row0 : row0 + rows]`` into
    ``[L, 1, C, rows, W]``; at the whole image and scale 3 it is k4's."""
    (x,) = D.draw_operands(np.random.default_rng(7), "k8", L, C, K8G_E, W)
    out = D.dyn_store_window(x)
    assert tuple(out.shape) == (L, 1, C, D.TH, W)
    assert torch.equal(out[:, 0], 2 * x[:, :, 8:16])
    assert torch.equal(D.dyn_store_window(x, row0=0, rows=K8G_E, scale=3.0)[:, 0],
                       D.dyn_store_bulk(x))


def test_reference_k4_raises_in_interpret_mode():
    """``probe_loop_dyn.py:76`` hands ``o_hbm.at[pl.ds(l, 1)][0]``, which is
    not a Ref, to the DMA: the JAX ``k4`` raises before it runs (``k9``
    fixed it with ``.at[l]``). A fix to the reference makes this fail, and
    then ``k4`` itself should be compared with the port."""
    ns = probe_namespace("probe_loop_dyn", **SIZES)
    (x,) = D.draw_operands(np.random.default_rng(1), "k4", L, C, E, W)
    with pltpu.force_tpu_interpret_mode():
        with pytest.raises(ValueError, match="must be Refs"):
            k8f_call(ns["k4"], any_out=True)(jax_of(x), jnp.zeros((L, C, 3 * C), jnp.float32))


def test_slot_body_reads_x2_twice_and_never_x3():
    (x,) = D.draw_operands(np.random.default_rng(2), "k5", L, C, E, W)
    out = D.dyn_load_sum(x, slot=True)
    assert torch.equal(out, x[0] + x[1] + 2 * x[2])
    moved = x.clone()
    moved[3] = -moved[3] + 7
    assert torch.equal(D.dyn_load_sum(moved, slot=True), out)
    moved[2] += 1
    assert torch.equal(D.dyn_load_sum(moved, slot=True), out + 2)
    assert [D.slot_of(l) for l in range(L)] == [2, 0, 1, 2]


@pytest.mark.parametrize("body", ["k3", "k11"])
def test_store_scratch_holds_every_layer(body):
    """``scratch=True`` returns ``scr[l] = 2 x[l]`` in the scratch type for
    every l (bf16: rounded, then doubled), and the same output."""
    _, _, fn, _, kwargs, _ = D.BODIES[body]
    (x,) = D.draw_operands(np.random.default_rng(3), body, L, C, E, W)
    out, scr = fn(x, **kwargs, scratch=True)
    dtype = kwargs["scratch_dtype"]
    assert scr.dtype == dtype and tuple(scr.shape) == (L, C, E, W)
    assert torch.equal(out, fn(x, **kwargs)) and torch.equal(out, scr[0].float())
    for l in range(L):
        assert torch.equal(scr[l].float(), 2 * x[l].to(dtype).float())
    if body == "k11":  # the normals are mostly not bf16-exact: the rounding shows
        assert (scr.float() != 2 * x).float().mean() > 0.9


def test_cases_follow_the_files():
    """The cases carry the JAX files' shapes (L=4, C=32, E=24, W=256); what
    each function needs (x's layers that it reads, the dots' weights, the
    f32 output; the dots' 2 C C flops per pixel and layer, the three weight
    blocks folded), which sets the bound; and what the TPU probe stages and
    issues."""
    cases = D.probe_cases("meta")
    assert [D.body_of(c) for c in cases] == ["k1", "k2", "k3", "k4", "k5", "k10", "k11", "k12",
                                             "k6", "k7", "k8"]
    k6 = cases[8]
    assert tuple(k6.args[0].shape) == (4, 32, 3) and k6.args[1:] == (24, 256)
    assert all(tuple(c.args[0].shape) == (4, 32, 24, 256) for c in cases if c is not k6)
    assert [c.args[0].dtype for c in cases] == ([torch.float32] * 5
                                                + [torch.bfloat16, torch.float32, torch.bfloat16]
                                                + [torch.float32] * 3)
    assert tuple(cases[1].args[1].shape) == (4, 32, 96)
    assert tuple(cases[9].args[1].shape) == (4, 32, 288)
    assert cases[10].kwargs == {"row0": 8, "rows": 8, "scale": 2.0}
    assert [c.nbytes for c in cases] == [3_932_160, 3_981_312, 1_572_864, 6_291_456, 3_145_728,
                                         2_359_296, 1_572_864, 2_383_872, 787_968, 4_079_616,
                                         2_097_152]
    assert [c.flops for c in cases] == [0, 50_331_648, 0, 0, 0, 0, 0, 50_331_648, 0,
                                        452_984_832, 0]
    assert [c.issued_flops for c in cases] == [0, 150_994_944, 0, 0, 0, 0, 0, 150_994_944, 0,
                                               452_984_832, 0]
    assert [c.staged_bytes for c in cases] == [3_981_312] * 3 + [6_340_608, 3_981_312,
                                                                 2_359_296, 3_932_160, 2_383_872,
                                                                 787_968, 4_079_616, 4_194_304]
    assert [D.bound(c)[1] for c in cases] == ["bytes"] * 9 + ["operations", "bytes"]
    assert D.bound(cases[0])[0] == pytest.approx(3_932_160 / 3.35e9)
    assert D.bound(cases[3])[0] == pytest.approx(6_291_456 / 3.35e9)
    assert [round(D.bound(c)[0], 6) for c in cases[8:]] == [0.000235, 0.006761, 0.000626]
    assert all(D.tolerance(c, torch.full((1,), 512.0)) == 0.0 for c in cases)
    assert all(c.fn.launches == 0 for c in cases)  # building cases launches nothing


def test_case_rate_sets_the_bound():
    """``Case.rate`` divides the operations: k2's f32 dot at 67 TFLOP/s, the
    bf16 dot and every staging and unit-loop case at the default 989
    TFLOP/s, their bounds unchanged (K8e's and K8i case 13's pinned)."""
    from evflow_torch.probes import staging as S
    from evflow_torch.probes import unit_loop as U

    grid, unit = S.probe_cases("meta")[4], U.probe_cases("meta")[0]
    assert grid.rate == unit.rate == BF16_FLOP_PER_S
    assert S.bound(grid) == (pytest.approx(3_022_848 / 3.35e9), "bytes")
    assert U.bound(unit) == (pytest.approx(2_180_608 / 3.35e9), "bytes")
    k2, k12, k7 = (D.probe_cases("meta")[i] for i in (1, 7, 9))
    assert (k2.rate, k12.rate, k7.rate) == (F32_FLOP_PER_S, BF16_FLOP_PER_S, F32_FLOP_PER_S)
    assert D.bound(k2)[0] == pytest.approx(1e3 * 3_981_312 / HBM_BYTES_PER_S)
    # with no bytes to move, the f32 operations at the f32 rate set the bound
    assert D.bound(k2._replace(nbytes=0)) == (pytest.approx(1e3 * 50_331_648 / 67e12),
                                              "operations")


def test_full_size_draw_is_exact_and_shows_the_layer():
    """At the files' shapes every dot's sum of |terms| stays below 2^24 (so
    every partial sum in any order is an exact f32 integer), every value is
    bf16-exact, and a body reading another layer moves most outputs."""
    rng = np.random.default_rng(0)
    x, w = D.draw_operands(rng, "k2", 4, 32, 24, 256)
    assert torch.equal(x.to(torch.bfloat16).float(), x) and bool((x == x.round()).all())
    terms = D.dyn_load_dot_plain(x.abs(), w.abs())
    assert float(terms.max()) < 2 ** 24
    out = D.dyn_load_dot_plain(x, w)
    rotated = D.dyn_load_dot_plain(x[[1, 2, 3, 0]], w)
    assert (rotated != out).float().mean() > 0.9
    (x1,) = D.draw_operands(rng, "k1", 4, 32, 24, 256)
    shifted = x1.clone()
    shifted[1] = x1[2]
    assert (D.dyn_load_sum_plain(shifted) != D.dyn_load_sum_plain(x1)).float().mean() > 0.9


@pytest.mark.parametrize("e,w", [(24, 256), (5, 40), (3, 130), (17, 24)])
def test_conv_sum_tiles_cover_every_output_once(e, w):
    """k7's launch rule (``conv_sum_grid`` CTAs, each writing
    ``conv_sum_tile``: one row, 32 columns cut at the image's edge, one half
    of the output channels) writes every element of the ``[C, e, w]``
    output exactly once: 384 CTAs at the file's 24 x 256, at least one on
    each of an H100 SXM's 132 SMs. The tile and the channel half are the
    source's ``CONV_TW`` and ``CONV_CO``."""
    import re
    from pathlib import Path

    src = (Path(D.__file__).resolve().parents[1] / "csrc" / "probe_loop_dyn.cu").read_text()
    assert int(re.search(r"constexpr int CONV_TW = (\d+);", src).group(1)) == D.CONV_TW
    assert re.search(r"constexpr int CONV_CO = C / (\d+);", src).group(1) == str(32 // D.CONV_CO)
    seen = np.zeros((32, e, w), np.int64)
    grid = D.conv_sum_grid(e, w)
    for cta in range(grid):
        row, cols, chans = D.conv_sum_tile(cta, e, w)
        assert len(cols) >= 1
        seen[chans.start:chans.stop, row, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    if (e, w) == (24, 256):
        assert grid == 384 >= 132


def test_load_dot_smem_and_grid():
    """k2's CTA: 32 pixels (192 CTAs at the files' E W = 6144, 4 at a
    ragged 120), 128 bytes of layer barriers and every layer's slab and
    weight rows (3C + 4 words), or the quarters' partial sums at L=1; up to
    13 layers fit a CTA. k12's CTA: 32 pixels as well (192 CTAs, at least
    one on each of the 132 SMs), barriers and the ring's alignment (1152
    bytes), a stage of 8 KB a layer up to 8 (w[l]'s three [C, C] blocks and
    x[l]'s [C, 32] slab) and the four K groups' partial sums (20,480 bytes):
    54,400 bytes at L=4, 87,168 from L=8 on, so any L fits and two CTAs
    share an SM."""
    assert D.load_dot_smem(4, 4) == 128 + 4 * 32 * (32 + 100) * 4
    assert D.load_dot_smem(1, 4) == 128 + 4 * 32 * 36 * 4
    assert D.load_dot_smem(13, 4) <= D.SMEM_LIMIT < D.load_dot_smem(14, 4)
    assert D.load_dot_smem(4, 2) == 54_400
    assert D.load_dot_smem(1, 2) == 1152 + 8192 + 20_480
    assert D.load_dot_smem(8, 2) == D.load_dot_smem(17, 2) == 87_168
    assert 2 * D.load_dot_smem(100, 2) <= D.SMEM_LIMIT
    assert (D.load_dot_grid(6144, 4), D.load_dot_grid(6144, 2), D.load_dot_grid(120, 4),
            D.load_dot_grid(120, 2)) == (192, 192, 4, 4)
    assert (D.load_dot_grid(8, 4), D.load_dot_grid(8, 2), D.load_dot_grid(6176, 2)) == (1, 1, 193)
    assert D.load_dot_grid(6144, 2) >= 132


@pytest.mark.parametrize("layer,tile,grid", [
    (32 * 24 * 256, 512, 384),   # k4 at the files' 6144 pixels: the largest tile
    (32 * 8 * 256, 500, 132),    # k8's window, TH=8: cut for 132 CTAs
    (32 * 120, 256, 15),         # ragged: 120 pixels, the smallest tile
    (32 * 3 * 24, 256, 9),       # k8 at 3 rows of 24 columns
    (32 * 8, 256, 1),            # one 8-pixel row: one CTA
    (32 * 27 * 64, 420, 132),    # k8 at 27 rows of 64: no divisor of the layer
    (32 * 256 * 256, 512, 4096),
], ids=["k4", "k8", "ragged", "k8-window", "floor", "odd-window", "large"])
def test_store_bulk_grid_and_smem(layer, tile, grid):
    """The bulk store's tile (k4, k8): the flattened output layer cut for
    132 CTAs in whole 16-byte pieces, 256 to 512 elements (one piece a
    thread of 128), so k4 at 6144 pixels runs on 384 CTAs and k8 at TH=8 on
    132 (96 and 32 with the fixed 2048 before); every tile a 16-byte
    multiple that covers the layer; a ring of up to 8 stages of it, one a
    layer, within a CTA's shared memory at L = 1, 4, 8 and 9."""
    assert D.store_bulk_tile(layer) == tile and D.store_bulk_grid(layer) == grid
    assert tile % 4 == 0 and (grid - 1) * tile < layer <= grid * tile
    assert [D.store_bulk_smem(n, layer) for n in (1, 4, 8, 9)] == [
        tile * 4, 4 * tile * 4, 8 * tile * 4, 8 * tile * 4]
    assert D.store_bulk_smem(9, layer) <= D.SMEM_LIMIT


def test_probe_cases_run_on_enough_ctas():
    """At the files' shapes k4 and k8 run on at least 128 CTAs and k12 on
    at least 132, each at least one CTA on every SM of an H100 SXM."""
    k4, k8 = (c for c in D.probe_cases("meta") if D.body_of(c) in ("k4", "k8"))
    assert D.store_bulk_grid(k4.args[0][0].numel()) >= 132
    rows = k8.kwargs["rows"]
    assert D.store_bulk_grid(32 * rows * k8.args[0].shape[-1]) >= 128
    assert D.load_dot_grid(24 * 256, 2) >= 132


@pytest.mark.parametrize("body", ["k3", "k4", "k8", "k11", "k12", "k1", "k2", "k5", "k6", "k10"])
def test_floor_args_are_one_cta(body):
    """``floor_args`` gives each body one layer of 8 pixels (k5 its three
    slot layers, k6 an 8-pixel image of p[0], k8 a one-row window of 8, the
    dots with w[0]): one CTA of its kernel, whose time is the launch floor;
    the plain version runs on them."""
    case = next(c for c in D.probe_cases("cpu") if D.body_of(c) == body)
    args, kwargs = D.floor_args(case)
    layers = 3 if body == "k5" else 1
    if body == "k6":
        assert tuple(args[0].shape) == (1, 32, 3) and args[1:] == (1, 8)
    else:
        assert tuple(args[0].shape) == (layers, 32, 1, 8)
    assert all(t.is_contiguous() for t in args if isinstance(t, torch.Tensor))
    if body in ("k3", "k11"):
        assert D.store_grid(8) == 1
    elif body in ("k12", "k2"):
        assert D.load_dot_grid(8, 2) == 1
    elif body in ("k1", "k5", "k6", "k10"):
        assert -(-8 // D.TP) == 1  # load_sum_kernel and narrow_sum_kernel: TP pixels a CTA
    else:
        assert D.store_bulk_grid(32 * kwargs.get("rows", 1) * 8) == 1
    if body in ("k12", "k2"):
        assert tuple(args[1].shape) == (1, 32, 96)
    if body == "k8":
        assert (kwargs["row0"], kwargs["rows"]) == (0, 1)
    out = case.plain(*args, **kwargs)
    assert torch.isfinite(out).all()


def test_bf16_dot_matches_jax_probe_on_normals():
    """k12 on bf16 normals: the JAX body in interpret mode within
    ``loop_dyn.f32_tolerance`` of the port's plain version (every product is
    exact in f32, the sums in another order), and the same function with
    its sums kept in bf16 (each layer's dot rounded to bf16 and added in
    bf16) past it, so the check the card's kernel is held to
    (``chip_smoke.py`` phase ``loopdyn``) tells an f32 accumulation from a
    bf16 one."""
    x, w = D.draw_operands(np.random.default_rng(9), "k12", L, C, E, W, normals=True)
    assert x.dtype == w.dtype == torch.bfloat16
    ref = jax_probe("k12", (x, w))
    out = D.dyn_load_dot(x, w)
    tol = D.f32_tolerance(x, w, out)
    assert np.abs(out.numpy() - ref).max() <= tol
    assert float((D.bf16_sums(x, w) - out).abs().max()) > 10 * tol


def test_store_smem_grid_and_kernel_bytes():
    """k3's and k11's CTA: 32 pixels (192 CTAs at the files' E W = 6144, 4
    at a ragged 120), its ``[L, C, 32]`` slab in the scratch type, up to 56
    f32 layers in a CTA's shared memory; what the kernel reads and writes
    (every layer of x and the output: 3,932,160 bytes, 0.001174 ms at 3.35
    TB/s) against what the function needs (x[0] and the output)."""
    assert (D.store_grid(6144), D.store_grid(120), D.store_grid(8)) == (192, 4, 1)
    assert (D.store_smem(4, 4), D.store_smem(4, 2)) == (16_384, 8_192)
    assert D.store_smem(56, 4) <= D.SMEM_LIMIT < D.store_smem(57, 4)
    assert D.store_kernel_bytes(4, 32, 24, 256) == 3_932_160
    assert round(1e3 * D.store_kernel_bytes(4, 32, 24, 256) / HBM_BYTES_PER_S, 6) == 0.001174
    k3 = D.probe_cases("meta")[2]
    assert k3.nbytes == 2 * 32 * 24 * 256 * 4  # the function: x[0] and the output


def test_store_instantiations_are_gated():
    """Both ``store_kernel`` instantiations the launch can choose (f32 and
    bf16 scratch) are in ``chip_smoke.REDESIGNED``, whose ptxas gate fails on
    a missing one."""
    import re
    from pathlib import Path

    import chip_smoke

    text = (Path(D.__file__).resolve().parents[1] / "csrc" / "probe_loop_dyn.cu").read_text()
    assert sorted(set(re.findall(r"run\(a, store_kernel<(\w+)>", text))) == ["bf", "float"]
    assert {"store_kernel<float>", "store_kernel<__nv_bfloat16>"} <= set(
        chip_smoke.REDESIGNED["probe_loop_dyn"])


def test_redesigned_loop_dyn_kernels_are_gated():
    """k12's ``load_dot_bf16_kernel``, k4's and k8's ``store_bulk_kernel``
    and k7's ``conv_sum_kernel`` (none a template: one instantiation each,
    all launched) are in ``chip_smoke.REDESIGNED`` beside k2's, k3's and
    k11's kernels, so phase ``build`` fails if ptxas reports one missing or
    spilling."""
    import re
    from pathlib import Path

    import chip_smoke

    text = (Path(D.__file__).resolve().parents[1] / "csrc" / "probe_loop_dyn.cu").read_text()
    for kernel in ("load_dot_bf16_kernel", "store_bulk_kernel", "conv_sum_kernel"):
        assert re.search(rf"__global__ void [^;{{}}]*\b{kernel}\(", text)
        assert re.search(rf"run\(a, {kernel},", text)
    assert set(chip_smoke.REDESIGNED["probe_loop_dyn"]) == {
        "load_dot_f32_kernel", "load_dot_bf16_kernel", "store_kernel<float>",
        "store_kernel<__nv_bfloat16>", "store_bulk_kernel", "conv_sum_kernel"}


def test_base_8_draw_is_exact_at_five_layers():
    """At L=5 a 16^l draw can leave f32's exact integers; 8^l keeps every
    dot's sum of |terms| below 2^24 and still moves the output when a layer
    is misread."""
    rng = np.random.default_rng(0)
    x, w = D.draw_operands(rng, "k2", 5, 32, 24, 256, base=8)
    assert float(D.dyn_load_dot_plain(x.abs(), w.abs()).max()) < 2 ** 24
    assert float(x[4].abs().max()) == 4 * 8 ** 4
    out = D.dyn_load_dot_plain(x, w)
    assert (D.dyn_load_dot_plain(x[[1, 2, 3, 4, 0]], w) != out).float().mean() > 0.9


X = torch.zeros(4, 8, 8, 16)


@pytest.mark.parametrize("call,match", [
    (lambda: D.dyn_load_sum(X.to("meta")), "cpu or cuda"),
    (lambda: D.dyn_load_sum(X.to(torch.float16)), "takes x of"),
    (lambda: D.dyn_load_sum(X[0]), r"x \[L, C, E, W\]"),
    (lambda: D.dyn_load_sum(X[:2], slot=True), "slot map"),
    (lambda: D.dyn_load_sum(X.transpose(2, 3)), "contiguous"),
    (lambda: D.dyn_store(X.to(torch.bfloat16)), "takes x of"),
    (lambda: D.dyn_store(X, scratch_dtype=torch.float16), "f32 or bf16 scratch"),
    (lambda: D.dyn_store_bulk(X, out=torch.zeros(4, 8, 8, 8)), "writes out"),
    (lambda: D.dyn_store_bulk(X, out=torch.zeros(4, 8, 8, 16, device="meta")), "one device"),
    (lambda: D.dyn_load_dot(X, torch.zeros(4, 8, 16)), r"w \[L, C, 3C\]"),
    (lambda: D.dyn_load_dot(X, torch.zeros(4, 8, 24, dtype=torch.bfloat16)), r"w \[L, C, 3C\]"),
    (lambda: D.dyn_load_dot(X, torch.zeros(4, 8, 24, device="meta")), "one device"),
    (lambda: D.dyn_narrow_sum(torch.zeros(4, 8, 4), 8, 16), r"p \[L, C, 3\]"),
    (lambda: D.dyn_narrow_sum(torch.zeros(4, 8, 3), 0, 16), r"\[E, W\] >= 1"),
    (lambda: D.dyn_conv_sum(X, torch.zeros(4, 8, 24)), r"w \[L, C, 9C\]"),
    (lambda: D.dyn_conv_sum(X.to(torch.bfloat16), torch.zeros(4, 8, 72)), "takes x of"),
    (lambda: D.dyn_store_window(X, row0=6, rows=4), "outside E=8"),
    (lambda: D.dyn_store_window(X, row0=0, rows=0), "outside E=8"),
], ids=["meta", "dtype", "rank", "slot-layers", "strided", "store-dtype", "scratch-dtype",
        "out-shape", "out-device", "w-shape", "w-dtype", "w-device", "p-shape", "p-image",
        "conv-w-shape", "conv-dtype", "window-rows", "window-empty"])
def test_wrappers_refuse(call, match):
    before = [fn.launches for fn in D.WRAPPERS]
    with pytest.raises(ValueError, match=match):
        call()
    assert [fn.launches for fn in D.WRAPPERS] == before
