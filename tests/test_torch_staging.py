"""The port's staging probes (``evflow_torch.probes.staging``, plain versions
on the CPU) against the JAX probe kernels of ``benchmarks/probe_manual_dma.py``,
``probe_manual_dma2.py`` and ``probe_layer_grid.py`` in interpret mode, on
the same numpy-made inputs at a small size (row window C=8, H=32, W=16,
TH=8; layer grid C=8, E=12, W=16, L=5).

The probe files run their whole benchmark when imported, so each is parsed
and only its imports and ``def``s are executed, with its size constants
rebound (``tests/_torch_port.py::probe_namespace``); the derived
``E`` is passed too, since module-level assignments are not executed.

Tolerances: the row window is a copy and a x2, so equal; the layer grid
within 1e-6 of max |out| (the JAX kernel sums in f32, the plain version in
float64, rounded once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import probe_namespace
from evflow_torch.probes import staging as S

RC, RH, RW, RTH = 8, 32, 16, 8          # row window
LC, LE, LW, LL = 8, 12, 16, 5           # layer grid


def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32).to(torch.bfloat16)


def row_input(halo, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal((1, RC, RH + 2 * halo, RW), dtype=np.float32)
    return bf16(a) if dtype == torch.bfloat16 else torch.tensor(a)


def jax_of(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # bf16 values: exact
    return jnp.asarray(t.numpy())


def test_row_window_matches_jax_probe_manual_dma():
    halo = S.HALO_DMA
    ns = probe_namespace("probe_manual_dma", C=RC, H=RH, W=RW, TH=RTH, HALO=halo,
                         E=RTH + 2 * halo)
    x = row_input(halo, torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ns["run"](jax_of(x)))
    out = S.row_window_copy(x, RTH, halo)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_window_matches_jax_probe_manual_dma2(dtype):
    halo = S.HALO_DMA2
    ns = probe_namespace("probe_manual_dma2", C=RC, H=RH, W=RW, TH=RTH, HALO=halo,
                         E=RTH + 2 * halo)
    x = row_input(halo, dtype, seed=1)
    run = ns["make_run"](jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(run(jax_of(x)))
    out = S.row_window_copy(x, RTH, halo)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_layer_grid_matches_jax_probe_layer_grid():
    ns = probe_namespace("probe_layer_grid", C=LC, K=9 * LC, E=LE, W=LW, L=LL)
    rng = np.random.default_rng(2)
    w_all = bf16(rng.standard_normal((LL, LC, 9 * LC), dtype=np.float32) * np.float32(0.05))
    m = bf16(rng.standard_normal((LL, LC, LE + 8, LW), dtype=np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ns["run"](jax_of(w_all), jax_of(m)))
    out = S.layer_grid(w_all, m, LE)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (1, LC, LE - 2, LW)
    err = np.abs(out.double().numpy() - ref.astype(np.float64))
    assert float(err.max()) <= 1e-6 * float(np.abs(ref).max()), float(err.max())


def test_staging_cases_follow_the_files():
    """The cases carry the JAX files' shapes; what each function needs (the
    row window's interior read once and its f32 output written; the layer
    grid's even layers, its 9 repeats folded), which sets the bound; and
    what each probe stages and issues (every tile's E-row window; K8e's 9
    repeats on every layer)."""
    cases = S.probe_cases("meta")
    assert len(cases) == 5
    assert [tuple(c.args[0].shape) for c in cases[:4]] == [
        (1, 32, 76, 256), (1, 32, 80, 256), (1, 32, 80, 256), (1, 32, 2060, 256)]
    assert [c.args[0].dtype for c in cases[:4]] == [torch.bfloat16, torch.float32,
                                                   torch.bfloat16, torch.bfloat16]
    assert [c.staged_bytes for c in cases[:4]] == [3_932_160, 6_291_456, 4_194_304, 125_829_120]
    assert [c.nbytes for c in cases[:4]] == [3_145_728, 4_194_304, 3_145_728, 100_663_296]
    w_all, m = cases[4].args
    assert tuple(w_all.shape) == (7, 32, 288) and tuple(m.shape) == (7, 32, 40, 256)
    assert cases[4].issued_flops == 990_904_320 and cases[4].staged_bytes == 3_078_144
    assert cases[4].flops == 62_914_560 and cases[4].nbytes == 3_022_848
    assert [S.bound(c)[1] for c in cases] == ["bytes"] * 5
    assert S.bound(cases[3])[0] == pytest.approx(100_663_296 / 3.35e9)
    assert all(c.fn.launches == 0 for c in cases)  # building cases launches nothing


def test_halo_sums_plain_adds_the_halo_rows():
    """``halo_sums_plain`` against a loop over tiles and channels: the sum
    mod 2^32 of the 32-bit words of each window's top and bottom halo rows;
    the CPU wrapper returns them beside the plain output."""
    halo = S.HALO_DMA
    for dtype in (torch.float32, torch.bfloat16):
        x = row_input(halo, dtype, seed=3)
        out, sums = S.row_window_copy(x, RTH, halo, halo_sums=True)
        assert torch.equal(out, S.row_window_copy_plain(x, RTH, halo))
        words = x[0].view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
        want = np.zeros((RC, RH // RTH), np.int64)
        for c in range(RC):
            for i in range(RH // RTH):
                r0 = i * RTH
                rows = list(range(r0, r0 + halo)) + list(range(r0 + halo + RTH, r0 + RTH + 2 * halo))
                want[c, i] = int(words[c, rows].sum()) % 2 ** 32
        assert sums.dtype == torch.int64 and np.array_equal(sums.numpy(), want)
        inner = x[:, :, halo:halo + RH].contiguous()  # no halo rows: every sum 0
        assert torch.equal(S.halo_sums_plain(inner, RTH, 0),
                           torch.zeros(RC, RH // RTH, dtype=torch.int64))


def test_channels_per_cta_fits_shared_memory():
    """On an H100 SXM's 132 SMs: one channel per CTA at the probes' shapes
    (4 tiles x 32 channels are 128 CTAs, under a CTA per SM); the large case
    bundles as many 28-row bf16 windows as fit the 48 KB budget; fewer SMs
    bundle more; a window beyond shared memory raises."""
    win, sms = 28 * 256 * 2, 132
    assert S.channels_per_cta(32, 4, 28, 256, 2, sms) == 1
    assert S.channels_per_cta(32, 4, 32, 256, 4, sms) == 1
    cpc = S.channels_per_cta(32, 128, 28, 256, 2, sms)
    assert cpc == 3 and cpc * win <= S.ROW_BUDGET and S.HEADER + cpc * win <= S.SMEM_LIMIT
    assert S.channels_per_cta(32, 4, 28, 256, 2, 64) == 2
    assert S.channels_per_cta(12, 56, 20, 24, 2, sms) == 5  # ragged last group (5, 5, 2)
    assert S.channels_per_cta(32, 128, 32, 1024, 4, sms) == 1  # 128 KB: over the budget, fits
    with pytest.raises(ValueError, match="shared memory"):
        S.channels_per_cta(32, 128, 32, 2048, 4, sms)  # 256 KB


ROW = dict(x=torch.zeros(1, 8, 44, 16, dtype=torch.bfloat16), th=8, halo=6)


@pytest.mark.parametrize("bad,match", [
    (dict(x=ROW["x"].to("meta")), "cpu or cuda"),
    (dict(x=ROW["x"].half()), "bf16 or f32"),
    (dict(th=12), "multiple of th"),
    (dict(x=torch.zeros(1, 8, 44, 12, dtype=torch.bfloat16)), "16 bytes"),
    (dict(x=torch.zeros(1, 8, 44, 6, dtype=torch.float32)), "16 bytes"),
    (dict(x=torch.zeros(2, 8, 44, 16, dtype=torch.bfloat16)), r"\[1, C"),
], ids=["meta", "dtype", "th", "bf16-row", "f32-row", "batch"])
def test_row_window_refuses(bad, match):
    kw = dict(ROW, **bad)
    before = S.row_window_copy.launches
    with pytest.raises(ValueError, match=match):
        S.row_window_copy(kw["x"], kw["th"], kw["halo"])
    assert S.row_window_copy.launches == before


LG = dict(w=torch.zeros(3, 8, 72, dtype=torch.bfloat16),
          m=torch.zeros(3, 8, 20, 16, dtype=torch.bfloat16), e=12)


@pytest.mark.parametrize("bad,match", [
    (dict(w=LG["w"].to("meta"), m=LG["m"].to("meta")), "cpu or cuda"),
    (dict(m=LG["m"].float()), "bf16"),
    (dict(m=torch.zeros(3, 8, 20, 12, dtype=torch.bfloat16)), "16 bytes"),
    (dict(w=torch.zeros(3, 8, 64, dtype=torch.bfloat16)), "at E="),
    (dict(e=21), "at E="),
], ids=["meta", "dtype", "row", "k", "extent"])
def test_layer_grid_refuses(bad, match):
    kw = dict(LG, **bad)
    with pytest.raises(ValueError, match=match):
        S.layer_grid(kw["w"], kw["m"], kw["e"])


def test_layer_grid_plan_fits_shared_memory():
    """The layer grid's launch choices (``layer_grid_plan``, mirrored from
    ``launch_layer_grid``): for every C <= 64 and L up to 40 the ring, its
    barriers and its alignment fit a CTA's shared memory, with as many
    stages as L, 8 and the memory allow, each a whole number of 1024-byte
    swizzle blocks, and stage 0 holds the K groups' partial sums; all 7 of
    the probe's layers at C=32 (5 weight boxes a stage), 4 stages at C=48,
    2 at C=64 (9 boxes)."""
    for c in range(1, S.LG_MAX_C + 1):
        mf = -(-c // 16)
        for layers in range(1, 41):
            plan = S.layer_grid_plan(c, layers, 7680)
            fit = (S.SMEM_LIMIT - S.LG_HEADER) // plan["stage"]
            assert plan["depth"] == max(1, min(layers, S.LG_MAX_DEPTH, fit))
            assert plan["smem"] == S.LG_HEADER + plan["depth"] * plan["stage"] <= S.SMEM_LIMIT
            assert 4 * 32 * mf * 8 * 4 <= plan["stage"]  # 4 quarters' f32 partial sums
            assert plan["stage"] % 1024 == 0
    assert S.layer_grid_plan(32, 7, 7680) == {"grid": 120, "depth": 7, "smem": 173_184,
                                              "stage": 24_576}
    assert [S.layer_grid_plan(c, 9, 240)["depth"] for c in (12, 16, 32, 48, 64)] == [8, 8, 8, 4, 2]
    assert S.layer_grid_plan(64, 9, 240) == {"grid": 4, "depth": 2, "smem": 164_992,
                                             "stage": 81_920}


def test_layer_grid_instantiations_are_gated():
    """Every ``layer_grid_kernel<MF>`` the entry point can launch is in
    ``chip_smoke.REDESIGNED``, whose ptxas gate fails on a missing one."""
    import re
    from pathlib import Path

    import chip_smoke

    text = (Path(S.__file__).resolve().parents[1] / "csrc" / "probe_staging.cu").read_text()
    launched = sorted(set(re.findall(r"launch_layer_grid<(\d)>\(\*a, s\)", text)))
    assert launched == ["1", "2", "3", "4"]
    assert chip_smoke.REDESIGNED["probe_staging"] == tuple(
        f"layer_grid_kernel<{mf}>" for mf in launched)


def test_staging_slope_fit_and_refusal(capsys):
    """``staging_slope.fit`` recovers a line's slope and intercept; its
    entry point measures the card only and refuses here, with no output."""
    from evflow_torch.probes import staging_slope

    slope, intercept = staging_slope.fit([1, 3, 5, 7], [0.004 + 0.0025 * n for n in (1, 3, 5, 7)])
    assert slope == pytest.approx(0.0025) and intercept == pytest.approx(0.004)
    assert staging_slope.LAYERS == (1, 3, 5, 7)
    assert staging_slope.main([]) == 1
    assert capsys.readouterr().out == ""


def test_row_window_floor_args_are_one_cta():
    """``floor_args`` gives a row-window case one channel and one tile of th
    rows with its halo: one CTA, whose time is the launch floor; the plain
    version runs on it."""
    for case in S.probe_cases("cpu"):
        if case.fn is not S.row_window_copy:
            continue
        (x,), kwargs = S.floor_args(case)
        th, halo = kwargs["th"], kwargs["halo"]
        assert tuple(x.shape) == (1, 1, th + 2 * halo, case.args[0].shape[-1])
        assert x.is_contiguous()
        assert S.channels_per_cta(1, 1, th + 2 * halo, x.shape[-1], x.element_size(), 132) == 1
        torch.testing.assert_close(case.plain(x, **kwargs),
                                   case.plain(*case.args, **kwargs)[:, :1, :th])
