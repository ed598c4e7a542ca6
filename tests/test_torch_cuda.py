"""The port's CUDA kernels on the card: each against its plain version at
shapes that leave ragged tiles, the launch counters, the fused evaluation
path, the whole-network kernels (K3, K4, K5, K6, K7) against
``firenet_step_plain``, and the in-kernel dot and staging probes against
theirs.

These tests need a CUDA card and skip without one. They import neither JAX
nor the reference package, so a GPU host with only PyTorch runs them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from evflow_torch.ops.conv_lif import conv_lif_plain, fused_conv_lif, pack_weights
from evflow_torch.ops.conv_lif_cmajor import conv_lif_cmajor_plain, fused_conv_lif_cmajor
from evflow_torch.ops.fused_net import WholeNetFireNet, firenet_step_plain, fused_firenet_step
from evflow_torch.ops.fused_net import launch_wholenet
from evflow_torch.ops.fused_net_batch import BatchFireNet, fused_firenet_step_batch
from evflow_torch.ops.fused_net_lgrid import LayerGridFireNet, fused_firenet_step_lgrid
from evflow_torch.ops.fused_net_loop import UnrolledLoopFireNet, fused_firenet_step_loop
from evflow_torch.ops.fused_net_loop2 import LoopFireNet, fused_firenet_step_loop2

pytestmark = pytest.mark.gpu

KERNELS = {"nhwc": (fused_conv_lif, conv_lif_plain),
           "cmajor": (fused_conv_lif_cmajor, conv_lif_cmajor_plain)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def operands(cuda, layout, cin, recurrent, B=2, H=20, W=40, C=32, seed=0):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=cuda)

    x = t(rng.poisson(0.5, (B, H, W, cin)) if cin == 2 else rng.random((B, H, W, cin)) < 0.3)
    mem = t(rng.normal(0, 0.5, (B, H, W, C)))
    prev = t(rng.random((B, H, W, C)) < 0.3) if recurrent else None
    if layout == "cmajor":
        x, mem = (a.permute(0, 3, 1, 2).contiguous() for a in (x, mem))
        prev = None if prev is None else prev.permute(0, 3, 1, 2).contiguous()
    w = t(rng.uniform(-1, 1, (3, 3, cin, C)) / np.sqrt(cin))
    w_rec = t(rng.uniform(-1, 1, (3, 3, C, C)) / np.sqrt(C)) if recurrent else None
    return dict(x=x, mem=mem, wk=pack_weights(w, w_rec), bias=t(rng.normal(0, 0.3, C)),
                beta=t(rng.uniform(0, 1, C)), theta=t(rng.uniform(0.01, 0.8, C)),
                prev_spk=prev)


@pytest.mark.parametrize("layout", sorted(KERNELS))
@pytest.mark.parametrize("cin,recurrent,hard", [(2, False, True), (32, False, True),
                                                (32, True, True), (32, False, False)])
def test_kernel_matches_plain_on_ragged_tiles(cuda, layout, cin, recurrent, hard):
    """H=20, W=40 leave partial 8x32 tiles: the border masking and the
    ragged edge are exercised. mem' within 1e-4 where spikes agree; spikes
    differ on at most 1e-5 of the elements (f32 sums in another order)."""
    kernel, plain = KERNELS[layout]
    op = operands(cuda, layout, cin, recurrent)
    before = kernel.launches
    s, m = kernel(**op, hard_reset=hard)
    assert kernel.launches == before + 1
    ps, pm = plain(**op, hard_reset=hard)
    torch.cuda.synchronize()
    agree = s == ps
    assert (~agree).float().mean() <= 1e-5
    assert float((m - pm).abs()[agree].max()) <= 1e-4


def test_kernel_refuses_what_it_cannot_take(cuda):
    op = operands(cuda, "nhwc", 32, False)
    with pytest.raises(ValueError):
        fused_conv_lif(**dict(op, mem=op["mem"].double()))
    with pytest.raises(ValueError):
        fused_conv_lif(**dict(op, wk=op["wk"].float()))


def test_fused_evaluate_launches_every_unit(cuda, tmp_path):
    from evflow_torch.data.synthetic import make_dataset
    from evflow_torch.eval import evaluate

    make_dataset(str(tmp_path), num_sequences=2, resolution=(32, 32),
                 events_per_sec=30000, duration=0.4, fmt="npz")
    cfg = {"data": {"path": str(tmp_path), "mode": "gtflow_dt1", "window": 1},
           "model": {"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                     "base_num_channels": 8},
           "loader": {"resolution": [32, 32], "batch_size": 1},
           "metrics": {"name": ["AEE"], "flow_scaling": 128}}
    for layout, kernel in (("nhwc", fused_conv_lif), ("cmajor", fused_conv_lif_cmajor)):
        kernel.launches = 0
        stats = {}
        results = evaluate(cfg, fused=True, layout=layout, stats=stats)
        assert kernel.launches == 7 * stats["windows"] > 0
        assert all(np.isfinite(float(v)) for v in results["AEE"].values())


WHOLENET = {"fused_net": (WholeNetFireNet, fused_firenet_step),
            "loop": (UnrolledLoopFireNet, fused_firenet_step_loop),
            "loop2": (LoopFireNet, fused_firenet_step_loop2),
            "lgrid": (LayerGridFireNet, fused_firenet_step_lgrid),
            "batch": (BatchFireNet, fused_firenet_step_batch)}


def seeded_fused(cuda, C=32):
    """LIFFireNet (C channels, 7 units), seeded weights, folded."""
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    model = build_model({"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                         "base_num_channels": C}, device=cuda)
    model.load_state_dict(seeded_state_dict(model, seed=0))
    return FusedFireNet.from_firenet(model, layout="cmajor")


def check_against_plain(runner, wrapper, cuda, B, H, W, windows=3, seed=0):
    """Run ``windows`` kernel steps; at each, the plain version on the same
    states: membranes within 1e-4 and kept spikes equal on all but 1e-5 of
    the elements, flow within 1e-4 on all but 1e-5 of its elements."""
    rng = np.random.default_rng(seed)
    states = runner.init_states(B, H, W)
    for _ in range(windows):
        x = torch.tensor(rng.poisson(0.3, (B, H, W, 2)).astype(np.float32), device=cuda)
        mems, spikes = runner.unit_states(states)
        prevs = [s if r else None for s, r in zip(spikes, runner.weights.recurrent)]
        pflow, pmems, pspikes = firenet_step_plain(x, mems, prevs, runner.weights)
        before = wrapper.launches
        flow, states = runner.step(x, states)
        assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        kmems, kspikes = runner.unit_states(states)
        for l, (km, pm) in enumerate(zip(kmems, pmems)):
            bad = (km.float() - pm.float()).abs() > 1e-4
            if kspikes[l] is not None:
                bad |= kspikes[l] != pspikes[l]
            assert bad.float().mean() <= 1e-5, (l, int(bad.sum()))
        assert ((flow - pflow).abs() > 1e-4).float().mean() <= 1e-5
        assert bool(torch.isfinite(flow).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(WHOLENET))
def test_wholenet_matches_plain_on_ragged_tiles(cuda, name, dtype):
    """H=20, W=40 is a multiple of no kernel's tile: the image border rows
    and columns (zero at every unit's input) and the ragged tiles are
    exercised, for three windows of recurrent state."""
    cls, wrapper = WHOLENET[name]
    check_against_plain(cls(seeded_fused(cuda), dtype), wrapper, cuda, B=2, H=20, W=40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wholenet_kernels_agree_bitwise(cuda, dtype):
    """The five schedules share the mainloop's k order and the LIF
    epilogue: over three windows at a ragged size their flows and
    membranes are equal."""
    fused = seeded_fused(cuda)
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.poisson(0.3, (2, 20, 40, 2)).astype(np.float32), device=cuda)
          for _ in range(3)]
    runs = {}
    for name, (cls, _) in WHOLENET.items():
        runner = cls(fused, dtype)
        st = runner.init_states(2, 20, 40)
        out = []
        for x in xs:
            flow, st = runner.step(x, st)
            out.append((flow, runner.unit_states(st)[0]))
        runs[name] = out
    ref = runs.pop("fused_net")
    for name, out in runs.items():
        for (flow, mems), (rflow, rmems) in zip(out, ref):
            assert torch.equal(flow, rflow), name
            assert all(torch.equal(m, r) for m, r in zip(mems, rmems)), name


def test_lgrid_grid_fills_the_card(cuda):
    """K6 at B=2, 256x256: more (b, tile) items than resident CTAs, so the
    cooperative grid is as large as the card holds at once and each CTA
    walks several items between grid barriers."""
    runner = LayerGridFireNet(seeded_fused(cuda), torch.float32)
    check_against_plain(runner, fused_firenet_step_lgrid, cuda, B=2, H=256, W=256, windows=2)
    items = 2 * (256 // 8) * (256 // 32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sms <= launch_wholenet.grid < items


def test_wholenet_refuses_what_it_cannot_take(cuda):
    runner = WholeNetFireNet(seeded_fused(cuda), torch.float32)
    mems, spks = runner.init_states(1, 16, 16)
    x = torch.zeros(1, 16, 16, 2, device=cuda)
    with pytest.raises(ValueError):
        fused_firenet_step(x, [m.double() for m in mems], spks, runner.weights)
    with pytest.raises(ValueError):
        fused_firenet_step(x, mems, spks[:1], runner.weights)


def test_unrolled_loop_refuses_what_it_cannot_take(cuda):
    """K4 refuses a state of another dtype, a wrong slot count, operands on
    two devices and a net of another width, before any launch."""
    runner = UnrolledLoopFireNet(seeded_fused(cuda), torch.float32)
    mems, slots = runner.init_states(1, 16, 16)
    x = torch.zeros(1, 16, 16, 2, device=cuda)
    w = runner.w_stack
    before = fused_firenet_step_loop.launches
    with pytest.raises(ValueError):
        fused_firenet_step_loop(x, mems.double(), slots.double(), w, runner.weights)
    with pytest.raises(ValueError):
        fused_firenet_step_loop(x, mems, slots[:1], w, runner.weights)
    with pytest.raises(ValueError):
        fused_firenet_step_loop(x, mems.cpu(), slots.cpu(), w, runner.weights)
    narrow = UnrolledLoopFireNet(seeded_fused(cuda, C=8), torch.float32)
    with pytest.raises(ValueError, match="C=32"):
        narrow.step(x, narrow.init_states(1, 16, 16))
    assert fused_firenet_step_loop.launches == before


PROBES = 4 + 6  # A, B, Bi, C and dot2's six cases


@pytest.mark.parametrize("index", range(PROBES))
def test_probe_matches_plain_on_ragged_tiles(cuda, index):
    """Each probe kernel against its plain version at Np = 200 (800 for
    dot2's 32768 case), no multiple of the 64-pixel CTA tile, over 3 steps:
    within ``inkernel_dot.tolerance`` (int8 and bf16 accumulation exact; an
    f32 accumulation of the bf16 case's operands fails the check)."""
    from evflow_torch.probes import inkernel_dot as P
    from evflow_torch.probes._harness import compare

    case = P.probe_cases(cuda, seed=index, np_pixels=200, steps=3)[index]
    before = case.fn.launches
    out = case.fn(*case.args, **case.kwargs)
    assert case.fn.launches == before + 1
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    res = compare(out, ref, P.tolerance(case, ref))
    assert res["ok"], res
    bf16_acc = case.kwargs.get("acc_dtype") == torch.bfloat16
    if case.int8 or bf16_acc:
        assert torch.equal(out, ref)
    if bf16_acc:
        control = case.fn(*case.args, acc_dtype=torch.float32, steps=3)
        assert not compare(control, ref, P.tolerance(case, ref))["ok"]


def test_probe_refuses_what_it_cannot_take(cuda):
    from evflow_torch.probes import inkernel_dot as P

    x = torch.zeros(288, 200, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(9, 32, 288, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # dtype
        P.dot_channel_major(x.float(), w.float())
    with pytest.raises(ValueError):  # two devices
        P.dot_channel_major(x, w.cpu())
    with pytest.raises(ValueError):  # K not a multiple of 16
        P.dot_channel_major(x[:280].contiguous(), w[..., :280].contiguous())
    with pytest.raises(ValueError):  # no tile fits shared memory
        P.dot_variant(torch.zeros(1024, 200, device=cuda, dtype=torch.bfloat16),
                      torch.zeros(9, 32, 1024, device=cuda, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_window_matches_plain_on_ragged_groups(cuda, dtype):
    """The row-window kernel bit-equal to its plain version at C=12 in
    groups of 5 channels (the last one of 2), W=24, with each CTA staging
    its channels' whole halo'd windows: the sums of the halo rows it read
    from shared memory equal x's."""
    from evflow_torch.probes import staging as S

    C, H, W, th, halo = 12, 448, 24, 8, 6
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, C, H + 2 * halo, W),
                                                              dtype=np.float32),
                     device=cuda).to(dtype)
    before = S.row_window_copy.launches
    out = S.row_window_copy(x, th, halo)
    assert S.row_window_copy.launches == before + 1
    ref = S.row_window_copy_plain(x, th, halo)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    cpc, esize = S.last_launch["cpc"], x.element_size()
    assert cpc == 5 and S.last_launch["grid"] == (H // th) * 3
    assert S.last_launch["smem"] >= cpc * (th + 2 * halo) * W * esize
    out2, sums = S.row_window_copy(x, th, halo, halo_sums=True)
    assert torch.equal(out2, ref) and torch.equal(sums, S.halo_sums_plain(x, th, halo))


@pytest.mark.parametrize("C", [12, 32])
def test_layer_grid_matches_plain_on_ragged_tiles(cuda, C):
    """The layer-grid kernel against its plain version at (E-2) W = 240
    pixels (3 blocks of 64 and one of 48), L=5, C=12 (padded to 16 channels)
    and 32: within ``staging.tolerance``."""
    from evflow_torch.probes import staging as S
    from evflow_torch.probes._harness import compare

    L, E, W = 5, 12, 24
    rng = np.random.default_rng(C)
    w_all = torch.tensor(rng.standard_normal((L, C, 9 * C), dtype=np.float32) * 0.05,
                         device=cuda).to(torch.bfloat16)
    m = torch.tensor(rng.standard_normal((L, C, E + 8, W), dtype=np.float32),
                     device=cuda).to(torch.bfloat16)
    case = S.Case("ragged", S.layer_grid, S.layer_grid_plain, (w_all, m), {"e": E}, 0, 0.0, 0,
                  0.0, "")
    before = S.layer_grid.launches
    out = S.layer_grid(w_all, m, E)
    assert S.layer_grid.launches == before + 1 and S.last_launch["grid"] == 4
    ref = S.layer_grid_plain(w_all, m, E)
    torch.cuda.synchronize()
    res = compare(out, ref, S.tolerance(case, ref))
    assert res["ok"], res
    # the odd layers' zeroed buffer: m's odd layers do not reach the output
    m2 = m.clone()
    m2[1::2] = float("nan")
    assert torch.equal(S.layer_grid(w_all, m2, E), out)


def test_staging_refuses_what_it_cannot_take(cuda):
    from evflow_torch.probes import staging as S

    x = torch.zeros(1, 8, 44, 16, device=cuda, dtype=torch.bfloat16)
    w_all = torch.zeros(3, 8, 72, device=cuda, dtype=torch.bfloat16)
    m = torch.zeros(3, 8, 20, 16, device=cuda, dtype=torch.bfloat16)
    before = (S.row_window_copy.launches, S.layer_grid.launches)
    shifted = torch.zeros(x.numel() + 4, device=cuda, dtype=x.dtype)[4:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):  # 8 bytes past a 16-byte boundary
        S.row_window_copy(shifted, 8, 6)
    with pytest.raises(ValueError):  # two devices
        S.layer_grid(w_all, m.cpu(), 12)
    with pytest.raises(ValueError):  # C beyond the kernel's 64
        S.layer_grid(torch.zeros(1, 72, 648, device=cuda, dtype=torch.bfloat16),
                     torch.zeros(1, 72, 12, 16, device=cuda, dtype=torch.bfloat16), 12)
    assert (S.row_window_copy.launches, S.layer_grid.launches) == before
