"""The port's CUDA kernels on the card: each against its plain version at
shapes that leave ragged tiles, the launch counters, the fused evaluation
path, and the whole-network kernels (K3, K5, K6, K7) against
``firenet_step_plain``.

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
            "loop2": (LoopFireNet, fused_firenet_step_loop2),
            "lgrid": (LayerGridFireNet, fused_firenet_step_lgrid),
            "batch": (BatchFireNet, fused_firenet_step_batch)}


def seeded_fused(cuda):
    """Full-width LIFFireNet (32 channels, 7 units), seeded weights, folded."""
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    model = build_model({"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                         "base_num_channels": 32}, device=cuda)
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
    """The four schedules share the mainloop's k order and the LIF
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
