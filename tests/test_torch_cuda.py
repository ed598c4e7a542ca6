"""The port's CUDA kernels on the card: each against its plain version at
shapes that leave ragged tiles, the launch counters, the fused evaluation
path (with the visualisation's IWE on the card), the IWE functions against
their CPU run, the whole-network kernels (K3, K4, K5, K6, K7) against
``firenet_step_plain``, and the in-kernel dot, staging, unit-loop,
runtime-indexed loop, Mosaic-ops and whole-net bisection probes against
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
@pytest.mark.parametrize("cin,recurrent,hard,C", [
    (2, False, True, 32), (32, False, True, 32), (32, True, True, 32), (32, False, False, 32),
    (8, False, True, 8), (8, True, True, 8), (24, False, True, 24), (24, True, True, 24),
    (48, False, True, 48), (48, True, True, 48)])
def test_kernel_matches_plain_on_ragged_tiles(cuda, layout, cin, recurrent, hard, C):
    """H=20, W=40 at B=2 leave partial tiles (8 x 16 ones: the 16 x 16 grid
    would leave SMs idle): the border masking and the ragged edge are
    exercised, at LIFFireNet's 32 channels and at widths
    the kernel pads to 16 (8), 32 (24) and 48 output channels. mem' within
    1e-4 where spikes agree; spikes differ on at most 1e-5 of the elements
    (f32 sums in another order)."""
    kernel, plain = KERNELS[layout]
    op = operands(cuda, layout, cin, recurrent, C=C)
    before = kernel.launches
    s, m = kernel(**op, hard_reset=hard)
    assert kernel.launches == before + 1
    ps, pm = plain(**op, hard_reset=hard)
    torch.cuda.synchronize()
    agree = s == ps
    assert (~agree).float().mean() <= 1e-5
    assert float((m - pm).abs()[agree].max()) <= 1e-4


@pytest.mark.parametrize("layout", sorted(KERNELS))
@pytest.mark.parametrize("B,H,W,C,recurrent", [(1, 17, 33, 32, True), (2, 20, 40, 24, False),
                                                (3, 9, 50, 8, True), (1, 128, 128, 32, False),
                                                (2, 33, 7, 48, True), (3, 100, 190, 24, True),
                                                (2, 130, 140, 32, False),
                                                (2, 130, 140, 8, False), (2, 130, 140, 48, True),
                                                (2, 130, 140, 56, True), (2, 130, 140, 64, False),
                                                (2, 130, 140, 5, True), (2, 130, 140, 33, False)])
def test_kernel_writes_every_element(cuda, layout, B, H, W, C, recurrent):
    """Launched through its entry point into NaN-filled spk and mem', the
    kernel writes every element of both, equal to what the wrapper returns
    and to the plain version (test_kernel_matches_plain_on_ragged_tiles's
    bars), at ragged H and W: on 8 x 16 tiles where 16 x 16 ones would
    leave SMs idle (the first five), on 16 x 16 tiles (the rest): two tile
    rows a warp at C <= 32 (8 and 5 padded to 16), one at 33..64 (padded
    to 48 and 64, the widest recurrent unit that fits, 56, and a
    feedforward one of 64); odd C stores its channels one by one."""
    from evflow_torch.ops.conv_lif import packed_channels
    from evflow_torch.ops.cuda_build import entry_point

    kernel, plain = KERNELS[layout]
    op = operands(cuda, layout, C, recurrent, B=B, H=H, W=W, C=C)
    spk, mem_out = (torch.full_like(op["mem"], float("nan")) for _ in range(2))
    entry = "conv_lif_cmajor" if layout == "cmajor" else "conv_lif"
    prev = op["prev_spk"]
    err = entry_point(entry)(
        op["x"].data_ptr(), prev.data_ptr() if recurrent else None, op["mem"].data_ptr(),
        op["wk"].data_ptr(), op["bias"].data_ptr(), op["beta"].data_ptr(),
        op["theta"].data_ptr(), spk.data_ptr(), mem_out.data_ptr(), B, H, W, C, C,
        packed_channels(C, C, recurrent), 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    ws, wm = kernel(**op)
    torch.cuda.synchronize()
    assert not spk.isnan().any() and not mem_out.isnan().any()
    assert torch.equal(spk, ws) and torch.equal(mem_out, wm)
    ps, pm = plain(**op)
    agree = spk == ps
    assert (~agree).float().mean() <= 1e-5
    assert float((mem_out - pm).abs()[agree].max()) <= 1e-4


@pytest.mark.parametrize("layout", sorted(KERNELS))
def test_kernel_refuses_what_it_cannot_take(cuda, layout):
    """A wrong dtype, unpacked weights, C = 65 and the recurrent units whose
    shared memory exceeds a CTA's (C = 57..64) raise ``ValueError`` before
    any launch."""
    kernel, _ = KERNELS[layout]
    op = operands(cuda, layout, 32, False)
    before = kernel.launches
    with pytest.raises(ValueError):
        kernel(**dict(op, mem=op["mem"].double()))
    with pytest.raises(ValueError):
        kernel(**dict(op, wk=op["wk"].float()))
    for C, recurrent in ((65, False), (65, True), (57, True), (64, True)):
        with pytest.raises(ValueError, match="channels|bytes"):
            kernel(**operands(cuda, layout, C, recurrent, B=1, H=8, W=8, C=C))
    assert kernel.launches == before


@pytest.mark.parametrize("channels", [8, 24])
def test_fused_evaluate_launches_every_unit(cuda, tmp_path, channels):
    from evflow_torch.data.synthetic import make_dataset
    from evflow_torch.eval import evaluate

    make_dataset(str(tmp_path), num_sequences=2, resolution=(32, 32),
                 events_per_sec=30000, duration=0.4, fmt="npz")
    cfg = {"data": {"path": str(tmp_path), "mode": "gtflow_dt1", "window": 1},
           "model": {"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                     "base_num_channels": channels},
           "loader": {"resolution": [32, 32], "batch_size": 1},
           "metrics": {"name": ["AEE"], "flow_scaling": 128}}
    for layout, kernel in (("nhwc", fused_conv_lif), ("cmajor", fused_conv_lif_cmajor)):
        kernel.launches = 0
        stats = {}
        results = evaluate(cfg, fused=True, layout=layout, debug=True, stats=stats)
        assert kernel.launches == 7 * stats["windows"] > 0
        assert all(np.isfinite(float(v)) for v in results["AEE"].values())


@pytest.fixture(scope="module")
def chunk_set(tmp_path_factory):
    """Two sequences of 20 windows at 64x64, the model at 32x32 (the GT
    kept at 64x64), and seeded 32-channel weights."""
    from evflow_torch.data.synthetic import make_dataset
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    root = str(tmp_path_factory.mktemp("chunk_set"))
    make_dataset(root, num_sequences=2, resolution=(64, 64), events_per_sec=40000,
                 duration=2.0, fmt="npz")
    cfg = {"data": {"path": root, "mode": "gtflow_dt1", "window": 1},
           "model": {"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                     "base_num_channels": 32},
           "loader": {"resolution": [32, 32], "std_resolution": [64, 64],
                      "keep_gt_full_res": True, "batch_size": 1},
           "metrics": {"name": ["AEE", "AAE", "NAAE", "AE_ofMeans"], "flow_scaling": 128}}
    model = build_model(cfg["model"], device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed=0))
    return cfg, model


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
def test_chunk_graph_matches_per_window(chunk_set, layout):
    """chunk=8 as CUDA graph replays (and, at chunk=3, partial chunks at
    every rollover) gives the per-window results bit for bit, and 7
    launches a window counted through the replays; device_metrics is within
    1e-5 of the host metrics."""
    from evflow_torch.eval import evaluate

    cfg, model = chunk_set
    kernel = KERNELS[layout][0]
    runs = {}
    for name, kw in (("window", {}), ("chunk8", dict(chunk=8)), ("chunk3", dict(chunk=3)),
                     ("device", dict(chunk=8, device_metrics=True))):
        kernel.launches = 0
        stats = {}
        runs[name] = evaluate(cfg, model=model, fused=True, layout=layout, debug=True,
                              stats=stats, **kw)
        assert stats["windows"] == 40
        assert kernel.launches == 7 * stats["windows"], name
    assert runs["chunk8"] == runs["window"]
    assert runs["chunk3"] == runs["window"]
    for metric, per_file in runs["window"].items():
        for fname, value in per_file.items():
            np.testing.assert_allclose(float(runs["device"][metric][fname]), float(value),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{metric} {fname}")


def test_chunk_capture_that_cannot_happen_raises(cuda):
    """A body that syncs the host cannot be captured: the chunk raises and
    does not run it eagerly instead."""
    from evflow_torch.chunk import ChunkProgram

    calls = []

    def body(x, carry):
        calls.append(1)
        total = float(x["w"].sum())  # a host sync, which a capture refuses
        return {"out": x["w"] * total}, [c + 1 for c in carry]

    program = ChunkProgram(body, cuda)
    program.stage({"w": [np.ones(3, np.float32)] * 2}, [torch.zeros(4, device=cuda)])
    with pytest.raises(RuntimeError, match="could not be captured"):
        program.run()  # the first chunk runs eagerly, then its capture fails
    assert len(calls) == 2
    torch.cuda.synchronize()


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


def random_wholenet(cuda, mask: str, hard: bool, seed: int, head: int = 16):
    """WholeNetWeights of random units, recurrent where ``mask`` says
    ``T`` (unit 0 feedforward): packed bf16 weights of the kernels' widths
    (``head`` channels for the head, 16 or 32; 32, 64 recurrent), random
    parameters."""
    from evflow_torch.ops.fused_net import WholeNetWeights

    rng = np.random.default_rng(seed)
    rec = tuple(m == "T" for m in mask)
    wk = tuple(torch.tensor(rng.uniform(-1, 1, (32, 9 * ck)) / np.sqrt(9 * ck), device=cuda,
                            dtype=torch.float32).to(torch.bfloat16)
               for ck in (head if l == 0 else (64 if r else 32) for l, r in enumerate(rec)))
    params = np.stack([np.stack([rng.normal(0.2, 0.3, 32), rng.uniform(0, 1, 32),
                                 rng.uniform(0.01, 0.8, 32)]) for _ in rec])
    return WholeNetWeights(
        recurrent=rec, wk=wk, params=torch.tensor(params, dtype=torch.float32, device=cuda),
        pred_w=torch.tensor(rng.normal(0, 0.3, (32, 2)), dtype=torch.float32, device=cuda),
        pred_b=torch.tensor(rng.normal(0, 0.1, 2), dtype=torch.float32, device=cuda),
        hard_reset=hard)


BATCH_CASES = {  # id: (B, H, W, mask, state dtype, hard reset)
    "B1-L1": (1, 17, 40, "F", torch.float32, True),
    "B2-L2": (2, 40, 17, "FT", torch.bfloat16, False),
    "B3-L3": (3, 17, 17, "FTF", torch.float32, False),
    "B8-L4-adjacent": (8, 40, 40, "FTTF", torch.bfloat16, True),
    "B2-L5": (2, 17, 256, "FFTFT", torch.float32, True),
    "B3-L5-short": (3, 40, 40, "FTFTF", torch.bfloat16, False),
    "B2-L5-feedforward": (2, 17, 40, "FFFFF", torch.float32, True),
    "B1-L6": (1, 256, 40, "FTFTFT", torch.bfloat16, False),
    "B8-L7-firenet": (8, 80, 64, "FTFFTFF", torch.bfloat16, True),
    "B2-L7-recurrent": (2, 256, 256, "FTTTTTT", torch.float32, False),
    "B3-L7-feedforward": (3, 40, 17, "FFFFFFF", torch.bfloat16, True),
}
# the item kernels: K7 walks items in persistent CTAs, K5, K4 and K3 launch
# one CTA an item, K6 runs the items a unit at a time in a cooperative grid
# of two CTAs an SM; K4 takes only the unit layouts it compiles
ITEM_KERNELS = {"batch": "fused_net_batch", "loop2": "fused_net_loop2", "loop": "fused_net_loop",
                "fused_net": "fused_net", "lgrid": "fused_net_lgrid"}


def compiled_by_k4(mask):
    from evflow_torch.ops.fused_net_loop import LAYOUTS

    return (len(mask), tuple(l for l, m in enumerate(mask) if m == "T")) in LAYOUTS


@pytest.mark.parametrize("kernel,case", [
    (k, c) for k in ITEM_KERNELS for c, v in BATCH_CASES.items()
    if k != "loop" or compiled_by_k4(v[3])])
def test_batch_writes_every_owned_element(cuda, kernel, case):
    """K7, K5, K4, K3 and K6 launched into NaN-filled membranes, spikes of
    every unit (K5's slot 2, the last feedforward unit's, among them) and
    flow, against ``firenet_step_plain`` under ``check_against_plain``'s
    bar: every element is written (no NaN left) and agrees, at B = 1, 2, 3,
    8, ragged H and W, L = 1..7 units under several recurrent masks (two
    recurrent units in a row; every unit after the head recurrent), both
    state dtypes and both reset modes, with fewer (b, tile) items than SMs
    and more (B=8 at 80x64: 160 items of 16 x 16; B=2 at 256x256: 512). K4
    runs the layouts it compiles; its grid, as K5's and K3's, is a CTA an
    item, K7's one CTA an SM at most, K6's two CTAs an SM at most."""
    from evflow_torch.ops.fused_net_item import item_count

    B, H, W, mask, dtype, hard = BATCH_CASES[case]
    weights = random_wholenet(cuda, mask, hard, seed=len(mask))
    rng = np.random.default_rng(B)
    L = len(mask)
    x = torch.tensor(rng.poisson(0.3, (B, H, W, 2)).astype(np.float32), device=cuda)
    mems = [torch.tensor(rng.normal(0, 0.5, (B, 32, H, W)), device=cuda).to(dtype)
            for _ in range(L)]
    prevs = [torch.tensor(rng.random((B, 32, H, W)) < 0.3, device=cuda).to(dtype) if r else None
             for r in weights.recurrent]
    mem_outs = [torch.full_like(m, float("nan")) for m in mems]
    spk_outs = [torch.full_like(m, float("nan")) for m in mems]
    flow = torch.full((B, H, W, 2), float("nan"), device=cuda)
    launch_wholenet(ITEM_KERNELS[kernel], x, mems, prevs, weights.wk, weights, mem_outs, spk_outs,
                    flow=flow)
    torch.cuda.synchronize()
    items = item_count(B, H, W)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per_sm = {"batch": 1, "lgrid": 2}.get(kernel)
    assert launch_wholenet.grid == (items if per_sm is None else min(items, per_sm * sms))
    pflow, pmems, pspikes = firenet_step_plain(x, mems, prevs, weights)
    for l in range(L):
        assert not bool(mem_outs[l].isnan().any()) and not bool(spk_outs[l].isnan().any()), l
        bad = ((mem_outs[l].float() - pmems[l].float()).abs() > 1e-4) | (spk_outs[l] != pspikes[l])
        assert bad.float().mean() <= 1e-5, (l, int(bad.sum()))
    assert bool(torch.isfinite(flow).all())
    assert ((flow - pflow).abs() > 1e-4).float().mean() <= 1e-5


HEAD32_CASES = {  # id: (B, H, W, Cin, mask, state dtype)
    "2ff-cin32": (2, 40, 17, 32, "FF", torch.bfloat16),
    "L7-firenet-cin20": (2, 48, 40, 20, "FTFFTFF", torch.float32),
    "L7-recurrent-cin32": (1, 40, 40, 32, "FTTTTTT", torch.bfloat16),
    "L3-cin17": (3, 17, 33, 17, "FTF", torch.float32),
}


@pytest.mark.parametrize("case", sorted(HEAD32_CASES))
@pytest.mark.parametrize("kernel", ["fused_net", "loop2", "batch", "lgrid"])
def test_head_of_32_channels(cuda, kernel, case):
    """A head of 17..32 input channels (packed to 32, ``packed_channels``):
    K3, K5, K7 and K6 launched into NaN-filled outputs against
    ``firenet_step_plain`` under ``check_against_plain``'s bar, among the
    nets ``probe_wholenet_bisect4.py``'s two feedforward units at Cin = 32
    and seven units with the event tile (30 x 30 pixels) running into the
    recurrent spike tile, with the first recurrent unit right after the
    head."""
    B, H, W, cin, mask, dtype = HEAD32_CASES[case]
    weights = random_wholenet(cuda, mask, True, seed=cin, head=32)
    rng = np.random.default_rng(cin)
    L = len(mask)
    x = torch.tensor(rng.poisson(0.3, (B, H, W, cin)).astype(np.float32), device=cuda)
    mems = [torch.tensor(rng.normal(0, 0.5, (B, 32, H, W)), device=cuda).to(dtype)
            for _ in range(L)]
    prevs = [torch.tensor(rng.random((B, 32, H, W)) < 0.3, device=cuda).to(dtype) if r else None
             for r in weights.recurrent]
    mem_outs = [torch.full_like(m, float("nan")) for m in mems]
    spk_outs = [torch.full_like(m, float("nan")) for m in mems]
    flow = torch.full((B, H, W, 2), float("nan"), device=cuda)
    launch_wholenet(ITEM_KERNELS[kernel], x, mems, prevs, weights.wk, weights, mem_outs, spk_outs,
                    flow=flow)
    torch.cuda.synchronize()
    pflow, pmems, pspikes = firenet_step_plain(x, mems, prevs, weights)
    for l in range(L):
        bad = ((mem_outs[l].float() - pmems[l].float()).abs() > 1e-4) | (spk_outs[l] != pspikes[l])
        assert not bool(mem_outs[l].isnan().any()) and bad.float().mean() <= 1e-5, l
    assert bool(torch.isfinite(flow).all())
    assert ((flow - pflow).abs() > 1e-4).float().mean() <= 1e-5
    assert 0.02 < float(pspikes[0].float().mean()) < 0.98  # the head fires, not everywhere


def test_lgrid_grid_fills_the_card(cuda):
    """K6 at B=2, 256x256: more (b, 16 x 16 tile) items than resident CTAs,
    so the cooperative grid is as large as the card holds at once and each
    CTA walks several items between grid barriers."""
    runner = LayerGridFireNet(seeded_fused(cuda), torch.float32)
    check_against_plain(runner, fused_firenet_step_lgrid, cuda, B=2, H=256, W=256, windows=2)
    items = 2 * (256 // 16) * (256 // 16)
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
    wide = random_wholenet(cuda, "FTFFTFF", True, seed=0, head=32)
    with pytest.raises(ValueError, match="head of 16"):
        fused_firenet_step_loop(torch.zeros(1, 16, 16, 32, device=cuda), mems, slots, w, wide)
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


def nan_block(shape, dtype, device):
    """The address of a freed block of ``shape`` filled with NaN (int32: its
    most negative value). With no allocation in between, the caching
    allocator hands the same block to the next tensor of that size: a
    kernel that leaves an output element unwritten shows it."""
    fill = float("nan") if dtype.is_floating_point else -2 ** 31
    buf = torch.full(shape, fill, dtype=dtype, device=device)
    ptr = buf.data_ptr()
    del buf
    return ptr


def probe_mode(P, case):
    if case.int8:
        return P.S8
    return P.BF16_ACC if case.kwargs.get("acc_dtype") == torch.bfloat16 else P.F32_ACC


@pytest.mark.parametrize("steps", [1, 2, 7, 8, 9])
@pytest.mark.parametrize("np_pixels", [208, 203], ids=["np208", "np203"])
@pytest.mark.parametrize("index", range(PROBES))
def test_probe_matches_plain_at_few_steps(cuda, index, np_pixels, steps):
    """Each probe kernel on both sides of the 8 step groups (S = 1, 2, 7:
    the split-K path for f32 and int8 accumulation; S = 8, 9 and bf16
    accumulation: the resident path), at Np = 208 (no multiple of the
    64-pixel tile: 16-byte copies, the tail zero-filled; dot2's 32768 case
    at 832) and Np = 203 (no multiple of 8: the scalar copies; 812), K=288
    and dot2's K=384 on 16-row tiles, into output memory filled with NaN:
    within ``inkernel_dot.tolerance`` (int8 and bf16 accumulation equal),
    every element written, one launch."""
    from evflow_torch.probes import inkernel_dot as P
    from evflow_torch.probes._harness import compare

    case = P.probe_cases(cuda, seed=index, np_pixels=np_pixels, steps=steps)[index]
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    ptr = nan_block(ref.shape, ref.dtype, cuda)
    before = case.fn.launches
    out = case.fn(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert case.fn.launches == before + 1 and out.data_ptr() == ptr
    # split K below the 8 step groups, never for bf16 accumulation (it rounds each whole dot)
    assert P.last_launch["split_k"] == int(steps < 8 and probe_mode(P, case) != P.BF16_ACC)
    assert P.last_launch["vec"] == int(case.fn is P.dot_pixel_major or np_pixels % 8 == 0)
    k = case.args[1].shape[-1]
    assert P.last_launch["tile_m"] == (16 if k == 384 else 32)
    res = compare(out, ref, P.tolerance(case, ref))
    assert res["ok"], res
    if res["tolerance"] == 0.0:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("index", range(PROBES))
def test_probe_writes_every_output_at_full_size(cuda, index, steps):
    """Each probe kernel at the JAX files' shapes (128 to 1024 CTAs, one or
    several row tiles), at one step (split K where the accumulation allows)
    and at 8 (every step group one step), into output memory filled with
    NaN: within ``inkernel_dot.tolerance``, every element written."""
    from evflow_torch.probes import inkernel_dot as P
    from evflow_torch.probes._harness import compare

    case = P.probe_cases(cuda, seed=index, steps=steps)[index]
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    ptr = nan_block(ref.shape, ref.dtype, cuda)
    out = case.fn(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr and P.last_launch["vec"] == 1
    res = compare(out, ref, P.tolerance(case, ref))
    assert res["ok"], res


@pytest.mark.parametrize("shape", [(32, 288, 32, 256), (32, 288, 3, 25), (16, 384, 2, 40)],
                         ids=["full", "np75", "k384"])
def test_dot3_writes_every_output(cuda, shape):
    """k_dot3 (one step, split K over all 16 warps) at the JAX probe's
    shape, at 75 pixels (no multiple of 8: scalar copies) and at K=384,
    into output memory filled with NaN: within ``mosaic_ops.tolerance``,
    every element written, one launch of its own count."""
    from evflow_torch.probes import mosaic_ops as M
    from evflow_torch.probes._harness import compare

    case = next(c for c in M.probe_cases(cuda, seed=3, shape=shape) if M.body_of(c) == "k_dot3")
    ref = case.plain(*case.args)
    torch.cuda.synchronize()
    ptr = nan_block(ref.shape, ref.dtype, cuda)
    before = M.dot3.launches
    out = case.fn(*case.args)
    torch.cuda.synchronize()
    assert M.dot3.launches == before + 1 and out.data_ptr() == ptr
    _, _, e, w = shape
    assert (M.last_launch["split_k"], M.last_launch["vec"]) == (1, int(e * w % 8 == 0))
    res = compare(out, ref, M.tolerance(case, ref))
    assert res["ok"], res


@pytest.mark.parametrize("draw", ["integers", "normals"])
@pytest.mark.parametrize("image", [(24, 256), (5, 24)], ids=["full", "ragged"])
@pytest.mark.parametrize("layers", [1, 2, 3, 4, 5])
def test_load_dot_f32_across_layer_counts(cuda, layers, image, draw):
    """k2 at L = 1..5 over the JAX probe's E W = 6144 pixels (192 CTAs) and
    a ragged 120 (three 32-pixel tiles and one of 24), into output memory
    filled with NaN: equal on integers scaled base^l (16, and 8 at L=5,
    where 16^4 terms would leave f32's exact integers), and on f32 normals
    within ``loop_dyn.f32_tolerance``, which the plain dot of the same
    operands rounded to TF32 misses."""
    from evflow_torch.probes import loop_dyn as D
    from evflow_torch.probes._harness import compare

    e, w = image
    args = D.draw_operands(np.random.default_rng(layers), "k2", layers, 32, e, w, device=cuda,
                           normals=draw == "normals", base=16 if layers <= 4 else 8)
    ref = D.dyn_load_dot_plain(*args)
    torch.cuda.synchronize()
    ptr = nan_block(ref.shape, ref.dtype, cuda)
    before = D.dyn_load_dot.launches
    out = D.dyn_load_dot(*args)
    torch.cuda.synchronize()
    assert D.dyn_load_dot.launches == before + 1 and out.data_ptr() == ptr
    assert D.last_launch["grid"] == D.load_dot_grid(e * w, 4)
    if draw == "integers":
        assert torch.equal(out, ref)
        assert float((ref != 0).float().mean()) > 0.5
    else:
        tol = D.f32_tolerance(*args, ref)
        res = compare(out, ref, tol)
        assert res["ok"], res
        tf32 = [((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32) for t in args]
        assert not compare(D.dyn_load_dot_plain(*tf32), ref, tol)["ok"]


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
    # no tile fits shared memory: nine [32, 1024] weight slices fit on neither
    # 32 nor 16 rows; the launch, which chooses the tile, refuses on either path
    before = P.dot_variant.launches
    for steps in (1, 64):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            P.dot_variant(torch.zeros(1024, 200, device=cuda, dtype=torch.bfloat16),
                          torch.zeros(9, 32, 1024, device=cuda, dtype=torch.bfloat16),
                          steps=steps)
    assert P.dot_variant.launches == before


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


def layer_grid_operands(cuda, L, C, E, W, seed):
    rng = np.random.default_rng(seed)
    w_all = torch.tensor(rng.standard_normal((L, C, 9 * C), dtype=np.float32) * 0.05,
                         device=cuda).to(torch.bfloat16)
    m = torch.tensor(rng.standard_normal((L, C, E + 8, W), dtype=np.float32),
                     device=cuda).to(torch.bfloat16)
    return w_all, m


def check_layer_grid(w_all, m, E):
    """One launch of the layer grid against its plain version within
    ``staging.tolerance``, with the launch's grid, ring depth and shared
    bytes those of ``staging.layer_grid_plan``; returns the output."""
    from evflow_torch.probes import staging as S
    from evflow_torch.probes._harness import compare

    L, C, _ = w_all.shape
    case = S.Case("ragged", S.layer_grid, S.layer_grid_plain, (w_all, m), {"e": E}, 0, 0.0, 0,
                  0.0, "")
    before = S.layer_grid.launches
    out = S.layer_grid(w_all, m, E)
    assert S.layer_grid.launches == before + 1
    plan = S.layer_grid_plan(C, L, (E - 2) * m.shape[3])
    assert {k: S.last_launch[k] for k in ("grid", "depth", "smem")} == {
        k: plan[k] for k in ("grid", "depth", "smem")}
    ref = S.layer_grid_plain(w_all, m, E)
    torch.cuda.synchronize()
    res = compare(out, ref, S.tolerance(case, ref))
    assert res["ok"], res
    return out


@pytest.mark.parametrize("C", [12, 32, 48, 64])
def test_layer_grid_matches_plain_on_ragged_tiles(cuda, C):
    """The layer-grid kernel against its plain version at (E-2) W = 240
    pixels (3 blocks of 64 and one of 48: 4 CTAs), L=5, at C=12 (padded to
    16 channels, staged element by element), 32, 48 and 64 (one m16
    fragment count each): within ``staging.tolerance``; m's odd layers do
    not reach the output."""
    from evflow_torch.probes import staging as S

    L, E, W = 5, 12, 24
    w_all, m = layer_grid_operands(cuda, L, C, E, W, seed=C)
    out = check_layer_grid(w_all, m, E)
    assert S.last_launch["grid"] == 4
    # the odd layers' zero block: m's odd layers do not reach the output
    m2 = m.clone()
    m2[1::2] = float("nan")
    assert torch.equal(S.layer_grid(w_all, m2, E), out)


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("L", [1, 2, 7, 9])
def test_layer_grid_ring_at_every_depth(cuda, L, C):
    """The layer grid against its plain version at L = 1, 2, 7 and 9 over a
    ragged last block: at C=32 the ring holds every layer up to 8 (9 reuses
    a stage), at C=64 two, so L >= 3 refills stages that the consumers
    release."""
    from evflow_torch.probes import staging as S

    E, W = 7, 40  # 200 pixels: 3 blocks of 64 and one of 8
    w_all, m = layer_grid_operands(cuda, L, C, E, W, seed=100 + L)
    check_layer_grid(w_all, m, E)
    assert S.last_launch["depth"] == min(L, 8 if C == 32 else 2)


@pytest.mark.parametrize("C", [12, 32])
def test_layer_grid_nonfinite_odd_weight_gives_nan(cuda, C):
    """An odd layer's products with the zero block are kept: a non-finite
    weight there (inf times 0) turns its output row to NaN, in the kernel as
    in the plain version, and every other row stays within tolerance."""
    from evflow_torch.probes import staging as S
    from evflow_torch.probes._harness import compare

    L, E, W = 4, 6, 16
    w_all, m = layer_grid_operands(cuda, L, C, E, W, seed=7)
    w_all[1, 3, 5] = float("inf")
    w_all[3, C - 1, 9 * C - 1] = float("nan")
    out = S.layer_grid(w_all, m, E)
    ref = S.layer_grid_plain(w_all, m, E)
    torch.cuda.synchronize()
    nan = torch.isnan(ref)
    assert bool(nan[0, 3].all()) and bool(nan[0, C - 1].all()) and int(nan.sum()) == 2 * (E - 2) * W
    assert torch.equal(torch.isnan(out), nan)
    finite = S.layer_grid_plain(w_all.nan_to_num(posinf=0.0), m, E)
    case = S.Case("nan", S.layer_grid, S.layer_grid_plain, (w_all, m), {"e": E}, 0, 0.0, 0, 0.0,
                  "")
    res = compare(out[~nan], ref[~nan], S.tolerance(case, finite))
    assert res["ok"], res


def test_staging_slope_times_each_layer_count(cuda):
    """``staging_slope.layer_times`` times K8e at each layer count it is
    given and fits a line through the times."""
    from evflow_torch.probes import staging as S
    from evflow_torch.probes.staging_slope import layer_times

    before = S.layer_grid.launches
    rows, line = layer_times(S.layer_grid, layers=(1, 3), iters=2)
    assert [r["L"] for r in rows] == [1, 3] and all(r["ms"] > 0 for r in rows)
    assert line["slope_ms"] == pytest.approx((rows[1]["ms"] - rows[0]["ms"]) / 2)
    assert S.layer_grid.launches > before


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


# (shape, cases): L=10 over E=20 clips every layer's cone at both edges of
# the window; W=264 at TH=7 leaves the last row tile one row (33 x 4 tiles
# of 8 columns by 2 rows). Case 14's integer draw grows by ~24x a layer, so
# at L=10 its sums are not exact in f32: it runs up to L=4.
UNIT_LOOP_SHAPES = [("full", (4, 32, 24, 256, 8), range(4)),
                    ("ragged", (4, 32, 20, 40, 6), range(4)),
                    ("two-layers", (2, 32, 16, 24, 8), range(4)),
                    ("clipped-cone", (10, 32, 20, 48, 4), (0, 2, 3)),
                    ("ragged-rows", (4, 32, 22, 264, 7), range(4))]
UNIT_LOOP_IDS = ("13", "14", "15", "dma")


def unit_loop_layout(U, case, cuda):
    """The launch ``launch_layout`` mirrors for ``case`` on this card."""
    x = case.args[0]
    layers = case.args[1].shape[0] if case.fn is U.unit_loop else case.args[3].shape[0]
    e, w = x.shape[-2:]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return U.launch_layout(layers, e, case.kwargs["th"], w, case.fn is U.unit_loop_dma, sms)


@pytest.mark.parametrize("shape,index", [
    pytest.param(shape, i, id=f"{UNIT_LOOP_IDS[i]}-{name}")
    for name, shape, cases in UNIT_LOOP_SHAPES for i in cases])
def test_unit_loop_matches_plain(cuda, shape, index):
    """Each unit-loop case against its plain version: at the JAX probes'
    shapes, at W=40 with E=20 and TH=6, at L=2 over W=24, at L=10 over E=20
    (every cone clipped at rows 0 and E) and at W=264, TH=7 (a last row tile
    of one row): equal, case 14 too (every sum exact,
    ``unit_loop.tolerance``); one launch each, its grid, threads and shared
    bytes those of ``launch_layout``, and K8j's stored spike slots equal to
    the plain slots."""
    from evflow_torch.probes import unit_loop as U
    from evflow_torch.probes._harness import compare

    case = U.probe_cases(cuda, seed=index, shape=shape)[index]
    before = case.fn.launches
    out = case.fn(*case.args, **case.kwargs)
    assert case.fn.launches == before + 1
    lay = unit_loop_layout(U, case, cuda)
    assert U.last_launch == {k: lay[k] for k in ("grid", "threads", "smem")}
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    res = compare(out, ref, U.tolerance(case, ref))
    assert res["ok"], res
    assert torch.equal(out, ref)
    if case.fn is U.unit_loop_dma:
        out2, slots = case.fn(*case.args, **case.kwargs, spike_slots=True)
        _, ref_slots = case.plain(*case.args, **case.kwargs, spike_slots=True)
        torch.cuda.synchronize()
        assert torch.equal(out2, out) and torch.equal(slots, ref_slots)
        assert 0 < float(ref_slots.float().mean()) < 1


@pytest.mark.parametrize("shape", [(4, 32, 21, 264, 7), (3, 32, 19, 40, 5)],
                         ids=["33x4-tiles", "5x5-tiles"])
@pytest.mark.parametrize("index", range(4), ids=["13", "14", "15", "dma"])
def test_unit_loop_writes_every_element(cuda, shape, index):
    """The kernel's outputs (and K8j's three slots, each written by some
    layer at L >= 3) filled with NaN before the launch, at E and W whose
    tiles are ragged (the last row tile short): every element is written,
    and equal to the plain version's."""
    from evflow_torch.probes import unit_loop as U

    case = U.probe_cases(cuda, seed=index, shape=shape)[index]
    layers, c, e, w, th = shape
    out = torch.full((layers, c, th, w), float("nan"), device=cuda)
    dma = case.fn is U.unit_loop_dma
    slots = torch.full((3, c, th, w), float("nan"), device=cuda, dtype=torch.bfloat16)
    if dma:
        x, mem, spk, wt, p = case.args
        U._launch(x, wt, p, mem, spk, out, slots, True, True, th)
        ref, ref_slots = case.plain(*case.args, **case.kwargs, spike_slots=True)
    else:
        x, wt, p, mem = case.args
        U._launch(x, wt, p, mem, None, out, None, case.kwargs["with_lif"],
                  case.kwargs["dyn_out"], th)
        ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert not bool(out.isnan().any()) and torch.equal(out, ref)
    if dma:
        assert not bool(slots.isnan().any()) and torch.equal(slots, ref_slots)


def test_unit_loop_refuses_what_it_cannot_take(cuda):
    """C other than the kernel's 32, an operand 8 bytes past a 16-byte
    boundary, and operands on two devices are refused before any launch."""
    import numpy as np

    from evflow_torch.probes import unit_loop as U

    rng = np.random.default_rng(0)
    x, w, p, mem = U.draw_operands(rng, 2, 32, 16, 24, device=cuda)
    before = (U.unit_loop.launches, U.unit_loop_dma.launches)
    with pytest.raises(ValueError, match="C=32"):
        U.unit_loop(*U.draw_operands(rng, 2, 16, 16, 24, device=cuda))
    shifted = torch.zeros(x.numel() + 4, device=cuda, dtype=x.dtype)[4:].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        U.unit_loop(shifted, w, p, mem)
    with pytest.raises(ValueError, match="one device"):
        U.unit_loop(x, w, p.cpu(), mem)
    xd, md, sd, wd, pd = U.draw_operands(rng, 2, 32, 16, 24, device=cuda, dma=True)
    with pytest.raises(ValueError, match="one device"):
        U.unit_loop_dma(xd, md, sd.cpu(), wd, pd)
    assert (U.unit_loop.launches, U.unit_loop_dma.launches) == before


@pytest.mark.parametrize("shape", [(4, 32, 24, 256), (4, 32, 5, 24), (3, 32, 5, 24)],
                         ids=["full", "ragged", "three-layers"])
@pytest.mark.parametrize("body", ["k1", "k2", "k3", "k4", "k5", "k10", "k11", "k12"])
def test_loop_dyn_matches_plain(cuda, shape, body):
    """Each runtime-indexed loop body against its plain version: at the JAX
    probes' shapes, and at E W = 120 pixels (a tile of 64 pixels and one of
    56; for k2, k3, k11 and k12 three of 32 and one of 24; for k4 15 tiles
    of 256 elements) with 4 and 3 layers: equal (every sum exact,
    ``loop_dyn.tolerance``), one launch each, on the CTAs of the mirrors
    (``load_dot_grid``, ``store_grid``, ``store_bulk_grid``); k3 and k11
    also with their whole scratch, every layer equal; k4 also into a
    NaN-filled output, every element written."""
    from evflow_torch.probes import loop_dyn as D

    case = next(c for c in D.probe_cases(cuda, seed=1, shape=shape) if D.body_of(c) == body)
    before = case.fn.launches
    out = case.fn(*case.args, **case.kwargs)
    assert case.fn.launches == before + 1
    pixels = shape[2] * shape[3]
    assert D.last_launch["grid"] == (D.load_dot_grid(pixels, case.args[0].element_size())
                                     if body in ("k2", "k12")
                                     else D.store_grid(pixels) if body in ("k3", "k11")
                                     else D.store_bulk_grid(32 * pixels) if body == "k4"
                                     else -(-pixels // 64))
    ref = case.plain(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert float((ref != 0).float().mean()) > 0.5
    if body in ("k3", "k11"):
        out2, scr = case.fn(*case.args, **case.kwargs, scratch=True)
        _, ref_scr = case.plain(*case.args, **case.kwargs, scratch=True)
        torch.cuda.synchronize()
        assert torch.equal(out2, out) and torch.equal(scr, ref_scr)
    if body == "k4":
        filled = torch.full_like(ref, float("nan"))
        assert case.fn(*case.args, out=filled) is filled
        torch.cuda.synchronize()
        assert torch.equal(filled, ref)


@pytest.mark.parametrize("P", [(24, 256), (5, 24)], ids=["full", "ragged"])
@pytest.mark.parametrize("L", [1, 4, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dyn_store_at_every_layer_count(cuda, dtype, L, P):
    """k3 (f32 scratch) and k11 (bf16) at L = 1, 4, 8 and 9 (a second batch
    of loads) over 6144 pixels and over 120 (three CTAs of 32 pixels and one
    of 24): the output and, with ``scratch=True``, every layer of the slab
    equal to the plain version's; the launch's CTAs and shared bytes those
    of ``loop_dyn.store_grid`` and ``store_smem``."""
    from evflow_torch.probes import loop_dyn as D

    E, W = P
    (x,) = D.draw_operands(np.random.default_rng(L), "k11", L, 32, E, W, device=cuda)
    before = D.dyn_store.launches
    out = D.dyn_store(x, scratch_dtype=dtype)
    assert D.dyn_store.launches == before + 1
    assert (D.last_launch["grid"], D.last_launch["smem"]) == (
        D.store_grid(E * W), D.store_smem(L, torch.finfo(dtype).bits // 8))
    out2, scr = D.dyn_store(x, scratch_dtype=dtype, scratch=True)
    ref, ref_scr = D.dyn_store_plain(x, dtype, scratch=True)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out2, ref)
    assert scr.dtype == dtype and torch.equal(scr, ref_scr)


@pytest.mark.parametrize("draw", ["integers", "normals"])
@pytest.mark.parametrize("image", [(24, 256), (5, 24)], ids=["full", "ragged"])
@pytest.mark.parametrize("layers", [1, 4, 8, 9, 17])
def test_dyn_load_dot_bf16_at_every_layer_count(cuda, layers, image, draw):
    """k12 at L = 1, 4, 8 (every stage of the ring used once), 9 and 17
    (the ring comes round once and twice) over 6144 pixels (192 CTAs) and a
    ragged 120 (three CTAs of 32 pixels and one of 24), into output memory
    filled with NaN, on the CTAs and shared bytes of ``loop_dyn.load_dot_grid``
    and ``load_dot_smem``: equal on integers (scaled 16^l up to L=4, 1 from
    L=8, so every sum stays an exact f32 integer), and on bf16 normals
    within ``loop_dyn.f32_tolerance``, which the same dot with its sums kept
    in bf16 misses."""
    from evflow_torch.probes import loop_dyn as D
    from evflow_torch.probes._harness import compare

    e, w = image
    args = D.draw_operands(np.random.default_rng(layers), "k12", layers, 32, e, w, device=cuda,
                           normals=draw == "normals", base=16 if layers <= 4 else 1)
    if draw == "integers":
        assert float(D.dyn_load_dot_plain(*(t.abs() for t in args)).max()) < 2 ** 24
    ref = D.dyn_load_dot_plain(*args)
    torch.cuda.synchronize()
    ptr = nan_block(ref.shape, ref.dtype, cuda)
    before = D.dyn_load_dot.launches
    out = D.dyn_load_dot(*args)
    torch.cuda.synchronize()
    assert D.dyn_load_dot.launches == before + 1 and out.data_ptr() == ptr
    assert (D.last_launch["grid"], D.last_launch["smem"]) == (
        D.load_dot_grid(e * w, 2), D.load_dot_smem(layers, 2))
    if draw == "integers":
        assert torch.equal(out, ref)
        assert float((ref != 0).float().mean()) > 0.5
    else:
        tol = D.f32_tolerance(*args, ref)
        res = compare(out, ref, tol)
        assert res["ok"], res
        assert not compare(D.bf16_sums(*args), ref, tol)["ok"]


@pytest.mark.parametrize("body,image,window", [
    ("k4", (24, 256), None), ("k4", (5, 24), None),
    ("k8", (24, 256), (8, 8)), ("k8", (17, 24), (5, 3)), ("k8", (24, 256), (0, 24)),
    ("k8", (40, 64), (13, 27)),
], ids=["k4-full", "k4-ragged", "k8-full", "k8-ragged", "k8-whole", "k8-odd-window"])
@pytest.mark.parametrize("L", [1, 4, 8, 9])
def test_dyn_store_bulk_at_every_layer_count(cuda, L, body, image, window):
    """The bulk store at L = 1, 4, 8 (every stage of the ring once) and 9
    (the ring comes round): k4 over 6144 pixels (384 CTAs) and a ragged 120
    (15 tiles of 256), each into a NaN-filled output that must be written
    whole; k8 at the JAX probe's window (rows 8..16 of 256 columns, 132
    CTAs), at rows 5..8 of 24, at the whole image and at rows 13..40 of 64
    (a tile that is no divisor of the layer). Every output equal to the
    plain version's, one launch each, on the CTAs and shared bytes of
    ``loop_dyn.store_bulk_grid`` and ``store_bulk_smem``."""
    from evflow_torch.probes import loop_dyn as D

    e, w = image
    (x,) = D.draw_operands(np.random.default_rng(L), "k4", L, 32, e, w, device=cuda)
    if body == "k4":
        ref = D.dyn_store_bulk_plain(x)
        out = torch.full_like(ref, float("nan"))
        before = D.dyn_store_bulk.launches
        assert D.dyn_store_bulk(x, out=out) is out
        assert D.dyn_store_bulk.launches == before + 1
        layer = 32 * e * w
    else:
        row0, rows = window
        ref = D.dyn_store_window_plain(x, row0, rows, 2.0)
        torch.cuda.synchronize()
        ptr = nan_block(ref.shape, ref.dtype, cuda)
        before = D.dyn_store_window.launches
        out = D.dyn_store_window(x, row0=row0, rows=rows, scale=2.0)
        assert D.dyn_store_window.launches == before + 1 and out.data_ptr() == ptr
        layer = 32 * rows * w
    torch.cuda.synchronize()
    assert (D.last_launch["grid"], D.last_launch["smem"]) == (
        D.store_bulk_grid(layer), D.store_bulk_smem(L, layer))
    assert torch.equal(out, ref)
    assert float((ref != 0).float().mean()) > 0.5


def test_loop_dyn_refuses_what_it_cannot_take(cuda):
    """C other than the kernels' 32, E W not a multiple of 8, a k4 output 4
    bytes past a 16-byte boundary, a scratch beyond a CTA's shared memory
    and operands on two devices are refused before any launch; the entry
    point itself refuses the slot map on fewer than 3 layers."""
    from evflow_torch.probes import loop_dyn as D

    rng = np.random.default_rng(0)
    (x,) = D.draw_operands(rng, "k4", 4, 32, 5, 24, device=cuda)
    xd, wd = D.draw_operands(rng, "k2", 4, 32, 5, 24, device=cuda)
    before = [fn.launches for fn in D.WRAPPERS]
    with pytest.raises(ValueError, match="C=32"):
        D.dyn_load_sum(D.draw_operands(rng, "k1", 4, 16, 5, 24, device=cuda)[0])
    with pytest.raises(ValueError, match="multiple of 8"):
        D.dyn_store(D.draw_operands(rng, "k3", 4, 32, 5, 5, device=cuda)[0])
    shifted = torch.empty(x.numel() + 4, device=cuda)[1:1 + x.numel()].view(x.shape)
    with pytest.raises(ValueError, match="aligned"):
        D.dyn_store_bulk(x, out=shifted)
    with pytest.raises(ValueError, match="shared memory"):
        D.dyn_load_sum(torch.zeros(30, 32, 1, 8, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        D.dyn_load_dot(xd, wd.cpu())
    assert [fn.launches for fn in D.WRAPPERS] == before
    with pytest.raises(RuntimeError, match="cudaError_t"):
        D._launch(D.LOAD_SUM, x[:2], torch.empty(x.shape[1:], device=cuda), slot=True)


@pytest.mark.parametrize("body,shape,window,normals", [
    ("k6", (4, 32, 24, 256), None, False), ("k6", (3, 32, 5, 24), None, False),
    ("k7", (4, 32, 24, 256), None, False), ("k7", (3, 32, 5, 40), None, False),
    ("k7", (2, 32, 3, 130), None, False), ("k8", (4, 32, 24, 256), None, False),
    ("k8", (3, 32, 17, 24), (5, 3), False), ("k7", (4, 32, 24, 256), None, True),
    ("k7", (3, 32, 5, 40), None, True), ("k7", (2, 32, 3, 130), None, True),
    ("k2", (4, 32, 24, 256), None, True),
], ids=["k6-full", "k6-ragged", "k7-full", "k7-ragged", "k7-wide", "k8-full", "k8-ragged",
        "k7-full-normals", "k7-ragged-normals", "k7-wide-normals", "k2-full-normals"])
def test_loop_dyn2_matches_plain(cuda, body, shape, window, normals):
    """K8g's bodies against their plain versions, equal (integer operands,
    ``loop_dyn.draw_operands``), one launch each, at the JAX probe's shapes
    and at ragged ones: k6 over E W = 120 pixels (a tile of 64 and one of
    56); k7 over 40 and 130 columns (a part of a 32-column tile) and 5 and
    3 rows (``loop_dyn.conv_sum_grid`` CTAs, one a row, 32 columns and
    channel half); k8 storing rows 5..7 of 24 columns, 9 tiles of 256 elements
    that cross channels (``loop_dyn.store_bulk_grid``). The f32 dots k7 (at
    all three shapes) and k2 also on f32 normals, within
    ``loop_dyn.f32_tolerance``: a dot that rounded its operands to TF32 or
    bf16 would miss it."""
    from evflow_torch.probes import loop_dyn as D
    from evflow_torch.probes._harness import compare

    case = next(c for c in D.probe_cases(cuda, seed=1, shape=shape) if D.body_of(c) == body)
    args = (D.draw_operands(np.random.default_rng(2), body, *shape, device=cuda, normals=True)
            if normals else case.args)
    kwargs = dict(case.kwargs)
    if window is not None:
        kwargs.update(row0=window[0], rows=window[1])
    before = case.fn.launches
    out = case.fn(*args, **kwargs)
    assert case.fn.launches == before + 1
    _, c, e, w = shape
    grid = {"k2": -(-e * w // 32), "k6": -(-e * w // 64), "k7": D.conv_sum_grid(e, w),
            "k8": D.store_bulk_grid(c * kwargs.get("rows", 0) * w)}[body]
    assert D.last_launch["grid"] == grid
    ref = case.plain(*args, **kwargs)
    torch.cuda.synchronize()
    if normals:
        res = compare(out, ref, D.f32_tolerance(*args, ref))
        assert res["ok"], res
    else:
        assert torch.equal(out, ref)
    assert float((ref != 0).float().mean()) > 0.5


def test_loop_dyn2_refuses_what_it_cannot_take(cuda):
    """A k8 window whose first element is off a 16-byte boundary, k6 and k7
    at C other than 32 and operands on two devices are refused before any
    launch; the entry point itself refuses a window past the image."""
    from evflow_torch.probes import loop_dyn as D

    x = torch.zeros(4, 32, 16, 6, device=cuda)
    before = [fn.launches for fn in D.WRAPPERS]
    with pytest.raises(ValueError, match="multiples of 4"):
        D.dyn_store_window(x, row0=1, rows=2)
    with pytest.raises(ValueError, match="C=32"):
        D.dyn_narrow_sum(torch.zeros(4, 16, 3, device=cuda), 8, 8)
    with pytest.raises(ValueError, match="C=32"):
        D.dyn_conv_sum(torch.zeros(4, 16, 5, 8, device=cuda), torch.zeros(4, 16, 144, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        D.dyn_conv_sum(x, torch.zeros(4, 32, 288))
    assert [fn.launches for fn in D.WRAPPERS] == before
    with pytest.raises(RuntimeError, match="cudaError_t"):
        D._launch(D.STORE_BULK, x, torch.empty(4, 32, 1, 6, device=cuda), row0=16, rows=1,
                  scale=2.0)


@pytest.mark.parametrize("shape", [(32, 288, 32, 256), (16, 32, 3, 24)], ids=["full", "ragged"])
@pytest.mark.parametrize("body", ["k_misc", "k_roll", "k_dot3"])
def test_mosaic_ops_matches_plain(cuda, shape, body):
    """K8o's bodies on normal bf16 draws against their plain versions, one
    launch each, at the JAX probe's shapes and at a ragged one (3 rows, a
    part of a CTA, a dot over 72 pixels): k_misc and k_roll equal (each sum
    rounds once alike; k_roll's rounding shows against the f32 sum), k_dot3
    within ``mosaic_ops.tolerance``."""
    from evflow_torch.probes import mosaic_ops as M
    from evflow_torch.probes._harness import compare

    from evflow_torch.probes import inkernel_dot

    case = next(c for c in M.probe_cases(cuda, seed=1, shape=shape) if M.body_of(c) == body)
    before, variant = case.fn.launches, inkernel_dot.dot_variant.launches
    out = case.fn(*case.args)
    # dot3 launches dot_variant's kernel itself: only its own count moves
    assert (case.fn.launches, inkernel_dot.dot_variant.launches) == (before + 1, variant)
    ref = case.plain(*case.args)
    torch.cuda.synchronize()
    res = compare(out, ref, M.tolerance(case, ref))
    assert res["ok"], res
    if body == "k_roll":
        v = case.args[0].float()
        assert float((out != torch.roll(v, 1, 2) + torch.roll(v, 1, 1)).float().mean()) > 0.3


def test_mosaic_ops_refuses_what_it_cannot_take(cuda):
    """W not a multiple of 8 and an operand off a 16-byte boundary are
    refused before any launch; the entry point itself refuses W = 4."""
    from evflow_torch.probes import mosaic_ops as M

    before = [fn.launches for fn in M.WRAPPERS]
    with pytest.raises(ValueError, match="multiple of 8"):
        M.roll_sum(torch.zeros(4, 4, 12, device=cuda, dtype=torch.bfloat16))
    shifted = torch.zeros(4 * 4 * 16 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(4, 4, 16)
    with pytest.raises(ValueError, match="aligned"):
        M.concat_where(shifted)
    assert [fn.launches for fn in M.WRAPPERS] == before
    v = torch.zeros(4, 4, 4, device=cuda, dtype=torch.bfloat16)
    args = M.MosaicArgs(v=v.data_ptr(), out=torch.empty(4, 4, 4, device=cuda).data_ptr(),
                        op=M.ROLL, C=4, E=4, W=4)
    from evflow_torch.probes._harness import launch

    with pytest.raises(RuntimeError, match="cudaError_t"):
        launch("probe_mosaic_ops", args, v.device)


@pytest.mark.parametrize("shape,batch", [((32, 64, 256), None), ((32, 32, 40), None),
                                         ((32, 16, 64), None), ((32, 32, 56), 3)],
                         ids=["full", "ragged", "one_row_tile", "ragged_b3"])
@pytest.mark.parametrize("index", range(11))
def test_wholenet_bisect_matches_plain(cuda, shape, batch, index):
    """Each of K8k-K8n's 11 cases against its plain version, one launch
    each, at the JAX files' shapes; at H=32, W=40 (two row tiles; the
    chain's last column tile of 8 columns); at H=16 (one row tile, which
    writes both border rows); and at H=32, W=56 with B=3 for every case (a
    W that is a multiple of 8 but not of the chain's 16-column tile): every
    output equal on the exact draws, the pred flow within
    ``wholenet_bisect.tolerance``, the launch's grid, threads and shared
    bytes those of ``launch_layout``. The outputs' memory held NaN before
    the call: the kernel writes every element, the zero border rows of o0
    and o1 too."""
    from evflow_torch.probes import wholenet_bisect as M
    from evflow_torch.probes._harness import compare

    case = M.probe_cases(cuda, seed=index, shape=shape, batch=batch)[index]
    body = M.body_of(case)
    refs = M.outputs(case, case.plain(*case.args, **case.kwargs))
    junk = [torch.full_like(t, float("nan")) for t in refs.values()]
    del junk  # the caching allocator hands these blocks to the kernel's outputs
    before = case.fn.launches
    outs = M.outputs(case, case.fn(*case.args, **case.kwargs))
    assert case.fn.launches == before + 1
    b = batch or (1 if body in ("kA", "kB") else 2)
    lay = M.launch_layout(body, b, shape[1], shape[2])
    assert M.last_launch == {k: lay[k] for k in ("grid", "threads", "smem")}
    torch.cuda.synchronize()
    assert list(outs) == list(refs)
    for name, out in outs.items():
        res = compare(out, refs[name], M.tolerance(case, refs[name], name))
        assert res["ok"], (body, name, res)
        assert 0.02 < float((refs[name] != 0).float().mean()), (body, name)


def test_wholenet_bisect_refuses_what_it_cannot_take(cuda):
    """C other than the kernel's 32, W not a multiple of 8, an operand 2
    bytes past a 16-byte boundary and operands on two devices are refused
    before any launch; the entry point itself refuses H not a multiple of
    16. The port's K3 runs
    ``probe_wholenet_bisect4.py``'s Cin = 32 (two feedforward units), held
    against its plain version, and refuses Cin = 33 before any launch."""
    from evflow_torch.ops.fused_net import WholeNetWeights
    from evflow_torch.probes import wholenet_bisect as M
    from evflow_torch.probes._harness import launch

    rng = np.random.default_rng(0)
    before = [fn.launches for fn in M.WRAPPERS]
    with pytest.raises(ValueError, match="C=32"):
        M.bisect_a(*M.draw_operands(rng, "kA", 1, 16, 16, 16, device=cuda))
    for body, fn in (("kA", M.bisect_a), ("kB", M.bisect_b), ("two_where", M.bisect6)):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(*M.draw_operands(rng, body, 1, 32, 16, 36, device=cuda))
    x, w, p = M.draw_operands(rng, "kA", 1, 32, 16, 16, device=cuda)
    shifted = torch.zeros(w.numel() + 1, device=cuda, dtype=w.dtype)[1:].view(w.shape)
    with pytest.raises(ValueError, match="aligned"):
        M.bisect_a(x, shifted, p)
    ops = M.draw_operands(rng, "two_where", 2, 32, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        M.bisect6(ops[0], ops[1].cpu(), *ops[2:])
    assert [fn.launches for fn in M.WRAPPERS] == before
    out = torch.empty(1, 32, 8, 16, device=cuda)
    args = M.BisectArgs(x=x.data_ptr(), w0=w.data_ptr(), p0=p.data_ptr(), out=out.data_ptr(),
                        body=M.KA, B=1, H=8, W=16)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        launch("probe_wholenet_bisect", args, x.device)
    weights = random_wholenet(cuda, "FF", True, seed=32, head=32)
    mems = tuple(torch.tensor(rng.normal(0, 0.5, (2, 32, 24, 40)), dtype=torch.float32,
                              device=cuda) for _ in range(2))
    xw = torch.tensor(rng.normal(0, 1, (2, 24, 40, 32)), dtype=torch.float32, device=cuda)
    before = fused_firenet_step.launches
    flow, m2, _ = fused_firenet_step(xw, mems, (), weights)
    assert fused_firenet_step.launches == before + 1
    pflow, pmems, _ = firenet_step_plain(xw, mems, [None, None], weights)
    torch.cuda.synchronize()
    assert ((flow - pflow).abs() > 1e-4).float().mean() <= 1e-5
    for km, pm in zip(m2, pmems):
        assert ((km - pm).abs() > 1e-4).float().mean() <= 1e-5
    wide = WholeNetWeights(weights.recurrent, (torch.zeros(32, 9 * 48, device=cuda,
                                                           dtype=torch.bfloat16),
                                               weights.wk[1]), *weights[2:])
    with pytest.raises(ValueError, match="Cin <= 32"):
        fused_firenet_step(torch.zeros(2, 24, 40, 33, device=cuda), mems, (), wide)
    assert fused_firenet_step.launches == before + 1


def test_chunk_program_captures_once_per_input_signature(cuda):
    """A new input dtype (the count wire widened to uint16 mid-run) is a new
    signature: its first chunk runs eagerly, then its own capture; the
    carry crosses from one graph's static buffers to the other's."""
    from evflow_torch.chunk import ChunkProgram
    from evflow_torch.eval import _widen

    def body(x, carry):
        w = _widen(x["w"])
        return {"out": w.sum(dim=1)}, [carry[0] + w.sum(dim=(0, 1))]

    program = ChunkProgram(body, cuda)
    carry = [torch.zeros(3, device=cuda)]
    rng = np.random.default_rng(0)
    total = np.zeros(3)
    for dtype, high in [(np.uint8, 255)] * 3 + [(np.int16, 30000)] * 3:
        arrs = [rng.integers(0, high, (2, 3)).astype(dtype) for _ in range(4)]
        program.stage({"w": arrs}, carry)
        out, carry = program.run()
        stacked = np.stack(arrs).astype(np.float64)
        total += stacked.sum(axis=(0, 1))
        np.testing.assert_array_equal(out["out"].cpu().numpy(), stacked.sum(axis=1))
        np.testing.assert_array_equal(carry[0].cpu().numpy(), total)
    assert len(program.graphs) == 2


@pytest.mark.parametrize("round_idx", [True, False])
def test_iwe_on_card_matches_cpu(cuda, round_idx):
    """The IWE functions on the card against the same call on the CPU: the
    gathers, warps, indices and weights equal (elementwise f32, one op at a
    time on both); the splats, whose ``index_add_`` adds in atomic order on
    the card, within 1e-5 a pixel (sums of fewer than 100 weights of at
    most 1), and exact at ``round_idx`` (sums of ones)."""
    from evflow_torch.ops import iwe

    rng = np.random.default_rng(0)
    B, N, H, W = 2, 4000, 24, 32
    ev = np.stack([rng.uniform(0, 1, (B, N)), rng.uniform(0, H, (B, N)),
                   rng.uniform(0, W, (B, N)), rng.choice([-1.0, 1.0], (B, N))], -1)
    host = dict(ev=torch.tensor(ev, dtype=torch.float32),
                fm=torch.tensor(rng.normal(0, 0.03, (B, H, W, 2)), dtype=torch.float32),
                valid=torch.tensor(rng.uniform(size=(B, N)) > 0.1, dtype=torch.float32))
    host["pos"], host["neg"] = (host["ev"][..., 3] > 0).float(), (host["ev"][..., 3] < 0).float()
    card = {k: v.to(cuda) for k, v in host.items()}

    def run(t):
        flow = iwe.lookup_event_flow(t["fm"], t["ev"])
        idx, w = iwe.get_interpolation(t["ev"], flow, 1.0, (H, W), 64.0, round_idx, t["valid"])
        return dict(flow=flow, idx=idx, w=w,
                    deblur=iwe.deblur_events(t["fm"], t["ev"], (H, W), 64.0, round_idx,
                                             t["pos"], t["valid"], tref=0.5),
                    pol=iwe.compute_pol_iwe(t["fm"], t["ev"], (H, W), t["pos"], t["neg"], 64.0,
                                            round_idx, t["valid"]))

    a, b = run(card), run(host)
    for k in ("flow", "idx", "w"):
        assert torch.equal(a[k].cpu(), b[k]), k
    for k in ("deblur", "pol"):
        if round_idx:
            assert torch.equal(a[k].cpu(), b[k]), k
        else:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=0, atol=1e-5)
    assert float(b["pol"].sum()) > 0


@pytest.mark.parametrize("layout", ["nhwc", "cmajor"])
def test_fused_evaluate_collect_vis_matches_cpu(cuda, tmp_path, layout):
    """``evaluate(fused=True, collect_vis=True)`` with the visual config's
    settings on the card, per window (the IWE beside the step) and in
    chunks of 8 (the IWE on the host), against ``device="cpu"`` (the
    kernels' plain versions): the results within 1%, the flows off by
    more than 0.05 on under 2% of the pixels (bf16 operands summed in
    another order can flip a spike), and each window's IWE equal to the
    CPU's IWE of the card's own flow over the window's event list."""
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.data.synthetic import make_dataset
    from evflow_torch.eval import evaluate
    from evflow_torch.ops.iwe import compute_pol_iwe
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    make_dataset(str(tmp_path), num_sequences=2, resolution=(64, 64), events_per_sec=40000,
                 duration=1.2, fmt="npz")
    cfg = {"data": {"path": str(tmp_path), "mode": "gtflow_dt1", "window": 1},
           "model": {"name": "LIFFireFlowNet", "encoding": "cnt", "num_bins": 2,
                     "base_num_channels": 32},
           "loader": {"resolution": [32, 32], "std_resolution": [64, 64], "batch_size": 1},
           "hot_filter": {"enabled": True},
           "metrics": {"name": ["AEE", "AAE"], "flow_scaling": 128},
           "vis": {"store": False}}
    model = build_model(cfg["model"], device="cpu")
    model.load_state_dict(seeded_state_dict(model, seed=0))
    cpu_res, cpu_frames = evaluate(cfg, model=model, fused=True, layout=layout, device="cpu",
                                   debug=True, collect_vis=True)
    stream = H5EventStream(cfg, 2)
    batches = [stream.next_batch() for _ in range(len(cpu_frames))]
    stream.close()
    for chunk in (1, 8):
        res, frames = evaluate(cfg, model=model.to(cuda), fused=True, layout=layout,
                               debug=True, collect_vis=True, chunk=chunk)
        model.to("cpu")
        assert len(frames) == len(cpu_frames) >= 20
        for metric, per_file in cpu_res.items():
            for fname, value in per_file.items():
                np.testing.assert_allclose(float(res[metric][fname]), float(value), rtol=0.01,
                                           err_msg=f"{metric} {fname} chunk {chunk}")
        for f, g, b in zip(frames, cpu_frames, batches):
            assert (np.abs(f["flow"] - g["flow"]) > 0.05).mean() < 0.02
            np.testing.assert_array_equal(f["event_cnt"], g["event_cnt"])
            pm = torch.from_numpy(b["event_list_pol_mask"])
            host_iwe = compute_pol_iwe(torch.from_numpy(f["flow"]),
                                       torch.from_numpy(b["event_list"]), (32, 32),
                                       pm[..., 0], pm[..., 1], flow_scaling=128, round_idx=True,
                                       valid=torch.from_numpy(b["event_valid"]))
            np.testing.assert_array_equal(f["iwe"], host_iwe.numpy())
