"""The port's CUDA kernels on the card: each against its plain version at
shapes that leave ragged tiles, the launch counters, and the fused
evaluation path.

These tests need a CUDA card and skip without one. They import neither JAX
nor the reference package, so a GPU host with only PyTorch runs them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from evflow_torch.ops.conv_lif import conv_lif_plain, fused_conv_lif, pack_weights
from evflow_torch.ops.conv_lif_cmajor import conv_lif_cmajor_plain, fused_conv_lif_cmajor

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
