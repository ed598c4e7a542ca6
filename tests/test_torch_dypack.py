"""The dy-packed convolution (``evflow_torch/ops/dypack.py``) against
``evflow.ops.dypack`` on the CPU, and the settings it brings to the port's
FireNet: ``conv_impl: dypack_int8`` and ``state_dtype: bfloat16`` against the
reference's FireNet (spike agreement > 0.999 per unit, the bar of
``tests/test_pallas.py:114-124``), their refusals in ``FusedFireNet`` and
``train``, and the int8 conv's refused backward.

The int8 conv must equal the reference's bit for bit (an int32 GEMM, then
one bf16 rounding an op, in the same order); the f32 conv that the port's
cells run for ``conv_impl: dypack`` sums the reference's products in
another order: within 4e-6 (8 f32 ulps at |y| < 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import counts, eval_config, model_cfg, seeded_flax_firenet
from evflow.ops import dypack as J
from evflow.registry import build_model as build_jax_model
from evflow_torch.ops import dypack as P
from evflow_torch.registry import build_model
from evflow_torch.weights import from_jax_variables

B, H, W, C = 2, 16, 16, 8


def oihw(k):
    return torch.tensor(np.transpose(k, (3, 2, 0, 1)))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return {"cnt": rng.poisson(0.6, (B, H, W, 2)).astype(np.float32),
            "x": rng.poisson(0.6, (B, H, W, C)).astype(np.float32),
            "spk": (rng.random((B, H, W, C)) < 0.3).astype(np.float32),
            "k_head": rng.uniform(-0.7, 0.7, (3, 3, 2, C)).astype(np.float32),
            "k_ff": rng.uniform(-0.35, 0.35, (3, 3, C, C)).astype(np.float32),
            "k_rec": rng.uniform(-0.2, 0.2, (3, 3, C, C)).astype(np.float32)}


def test_pack_kernel_dy_is_the_reference_packing_of_oihw(arrays):
    """``W'[(dx, ci), (dy, co)] = w[co, ci, dy, dx]``: the reference's
    packing of the HWIO kernel."""
    for k in (arrays["k_head"], arrays["k_ff"]):
        ref = np.asarray(J.pack_kernel_dy(jnp.asarray(k)))
        assert np.array_equal(P.pack_kernel_dy(oihw(k)).numpy(), ref)
    with pytest.raises(ValueError, match="3x3"):
        P.pack_kernel_dy(torch.zeros(4, 2, 1, 1))


def test_cols_and_epilogue_equal_reference(arrays):
    x, s = arrays["x"], arrays["spk"]
    assert np.array_equal(P.cols_dx(torch.tensor(x)).numpy(),
                          np.asarray(J.cols_dx(jnp.asarray(x))))
    assert np.array_equal(P.cols_dx_dual(torch.tensor(x), torch.tensor(s)).numpy(),
                          np.asarray(J.cols_dx_dual(jnp.asarray(x), jnp.asarray(s))))
    Z = np.random.default_rng(1).normal(size=(B, H, W, 3 * C)).astype(np.float32)
    assert np.array_equal(P.dy_epilogue(torch.tensor(Z), H, C).numpy(),
                          np.asarray(J.dy_epilogue(jnp.asarray(Z), H, C)))


@pytest.mark.parametrize("case", ["head", "ff"])
def test_conv3x3_dypack_int8_is_bit_equal(arrays, case):
    x, k = (arrays["cnt"], arrays["k_head"]) if case == "head" else (arrays["x"], arrays["k_ff"])
    ref = np.asarray(J.conv3x3_dypack(jnp.asarray(x), jnp.asarray(k), int8=True))
    got = P.conv3x3_dypack(torch.tensor(x), oihw(k))
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    assert np.array_equal(got.float().numpy(), ref.astype(np.float32))


def test_conv3x3_dypack_dual_int8_is_bit_equal(arrays):
    args = [arrays[k] for k in ("x", "spk", "k_ff", "k_rec")]
    ref = np.asarray(J.conv3x3_dypack_dual(*map(jnp.asarray, args), int8=True))
    got = P.conv3x3_dypack_dual(torch.tensor(args[0]), torch.tensor(args[1]), oihw(args[2]),
                                oihw(args[3]))
    assert np.array_equal(got.float().numpy(), ref.astype(np.float32))


def test_conv3x3_dypack_f32_matches_reference(arrays):
    """The reference's float branch (``conv_impl: dypack``) against the conv
    the port's cells run for that setting (``conv_nhwc``): the same
    products, summed in another order (4e-6); the recurrent cell's ff + rec
    against the reference's dual GEMM."""
    from evflow_torch.models.cells import cell_conv

    def conv(k):
        c = torch.nn.Conv2d(k.shape[2], k.shape[3], 3, padding=1, bias=False)
        c.weight.data = oihw(k)
        return c

    x, k = arrays["x"], arrays["k_ff"]
    ref = np.asarray(J.conv3x3_dypack(jnp.asarray(x), jnp.asarray(k)))
    with torch.no_grad():
        got = cell_conv(torch.tensor(x), conv(k), None, "dypack")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4e-6)
    args = [arrays[k] for k in ("x", "spk", "k_ff", "k_rec")]
    ref = np.asarray(J.conv3x3_dypack_dual(*map(jnp.asarray, args)))
    with torch.no_grad():
        got = (cell_conv(torch.tensor(args[0]), conv(args[2]), None, "dypack")
               + cell_conv(torch.tensor(args[1]), conv(args[3]), None, "dypack"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=4e-6)


def test_int8_matmul_pads_m_k_and_n_exactly():
    """K = 6 (the head's 3 * num_bins), an N off the multiple of 8 and an M
    off the multiple of 32: the padded GEMM equals the int64 product;
    float operands raise."""
    rng = np.random.default_rng(2)
    a = torch.tensor(rng.integers(-127, 128, (40, 6)), dtype=torch.int8)
    b = torch.tensor(rng.integers(-127, 128, (6, 5)), dtype=torch.int8)
    got = P.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (40, 5)
    assert torch.equal(got.long(), a.long() @ b.long())
    with pytest.raises(TypeError, match="int8"):
        P.int8_matmul(a.float(), b)


def test_int8_conv_backward_raises(arrays):
    """The reference's gradient through the int8 conv reaches only each
    conv's largest weight (through its scale); the port refuses the
    backward instead of computing another gradient."""
    w = oihw(arrays["k_ff"]).requires_grad_(True)
    y = P.conv3x3_dypack(torch.tensor(arrays["x"]), w)
    with pytest.raises(NotImplementedError, match="queue 3"):
        y.float().sum().backward()
    with torch.no_grad():  # no autograd: a plain forward
        assert not P.conv3x3_dypack(torch.tensor(arrays["x"]), w).requires_grad


@pytest.fixture(scope="module")
def weights():
    return {name: seeded_flax_firenet(model_cfg(name), seed=1)[1]
            for name in ("LIFFireNet", "LIFFireFlowNet")}


@pytest.mark.parametrize("name,extra", [
    ("LIFFireNet", {"state_dtype": "bfloat16"}),
    ("LIFFireNet", {"conv_impl": "dypack_int8"}),
    ("LIFFireNet", {"conv_impl": "dypack_int8", "state_dtype": "bfloat16"}),
    ("LIFFireFlowNet", {"conv_impl": "dypack_int8"}),
], ids=["bf16_state", "int8", "int8_bf16_state", "int8_feedforward"])
def test_firenet_forward_matches_reference(weights, name, extra):
    """The unfused FireNet with the setting against the reference's over 6
    windows: spike agreement > 0.999 per unit, flows within 1e-3, the
    state dtypes alike."""
    cfg = model_cfg(name, **extra)
    jm = build_jax_model(cfg)
    v = weights[name]
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(from_jax_variables(v))
    rng = np.random.default_rng(0)
    js, ps = jm.init_states(B, H, W), pm.init_states(B, H, W)
    agree = []
    for _ in range(6):
        x = counts(rng, (B, H, W, 2))
        jo, js = jm.apply(v, None, jnp.asarray(x), js)
        with torch.no_grad():
            po, ps = pm(None, torch.tensor(x), ps)
        agree.append([float(np.mean(np.asarray(a.spk, np.float32) == b.spk.float().numpy()))
                      for a, b in zip(js, ps)])
        np.testing.assert_allclose(po["flow"][0].numpy(), np.asarray(jo["flow"][0]), atol=1e-3)
    assert min(np.mean(agree, axis=0)) > 0.999
    want = torch.bfloat16 if extra.get("state_dtype") else torch.float32
    assert all(s.mem.dtype == want and s.spk.dtype == want for s in ps)
    assert str(np.asarray(js[0].mem).dtype) == str(want).replace("torch.", "")


def test_fused_and_train_refuse_what_they_do_not_compute(tmp_path):
    """``FusedFireNet`` carries f32 membranes through f32 convs: it refuses
    a bf16-state or int8-conv FireNet (the reference's silently computes
    another function), and so does ``evaluate(fused=True)``; ``train``
    refuses bf16 state before any file opens."""
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.train import train

    from evflow_torch.eval import evaluate

    for extra, match in (({"state_dtype": "bfloat16"}, "state_dtype"),
                         ({"conv_impl": "dypack_int8"}, "dypack_int8")):
        model = build_model(model_cfg(**extra), device="cpu")
        with pytest.raises(ValueError, match=match):
            FusedFireNet.from_firenet(model)
        with pytest.raises(ValueError, match=match):
            evaluate(eval_config(str(tmp_path / "none")), model=model, fused=True, device="cpu",
                     debug=True)
    with pytest.raises(ValueError, match="FireNet"):
        FusedFireNet.from_firenet(torch.nn.Linear(2, 2))
    cfg = {"data": {"mode": "events", "path": str(tmp_path / "none")},
           "model": model_cfg(state_dtype="bfloat16"), "loader": {}}
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        train(cfg, path_runs=str(tmp_path), device="cpu")
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError, match="state_dtype"):
        build_model(model_cfg(state_dtype="float16"), device="cpu")
