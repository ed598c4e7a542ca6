"""The port's whole-net bisection probes (``evflow_torch.probes.wholenet_bisect``,
plain versions on the CPU) against the JAX probe kernels of
``benchmarks/probe_wholenet_bisect.py`` (K8k ``runA``, ``runB``),
``probe_wholenet_bisect3.py`` (K8l), ``bisect5.py`` (K8m) and ``bisect6.py``
(K8n) in interpret mode, on the same numpy-made operands at a small size
(C = Cin = 8, H = 32, W = 16, TH = 16, E = 32, Hp = 64; B = 1 for K8k, 2
for the chain).

The probe files run their cases when imported, so each is parsed and only
its imports and ``def``s are executed, with its size constants and the
derived E, Hp and Cin bound (``tests/_torch_port.py::probe_namespace``);
each file's own ``runA``, ``runB`` or ``build(...)`` makes the
``pallas_call``.

Tolerance: equality, on operands that make every sum exact
(``wholenet_bisect.draw_operands``), but for K8m's pred-head flow, which
is held within ``wholenet_bisect.tolerance`` (two tanh implementations
differ by an ulp). The TPU kernels leave rows [0, TH) and [TH + H, Hp) of
o0 and o1 unwritten, and interpret mode fills them with NaN
(``test_reference_leaves_unwritten_rows_nan_in_interpret_mode``), so o0
and o1 are compared on rows [TH, TH + H); the port writes zeros there.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import ROOT, probe_namespace
from evflow_torch.probes import wholenet_bisect as M

C, H, W, TH = 8, 32, 16, 16
E, HP = TH + 16, H + 2 * TH
SIZES = dict(B=M.B_CHAIN, C=C, Cin=C, H=H, W=W, TH=TH, E=E, Hp=HP)
CHAIN = [body for body in M.BODIES if body not in ("kA", "kB")]


def jax_of(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # bf16 values: exact
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def cases():
    """The 11 cases at the small size, by body, operands from seed 0."""
    return {M.body_of(c): c for c in M.probe_cases("cpu", seed=0, shape=(C, H, W))}


@pytest.fixture(scope="module")
def jax_out(cases):
    """The JAX probe's outputs (numpy f32) of a body, by output name,
    computed once per body in interpret mode."""
    memo = {}

    def run(body):
        if body not in memo:
            case = cases[body]
            with pltpu.force_tpu_interpret_mode():
                if body in ("kA", "kB"):
                    ns = probe_namespace("probe_wholenet_bisect", **SIZES)
                    out = (ns["runA" if body == "kA" else "runB"](*map(jax_of, case.args)),)
                else:
                    ns = probe_namespace(f"probe_wholenet_{case.fn.__name__}", **SIZES)
                    out = ns["build"](*case.kwargs.values())(*map(jax_of, case.args))
            names = ("out",) if body in ("kA", "kB") else ("o0", "o1", "flow")
            memo[body] = {k: np.asarray(o, np.float32) for k, o in zip(names, out)}
        return memo[body]

    return run


@pytest.mark.parametrize("body", list(M.BODIES), ids=lambda b: b.replace(" + ", "-"))
def test_case_matches_jax_probe(cases, jax_out, body):
    """Each of the 11 cases, the port's wrapper on CPU tensors (its plain
    version, no launch) against the JAX probe: every output of the same
    shape and equal, o0 and o1 on rows [TH, TH + H), the pred flow within
    the stated tolerance; and the outputs are not all zeros or all ones."""
    case = cases[body]
    ref = jax_out(body)
    before = case.fn.launches
    out = M.outputs(case, case.fn(*case.args, **case.kwargs))
    assert case.fn.launches == before  # the CPU runs the plain version
    assert list(out) == list(ref)
    for name, t in out.items():
        got, want = t.float().numpy(), ref[name]
        assert got.shape == want.shape, name
        if name in ("o0", "o1"):
            got, want = got[:, :, TH:TH + H], want[:, :, TH:TH + H]
        assert 0.05 < (want != 0).mean() and (want != want.flat[0]).any(), name
        tol = M.tolerance(case, torch.tensor(want), name)
        if tol:
            assert 0 < np.abs(got - want).max() <= tol, name  # two tanhs
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_reference_leaves_unwritten_rows_nan_in_interpret_mode(cases, jax_out):
    """Records the TPU kernels' unwritten rows: K8l-K8n write o0 and o1 only
    in row blocks i + 1 (``probe_wholenet_bisect3.py:59-60``, ``bisect5.py:
    78-79``, ``bisect6.py:64-65``), so rows [0, TH) and [TH + H, Hp) are
    whatever the buffer held; interpret mode (jax 0.9.0) fills them with
    NaN. The port writes zeros there, one launch per call."""
    for body in CHAIN:
        ref = jax_out(body)
        out = M.outputs(cases[body], cases[body].fn(*cases[body].args, **cases[body].kwargs))
        for name in ("o0", "o1"):
            border = np.concatenate([ref[name][:, :, :TH], ref[name][:, :, TH + H:]], axis=2)
            assert np.isnan(border).all(), (body, name)
            assert np.isfinite(ref[name][:, :, TH:TH + H]).all(), (body, name)
            t = out[name]
            assert not bool(t[:, :, :TH].any()) and not bool(t[:, :, TH + H:].any()), (body, name)


def test_chain_reads_the_padding_rows_as_they_are(cases):
    """Unlike FireNet, the chain does not zero the rows outside the image:
    x's padding row TH - 1 moves unit 1's spikes on that row, which unit 2
    reads for image row 0, while image rows beyond unit 2's reach stay."""
    case = cases["h_chain"]
    x = case.args[0].clone()
    x[:, :, TH - 1] = 2
    o0, o1, flow = M.bisect3(x, *case.args[1:], **case.kwargs)
    r0, r1, rflow = M.bisect3(*case.args, **case.kwargs)
    assert torch.equal(o0[:, :, TH + 1:], r0[:, :, TH + 1:])
    assert not torch.equal(o1[:, :, TH], r1[:, :, TH])
    assert torch.equal(flow[:, :, 2:], rflow[:, :, 2:])


def test_kb_reads_only_each_blocks_cone(cases):
    """kB's seven layers reach rows 0..29 of each 32-row block (what
    ``bisect_bytes`` counts): the last two rows of a block move nothing,
    row 29 moves the block's last output row."""
    (xb, w), kw = cases["kB"].args, cases["kB"].kwargs
    ref = M.bisect_b(xb, w, **kw)
    tail = xb.clone()
    tail[:, :, E - 2:E] = 2
    assert torch.equal(M.bisect_b(tail, w), ref)
    row = xb.clone()
    row[:, :, TH + 2 * M.KB_LAYERS - 1] += 1
    moved = M.bisect_b(row, w)
    assert torch.equal(moved[:, :, :TH - 1], ref[:, :, :TH - 1])
    assert not torch.equal(moved[:, :, TH - 1], ref[:, :, TH - 1])


def test_cases_follow_the_files():
    """The cases carry the JAX files' shapes (C = 32, H = 64, W = 256, TH =
    16; B = 1 for K8k, 2 for the chain), what each function needs (which
    sets the bound), what the TPU probe stages and issues, and the
    ``pallas_call`` each replaces."""
    cases = M.probe_cases("meta")
    assert [M.body_of(c) for c in cases] == list(M.BODIES)
    assert [c.fn for c in cases] == [M.bisect_a, M.bisect_b] + [M.bisect3] * 2 + [
        M.bisect5] * 4 + [M.bisect6] * 3
    shapes = {M.body_of(c): [tuple(a.shape) for a in c.args] for c in cases}
    assert shapes["kA"] == [(1, 32, 96, 256), (32, 288), (32, 3)]
    assert shapes["kB"] == [(1, 32, 128, 256), (32, 288)]
    assert shapes["all-real"] == [(2, 32, 96, 256)] * 3 + [(32, 288)] * 2 + [(32, 3)] * 2 + [
        (2, 32), (2, 1)]
    assert shapes["two_where"] == [(2, 32, 96, 256)] * 3 + [(32, 288)] * 2
    row, wts = 32 * 256 * 2, 32 * 288 * 2
    px = 2 * 32 * 288
    by = {M.body_of(c): c for c in cases}
    assert by["kA"].nbytes == 66 * row + wts + 32 * 4 + 32 * 64 * 256 * 4
    assert by["kA"].flops == px * 64 * 256
    assert by["kB"].nbytes == 4 * 30 * row + wts + 32 * 64 * 256 * 4
    assert by["kB"].flops == px * 4 * 154 * 256  # layers on 28, 26, .., 16 rows
    assert by["kB"].issued_flops == px * 4 * 168 * 256  # 30, 28, .., 18
    outs = 2 * 2 * 96 * row
    assert by["h_chain"].nbytes == 2 * (68 + 66 + 64) * row + 2 * wts + outs + 2 * 32 * 64 * 256 * 4
    assert by["from_scratch"].nbytes == 2 * (66 + 64 + 64) * row + 2 * wts + outs + (
        2 * 32 * 64 * 256 * 4)
    assert by["two_where"].nbytes == 2 * 198 * row + 2 * wts + outs + 2 * 2 * 64 * 256 * 4
    assert by["all-real"].nbytes == by["two_where"].nbytes + 2 * 32 * 12 + 2 * 32 * 2 + 8
    assert by["h_chain"].flops == px * 2 * (66 + 64) * 256
    assert by["all-real"].flops == px * 2 * 130 * 256 + 4 * 32 * 2 * 64 * 256
    assert by["h_chain"].staged_bytes == 2 * 4 * 32 * 3 * row + 2 * wts + 2 * 2 * 64 * row + (
        2 * 32 * 64 * 256 * 4)
    assert by["h_chain"].issued_flops == 2 * 4 * 256 * px * (30 + 28)
    assert [M.bound(c)[1] for c in cases] == ["bytes", "operations"] + ["bytes"] * 9
    assert round(M.bound(by["kB"])[0], 6) == 0.002939
    replaces = {c.replaces for c in cases}
    assert replaces == {"benchmarks/probe_wholenet_bisect.py:28",
                        "benchmarks/probe_wholenet_bisect.py:63",
                        "benchmarks/probe_wholenet_bisect3.py:55",
                        "benchmarks/probe_wholenet_bisect5.py:74",
                        "benchmarks/probe_wholenet_bisect6.py:60"}
    for r in replaces:
        path, line = r.split(":")
        assert "pl.pallas_call(" in (ROOT / path).read_text().splitlines()[int(line) - 1], r
    assert all(c.fn.launches == 0 for c in cases)  # building cases launches nothing


def test_bodies_are_the_files_cases():
    """The chain's nine variants are the files' case lists, in their order
    (``bisect3.py:79``, ``bisect5.py:102-107``, ``bisect6.py:84``), and the
    entry point's body numbers 2..10 follow them."""
    text = {f: (ROOT / "benchmarks" / f"probe_wholenet_{f}.py").read_text()
            for f in ("bisect3", "bisect5", "bisect6")}
    listed = (re.findall(r'"(\w+)"', text["bisect3"].split("for variant in")[1].split(":")[0])
              + re.findall(r'"([^"]+)"\),', text["bisect5"].split("for real_lif")[1])
              + re.findall(r'"(\w+)"', text["bisect6"].split("for mode in")[1].split(":")[0]))
    assert listed == CHAIN
    assert [v.body for v in M.VARIANTS.values()] == list(range(2, 11))


X = torch.zeros(2, 32, 48, 16, dtype=torch.bfloat16)
WT = torch.zeros(32, 288, dtype=torch.bfloat16)
P = torch.zeros(32, 3)
PW = torch.zeros(2, 32, dtype=torch.bfloat16)


@pytest.mark.parametrize("call,match", [
    (lambda: M.bisect_a(X.to("meta"), WT.to("meta"), P.to("meta")), "cpu or cuda"),
    (lambda: M.bisect_a(X, WT.to("meta"), P), "one device"),
    (lambda: M.bisect3(X, X, X.to("meta"), WT, WT), "one device"),
    (lambda: M.bisect_a(X.float(), WT, P), "bf16"),
    (lambda: M.bisect_a(X[:, :, :40].contiguous(), WT, P), r"H \+ 32"),
    (lambda: M.bisect_a(X, WT[:, :72].contiguous(), P), r"\[C, 9 Cin\]"),
    (lambda: M.bisect_a(X, WT, P[:, :2].contiguous()), r"p \[C, 3\] f32"),
    (lambda: M.bisect_b(X[:, :, :40].contiguous(), WT), "n 32"),
    (lambda: M.bisect_b(X.transpose(2, 3), WT), "contiguous"),
    (lambda: M.bisect3(X, X, X[:, :, :40].contiguous(), WT, WT), "m0 .* and m1"),
    (lambda: M.bisect3(X, X, X, WT, WT, variant="other"), "no case 'other'"),
    (lambda: M.bisect3(X[:, :8].contiguous(), X, X, WT[:, :72].contiguous(), WT,
                       variant="from_scratch"), "Cin must equal C"),
    (lambda: M.bisect5(X, X, X, WT, WT, P, P, None, None), r"pw \[2, C\]"),
    (lambda: M.bisect5(X, X, X, WT, WT, P, P[:, :2].contiguous(), PW, torch.zeros(2, 1)),
     r"p0, p1 \[C, 3\]"),
    (lambda: M.bisect5(X, X, X, WT, WT, P, P, None, None, real_lif=False, use_pred=False),
     "no case None"),
    (lambda: M.bisect6(X, X, X, WT, WT, mode="h_chain"), "no case 'h_chain'"),
], ids=["meta", "mixed", "mixed-chain", "dtype", "rows", "weights", "params", "blocks",
        "strided", "membranes", "variant", "scratch-cin", "pred", "chain-params", "bisect5-case",
        "mode"])
def test_wrappers_refuse(call, match):
    before = [fn.launches for fn in M.WRAPPERS]
    with pytest.raises(ValueError, match=match):
        call()
    assert [fn.launches for fn in M.WRAPPERS] == before


def test_module_imports_neither_jax_nor_the_reference():
    """The probe module and ``chip_smoke.py`` import no ``jax``, ``flax`` or
    ``evflow`` (the GPU host has only torch), and the CUDA source is built
    by ``ops/cuda_build.py`` like every other source."""
    from evflow_torch.ops import cuda_build

    imports = re.compile(r"^\s*(?:import|from)\s+(jax|evflow|flax)\b", re.MULTILINE)
    for path in (ROOT / "evflow_torch" / "probes" / "wholenet_bisect.py", ROOT / "chip_smoke.py"):
        assert not imports.search(path.read_text()), path
    assert "probe_wholenet_bisect" in cuda_build.SOURCES
    assert (cuda_build.CSRC_DIR / "probe_wholenet_bisect.cu").exists()
