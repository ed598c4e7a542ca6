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


# --- the launch's layout (``launch_layout``, ``Stack`` and ``Chain`` in the source) ----

CSRC = ROOT / "evflow_torch" / "csrc" / "probe_wholenet_bisect.cu"


@pytest.mark.parametrize("body", list(M.BODIES), ids=lambda b: b.replace(" + ", "-"))
def test_launch_layout_fits_a_cta(body):
    """Every body's launch fits one CTA: its shared bytes within 232,448,
    its threads within 17 warps, its largest layer's m16 fragments within
    the fragments a warp it compiles times its compute warps; at the files'
    shapes kA and kB take 128 CTAs of 8 x 16 pixels (256 and 512 threads),
    the chain 128 of 16 x 16 (512 and a warp that issues the copies)."""
    b = M.B_K8K if body in ("kA", "kB") else M.B_CHAIN
    lay = M.launch_layout(body, b, M.H, M.W)
    assert lay["smem"] <= 232448 and lay["threads"] <= 544
    warps = lay["threads"] // 32 - (body not in ("kA", "kB"))  # the chain's compute warps
    assert lay["frags"] <= lay["fpw"] * warps
    assert lay["fpw"] <= (3 if body == "kB" else 2)
    expect = {"kA": (128, 256, 64256, 1), "kB": (128, 512, 126336, 3)}.get(
        body, (128, 544, 213120, 2))
    assert (lay["grid"], lay["threads"], lay["smem"], lay["fpw"]) == expect


def test_launch_layout_takes_the_domain():
    """Every (B, H, W) with B in 1..3, H a multiple of 16 up to 256 and W a
    multiple of 8 up to 1,024 is taken by every body, with the grid of its
    tiles (kA, kB: W/8 x H/16 x B; the chain: ceil(W/16) x H/16 x B); H not
    a multiple of 16, W not a multiple of 8 (36, 1,020) and B = 0 are
    refused."""
    taken = 0
    for body in M.BODIES:
        stack = body in ("kA", "kB")
        for b in (1, 2, 3):
            for h in range(16, 257, 16):
                for w in range(8, 1025, 8):
                    lay = M.launch_layout(body, b, h, w)
                    tiles = w // 8 if stack else -(-w // 16)
                    assert lay is not None and lay["grid"] == tiles * (h // 16) * b, (body, b, h, w)
                    taken += 1
        for b, h, w in ((1, 64, 36), (1, 64, 1020), (1, 8, 256), (1, 40, 256), (0, 64, 256),
                        (1, 0, 256), (1, 64, 0)):
            assert M.launch_layout(body, b, h, w) is None, (body, b, h, w)
    assert taken == 11 * 3 * 16 * 128
    with pytest.raises(ValueError, match="no body"):
        M.launch_layout("kC", 1, 64, 256)


def test_layout_mirror_constants_match_the_source():
    """The mirror's constants are the source's, and the source's layouts
    have the pieces ``launch_layout`` counts."""
    src = CSRC.read_text()
    for name, value in (("STACK_TW", M.STACK_TW), ("CHAIN_TW", M.CHAIN_TW),
                        ("CHAIN_WARPS", M.CHAIN_WARPS), ("KB_WARPS", M.KB_WARPS),
                        ("SMEM_LIMIT", M.SMEM_LIMIT), ("TH", M.TH), ("KB_LAYERS", M.KB_LAYERS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
    assert "constexpr int E = TH + 16;" in src and M.E == M.TH + 16
    assert (M.SPITCH, M.WPITCH, M.PBYTES, M.PWBYTES) == (40, 296, 384, 128)
    assert (M.W_BLOCK, M.W_BLOCKS) == (4096, 5)
    for piece in ("constexpr int WPITCH = 9 * C + PAD;", "constexpr int W_BLOCK = C * 128;",
                  "constexpr int W_BLOCKS = (9 * C + 63) / 64;",
                  "constexpr int plane(int bytes) { return up128(bytes) + 16; }"):
        assert piece in src, piece
    stack = re.search(r"struct Stack \{.*?\n\};", src, re.S).group(0)
    for piece in ("HALO = (NL + 7) / 8 * 8;", "HR = TH + 2 * NL;", "HC = TW + 2 * NL;",
                  "BX = TW + 2 * HALO;", "WARPS = NL == 1 ? 8 : KB_WARPS;",
                  "QUADS = ((HR - 2) * (HC - 2) + 63) / 64;",
                  "MAXQ = (QUADS + WARPS / 4 - 1) / (WARPS / 4);", "BUF = HR * HC * SPITCH * 2;",
                  "XPL = plane(HR * BX * 2);", "OPL = plane(TH * TW * 4);",
                  "OFF_BAR = W_BLOCKS * W_BLOCK;", "OFF_B0 = OFF_BAR + 128;",
                  "OFF_B1 = OFF_B0 + up128(BUF);",
                  "SMEM = OFF_B1 + up128(max3(NL > 1 ? BUF : 0, C * XPL, C * OPL));"):
        assert piece in stack, piece
    chain = re.search(r"struct Chain \{.*?\n\};", src, re.S).group(0)
    for piece in ("XR = TH + 4, XC = TW + 4, XB = TW + 16;", "U1 = TH + 2;",
                  "M0B = TW + 24, M0R = U1 + 1;", "M1B = TW + 8, M1R = TH + 1;",
                  "WARPS = CHAIN_WARPS;", "MAXF = ((U1 * U1 + 15) / 16 + WARPS - 1) / WARPS;",
                  "XPL = plane(XR * XB * 2);", "M0PL = M0R * M0B * 2;",
                  "M1PL = M1R * M1B * 2;", "O0PL = TH * TW * 2;", "OPL = plane(TH * TW * 2);",
                  "FPL = plane(TH * TW * 4);", "XT = XR * XC * SPITCH * 2;",
                  "S1 = U1 * U1 * SPITCH * 2;", "OFF_W0 = 128;",
                  "OFF_W1 = OFF_W0 + up128(C * WPITCH * 2);",
                  "OFF_P = OFF_W1 + up128(C * WPITCH * 2);",
                  "OFF_X = OFF_P + up128(2 * PBYTES + PWBYTES);",
                  "OFF_XT = OFF_X + up128(max3(C * XPL, C * O0PL + C * OPL, 0));",
                  "OFF_M0 = OFF_XT + up128(XT);",
                  "OFF_M1 = OFF_M0 + up128(max3(C * M0PL, C * FPL, 0));",
                  "OFF_S1 = OFF_M1 + up128(C * M1PL);", "SMEM = OFF_S1 + up128(S1);"):
        assert piece in chain, piece
    assert "dim3(a.W / G::TW, a.H / TH, a.B)" in src
    assert "dim3((a.W + G::TW - 1) / G::TW, a.H / TH, a.B)" in src
    assert "a.W < 8 ||\n      a.W % 8 != 0" in src


def test_split_variants_have_their_hooks(tmp_path):
    """Each variant of ``wholenet_bisect --split`` takes out a part that the
    source declares and tests (``keeps(BI_CUT_<part>)``); a source without
    those hooks (as before this design) is refused for every variant but
    the full one."""
    assert M.split_missing(ROOT) == []
    src = CSRC.read_text()
    parts = [flags[0][len("-DBI_CUT="):] for flags in M.SPLIT_VARIANTS.values() if flags]
    assert all(flags[0].startswith("-DBI_CUT=") for flags in M.SPLIT_VARIANTS.values() if flags)
    for part in parts:
        assert f"keeps({part})" in src and f"  {part}," in src
    declared = re.findall(r"^  (BI_CUT_\w+),", src, re.M)
    assert sorted(declared[1:]) == sorted(parts)
    csrc = tmp_path / "evflow_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "probe_wholenet_bisect.cu").write_text("// no hooks\n")
    assert M.split_missing(tmp_path) == [v for v in M.SPLIT_VARIANTS if v != "full"]


def test_instantiations_are_gated():
    """Every ``stack_kernel<NL>`` and ``chain_kernel<LIF, PRM, FLOW, OUT_SPK,
    SCRATCH>`` the entry point can launch is in ``chip_smoke.REDESIGNED``,
    whose ptxas gate fails on a missing one, a stack frame or spills."""
    import chip_smoke

    src = CSRC.read_text()
    values = {"SIMPLE": 0, "REAL": 1, "ONE_WHERE": 2, "TWO_WHERE": 3, "NO_PARAMS": 0, "HALF": 1,
              "PER_CHANNEL": 2, "ALL_CHANNELS": 0, "TWO_CHANNELS": 1, "PRED": 2, "true": 1,
              "false": 0}
    chains = re.findall(r"launch_chain<(\w+), (\w+), (\w+), (\w+), (\w+)>\(\*a, s\)", src)
    names = {"chain_kernel<" + ",".join(str(values[v]) for v in t) + ">" for t in chains}
    assert len(chains) == len(names) == len(M.VARIANTS)
    assert re.findall(r"launch_stack<(\w+)>\(\*a, s\)", src) == ["1", "KB_LAYERS"]
    names |= {"stack_kernel<1>", f"stack_kernel<{M.KB_LAYERS}>"}
    assert set(chip_smoke.REDESIGNED["probe_wholenet_bisect"]) == names
