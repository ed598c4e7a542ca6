"""The port's in-kernel dot probes (``evflow_torch.probes.inkernel_dot``,
plain versions on the CPU) against the JAX probe kernels of
``benchmarks/probe_inkernel_dot.py`` and ``probe_inkernel_dot2.py`` in
interpret mode, on the same numpy-made operands at a small size (Np=256,
S=2 steps; the files' K, C, L and dot2's M, K, L).

The probe files run their whole benchmark when imported, so they are not
imported: each is parsed, and only its imports and ``def``s are executed,
in a namespace whose size constants (``Np``, ``S``) are rebound; then its
``run_a`` / ``run_b`` / ``run_bi`` / ``run_c`` / ``make(...)`` are called.

Tolerances: f32 accumulation within 1e-6 of max |out| (the JAX kernel sums
in f32, the plain version in float64, rounded once); int8 exact. bf16
accumulation (integer operands, so every dot is exact): XLA on the CPU
rounds each dot and each running sum to bf16 except the last sum of a step,
whose convert back to f32 it elides (excess precision), so the JAX output
is S (run_{L-2} + d_{L-1}) where the plain version rounds that sum to bf16:
the two differ by at most S times half a bf16 ulp of |out| / S. An f32
accumulation of the same operands falls outside that limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import probe_namespace
from evflow_torch.probes import inkernel_dot as P

NPX, STEPS = 256, 2
CASES = {c.name: c for c in P.probe_cases("cpu", seed=3, np_pixels=NPX, steps=STEPS)}


@pytest.fixture(scope="module")
def dot1():
    return probe_namespace("probe_inkernel_dot", Np=NPX, C=P.C, K=P.K, L=P.L, S=STEPS)


@pytest.fixture(scope="module")
def dot2():
    return probe_namespace("probe_inkernel_dot2", S=STEPS)


def jax_operand(t: torch.Tensor):
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)  # bf16 values: exact


def bf16_half_ulp(v):
    """Half a bf16 ulp (8 significant bits) of |v|."""
    _, e = np.frexp(np.abs(v))  # |v| = m 2^e, 0.5 <= m < 1
    return np.ldexp(1.0, e - 9)


def check(case, jax_out):
    """The port's wrapper (plain on the CPU) against the JAX probe."""
    out = case.fn(*case.args, **case.kwargs)
    ref = np.asarray(jax_out)
    assert tuple(out.shape) == ref.shape
    if case.int8:
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)
        return
    err = np.abs(out.double().numpy() - ref.astype(np.float64))
    if case.kwargs.get("acc_dtype") == torch.bfloat16:
        steps = case.kwargs["steps"]
        out64 = out.double().numpy()
        tol = steps * bf16_half_ulp(out64 / steps)
        assert (err <= tol).all(), float((err - tol).max())
        # the limit tells the accumulations apart: f32 sums of the same dots
        # miss it on about half of the elements
        f32 = case.plain(*case.args, acc_dtype=torch.float32, steps=steps).double().numpy()
        assert (np.abs(f32 - ref) > tol).mean() > 0.25
    else:
        assert float(err.max()) <= 1e-6 * float(np.abs(ref).max()), float(err.max())


@pytest.mark.parametrize("key,run", [("A  pixel-major", "run_a"), ("B  channel-major", "run_b"),
                                     ("Bi channel-major int8", "run_bi"),
                                     ("C  K-split x3", "run_c")])
def test_probe_matches_jax_probe_inkernel_dot(dot1, key, run):
    case = next(c for n, c in CASES.items() if n.startswith(key))
    with pltpu.force_tpu_interpret_mode():
        jout = dot1[run](*(jax_operand(t) for t in case.args))
    check(case, jout)


@pytest.mark.parametrize("variant", P.VARIANTS, ids=[v[0] for v in P.VARIANTS])
def test_probe_matches_jax_probe_inkernel_dot2(dot2, variant):
    name, M, K, _, L, acc = variant
    case = CASES["dot2 " + name]
    x, w = case.args
    run = dot2["make"](M, K, x.shape[1], L, jnp.bfloat16 if acc == torch.bfloat16 else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        jout = run(jax_operand(x), jax_operand(w))
    check(case, jout)


def test_probe_cases_follow_the_files():
    """The cases carry the JAX files' shapes and flop counts: 2 M K Np L S."""
    full = P.probe_cases("meta")
    assert len(full) == 4 + 6
    assert full[0].flops == 2.0 * 32 * 288 * 8192 * 9 * 64
    assert [c.args[0].shape for c in full[4:]] == [(k, n) for _, _, k, n, _, _ in P.VARIANTS]
    assert all(c.fn.launches == 0 for c in full)  # building cases launches nothing


def test_ptxas_report_is_parsed_per_kernel():
    """``cuda_build.ptxas_functions`` reads registers, stack and spill
    bytes per kernel from an ``nvcc -Xptxas -v`` log."""
    from evflow_torch.ops.cuda_build import ptxas_functions

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 380 bytes cmem[0]
"""
    assert ptxas_functions(log) == {
        "_Z1aPf": {"registers": 90, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        "_Z1bPf": {"registers": 255, "stack": 8, "spill_stores": 4, "spill_loads": 12}}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN6evflow5probe12probe_kernelILi32ELi0ELb1ELb0EEEvNS0_9ProbeArgsE",
     "probe_kernel<32,0,1,0>"),
    ("_ZN6evflow5probe12probe_kernelILi16ELi2ELb0ELb1EEEvNS0_9ProbeArgsE",
     "probe_kernel<16,2,0,1>"),
    ("_ZN6evflow7loopdyn19load_dot_f32_kernelEPKfS2_Pfiii", "load_dot_f32_kernel"),
    ("_Z1aPf", "a"),
    ("_ZN1a1bILin3EEEvv", "b<-3>"),
    ("plain_c_name", "plain_c_name"),
    ("_ZN6evflow7loopdyn12store_kernelIfEEvPKfPfPT_ii", "store_kernel<float>"),
    ("_ZN6evflow7loopdyn12store_kernelI13__nv_bfloat16EEvPKfPfPT_ii",
     "store_kernel<__nv_bfloat16>"),
    ("_ZN6evflow7staging17layer_grid_kernelILi3EEEvNS0_13LayerGridArgsE",
     "layer_grid_kernel<3>"),
    ("_ZN6evflow7loopdyn15load_sum_kernelIfNS0_8IdentityEEEvPKT_Pfii", "load_sum_kernel"),
    ("_ZN1a1bIPfEEvv", "b"),
], ids=["pixel-major", "int8-split", "k2", "global", "negative", "unmangled", "store-f32",
        "store-bf16", "layer-grid", "nested-type", "pointer-argument"])
def test_kernel_name_reads_template_arguments(mangled, name):
    """``cuda_build.kernel_name`` drops namespaces and parameter types and
    keeps integer and bool template arguments, ``float`` and named types,
    as the build phase names the redesigned kernels; a template argument of
    another kind (a nested name, a pointer) leaves the bare name."""
    from evflow_torch.ops.cuda_build import kernel_name

    assert kernel_name(mangled) == name


def test_ptxas_kernels_names_what_no_log_reports(tmp_path):
    """``cuda_build.ptxas_kernels`` returns the rows of the expected
    kernels and names every one that no log reports: an instantiation
    missing from its source's log, and every kernel of a source with no log,
    so a build gate cannot pass on an empty report."""
    from evflow_torch.ops.cuda_build import ptxas_kernels

    entry = "_ZN6evflow5probe12probe_kernelILi{}ELi0ELb0ELb{}EEEvNS0_9ProbeArgsE"
    (tmp_path / "dot.ptxas.txt").write_text("".join(
        f"ptxas info    : Compiling entry function '{entry.format(mt, s)}' for 'sm_90a'\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {r} registers, used 1 barriers\n"
        for mt, s, r in ((32, 0, 90), (32, 1, 64))))
    rows, missing = ptxas_kernels(
        {"dot": ("probe_kernel<32,0,0,0>", "probe_kernel<32,0,0,1>", "probe_kernel<16,0,0,0>"),
         "k2": ("load_dot_f32_kernel",)}, tmp_path)
    assert rows == {
        "probe_kernel<32,0,0,0>": {"registers": 90, "stack": 0, "spill_stores": 0,
                                   "spill_loads": 0},
        "probe_kernel<32,0,0,1>": {"registers": 64, "stack": 0, "spill_stores": 0,
                                   "spill_loads": 0}}
    assert missing == ["probe_kernel<16,0,0,0>", "load_dot_f32_kernel"]


@pytest.mark.parametrize("fn", P.WRAPPERS, ids=lambda f: f.__name__)
def test_probes_refuse_other_devices_and_dtypes(fn):
    x = torch.zeros(288, 64, dtype=torch.int8 if fn is P.dot_channel_major_s8 else torch.bfloat16)
    w = torch.zeros(2, 32, 288, dtype=x.dtype)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fn(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        fn(x.float(), w.float())
