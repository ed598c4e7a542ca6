"""The port's Mosaic-ops probes (``evflow_torch.probes.mosaic_ops``, plain
versions on the CPU) against the JAX probe kernels of
``benchmarks/probe_mosaic_ops.py`` (K8o: ``k_dot3``, ``k_roll``,
``k_misc``) in interpret mode, on the same numpy-made operands at a small
size (C=8, K=32, E=8, W=16).

The probe file runs its cases when imported, so it is parsed and only its
imports and ``def``s are executed, with its size constants rebound
(``tests/_torch_port.py::probe_namespace``); each ``pallas_call`` is built
here with the file's own specs (``probe_mosaic_ops.py:24-50``).

Tolerance: equality, on bf16 integers in [-64, 64] (``draw_operands(...,
integers=True)``): every pairwise sum of ``k_roll`` and every dot of
``k_dot3`` is then exact, so the roundings, and the order of the sums,
cannot show. ``k_misc`` is exact on any draw. On normal draws interpret
mode does not round ``k_roll``'s bf16 sum, and the port does: see
``test_reference_k_roll_does_not_round_in_interpret_mode``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from _torch_port import ROOT, probe_namespace
from evflow_torch.device import BF16_FLOP_PER_S
from evflow_torch.probes import mosaic_ops as M

C, K, E, W = 8, 32, 8, 16


def jax_probe(body, args):
    """The JAX body's output in interpret mode on the port's operands."""
    ns = probe_namespace("probe_mosaic_ops", C=C, K=K, E=E, W=W)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(ns[body], out_shape=jax.ShapeDtypeStruct((C, E, W), jnp.float32),
                              in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
                              out_specs=pl.BlockSpec(memory_space=pltpu.VMEM))
        return np.asarray(call(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in args)))


@pytest.mark.parametrize("integers", [True, False], ids=["integers", "normals"])
@pytest.mark.parametrize("body", ["k_misc", "k_roll", "k_dot3"])
def test_body_matches_jax_probe(body, integers):
    """Equal on bf16 integers; on normals ``k_misc`` stays equal (2 v and v
    are exact), ``k_dot3`` within ``dot_variant``'s f32 tolerance, and
    ``k_roll`` differs by the bf16 rounding that interpret mode skips."""
    _, fn, _, _ = M.BODIES[body]
    args = M.draw_operands(np.random.default_rng(0), body, C, K, E, W, integers=integers)
    ref = jax_probe(body, args)
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before  # the CPU runs the plain version: no launch
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (C, E, W)
    assert (ref != 0).mean() > 0.5
    if integers or body == "k_misc":
        np.testing.assert_array_equal(out.numpy(), ref)
    elif body == "k_dot3":
        case = M.probe_cases("cpu", shape=(C, K, E, W))[2]
        tol = M.tolerance(case._replace(args=args), torch.tensor(ref))
        assert 0 < tol and np.abs(out.numpy() - ref).max() <= tol
    else:
        err = np.abs(out.numpy() - ref)
        assert 0 < err.max() <= np.abs(ref).max() * 2.0 ** -8  # one bf16 half-ulp at most


def test_reference_k_roll_does_not_round_in_interpret_mode():
    """``probe_mosaic_ops.py:17`` adds two bf16 values and widens the sum:
    eager ``jnp``, torch and a bf16 vector unit round the sum to bf16 first,
    but in interpret mode the Pallas output is the unrounded f32 sum. On
    normal bf16 draws the interpret-mode output equals that f32 sum, and
    the port's plain version (which rounds, as the kernel does) differs from
    it on a large share of the elements by at most half a bf16 ulp. A
    change in interpret mode makes this fail; then compare ``k_roll`` on
    normal draws."""
    (v,) = M.draw_operands(np.random.default_rng(1), "k_roll", C, K, E, W)
    ref = jax_probe("k_roll", (v,))
    vf = v.float()
    unrounded = (torch.roll(vf, 1, 2) + torch.roll(vf, 1, 1)).numpy()
    np.testing.assert_array_equal(ref, unrounded)
    rounded = M.roll_sum(v).numpy()
    eager = np.asarray((jnp.roll(jnp.asarray(vf.numpy(), jnp.bfloat16), 1, 2)
                        + jnp.roll(jnp.asarray(vf.numpy(), jnp.bfloat16), 1, 1))
                       .astype(jnp.float32))
    np.testing.assert_array_equal(rounded, eager)
    differ = rounded != ref
    assert differ.mean() > 0.3
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(ref[differ]))) - 8)
    assert (np.abs(rounded - ref)[differ] <= half_ulp).all()


def test_roll_wraps_around_both_axes():
    v = torch.arange(C * E * W, dtype=torch.float32).reshape(C, E, W).remainder(61)
    v = v.to(torch.bfloat16)
    out = M.roll_sum(v)
    vf = v.float()
    assert torch.equal(out[:, 0, 0], vf[:, 0, W - 1] + vf[:, E - 1, 0])
    assert torch.equal(out[:, 3, 5], vf[:, 3, 4] + vf[:, 2, 5])


def test_concat_where_doubles_all_but_column_0():
    (v,) = M.draw_operands(np.random.default_rng(2), "k_misc", C, K, E, W)
    out = M.concat_where(v)
    assert torch.equal(out[:, :, 1:], 2 * v[:, :, 1:].float())
    assert torch.equal(out[:, :, 0], v[:, :, 0].float())


def test_cases_follow_the_file():
    """The cases carry the JAX file's shapes (C=32, K=288, E=32, W=256);
    what each function needs (v in bf16 and the f32 output; the dot's
    operands and 2 C K E W flops), which sets the bound; and the sources."""
    cases = M.probe_cases("meta")
    assert [M.body_of(c) for c in cases] == ["k_misc", "k_roll", "k_dot3"]
    assert [tuple(a.shape) for c in cases for a in c.args] == [(32, 32, 256), (32, 32, 256),
                                                               (32, 288), (288, 32, 256)]
    assert [c.nbytes for c in cases] == [1_572_864, 1_572_864, 5_785_600]
    assert [c.flops for c in cases] == [0, 0, 150_994_944]
    assert all(c.staged_bytes == c.nbytes and c.issued_flops == c.flops for c in cases)
    assert all(c.rate == BF16_FLOP_PER_S for c in cases)
    assert [M.bound(c)[1] for c in cases] == ["bytes"] * 3
    assert [round(M.bound(c)[0], 6) for c in cases] == [0.00047, 0.00047, 0.001727]
    assert [c.replaces for c in cases] == [f"benchmarks/probe_mosaic_ops.py:{n}"
                                           for n in (50, 33, 24)]
    src = (ROOT / "benchmarks" / "probe_mosaic_ops.py").read_text().splitlines()
    assert all("pl.pallas_call(" in src[n - 1] for n in (24, 33, 50))
    assert all(c.fn.launches == 0 for c in cases)  # building cases launches nothing


V = torch.zeros(8, 8, 16, dtype=torch.bfloat16)


@pytest.mark.parametrize("call,match", [
    (lambda: M.roll_sum(V.to("meta")), "cpu or cuda"),
    (lambda: M.roll_sum(V.float()), r"v \[C, E, W\] bf16"),
    (lambda: M.concat_where(V[0]), r"v \[C, E, W\] bf16"),
    (lambda: M.concat_where(V.transpose(1, 2)), "contiguous"),
    (lambda: M.dot3(V[0], V), r"w \[C, K\] and x3 \[K, E, W\]"),
    (lambda: M.dot3(torch.zeros(8, 8), V), "bf16 operands"),
    (lambda: M.dot3(V[0, :, :8].contiguous(), V.to("meta")), "one device"),
], ids=["meta", "dtype", "rank", "strided", "dot-shape", "dot-dtype", "dot-device"])
def test_wrappers_refuse(call, match):
    before = [fn.launches for fn in M.WRAPPERS]
    with pytest.raises(ValueError, match=match):
        call()
    assert [fn.launches for fn in M.WRAPPERS] == before


def test_port_imports_neither_jax_nor_the_reference():
    """No module of ``evflow_torch`` and no line of ``chip_smoke.py`` imports
    ``jax`` or ``evflow``: the port runs on a host that has only torch."""
    imports = re.compile(r"^\s*(?:import|from)\s+(jax|evflow|flax)\b", re.MULTILINE)
    files = sorted((ROOT / "evflow_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files if imports.search(f.read_text())]
    assert offenders == []
    assert imports.search("import jax.numpy as jnp") and imports.search("from evflow.ops import x")
    assert not imports.search("from evflow_torch.ops import x")


def test_elementwise_floor_args_are_one_cta():
    """``floor_args`` gives k_misc and k_roll one row of v: one CTA of
    ``VEC`` elements a thread, whose time is the launch floor; the plain
    version runs on it."""
    for case in M.probe_cases("cpu"):
        if M.body_of(case) == "k_dot3":
            continue
        (v,), kwargs = M.floor_args(case)
        assert tuple(v.shape) == (1, 1, case.args[0].shape[-1]) and v.is_contiguous()
        assert v.numel() <= M.VEC * 256  # one CTA of 256 threads (csrc/probe_mosaic_ops.cu)
        assert torch.isfinite(case.plain(v, **kwargs)).all()
