"""The Mosaic-ops probes on Hopper (port of ``benchmarks/probe_mosaic_ops.py``,
K8o).

The TPU probe asked whether three value-level operations lower inside a
Pallas kernel: a dot of a 3-D operand, ``pltpu.roll`` along lanes and
sublanes, and a concat with an iota mask. Over v ``[C, E, W]`` bf16 (and
for the dot w ``[C, K]``, x3 ``[K, E, W]`` bf16) the three bodies compute:

* ``k_misc`` (``concat_where``): ``out = f32(concat(v, v, v)[:C] +
  where(w > 0, v, 0))``, that is ``2 v`` where the column w > 0 and ``v``
  at w = 0, exact;
* ``k_roll`` (``roll_sum``): ``out[c, e, w] = f32(v[c, e, (w - 1) mod W] +
  v[c, (e - 1) mod E, w])``, both rolls wrapping around, the bf16 sum
  rounded to bf16 before it is widened;
* ``k_dot3`` (``dot3``): ``out[C, E, W] = w[C, K] @ x3[K, E, W]``, f32
  accumulation.

``k_misc`` and ``k_roll`` are one launch of ``elementwise_kernel`` in
``evflow_torch/csrc/probe_mosaic_ops.cu`` (see the source's note).
``k_dot3`` is the x1 case of ``probe_inkernel_dot2.py`` at one step:
``dot3`` checks its shapes and launches ``inkernel_dot.dot_variant``'s
kernel (``csrc/probe_inkernel_dot.cu``) through ``inkernel_dot._launch``,
which adds to ``dot3.launches`` at the launch.

``k_roll``'s rounding: the sum of two bf16 values is a bf16 value in the
source (``(r + r2).astype(f32)``), as eager ``jnp``, torch and a bf16
vector unit give it. Pallas's interpret mode returns the unrounded f32 sum
instead (``tests/test_torch_mosaic_ops.py`` records it); the port rounds.

The plain versions take the sums in f32 and round to bf16 where the kernel
does, and the dot in float64 (``dot_variant_plain``). CPU tensors run the
plain version; CUDA tensors launch the kernel or raise.

    python -m evflow_torch.probes.mosaic_ops   # one line per body, needs CUDA
"""

from __future__ import annotations

import argparse
import ctypes
import math
from typing import List, Optional

import numpy as np
import torch

from evflow_torch.device import BF16_FLOP_PER_S, describe_card
from evflow_torch.probes import inkernel_dot
from evflow_torch.probes._harness import Case, bound, card_device, launch, on_card, run_cases

__all__ = [
    "concat_where", "concat_where_plain", "roll_sum", "roll_sum_plain", "dot3", "dot3_plain",
    "mosaic_bytes", "draw_operands", "probe_cases", "body_of", "bound", "tolerance", "run_all",
    "WRAPPERS", "BODIES", "last_launch", "floor_args",
]

# the probe's shapes (probe_mosaic_ops.py:6)
C, K, E, W = 32, 288, 32, 256
VEC = 8  # consecutive elements per thread (csrc/probe_mosaic_ops.cu)
MISC, ROLL = range(2)


class MosaicArgs(ctypes.Structure):
    """ctypes mirror of ``MosaicArgs`` in ``csrc/probe_mosaic_ops.cu``."""

    _fields_ = [("v", ctypes.c_void_p), ("out", ctypes.c_void_p), ("op", ctypes.c_int),
                ("C", ctypes.c_int), ("E", ctypes.c_int), ("W", ctypes.c_int),
                ("grid", ctypes.c_int), ("threads", ctypes.c_int), ("smem", ctypes.c_int)]


last_launch = {"grid": 0, "threads": 0, "smem": 0}


def _v_shape(name, v):
    if v.dtype != torch.bfloat16 or v.dim() != 3:
        raise ValueError(f"{name} takes v [C, E, W] bf16, got {v.dtype} {tuple(v.shape)}")
    return tuple(v.shape)


def _round(t: torch.Tensor) -> torch.Tensor:
    """An f32 sum of two bf16 values rounded to bf16 (to nearest even) and
    widened again: the bf16 add."""
    return t.to(torch.bfloat16).float()


# --- plain versions ------------------------------------------------------------

def concat_where_plain(v: torch.Tensor) -> torch.Tensor:
    _, _, w = _v_shape("concat_where", v)
    vf = v.float()
    lane = torch.arange(w, device=v.device)
    return _round(vf + torch.where(lane > 0, vf, 0.0))


def roll_sum_plain(v: torch.Tensor) -> torch.Tensor:
    _v_shape("roll_sum", v)
    vf = v.float()
    return _round(torch.roll(vf, 1, 2) + torch.roll(vf, 1, 1))


def _dot_shape(w, x3):
    if w.dim() != 2 or x3.dim() != 3 or w.shape[1] != x3.shape[0]:
        raise ValueError(f"dot3 takes w [C, K] and x3 [K, E, W], got {tuple(w.shape)} and "
                         f"{tuple(x3.shape)}")
    if w.dtype != torch.bfloat16 or x3.dtype != torch.bfloat16:
        raise ValueError(f"dot3 takes bf16 operands, got {w.dtype} and {x3.dtype}")


def dot3_plain(w: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    _dot_shape(w, x3)
    k, e, wd = x3.shape
    return inkernel_dot.dot_variant_plain(x3.reshape(k, e * wd), w[None], torch.float32,
                                          steps=1).reshape(w.shape[0], e, wd)


# --- the kernels ---------------------------------------------------------------

def _elementwise(fn, plain, op, v):
    cuda = on_card(fn.__name__, v, align=16)
    c, e, w = _v_shape(fn.__name__, v)
    if not cuda:
        return plain(v)
    if w % VEC:
        raise ValueError(f"{fn.__name__}: the kernel takes W a multiple of {VEC}, got {w}")
    out = torch.empty(c, e, w, device=v.device, dtype=torch.float32)
    args = MosaicArgs(v=v.data_ptr(), out=out.data_ptr(), op=op, C=c, E=e, W=w)
    launch("probe_mosaic_ops", args, v.device)
    last_launch.clear()
    last_launch.update(grid=args.grid, threads=args.threads, smem=args.smem)
    fn.launches += 1
    return out


def concat_where(v: torch.Tensor) -> torch.Tensor:
    """k_misc: ``f32(v + where(w > 0, v, 0))`` for v ``[C, E, W]`` bf16 ->
    ``[C, E, W]`` f32 (``concat(v, v, v)[:C]`` is v)."""
    return _elementwise(concat_where, concat_where_plain, MISC, v)


def roll_sum(v: torch.Tensor) -> torch.Tensor:
    """k_roll: ``f32(bf16(roll(v, 1, 2) + roll(v, 1, 1)))`` for v ``[C, E,
    W]`` bf16 -> ``[C, E, W]`` f32, both rolls wrapping around."""
    return _elementwise(roll_sum, roll_sum_plain, ROLL, v)


def dot3(w: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
    """k_dot3: ``w [C, K] @ x3 [K, E, W]`` bf16 -> ``[C, E, W]`` f32, f32
    accumulation: ``inkernel_dot.dot_variant``'s kernel on ``x3`` as ``[K, E
    W]`` at one step, launched (and counted) here."""
    cuda = on_card("dot3", w, x3)
    _dot_shape(w, x3)
    if not cuda:
        return dot3_plain(w, x3)
    k, e, wd = x3.shape
    out = inkernel_dot._channel_major(dot3, x3.reshape(k, e * wd), w[None], 1,
                                      inkernel_dot.F32_ACC)
    last_launch.clear()
    last_launch.update(inkernel_dot.last_launch)
    return out.reshape(w.shape[0], e, wd)


WRAPPERS = (concat_where, roll_sum, dot3)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probe's cases -----------------------------------------------------------

def floor_args(case):
    """An elementwise case's (k_misc, k_roll) arguments at the smallest size
    its kernel takes, one CTA: one row of v. Its time is the kernel's launch
    floor."""
    (v,) = case.args
    return (v[:1, :1].contiguous(),), dict(case.kwargs)


# body: (the file's name for it, wrapper, plain, the TPU pallas_call)
BODIES = {
    "k_misc": ("misc", concat_where, concat_where_plain, "benchmarks/probe_mosaic_ops.py:50"),
    "k_roll": ("roll", roll_sum, roll_sum_plain, "benchmarks/probe_mosaic_ops.py:33"),
    "k_dot3": ("dot3", dot3, dot3_plain, "benchmarks/probe_mosaic_ops.py:24"),
}


def mosaic_bytes(body: str, c: int, k: int, e: int, w: int):
    """(needed bytes, needed flops) of one call, which is also what the
    TPU's ``pallas_call`` stages and issues: v in bf16 and the f32 output
    (the adds count no flops: they are far below the bytes); the dot's
    operands in bf16, its f32 output and 2 C K E W flops."""
    out = c * e * w * 4
    if body == "k_dot3":
        return 2 * (c * k + k * e * w) + out, 2.0 * c * k * e * w
    return c * e * w * 2 + out, 0.0


def draw_operands(rng, kind: str, c: int, k: int, e: int, w: int, device="cpu",
                  integers: bool = False):
    """The operands of body ``kind`` with numpy from ``rng``: standard
    normals rounded to bf16, as the JAX file draws them, or with
    ``integers`` bf16 integers in [-64, 64] (the pairwise sums of k_roll and
    every dot of k_dot3 at K <= 288 are then exact: the roundings vanish).
    Returns the body's positional arguments."""
    if kind not in BODIES:
        raise ValueError(f"unknown body {kind!r}; one of {sorted(BODIES)}")

    def bf(*shape):
        a = rng.integers(-64, 65, shape) if integers else rng.standard_normal(shape)
        return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)

    if kind == "k_dot3":
        return bf(c, k), bf(k, e, w)
    return (bf(c, e, w),)


def probe_cases(device, seed: int = 0, shape=(C, K, E, W)) -> List[Case]:
    """The three bodies at the JAX file's shapes, operands from
    ``draw_operands`` (normals) with numpy from ``seed``; on ``meta`` only
    their shapes."""
    c, k, e, w = shape
    rng = np.random.default_rng(seed)
    cases = []
    for body, (tag, fn, plain, replaces) in BODIES.items():
        if torch.device(device).type == "meta":
            args = ((torch.empty(c, k, device="meta", dtype=torch.bfloat16),
                     torch.empty(k, e, w, device="meta", dtype=torch.bfloat16))
                    if body == "k_dot3" else
                    (torch.empty(c, e, w, device="meta", dtype=torch.bfloat16),))
        else:
            args = draw_operands(rng, body, c, k, e, w, device)
        nbytes, flops = mosaic_bytes(body, c, k, e, w)
        dims = f"[{c},{k}]@[{k},{e},{w}]" if body == "k_dot3" else f"[{c},{e},{w}]"
        cases.append(Case(f"K8o {body} {tag} {dims}", fn, plain, args, {}, nbytes, flops,
                          nbytes, flops, replaces, BF16_FLOP_PER_S))
    return cases


def body_of(case: Case) -> str:
    """``k_misc``, ``k_roll`` or ``k_dot3``: the body a case runs."""
    return case.name.split()[1]


def tolerance(case: Case, ref: torch.Tensor) -> float:
    """What the kernel's output may differ from ``ref`` (the plain version)
    by: nothing for k_misc and k_roll (each sum rounds once alike); for
    k_dot3 ``dot_variant``'s f32 tolerance at one dot and one step, ``2
    sqrt(K) 2^-24 max |out|`` (sums of K terms in another order)."""
    if body_of(case) != "k_dot3":
        return 0.0
    return 2.0 * math.sqrt(case.args[0].shape[1]) * 2.0 ** -24 * float(ref.abs().max())


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every body once at its shapes on the card, timed as the other probes
    are (best of ``repeats`` after a warm-up call): a row per case with ms,
    the GB/s and TFLOP/s of what the function needs, the bound, the CTAs and
    shared bytes, and the kernel launches the case made (``1 + repeats``)."""
    def row(case, ms):
        bms, by = bound(case)
        return {"gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
                "bound_ms": bms, "bound_by": by, "ctas": last_launch["grid"],
                "smem": last_launch["smem"]}

    return run_cases(probe_cases(card_device(device), seed), repeats, row)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Mosaic-ops probes on the card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    rows = run_all(seed=args.seed, repeats=args.repeats)
    card = describe_card()
    for r in rows:
        print(f"{r['wrapper']} {r['name']}: {r['ms']:.6f} ms -> {r['gbps']:.1f} GB/s, "
              f"{r['tflops']:.3f} TF/s needed, bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
              f"{r['ctas']} CTAs, {r['smem']} B shared) [{card}]", flush=True)
    return rows


if __name__ == "__main__":
    main()
