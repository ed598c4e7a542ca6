"""In-kernel dot probes on Hopper (port of ``benchmarks/probe_inkernel_dot.py``
and ``benchmarks/probe_inkernel_dot2.py``).

The TPU probes measured how fast dots run inside a Pallas kernel with
operands resident in VMEM, at the whole-network conv's shapes: each grid
step of ``S`` ran ``L`` dots and added their sum to the output block, so

    out = sum_{s < S} sum_{i < L} W_i . X

Here each probe is one launch of ``evflow_torch/csrc/probe_inkernel_dot.cu``,
whose CTAs stage their X tile and weight rows into shared memory with
16-byte copies and run the whole-network kernels' mma.sync mainloop over
the S steps; below 8 steps the warps that would have no step split K
instead (see the source's note). The launch chooses the CTA's output rows
(32, or 16 where 32 do not fit in shared memory), the path and the copies,
and reports them in ``last_launch``. One function per JAX ``pallas_call``:

* ``dot_pixel_major`` (A): ``out[Np, C] = S sum_i X[Np, K] @ W_i[K, C]``;
* ``dot_channel_major`` (B): ``out[C, Np] = S sum_i W_i[C, K] @ X[K, Np]``;
* ``dot_channel_major_s8`` (Bi): B in int8 x int8 -> int32;
* ``dot_ksplit`` (C): ``S sum_i sum_{j<3} W[i, j][C, 96] @ X[j][96, Np]``;
* ``dot_variant`` (``probe_inkernel_dot2.make``): B at any ``[M, K] @ [K, Np]``
  with f32 or bf16 accumulation (``VARIANTS``: the six cases of the file).

Each has a plain PyTorch version beside it (float64 sums, exact for int8;
for bf16 accumulation each dot and the running sum are rounded to bf16 as
JAX does) and a launch counter (``fn.launches``). CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.

The bf16-accumulation case draws small integers (x in [-4, 4], w in
[-16, 16], as bf16): every dot is then exact in f32 whatever the order of
its sum, so the kernel's bf16 roundings of the dots and of the running sum
are reproduced bit for bit and the case is held to equality. A kernel that
accumulated in f32, or skipped steps, differs on most elements.

    python -m evflow_torch.probes.inkernel_dot   # one line per case, needs CUDA
"""

from __future__ import annotations

import argparse
import ctypes
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from evflow_torch.device import describe_card
from evflow_torch.probes._harness import card_device, launch, on_card, run_cases

__all__ = [
    "dot_pixel_major", "dot_channel_major", "dot_channel_major_s8", "dot_ksplit",
    "dot_variant", "dot_pixel_major_plain", "dot_channel_major_plain",
    "dot_channel_major_s8_plain", "dot_ksplit_plain", "dot_variant_plain",
    "probe_cases", "run_all", "last_launch", "VARIANTS", "WRAPPERS",
]

# the probes' shapes (probe_inkernel_dot.py): pixels, channels, K = 9 taps x
# 32 channels, dots per step, steps
NP, C, K, L, S = 8192, 32, 288, 9, 64
KSEG = 96  # C's K split
# probe_inkernel_dot2.py's six cases: (name, M, K, Np, L, accumulation)
VARIANTS = (
    ("acc=bf16 [32,288]@[288,8192] x9", 32, 288, 8192, 9, torch.bfloat16),
    ("acc=f32  [128,288]@[288,8192] x9", 128, 288, 8192, 9, torch.float32),
    ("acc=f32  [32,384]@[384,8192] x9 (K pad 3x128)", 32, 384, 8192, 9, torch.float32),
    ("acc=f32  [32,288]@[288,32768] x9", 32, 288, 32768, 9, torch.float32),
    ("acc=f32  [32,288]@[288,8192] x1", 32, 288, 8192, 1, torch.float32),
    ("acc=f32  [256,256]@[256,8192] x9", 256, 256, 8192, 9, torch.float32),
)

# csrc/probe_inkernel_dot.cu's accumulation modes
F32_ACC, BF16_ACC, S8 = 0, 1, 2


class ProbeArgs(ctypes.Structure):
    """ctypes mirror of ``ProbeArgs`` in ``csrc/probe_inkernel_dot.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("x_sp", ctypes.c_longlong), ("x_sk", ctypes.c_longlong),
        ("w_si", ctypes.c_longlong), ("w_sm", ctypes.c_longlong),
        ("w_sj", ctypes.c_longlong), ("w_sk", ctypes.c_longlong),
        ("o_sp", ctypes.c_longlong), ("o_sm", ctypes.c_longlong),
        ("Np", ctypes.c_int), ("K", ctypes.c_int), ("M", ctypes.c_int), ("L", ctypes.c_int),
        ("S", ctypes.c_int), ("kseg", ctypes.c_int), ("pixel_major", ctypes.c_int),
        ("mode", ctypes.c_int),
        # set by the launch
        ("tile_m", ctypes.c_int), ("split_k", ctypes.c_int), ("grid", ctypes.c_int),
        ("smem", ctypes.c_int), ("vec", ctypes.c_int),
    ]


last_launch = {"grid": 0, "tile_m": 0, "smem": 0, "split_k": 0, "vec": 0}


def _launch(fn, x, w, out, *, x_st, w_st, o_st, Np, k, M, dots, steps, kseg, pixel_major,
            mode):
    args = ProbeArgs(
        x=x.data_ptr(), w=w.data_ptr(), out=out.data_ptr(),
        x_sp=x_st[0], x_sk=x_st[1], w_si=w_st[0], w_sm=w_st[1], w_sj=w_st[2], w_sk=w_st[3],
        o_sp=o_st[0], o_sm=o_st[1], Np=Np, K=k, M=M, L=dots, S=steps, kseg=kseg,
        pixel_major=int(pixel_major), mode=mode)
    launch("probe_inkernel_dot", args, x.device)
    fn.launches += 1
    last_launch.update(grid=args.grid, tile_m=args.tile_m, smem=args.smem,
                       split_k=args.split_k, vec=args.vec)
    return out


def _check(name: str, x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, steps: int) -> bool:
    """True for CUDA operands, False for CPU ones; raises on anything else."""
    cuda = on_card(name, x, w)
    if x.dtype != dtype or w.dtype != dtype:
        raise ValueError(f"{name}: operands must be {dtype}, got {x.dtype}, {w.dtype}")
    if steps < 1:
        raise ValueError(f"{name}: steps must be >= 1, got {steps}")
    return cuda


def _check_k(name: str, k: int, dtype: torch.dtype):
    kstep = 32 if dtype == torch.int8 else 16
    if k % kstep:
        raise ValueError(f"{name}: the kernel takes K in multiples of {kstep}, got {k}")


def _dots_plain(xk: torch.Tensor, wk: torch.Tensor, steps: int, mode: int) -> torch.Tensor:
    """``sum_s sum_i wk[i] @ xk`` for xk ``[K, Np]``, wk ``[L, M, K]``:
    float64 sums rounded once (f32 and int32 out), or each dot and the
    running sum rounded to bf16 (``BF16_ACC``, f32 out)."""
    x64 = xk.double()
    if mode == BF16_ACC:
        run = torch.zeros(wk.shape[1], xk.shape[1], dtype=torch.bfloat16, device=xk.device)
        for i in range(wk.shape[0]):
            d = (wk[i].double() @ x64).float().to(torch.bfloat16)
            run = (run.float() + d.float()).to(torch.bfloat16)
        # S adds of one bf16 value are exact in f32 (8 + 16 bits of mantissa)
        return run.float() * steps
    total = torch.matmul(wk.double(), x64).sum(0) * steps
    if mode == S8:
        if float(total.abs().max()) >= 2 ** 31:
            raise OverflowError("the int32 sum overflows")
        return total.to(torch.int32)
    return total.float()


# --- A: pixel-major ---------------------------------------------------------

def dot_pixel_major_plain(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    return _dots_plain(x.t(), w.transpose(1, 2), steps, F32_ACC).t().contiguous()


def dot_pixel_major(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    """A: x ``[Np, K]`` bf16, w ``[L, K, C]`` bf16 -> ``[Np, C]`` f32."""
    cuda = _check("dot_pixel_major", x, w, torch.bfloat16, steps)
    (Np, k), (dots, kw, M) = x.shape, w.shape
    if kw != k:
        raise ValueError(f"dot_pixel_major: x [Np, {k}] against w [L, {kw}, C]")
    if not cuda:
        return dot_pixel_major_plain(x, w, steps)
    _check_k("dot_pixel_major", k, x.dtype)
    out = torch.empty(Np, M, device=x.device, dtype=torch.float32)
    return _launch(dot_pixel_major, x, w, out, x_st=(k, 1), w_st=(k * M, 1, 0, M), o_st=(M, 1),
                   Np=Np, k=k, M=M, dots=dots, steps=steps, kseg=k, pixel_major=True,
                   mode=F32_ACC)


# --- B, Bi and dot2: channel-major ------------------------------------------

def _channel_major(fn, x, w, steps, mode):
    (k, Np), (dots, M, kw) = x.shape, w.shape
    if kw != k:
        raise ValueError(f"{fn.__name__}: x [{k}, Np] against w [L, M, {kw}]")
    _check_k(fn.__name__, k, x.dtype)
    out = torch.empty(M, Np, device=x.device,
                      dtype=torch.int32 if mode == S8 else torch.float32)
    return _launch(fn, x, w, out, x_st=(1, Np), w_st=(M * k, k, 0, 1), o_st=(1, Np), Np=Np,
                   k=k, M=M, dots=dots, steps=steps, kseg=k, pixel_major=False, mode=mode)


def dot_channel_major_plain(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    return _dots_plain(x, w, steps, F32_ACC)


def dot_channel_major(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    """B: x ``[K, Np]`` bf16, w ``[L, C, K]`` bf16 -> ``[C, Np]`` f32."""
    if not _check("dot_channel_major", x, w, torch.bfloat16, steps):
        return dot_channel_major_plain(x, w, steps)
    return _channel_major(dot_channel_major, x, w, steps, F32_ACC)


def dot_channel_major_s8_plain(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    return _dots_plain(x, w, steps, S8)


def dot_channel_major_s8(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    """Bi: x ``[K, Np]`` int8, w ``[L, C, K]`` int8 -> ``[C, Np]`` int32."""
    if not _check("dot_channel_major_s8", x, w, torch.int8, steps):
        return dot_channel_major_s8_plain(x, w, steps)
    return _channel_major(dot_channel_major_s8, x, w, steps, S8)


def dot_variant_plain(x: torch.Tensor, w: torch.Tensor, acc_dtype=torch.float32,
                      steps: int = S) -> torch.Tensor:
    return _dots_plain(x, w, steps, BF16_ACC if acc_dtype == torch.bfloat16 else F32_ACC)


def dot_variant(x: torch.Tensor, w: torch.Tensor, acc_dtype=torch.float32,
                steps: int = S) -> torch.Tensor:
    """``probe_inkernel_dot2.make(M, K, Np, L, acc_dtype)``: x ``[K, Np]``
    bf16, w ``[L, M, K]`` bf16 -> ``[M, Np]`` f32, each step's dots summed
    in ``acc_dtype`` (float32 or bfloat16)."""
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dot_variant accumulates in float32 or bfloat16, got {acc_dtype}")
    if not _check("dot_variant", x, w, torch.bfloat16, steps):
        return dot_variant_plain(x, w, acc_dtype, steps)
    return _channel_major(dot_variant, x, w, steps,
                          BF16_ACC if acc_dtype == torch.bfloat16 else F32_ACC)


# --- C: K-split ---------------------------------------------------------------

def _ksplit_operands(x: torch.Tensor, w: torch.Tensor):
    """x ``[3, 96, Np]`` -> ``[288, Np]``; w ``[L, 3, C, 96]`` -> ``[L, C, 288]``."""
    j, kk, Np = x.shape
    return x.reshape(j * kk, Np), w.permute(0, 2, 1, 3).reshape(w.shape[0], w.shape[2], j * kk)


def dot_ksplit_plain(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    return _dots_plain(*_ksplit_operands(x, w), steps, F32_ACC)


def dot_ksplit(x: torch.Tensor, w: torch.Tensor, steps: int = S) -> torch.Tensor:
    """C: x ``[3, 96, Np]`` bf16, w ``[L, 3, C, 96]`` bf16 -> ``[C, Np]`` f32,
    the three K=96 dots of each weight summed into one accumulator."""
    cuda = _check("dot_ksplit", x, w, torch.bfloat16, steps)
    (j, kk, Np), (dots, jw, M, kkw) = x.shape, w.shape
    if (j, kk) != (jw, kkw):
        raise ValueError(f"dot_ksplit: x [{j}, {kk}, Np] against w [L, {jw}, C, {kkw}]")
    if not cuda:
        return dot_ksplit_plain(x, w, steps)
    _check_k("dot_ksplit", kk, x.dtype)
    out = torch.empty(M, Np, device=x.device, dtype=torch.float32)
    return _launch(dot_ksplit, x, w, out, x_st=(1, Np), w_st=(j * M * kk, kk, M * kk, 1),
                   o_st=(1, Np), Np=Np, k=j * kk, M=M, dots=dots, steps=steps, kseg=kk,
                   pixel_major=False, mode=F32_ACC)


WRAPPERS = (dot_pixel_major, dot_channel_major, dot_channel_major_s8, dot_ksplit, dot_variant)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probes' cases ----------------------------------------------------------

class Case(NamedTuple):
    name: str
    fn: Callable
    plain: Callable
    args: tuple
    kwargs: dict
    flops: float  # 2 M K Np L S
    int8: bool


def probe_cases(device, seed: int = 0, np_pixels: int = NP, steps: int = S) -> List[Case]:
    """Every probe at the JAX files' shapes (``np_pixels`` replaces their
    Np = 8192 where given), operands drawn with numpy from ``seed``: bf16
    operands standard normal, except the bf16-accumulation case's x in
    [-4, 4] and w in [-16, 16] (integers); Bi's x in [-4, 4] and w in
    [-127, 127]."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.tensor(a).to(device=device, dtype=torch.bfloat16)

    def i8(lo, hi, *shape):
        return torch.tensor(rng.integers(lo, hi + 1, shape, dtype=np.int8), device=device)

    def bf_int(lo, hi, *shape):  # integers, exact in bf16
        return i8(lo, hi, *shape).to(torch.bfloat16)

    def fl(m, k, n, dots):
        return 2.0 * m * k * n * dots * steps

    npx = np_pixels
    kw = {"steps": steps}
    cases = [
        Case(f"A  pixel-major   [{npx},{K}]@[{K},{C}]", dot_pixel_major, dot_pixel_major_plain,
             (bf(npx, K), bf(L, K, C)), kw, fl(C, K, npx, L), False),
        Case(f"B  channel-major [{C},{K}]@[{K},{npx}]", dot_channel_major,
             dot_channel_major_plain, (bf(K, npx), bf(L, C, K)), kw, fl(C, K, npx, L), False),
        Case(f"Bi channel-major int8 [{C},{K}]@[{K},{npx}]", dot_channel_major_s8,
             dot_channel_major_s8_plain, (i8(-4, 4, K, npx), i8(-127, 127, L, C, K)), kw,
             fl(C, K, npx, L), True),
        Case(f"C  K-split x3    [{C},{KSEG}]@[{KSEG},{npx}]", dot_ksplit, dot_ksplit_plain,
             (bf(K // KSEG, KSEG, npx), bf(L, K // KSEG, C, KSEG)), kw, fl(C, K, npx, L), False),
    ]
    for name, m, k, n, dots, acc in VARIANTS:
        n = n * npx // NP
        args = ((bf_int(-4, 4, k, n), bf_int(-16, 16, dots, m, k)) if acc == torch.bfloat16
                else (bf(k, n), bf(dots, m, k)))
        cases.append(Case(f"dot2 {name}", dot_variant, dot_variant_plain, args,
                          dict(kw, acc_dtype=acc), fl(m, k, n, dots), False))
    return cases


def tolerance(case: Case, ref: torch.Tensor) -> float:
    """What the kernel's output may differ from ``ref`` (the plain version)
    by: int8 nothing; bf16 accumulation nothing (its integer operands make
    every f32 dot exact, so both round the same values to bf16); f32
    accumulation ``2 sqrt(K L S) 2^-24 max |out|``, sums of K L S terms
    taken in another order (mma accumulators, the steps split over warps)."""
    if case.int8 or case.kwargs.get("acc_dtype") == torch.bfloat16:
        return 0.0
    x, w = case.args
    steps, dots = case.kwargs["steps"], w.shape[0]
    m = ref.shape[1] if case.fn is dot_pixel_major else ref.shape[0]
    k = w[0].numel() // m
    return 2.0 * math.sqrt(k * dots * steps) * 2.0 ** -24 * float(ref.abs().max())


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every probe once at its shapes on the card, timed as the JAX probes
    time theirs (best of ``repeats`` after a warm-up call): a row per case
    with ms, TF/s (TOP/s for int8), the CTAs and their output rows, and the
    kernel launches the case made (``1 + repeats``)."""
    return run_cases(probe_cases(card_device(device), seed), repeats,
                     lambda case, ms: {"tflops": case.flops / ms / 1e9,
                                       "ctas": last_launch["grid"],
                                       "tile_m": last_launch["tile_m"], "int8": case.int8})


def main(argv=None):
    ap = argparse.ArgumentParser(description="In-kernel dot probes on the card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    rows = run_all(seed=args.seed, repeats=args.repeats)
    print(describe_card(), flush=True)
    for r in rows:
        unit = "TOP/s" if r["int8"] else "TF/s"
        print(f"{r['name']}: {r['ms']:.3f} ms -> {r['tflops']:.1f} {unit} "
              f"({r['ctas']} CTAs x {r['tile_m']} rows)", flush=True)
    return rows


if __name__ == "__main__":
    main()
