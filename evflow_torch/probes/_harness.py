"""What every probe module shares: the operand checks, the launch of a plain
C entry point, the comparison with the plain version, and the timing.

A probe module keeps only its kernels' wrappers, its cases, its tolerances
and its bounds; each case is a ``NamedTuple`` with at least ``name``, ``fn``
(the wrapper, which carries a ``launches`` counter), ``args`` and
``kwargs``. The staging, unit-loop and loop_dyn probes share ``Case``,
which also counts what the function needs (and so its ``bound``, at the
peak rate of its operations' type) apart from what the TPU probe stages
and issues.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Iterable, List, NamedTuple, Optional

import torch

from evflow_torch.device import BF16_FLOP_PER_S, HBM_BYTES_PER_S, resolve_device

__all__ = ["on_card", "launch", "compare", "time_ms", "run_cases", "card_device", "Case",
           "bound"]


def on_card(name: str, *ts: torch.Tensor, align: int = 0) -> bool:
    """True for CUDA operands, False for CPU ones. Raises on another device,
    on operands that are not contiguous or not on one device, and, where
    ``align`` is given, on CUDA operands whose address is no multiple of
    ``align`` bytes."""
    dev = ts[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {dev}")
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on one device")
        if align and dev.type == "cuda" and t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel needs {align}-byte aligned operands")
    return dev.type == "cuda"


def launch(entry: str, args: ctypes.Structure, device: torch.device):
    """Calls the plain C entry point ``entry(&args, stream)`` on ``device``'s
    current stream; raises on the ``cudaError_t`` it returns."""
    from evflow_torch.ops.cuda_build import entry_point

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry_point(entry)(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with cudaError_t {err}")


def compare(out: torch.Tensor, ref: torch.Tensor, tol: float) -> dict:
    """``out`` against ``ref`` (the plain version) under ``tol``: the
    largest error, the tolerance, the share of unequal elements, and whether
    the shapes agree and every element is finite and within ``tol``."""
    err = (out.double() - ref.double()).abs()
    ok = (out.shape == ref.shape and bool((err <= tol).all())
          and bool(torch.isfinite(out.double()).all()))
    return {"max_abs_err": float(err.max()), "tolerance": tol,
            "unequal_share": float((err > 0).double().mean()),
            "max_abs_out": float(ref.double().abs().max()), "ok": ok}


def time_ms(fn: Callable[[], object], repeats: int = 3) -> float:
    """Best CUDA-event time of ``repeats`` calls, after one warm-up call. The
    card sleeps while the host enqueues each call, so the events time the
    call on the device and not the host's enqueue."""
    fn()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e7))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def card_device(device: Optional[str]) -> torch.device:
    """The device a probe run measures: the card, or a refusal."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probes measure the card: run them on cuda")
    return dev


def run_cases(cases: Iterable, repeats: int, row: Callable[[object, float], dict]) -> List[dict]:
    """Each case timed by ``time_ms`` (best of ``repeats`` after a warm-up
    call): a dict per case with its name, wrapper, ms, the fields ``row(case,
    ms)`` adds, and the kernel launches the case made (``1 + repeats``)."""
    rows = []
    for case in cases:
        before = case.fn.launches
        ms = time_ms(lambda: case.fn(*case.args, **case.kwargs), repeats)
        rows.append({"name": case.name, "wrapper": case.fn.__name__, "ms": ms,
                     **row(case, ms), "launches": case.fn.launches - before})
    return rows


class Case(NamedTuple):
    name: str
    fn: Callable
    plain: Callable
    args: tuple
    kwargs: dict
    nbytes: int          # bytes the function needs: each needed input read once, the output written
    flops: float         # operations the function needs
    staged_bytes: int    # bytes the TPU probe stages
    issued_flops: float  # operations the TPU probe issues
    replaces: str        # the JAX probe's pallas_call
    rate: float = BF16_FLOP_PER_S  # the card's peak rate for the type of those operations


def bound(case: Case):
    """(least ms on an H100 SXM for what the function needs, "bytes" |
    "operations"): the bytes over the memory rate, the operations over
    ``case.rate``."""
    t_bytes = case.nbytes / HBM_BYTES_PER_S
    t_ops = case.flops / case.rate
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")
