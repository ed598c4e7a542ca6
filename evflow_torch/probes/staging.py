"""Staging probes on Hopper (port of ``benchmarks/probe_manual_dma.py``,
``probe_manual_dma2.py`` and ``probe_layer_grid.py``).

The TPU probes measured how a Pallas kernel stages operands from device
memory itself (``pltpu.make_async_copy`` and a DMA semaphore):

* ``row_window_copy`` (K8c, K8d): per row tile ``i`` the halo'd window
  ``x[0, :, i*TH : i*TH + E, :]`` (E = TH + 2 HALO) is copied into fast
  memory and its interior written out, ``out[0, c, h, w] = 2 x[0, c, HALO +
  h, w]`` as f32; x bf16 (K8c, HALO=6) or bf16 / f32 (K8d, HALO=8);
* ``layer_grid`` (K8e): a layer loop over a persistent accumulator with a
  copy on even layers only and the weights read at the runtime layer index,
  ``out[0] = sum_{l<L} W_l [C, 9C] @ tile9(s_l)``, ``s_l = m[l, :, :E-2]``
  for even l and 0 for odd l.

Here each probe is one launch of ``evflow_torch/csrc/probe_staging.cu``,
which stages with the TMA engine's bulk copies (the layer grid: tensor
copies into a ring of stages) completing on mbarriers (see the source's
note). Each wrapper has a plain PyTorch version beside it (the row window
exact; the layer grid in float64 sums, rounded once to f32) and a launch
counter (``fn.launches``); ``last_launch`` holds the last launch's CTAs,
channels per CTA, shared bytes and the layer grid's ring depth
(``layer_grid_plan`` mirrors its launch's choices). CPU tensors run the
plain version; CUDA tensors launch the kernel or raise.

A case's bound counts what its function needs (``nbytes``, ``flops``): the
row window's interior read once and its f32 output written, the layer
grid's even layers (odd ones multiply zeros) with the 9 repeats folded.
What the probe stages and issues is counted apart (``staged_bytes``: every
tile's halo'd window and the output; ``issued_flops``: 9 repeats on every
layer) and reported as a rate of its own.

    python -m evflow_torch.probes.staging   # one line per case, needs CUDA
"""

from __future__ import annotations

import argparse
import ctypes
import math
from typing import List, Optional

import numpy as np
import torch

from evflow_torch.device import describe_card
from evflow_torch.probes._harness import Case, bound, card_device, launch, on_card, run_cases

__all__ = [
    "row_window_copy", "row_window_copy_plain", "halo_sums_plain", "layer_grid",
    "layer_grid_plain", "layer_grid_plan", "channels_per_cta", "probe_cases", "run_all",
    "WRAPPERS", "last_launch", "floor_args",
]

# the probes' shapes: probe_manual_dma.py (HALO 6), probe_manual_dma2.py
# (HALO 8), probe_layer_grid.py (E, L; m has E + 8 rows); the large case's H
C, H, W, TH = 32, 64, 256, 16
HALO_DMA, HALO_DMA2 = 6, 8
LG_E, LG_L = 32, 7
LARGE_H = 2048

# csrc/probe_staging.cu's limits and tiles
SMEM_LIMIT = 232448   # dynamic shared memory of one CTA
HEADER = 16           # the mbarrier, before the staged data
ROW_BUDGET = 48 * 1024  # staged window bytes of one row-window CTA
LG_MAX_C = 64         # the layer grid's register tile: 4 m16 fragments
LG_PX = 64            # the layer grid's pixels per CTA
LG_BOX = 64           # bf16 columns of a staged box (128-byte rows)
LG_MAX_DEPTH = 8      # stages of the layer ring
LG_HEADER = 128 + 1024  # its full and empty barriers, and the ring's alignment


class RowWindowArgs(ctypes.Structure):
    """ctypes mirror of ``RowWindowArgs`` in ``csrc/probe_staging.cu``."""

    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("halo_sum", ctypes.c_void_p), ("esize", ctypes.c_int),
                ("C", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("th", ctypes.c_int), ("halo", ctypes.c_int), ("cpc", ctypes.c_int),
                ("grid", ctypes.c_int), ("smem", ctypes.c_int)]


class LayerGridArgs(ctypes.Structure):
    """ctypes mirror of ``LayerGridArgs`` in ``csrc/probe_staging.cu``."""

    _fields_ = [("w", ctypes.c_void_p), ("m", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("L", ctypes.c_int), ("C", ctypes.c_int), ("E", ctypes.c_int),
                ("Em", ctypes.c_int), ("W", ctypes.c_int), ("grid", ctypes.c_int),
                ("depth", ctypes.c_int), ("smem", ctypes.c_int)]


last_launch = {"grid": 0, "cpc": 0, "smem": 0, "depth": 0}


def layer_grid_plan(c: int, layers: int, pixels: int) -> dict:
    """The layer-grid launch's choices (``launch_layer_grid``), for C <=
    ``LG_MAX_C`` channels, L layers and ``pixels`` = (E-2) W: a CTA per 64
    pixels; a ring of ``depth`` stages, each one layer's weights as ``[CP,
    64]`` bf16 boxes over its 9 CP columns and its channel rows ``[CP, 64]``
    (CP = C rounded up to 16), as many as L, 8 and the CTA's shared memory
    allow; and the shared bytes, the barriers and the ring's alignment
    included."""
    cp = 16 * -(-c // 16)
    stage = (-(-9 * cp // LG_BOX) + 1) * cp * LG_BOX * 2
    depth = max(1, min(layers, LG_MAX_DEPTH, (SMEM_LIMIT - LG_HEADER) // stage))
    return {"grid": -(-pixels // LG_PX), "depth": depth, "smem": LG_HEADER + depth * stage,
            "stage": stage}


def channels_per_cta(c: int, tiles: int, e: int, w: int, esize: int, num_sms: int) -> int:
    """Channels whose E-row windows one row-window CTA stages: as many as
    fit in ``ROW_BUDGET`` bytes, but no more than leave the grid of ``tiles``
    x groups a CTA per SM of the card's ``num_sms``; at least one, and raises
    where not even one window fits in shared memory."""
    win = e * w * esize
    if HEADER + win > SMEM_LIMIT:
        raise ValueError(f"a {e} x {w} window of {esize}-byte elements ({win} bytes) does not "
                         f"fit in shared memory")
    return max(1, min(c, ROW_BUDGET // win, c * tiles // num_sms))


def _check_rows(name: str, w: int, esize: int):
    if (w * esize) % 16:
        raise ValueError(f"{name}: a row of W={w} elements must be a multiple of 16 bytes "
                         f"(the bulk copy's unit), got {w * esize}")


# --- row window (K8c, K8d) ----------------------------------------------------

def _row_window_shape(x: torch.Tensor, th: int, halo: int):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"row_window_copy takes bf16 or f32, got {x.dtype}")
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"row_window_copy takes x [1, C, H + 2 halo, W], got {tuple(x.shape)}")
    if th < 1 or halo < 0:
        raise ValueError(f"row_window_copy: th >= 1 and halo >= 0, got {th}, {halo}")
    _, c, rows, w = x.shape
    h = rows - 2 * halo
    if h < th or h % th:
        raise ValueError(f"row_window_copy: H = {h} rows must be a multiple of th = {th}")
    _check_rows("row_window_copy", w, x.element_size())
    return c, h, w


def row_window_copy_plain(x: torch.Tensor, th: int, halo: int) -> torch.Tensor:
    _, h, _ = _row_window_shape(x, th, halo)
    return x[:, :, halo:halo + h].float() * 2.0


def halo_sums_plain(x: torch.Tensor, th: int, halo: int) -> torch.Tensor:
    """``[C, H / th]`` int64: for each channel and row tile, the sum mod
    2^32 of the 32-bit words of the window's 2 ``halo`` halo rows (rows
    ``i th + [0, halo)`` and ``i th + halo + th + [0, halo)`` of x)."""
    _, h, _ = _row_window_shape(x, th, halo)
    words = x[0].view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # [C, H + 2 halo, W esize / 4]
    top = torch.arange(halo, device=x.device)
    rows = torch.arange(0, h, th, device=x.device)[:, None] + torch.cat([top, top + halo + th])
    return words[:, rows].sum((-1, -2)) & 0xFFFFFFFF


def row_window_copy(x: torch.Tensor, th: int, halo: int, halo_sums: bool = False):
    """K8c/K8d: x ``[1, C, H + 2 halo, W]`` bf16 or f32 -> ``[1, C, H, W]``
    f32, ``2 x[0, c, halo + h, w]``, each tile of ``th`` rows staged with
    its halo. With ``halo_sums`` it returns ``(out, sums)`` as well, where
    the kernel reads ``sums`` (``halo_sums_plain``'s) from the halo rows as
    they landed in shared memory."""
    cuda = on_card("row_window_copy", x, align=16)
    c, h, w = _row_window_shape(x, th, halo)
    if not cuda:
        out = row_window_copy_plain(x, th, halo)
        return (out, halo_sums_plain(x, th, halo)) if halo_sums else out
    esize = x.element_size()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cpc = channels_per_cta(c, h // th, th + 2 * halo, w, esize, sms)
    out = torch.empty(1, c, h, w, device=x.device, dtype=torch.float32)
    sums = torch.zeros(c, h // th, device=x.device, dtype=torch.int32) if halo_sums else None
    args = RowWindowArgs(x=x.data_ptr(), out=out.data_ptr(),
                         halo_sum=None if sums is None else sums.data_ptr(), esize=esize, C=c,
                         H=h, W=w, th=th, halo=halo, cpc=cpc)
    launch("probe_row_window", args, x.device)
    row_window_copy.launches += 1
    last_launch.update(grid=args.grid, cpc=cpc, smem=args.smem, depth=0)
    return (out, sums.to(torch.int64) & 0xFFFFFFFF) if halo_sums else out


# --- layer grid (K8e) -----------------------------------------------------------

def _layer_grid_shape(w_all: torch.Tensor, m: torch.Tensor, e: int):
    if w_all.dtype != torch.bfloat16 or m.dtype != torch.bfloat16:
        raise ValueError(f"layer_grid takes bf16 operands, got {w_all.dtype}, {m.dtype}")
    if w_all.dim() != 3 or m.dim() != 4:
        raise ValueError("layer_grid takes w_all [L, C, 9C] and m [L, C, Em, W]")
    layers, c, k = w_all.shape
    if k != 9 * c or tuple(m.shape[:2]) != (layers, c) or not 3 <= e <= m.shape[2]:
        raise ValueError(f"layer_grid: w_all {tuple(w_all.shape)} against m "
                         f"{tuple(m.shape)} at E={e}")
    _check_rows("layer_grid", m.shape[3], m.element_size())
    return layers, c, m.shape[3]


def layer_grid_plain(w_all: torch.Tensor, m: torch.Tensor, e: int) -> torch.Tensor:
    layers, c, w = _layer_grid_shape(w_all, m, e)
    s = m[:, :, :e - 2].double().reshape(layers, c, -1).clone()
    s[1::2] = 0.0  # odd layers: no copy, the zeroed buffer
    pat = torch.cat([s] * 9, dim=1)  # [L, 9C, P]
    out = torch.matmul(w_all.double(), pat).sum(0)
    return out.float().reshape(1, c, e - 2, w)


def layer_grid(w_all: torch.Tensor, m: torch.Tensor, e: int) -> torch.Tensor:
    """K8e: w_all ``[L, C, 9C]`` bf16, m ``[L, C, Em, W]`` bf16 (Em >= e)
    -> ``[1, C, e - 2, W]`` f32, ``sum_l W_l @ tile9(s_l)`` with ``s_l =
    m[l, :, :e-2]`` on even layers and 0 on odd ones."""
    cuda = on_card("layer_grid", w_all, m, align=16)
    layers, c, w = _layer_grid_shape(w_all, m, e)
    if not cuda:
        return layer_grid_plain(w_all, m, e)
    if c > LG_MAX_C:
        raise ValueError(f"layer_grid: the kernel takes C <= {LG_MAX_C}, got {c}")
    out = torch.empty(1, c, e - 2, w, device=m.device, dtype=torch.float32)
    args = LayerGridArgs(w=w_all.data_ptr(), m=m.data_ptr(), out=out.data_ptr(), L=layers, C=c,
                         E=e, Em=m.shape[2], W=w)
    launch("probe_layer_grid", args, m.device)
    layer_grid.launches += 1
    last_launch.update(grid=args.grid, cpc=c, smem=args.smem, depth=args.depth)
    return out


WRAPPERS = (row_window_copy, layer_grid)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probes' cases ----------------------------------------------------------

def floor_args(case):
    """A row-window case's arguments at the smallest size its kernel takes,
    one CTA: one channel, one tile of ``th`` rows with its halo. Its time is
    the kernel's launch floor."""
    (x,) = case.args
    rows = case.kwargs["th"] + 2 * case.kwargs["halo"]
    return (x[:, :1, :rows].contiguous(),), dict(case.kwargs)


def row_window_bytes(c: int, h: int, w: int, th: int, halo: int, esize: int):
    """(needed, staged): the f32 interior written, and the interior read once
    (needed) or every tile's halo'd E-row window read (staged)."""
    out = c * h * w * 4
    return c * h * w * esize + out, (h // th) * c * (th + 2 * halo) * w * esize + out


def layer_grid_bytes(layers: int, c: int, e: int, w: int):
    """(needed, staged): the even layers' E-2 rows of m and the f32 output,
    with the even layers' weights (needed) or every layer's (staged)."""
    even = (layers + 1) // 2
    rest = even * c * (e - 2) * w * 2 + c * (e - 2) * w * 4
    return even * c * 9 * c * 2 + rest, layers * c * 9 * c * 2 + rest


def probe_cases(device, seed: int = 0) -> List[Case]:
    """Every probe at the JAX files' shapes, and K8c's function at H =
    ``LARGE_H``, where the bytes and not the launch set the time. Inputs are
    drawn with numpy from ``seed`` (standard normal; the layer grid's weights
    times 0.05, as the JAX file draws them); on ``meta`` only their shapes."""
    rng = np.random.default_rng(seed)
    meta = torch.device(device).type == "meta"

    def draw(*shape, dtype=torch.bfloat16, scale=1.0):
        if meta:
            return torch.empty(shape, device="meta", dtype=dtype)
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.tensor(a).to(device=device, dtype=dtype)

    cases = []
    for tag, halo, dtype, h, replaces in (
            ("K8c bf16 HALO=6", HALO_DMA, torch.bfloat16, H, "benchmarks/probe_manual_dma.py:20"),
            ("K8d f32 HALO=8", HALO_DMA2, torch.float32, H, "benchmarks/probe_manual_dma2.py:20"),
            ("K8d bf16 HALO=8", HALO_DMA2, torch.bfloat16, H, "benchmarks/probe_manual_dma2.py:20"),
            (f"K8c large H={LARGE_H}", HALO_DMA, torch.bfloat16, LARGE_H,
             "benchmarks/probe_manual_dma.py:20")):
        esize = torch.finfo(dtype).bits // 8
        needed, staged = row_window_bytes(C, h, W, TH, halo, esize)
        cases.append(Case(f"{tag} [1,{C},{h + 2 * halo},{W}]", row_window_copy,
                          row_window_copy_plain, (draw(1, C, h + 2 * halo, W, dtype=dtype),),
                          {"th": TH, "halo": halo}, needed, 0.0, staged, 0.0, replaces))
    needed, staged = layer_grid_bytes(LG_L, C, LG_E, W)
    px = (LG_E - 2) * W
    cases.append(Case(f"K8e [{LG_L},{C},{9 * C}] x [{LG_L},{C},{LG_E + 8},{W}]",
                      layer_grid, layer_grid_plain,
                      (draw(LG_L, C, 9 * C, scale=0.05), draw(LG_L, C, LG_E + 8, W)),
                      {"e": LG_E}, needed, 2.0 * C * C * px * ((LG_L + 1) // 2), staged,
                      2.0 * C * 9 * C * px * LG_L, "benchmarks/probe_layer_grid.py:42"))
    return cases


def tolerance(case: Case, ref: torch.Tensor) -> float:
    """What the kernel's output may differ from ``ref`` (the plain version)
    by: the row window nothing (a copy and x2 are exact); the layer grid
    ``2 sqrt(K L) 2^-24 max |out|``, K = 9C, sums of K L products in another
    order (f32 mma accumulators against float64)."""
    if case.fn is row_window_copy:
        return 0.0
    w_all = case.args[0]
    k_total = w_all.shape[0] * w_all.shape[2]
    return 2.0 * math.sqrt(k_total) * 2.0 ** -24 * float(ref.abs().max())


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every staging probe once at its shapes on the card, timed as the
    JAX probes time theirs (best of ``repeats`` after a warm-up call): a row
    per case with ms, the function's GB/s and the staged GB/s, the issued
    TFLOP/s, the bound, the CTAs, channels per CTA and shared bytes, and the
    kernel launches the case made (``1 + repeats``)."""
    def row(case, ms):
        bms, by = bound(case)
        return {"gbps": case.nbytes / ms / 1e6, "staged_gbps": case.staged_bytes / ms / 1e6,
                "tflops": case.issued_flops / ms / 1e9, "bound_ms": bms, "bound_by": by,
                "ctas": last_launch["grid"], "channels_per_cta": last_launch["cpc"],
                "smem": last_launch["smem"]}

    return run_cases(probe_cases(card_device(device), seed), repeats, row)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Staging probes on the card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    rows = run_all(seed=args.seed, repeats=args.repeats)
    card = describe_card()
    for r in rows:
        rate = (f"{r['tflops']:.1f} TF/s issued" if r["wrapper"] == "layer_grid"
                else f"{r['gbps']:.1f} GB/s ({r['staged_gbps']:.1f} staged)")
        print(f"{r['wrapper']} {r['name']}: {r['ms']:.4f} ms -> {rate}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['ctas']} CTAs, {r['smem']} B shared) [{card}]", flush=True)
    return rows


if __name__ == "__main__":
    main()
