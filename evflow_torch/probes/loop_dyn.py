"""The runtime-indexed loop probes on Hopper (port of
``benchmarks/probe_loop_dyn.py``, K8f, ``probe_loop_dyn2.py``, K8g, and
``probe_loop_dyn3.py``, K8h).

The TPU probes asked whether a layer loop with a runtime trip count
(``fori_loop``) can read and write on-chip scratch at the runtime layer
index ``l``, in f32 (K8f, K8g) and with bf16 scratch or operands (K8h).
Over x ``[L, C, E, W]`` and, for the dots, w ``[L, C, 3C]``, the eleven
bodies compute:

* ``k1`` / ``k10`` (``dyn_load_sum``): ``out = sum_l x[l]`` read from a
  copy in scratch, f32 / bf16 scratch, f32 sum;
* ``k5`` (``dyn_load_sum(slot=True)``): ``out = sum_l x[s(l)]``, s(l) = 0
  at l=1, 1 at l=2, else 2: x0 + x1 + 2 x2, x3 never read;
* ``k3`` / ``k11`` (``dyn_store``): ``scr[l] = 2 x[l]`` stored at the
  runtime index in f32 / bf16 (rounded, then doubled), ``out = f32(scr[0])``;
  ``scratch=True`` returns the whole scratch as well, which the output
  cannot show;
* ``k4`` (``dyn_store_bulk``): ``out[l] = 3 x[l]`` through a stage and a
  copy to the runtime index. The JAX ``k4`` raises in interpret mode (its
  ``o_hbm.at[pl.ds(l, 1)][0]`` is not a Ref); ``k9`` of
  ``probe_loop_dyn2.py`` computes the same function with ``.at[l]``, and
  this kernel stands for both;
* ``k2`` / ``k12`` (``dyn_load_dot``): ``out = sum_l w[l] @ concat(x[l],
  x[l], x[l])`` in f32 / on bf16 operands, f32 accumulation;
* ``k6`` (``dyn_narrow_sum``): ``out[c, :, :] = sum_l p[l][c][1]`` from a
  narrow p ``[L, C, 3]``, broadcast over ``[E, W]``;
* ``k7`` (``dyn_conv_sum``): ``out = sum_l conv3x3(x[l], w[l])``, SAME
  padding with zero rows and columns, w ``[L, C, 9C]`` with
  ``w[l][co, (dy 3 + dx) C + ci]``, exact f32;
* ``k8`` (``dyn_store_window``): ``out[l, 0] = 2 x[l][:, 8 : 8 + TH]``, a
  row window of every layer stored at the runtime index into ``[L, 1, C,
  TH, W]``: k4's bulk store with a source window and a scale.

Each body is one launch of one of seven kernels in
``evflow_torch/csrc/probe_loop_dyn.cu`` (see the source's note), through
one entry point. The plain versions sum in float64 and round once to f32.
CPU tensors run the plain version; CUDA tensors launch the kernel or raise.

A case's bound counts what its function needs (``nbytes``, ``flops``; the
dots' three weight blocks fold into one, see ``loop_dyn_bytes``) over the
rate of its operations' type (``Case.rate``); what the TPU probe stages and
issues is counted apart.

    python -m evflow_torch.probes.loop_dyn   # one line per body, needs CUDA
"""

from __future__ import annotations

import argparse
import ctypes
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from evflow_torch.device import BF16_FLOP_PER_S, F32_FLOP_PER_S, describe_card
from evflow_torch.probes._harness import Case, bound, card_device, launch, on_card, run_cases

__all__ = [
    "dyn_load_sum", "dyn_load_sum_plain", "dyn_store", "dyn_store_plain", "dyn_store_bulk",
    "dyn_store_bulk_plain", "dyn_load_dot", "dyn_load_dot_plain", "dyn_narrow_sum",
    "dyn_narrow_sum_plain", "dyn_conv_sum", "dyn_conv_sum_plain", "dyn_store_window",
    "dyn_store_window_plain", "conv_weights", "slot_of", "loop_dyn_bytes", "draw_operands",
    "load_dot_smem", "load_dot_grid", "store_smem", "store_grid", "store_kernel_bytes",
    "store_bulk_tile", "store_bulk_grid", "store_bulk_smem", "conv_sum_grid", "conv_sum_tile",
    "floor_args", "probe_cases",
    "body_of", "bound", "tolerance", "f32_tolerance", "bf16_sums", "run_all", "WRAPPERS",
    "BODIES", "last_launch",
]

# the probes' shapes (probe_loop_dyn.py:17, probe_loop_dyn2.py:15,
# probe_loop_dyn3.py:13), C being also the only width the kernels take
L, C, E, W, TH = 4, 32, 24, 256, 8
ROW0 = 8                # k8's first stored row (probe_loop_dyn2.py:72)
TP = 64                 # pixels of every channel per CTA (csrc/probe_loop_dyn.cu)
DOT_TP = 32             # pixels of every channel per k2 / k12 CTA
ST_TP = 32              # pixels of every channel per k3 / k11 CTA
CONV_TW, CONV_CO = 32, 16  # columns of one row and output channels per k7 CTA
BULK_CTAS = 132         # CTAs a bulk-store layer is cut for at least: an H100 SXM's SMs
BULK_MIN, BULK_MAX = 256, 512  # elements of a bulk-store tile
RING = 8                # layer stages of the bulk store and of k12, at most
SMEM_LIMIT = 232448     # dynamic shared memory of one CTA
LOAD_SUM, STORE, STORE_BULK, LOAD_DOT, NARROW_SUM, CONV = range(6)


class LoopDynArgs(ctypes.Structure):
    """ctypes mirror of ``LoopDynArgs`` in ``csrc/probe_loop_dyn.cu``."""

    _fields_ = [("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("op", ctypes.c_int), ("bf16", ctypes.c_int),
                ("slot", ctypes.c_int), ("L", ctypes.c_int), ("C", ctypes.c_int),
                ("P", ctypes.c_int), ("W", ctypes.c_int), ("row0", ctypes.c_int),
                ("rows", ctypes.c_int), ("scale", ctypes.c_float), ("grid", ctypes.c_int),
                ("threads", ctypes.c_int), ("smem", ctypes.c_int)]


last_launch = {"grid": 0, "threads": 0, "smem": 0}


def slot_of(l: int) -> int:
    """The scratch slot k5 reads at layer ``l``: 0 at l=1, 1 at l=2, else 2."""
    return 0 if l == 1 else (1 if l == 2 else 2)


# --- operand checks ------------------------------------------------------------

def _x_shape(name, x, dtypes, slot=False):
    if x.dtype not in dtypes:
        raise ValueError(f"{name} takes x of {' or '.join(map(str, dtypes))}, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} takes x [L, C, E, W], got {tuple(x.shape)}")
    if slot and x.shape[0] < 3:
        raise ValueError(f"{name}: the slot map reads layers 0..2, got L={x.shape[0]}")
    return tuple(x.shape)


def _dot_shape(x, w, name="dyn_load_dot", taps=3, dtypes=(torch.float32, torch.bfloat16)):
    layers, c, _, _ = _x_shape(name, x, dtypes)
    if w.dtype != x.dtype or tuple(w.shape) != (layers, c, taps * c):
        raise ValueError(f"{name} takes w [L, C, {taps}C] of x's type, got {w.dtype} "
                         f"{tuple(w.shape)} against x {tuple(x.shape)}")


def _narrow_shape(p, e, w):
    if p.dtype != torch.float32 or p.dim() != 3 or p.shape[2] != 3:
        raise ValueError(f"dyn_narrow_sum takes p [L, C, 3] f32, got {p.dtype} {tuple(p.shape)}")
    if e < 1 or w < 1:
        raise ValueError(f"dyn_narrow_sum broadcasts over [E, W] >= 1, got [{e}, {w}]")
    return (p.shape[0], p.shape[1], e, w)


def _window(x, row0, rows):
    e = _x_shape("dyn_store_window", x, (torch.float32,))[2]
    if row0 < 0 or rows < 1 or row0 + rows > e:
        raise ValueError(f"dyn_store_window: rows {row0}..{row0 + rows} lie outside E={e}")


def _check_card(name, shape, slab_bytes, px8=True):
    layers, c, e, w = shape
    if c != C:
        raise ValueError(f"{name}: the kernel takes C={C}, got {c}")
    if px8 and (e * w) % 8:
        raise ValueError(f"{name}: the kernel takes E W a multiple of 8, got {e * w}")
    if slab_bytes > SMEM_LIMIT:
        raise ValueError(f"{name}: L={layers} layers of scratch need {slab_bytes} bytes of "
                         f"shared memory, beyond {SMEM_LIMIT}")


# --- plain versions ------------------------------------------------------------

def dyn_load_sum_plain(x: torch.Tensor, slot: bool = False) -> torch.Tensor:
    layers = _x_shape("dyn_load_sum", x, (torch.float32, torch.bfloat16), slot)[0]
    idx = [slot_of(l) if slot else l for l in range(layers)]
    return x[idx].double().sum(0).float()


def dyn_store_plain(x: torch.Tensor, scratch_dtype: torch.dtype = torch.float32,
                    scratch: bool = False):
    _x_shape("dyn_store", x, (torch.float32,))
    scr = x.to(scratch_dtype) * 2  # rounded to the scratch type first, then doubled in it
    out = scr[0].float()
    return (out, scr) if scratch else out


def dyn_store_bulk_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    _x_shape("dyn_store_bulk", x, (torch.float32,))
    res = x * 3.0
    return res if out is None else out.copy_(res)


def dyn_load_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _dot_shape(x, w)
    layers, c = x.shape[:2]
    pg = torch.cat([x.double()] * 3, dim=1).reshape(layers, 3 * c, -1)  # concat(h, h, h)
    return torch.matmul(w.double(), pg).sum(0).float().reshape(x.shape[1:])


def dyn_narrow_sum_plain(p: torch.Tensor, e: int, w: int) -> torch.Tensor:
    _, c, e, w = _narrow_shape(p, e, w)
    return p[:, :, 1].double().sum(0).float()[:, None, None].expand(c, e, w).contiguous()


def conv_weights(w: torch.Tensor) -> torch.Tensor:
    """w ``[L, C, 9C]`` (``w[l][co, (dy 3 + dx) C + ci]``) as ``[C, L C, 3,
    3]``: the sum over layers of the convs is one conv of x ``[1, L C, E,
    W]``."""
    layers, c = w.shape[:2]
    return w.reshape(layers, c, 3, 3, c).permute(1, 0, 4, 2, 3).reshape(c, layers * c, 3, 3)


def dyn_conv_sum_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _dot_shape(x, w, "dyn_conv_sum", 9, (torch.float32,))
    layers, c, e, wd = x.shape
    out = F.conv2d(x.double().reshape(1, layers * c, e, wd), conv_weights(w.double()), padding=1)
    return out[0].float()


def dyn_store_window_plain(x: torch.Tensor, row0: int = ROW0, rows: int = TH,
                           scale: float = 2.0) -> torch.Tensor:
    _window(x, row0, rows)
    return (x[:, :, row0:row0 + rows] * scale)[:, None].contiguous()


# --- the kernels ---------------------------------------------------------------

def _launch(op, x, out, w=None, scratch=None, bf16=False, slot=False, image=None, row0=0,
            rows=0, scale=0.0):
    """Launches ``op`` over x ``[L, C, E, W]`` (or p ``[L, C, 3]`` with its
    output's ``image`` = (E, W))."""
    layers, c = x.shape[:2]
    e, wd = x.shape[2:] if image is None else image
    args = LoopDynArgs(x=x.data_ptr(), w=None if w is None else w.data_ptr(), out=out.data_ptr(),
                       scratch=None if scratch is None else scratch.data_ptr(), op=op,
                       bf16=int(bf16), slot=int(slot), L=layers, C=c, P=e * wd, W=wd, row0=row0,
                       rows=rows, scale=scale)
    launch("probe_loop_dyn", args, x.device)
    last_launch.update(grid=args.grid, threads=args.threads, smem=args.smem)


def _slab(layers, esize):
    return layers * C * TP * esize


def load_dot_smem(layers: int, esize: int) -> int:
    """Dynamic shared memory of a ``dyn_load_dot`` CTA: f32 (k2) 128 bytes
    of layer barriers, then every layer's ``[C, 32]`` slab and ``[C, 3C]``
    weight rows padded to 3C + 4 words, or the four channel quarters'
    ``[C, 32 + 4]`` partial sums where larger; bf16 (k12) 128 bytes of full
    and empty barriers and 1024 of slack that aligns the ring, a ring of up
    to 8 layer stages (w[l]'s three ``[C, C]`` blocks and x[l]'s ``[C,
    32]`` slab, 8 KB) and the four K groups' ``[C, 32 + 8]`` f32 partial
    sums."""
    if esize == 2:
        return 128 + 1024 + min(layers, RING) * 4 * C * DOT_TP * 2 + 4 * C * (DOT_TP + 8) * 4
    return 128 + max(layers * C * (DOT_TP + 3 * C + 4) * 4, 4 * C * (DOT_TP + 4) * 4)


def load_dot_grid(p: int, esize: int) -> int:
    """CTAs of a ``dyn_load_dot`` launch over ``p = E W`` pixels: 32 pixels
    a CTA, in f32 (k2) and in bf16 (k12): 192 at the files' 6144."""
    return -(-p // DOT_TP)


def store_bulk_tile(layer: int) -> int:
    """Elements of one output layer that a bulk-store CTA (k4, k8) owns, for
    a flattened layer of ``layer = C rows W`` elements: the layer cut for
    132 CTAs (an H100 SXM's SMs) in whole 16-byte pieces, between 256 and
    512 elements, one piece a thread (500 at k8's 65,536: 132 CTAs; 512 at
    k4's 196,608: 384 CTAs)."""
    per_cta = -(-layer // BULK_CTAS)
    return max(BULK_MIN, min(BULK_MAX, -(-per_cta // 4) * 4))


def store_bulk_grid(layer: int) -> int:
    """CTAs of a bulk-store launch (k4, k8) over a flattened output layer of
    ``layer`` elements: 384 at k4's, 132 at k8's."""
    return -(-layer // store_bulk_tile(layer))


def store_bulk_smem(layers: int, layer: int) -> int:
    """Dynamic shared memory of a bulk-store CTA: a ring of up to 8 f32
    stages of its tile, one a layer."""
    return min(layers, RING) * store_bulk_tile(layer) * 4


def store_smem(layers: int, esize: int) -> int:
    """Dynamic shared memory of a ``dyn_store`` CTA: its ``[L, C, 32]`` slab
    in the scratch type (``esize`` 4: f32, k3; 2: bf16, k11)."""
    return layers * C * ST_TP * esize


def store_grid(p: int) -> int:
    """CTAs of a ``dyn_store`` launch over ``p = E W`` pixels: 32 pixels a
    CTA (192 at the files' 6144)."""
    return -(-p // ST_TP)


def store_kernel_bytes(layers: int, c: int, e: int, w: int) -> int:
    """Bytes a ``dyn_store`` launch reads and writes without ``scratch``:
    every layer of x (the TPU body stores each at the runtime index) and the
    f32 output, each once; the function needs x[0] alone
    (``loop_dyn_bytes``)."""
    return (layers + 1) * c * e * w * 4


def conv_sum_grid(e: int, w: int) -> int:
    """CTAs of a ``dyn_conv_sum`` launch (k7) over an ``e`` x ``w`` image:
    one row, 32 columns and one half of the output channels a CTA (384 at
    the file's 24 x 256)."""
    return e * -(-w // CONV_TW) * (C // CONV_CO)


def conv_sum_tile(cta: int, e: int, w: int):
    """The outputs k7's CTA ``cta`` writes (``csrc/probe_loop_dyn.cu``,
    ``conv_sum_kernel``): (row, columns, output channels) as ranges, the
    columns cut at the image's edge."""
    tiles = -(-w // CONV_TW)
    half, t = cta % 2, cta // 2
    row, w0 = t // tiles, (t % tiles) * CONV_TW
    return row, range(w0, min(w0 + CONV_TW, w)), range(half * CONV_CO, (half + 1) * CONV_CO)


def floor_args(case: Case):
    """The arguments and keywords of ``case``'s body at the smallest size its
    kernel takes, one CTA: one layer of 8 pixels (k5 the three layers its
    slot map reads, k6 an 8-pixel image from p[0], k8 a window of one
    8-pixel row, the dots k2, k7 and k12 with w[0]; k7's 8-pixel row runs
    two CTAs, one a channel half). Its time is the kernel's launch floor."""
    body = body_of(case)
    if body == "k6":
        return (case.args[0][:1].contiguous(), 1, 8), dict(case.kwargs)
    x = case.args[0][:3 if body == "k5" else 1, :, :1, :8].contiguous()
    if body in DOTS:
        return (x, case.args[1][:1].contiguous()), dict(case.kwargs)
    if body == "k8":
        return (x,), dict(case.kwargs, row0=0, rows=1)
    return (x,), dict(case.kwargs)


def dyn_load_sum(x: torch.Tensor, slot: bool = False) -> torch.Tensor:
    """k1 / k10 (k5 with ``slot``): x ``[L, C, E, W]`` f32 or bf16 copied
    into scratch, its layers (or slots) summed at the runtime index ->
    ``[C, E, W]`` f32."""
    cuda = on_card("dyn_load_sum", x, align=16)
    shape = _x_shape("dyn_load_sum", x, (torch.float32, torch.bfloat16), slot)
    if not cuda:
        return dyn_load_sum_plain(x, slot)
    _check_card("dyn_load_sum", shape, _slab(shape[0], x.element_size()))
    out = torch.empty(shape[1:], device=x.device, dtype=torch.float32)
    _launch(LOAD_SUM, x, out, bf16=x.dtype == torch.bfloat16, slot=slot)
    dyn_load_sum.launches += 1
    return out


def dyn_store(x: torch.Tensor, scratch_dtype: torch.dtype = torch.float32,
              scratch: bool = False):
    """k3 / k11: ``scr[l] = 2 x[l]`` stored at the runtime index into f32 or
    bf16 scratch (bf16: rounded, then doubled), -> ``f32(scr[0])`` ``[C, E,
    W]``; with ``scratch`` also the whole scratch ``[L, C, E, W]``, written
    out by the kernel on a branch that the other launches skip."""
    if scratch_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dyn_store keeps f32 or bf16 scratch, got {scratch_dtype}")
    cuda = on_card("dyn_store", x, align=16)
    shape = _x_shape("dyn_store", x, (torch.float32,))
    if not cuda:
        return dyn_store_plain(x, scratch_dtype, scratch)
    _check_card("dyn_store", shape, store_smem(shape[0], torch.finfo(scratch_dtype).bits // 8))
    out = torch.empty(shape[1:], device=x.device, dtype=torch.float32)
    scr = torch.empty(shape, device=x.device, dtype=scratch_dtype) if scratch else None
    _launch(STORE, x, out, scratch=scr, bf16=scratch_dtype == torch.bfloat16)
    dyn_store.launches += 1
    return (out, scr) if scratch else out


def dyn_store_bulk(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k4 (and k9): ``out[l] = 3 x[l]`` ``[L, C, E, W]`` f32, each layer
    staged and copied to its runtime index; into ``out`` where given (f32,
    x's shape), which every launch writes whole."""
    cuda = on_card("dyn_store_bulk", x, *(() if out is None else (out,)), align=16)
    shape = _x_shape("dyn_store_bulk", x, (torch.float32,))
    if out is not None and (out.dtype != torch.float32 or tuple(out.shape) != shape):
        raise ValueError(f"dyn_store_bulk writes out {shape} f32, got {out.dtype} "
                         f"{tuple(out.shape)}")
    if not cuda:
        return dyn_store_bulk_plain(x, out)
    _check_card("dyn_store_bulk", shape, 0)
    if out is None:
        out = torch.empty(shape, device=x.device, dtype=torch.float32)
    _launch(STORE_BULK, x, out, rows=shape[2], scale=3.0)
    dyn_store_bulk.launches += 1
    return out


def dyn_store_window(x: torch.Tensor, row0: int = ROW0, rows: int = TH,
                     scale: float = 2.0) -> torch.Tensor:
    """k8: ``out[l, 0] = scale x[l][:, row0 : row0 + rows]`` ``[L, 1, C,
    rows, W]`` f32 from x ``[L, C, E, W]`` f32, each layer's window staged
    and copied to its runtime index (k4's bulk store with a source window);
    on the card ``rows W`` and ``row0 W`` must be multiples of 4 (16-byte
    runs)."""
    cuda = on_card("dyn_store_window", x, align=16)
    _window(x, row0, rows)
    if not cuda:
        return dyn_store_window_plain(x, row0, rows, scale)
    layers, c, _, w = x.shape
    _check_card("dyn_store_window", tuple(x.shape), 0)
    if (rows * w) % 4 or (row0 * w) % 4:
        raise ValueError(f"dyn_store_window: rows W and row0 W must be multiples of 4 (16-byte "
                         f"runs), got rows={rows}, row0={row0}, W={w}")
    out = torch.empty(layers, 1, c, rows, w, device=x.device, dtype=torch.float32)
    _launch(STORE_BULK, x, out, row0=row0, rows=rows, scale=float(scale))
    dyn_store_window.launches += 1
    return out


def dyn_narrow_sum(p: torch.Tensor, e: int = E, w: int = W) -> torch.Tensor:
    """k6: ``out[c, :, :] = sum_l p[l][c][1]``, p ``[L, C, 3]`` f32 (a
    12-byte row, staged whole) -> ``[C, e, w]`` f32."""
    cuda = on_card("dyn_narrow_sum", p, align=16)
    shape = _narrow_shape(p, e, w)
    if not cuda:
        return dyn_narrow_sum_plain(p, e, w)
    _check_card("dyn_narrow_sum", shape, 16 + p.numel() * 4)
    out = torch.empty(shape[1:], device=p.device, dtype=torch.float32)
    _launch(NARROW_SUM, p, out, image=(e, w))
    dyn_narrow_sum.launches += 1
    return out


def dyn_conv_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k7: ``sum_l conv3x3_SAME(x[l], w[l])``, x ``[L, C, E, W]`` f32, w
    ``[L, C, 9C]`` f32 (``w[l][co, (dy 3 + dx) C + ci]``), zero rows and
    columns outside the image, exact f32 -> ``[C, E, W]`` f32."""
    cuda = on_card("dyn_conv_sum", x, w, align=16)
    _dot_shape(x, w, "dyn_conv_sum", 9, (torch.float32,))
    if not cuda:
        return dyn_conv_sum_plain(x, w)
    _check_card("dyn_conv_sum", tuple(x.shape), 0, px8=False)
    out = torch.empty(x.shape[1:], device=x.device, dtype=torch.float32)
    _launch(CONV, x, out, w=w)
    dyn_conv_sum.launches += 1
    return out


def dyn_load_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k2 / k12: ``sum_l w[l] @ concat(x[l], x[l], x[l])``, x ``[L, C, E,
    W]`` and w ``[L, C, 3C]`` both f32 or both bf16, -> ``[C, E, W]`` f32."""
    cuda = on_card("dyn_load_dot", x, w, align=16)
    _dot_shape(x, w)
    if not cuda:
        return dyn_load_dot_plain(x, w)
    esize = x.element_size()
    _check_card("dyn_load_dot", tuple(x.shape), load_dot_smem(x.shape[0], esize))
    out = torch.empty(x.shape[1:], device=x.device, dtype=torch.float32)
    _launch(LOAD_DOT, x, out, w=w, bf16=esize == 2)
    dyn_load_dot.launches += 1
    return out


WRAPPERS = (dyn_load_sum, dyn_store, dyn_store_bulk, dyn_load_dot, dyn_narrow_sum, dyn_conv_sum,
            dyn_store_window)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probes' cases -----------------------------------------------------------

# body: (probe, the file's name for it, wrapper, plain, kwargs, the TPU pallas_call)
BODIES = {
    "k1": ("K8f", "dyn-load", dyn_load_sum, dyn_load_sum_plain, {},
           "benchmarks/probe_loop_dyn.py:21"),
    "k2": ("K8f", "dyn-load+dot", dyn_load_dot, dyn_load_dot_plain, {},
           "benchmarks/probe_loop_dyn.py:21"),
    "k3": ("K8f", "dyn-store", dyn_store, dyn_store_plain, {"scratch_dtype": torch.float32},
           "benchmarks/probe_loop_dyn.py:21"),
    "k4": ("K8f", "dma-store", dyn_store_bulk, dyn_store_bulk_plain, {},
           "benchmarks/probe_loop_dyn.py:21"),
    "k5": ("K8f", "dyn-load-where", dyn_load_sum, dyn_load_sum_plain, {"slot": True},
           "benchmarks/probe_loop_dyn.py:21"),
    "k10": ("K8h", "dyn-load-bf16", dyn_load_sum, dyn_load_sum_plain, {},
            "benchmarks/probe_loop_dyn3.py:29"),
    "k11": ("K8h", "dyn-store-bf16", dyn_store, dyn_store_plain,
            {"scratch_dtype": torch.bfloat16}, "benchmarks/probe_loop_dyn3.py:43"),
    "k12": ("K8h", "dyn-load-bf16-dot", dyn_load_dot, dyn_load_dot_plain, {},
            "benchmarks/probe_loop_dyn3.py:61"),
    "k6": ("K8g", "p-narrow", dyn_narrow_sum, dyn_narrow_sum_plain, {},
           "benchmarks/probe_loop_dyn2.py:31"),
    "k7": ("K8g", "patches+dot", dyn_conv_sum, dyn_conv_sum_plain, {},
           "benchmarks/probe_loop_dyn2.py:60"),
    "k8": ("K8g", "5d-store", dyn_store_window, dyn_store_window_plain,
           {"row0": ROW0, "rows": TH, "scale": 2.0}, "benchmarks/probe_loop_dyn2.py:75"),
}
DOTS = ("k2", "k12", "k7")
F32_DOTS = ("k2", "k7")


def loop_dyn_bytes(body: str, layers: int, c: int, e: int, w: int, rows: int = TH):
    """(needed bytes, needed flops, staged bytes, issued flops) of one call.

    Needed: each input the function reads, once, and its f32 output: every
    layer of x for k1, k10, k2, k12, k4 and k7 (k4 writes every layer too),
    x[0] alone for k3 and k11 (the output is scr[0]), layers 0..2 for k5,
    the ``rows`` window of every layer for k8 (which writes it too), the
    whole narrow p for k6; the dots' weights. The dots need 2 C C flops per
    pixel and layer: ``w[l] @ concat(h, h, h)`` is ``(w0 + w1 + w2) @ h``;
    k7's conv 2 C 9C. The copies, sums and scalings count no flops (as the
    staging probes' x2 does not): they are far below the bytes. Staged and
    issued: what the TPU's ``pallas_call`` moves in and out (K8f passes x
    and w to every body, K8g and K8h only what each takes; k8 stages the
    whole x) and the three blocks' 2 C 3C flops per pixel and layer (k7: its
    conv's)."""
    px = e * w
    f32, bf16 = c * px * 4, c * px * 2
    if body == "k6":
        needed = layers * c * 3 * 4 + f32
        return needed, 0.0, needed, 0.0
    if body == "k7":
        flops = 2.0 * c * 9 * c * px * layers
        needed = layers * f32 + layers * c * 9 * c * 4 + f32
        return needed, flops, needed, flops
    if body == "k8":
        window = layers * c * rows * w * 4
        return 2 * window, 0.0, layers * f32 + window, 0.0
    x_layer = bf16 if body in ("k10", "k12") else f32
    out = layers * f32 if body == "k4" else f32
    w_bytes = layers * c * 3 * c * (2 if body == "k12" else 4)
    read = {"k3": 1, "k11": 1, "k5": min(3, layers)}.get(body, layers)
    dot = body in ("k2", "k12")
    needed = read * x_layer + (w_bytes if dot else 0) + out
    staged = layers * x_layer + (w_bytes if BODIES[body][0] == "K8f" or dot else 0) + out
    flops = 2.0 * c * c * px * layers if dot else 0.0
    return needed, flops, staged, 3 * flops


def draw_operands(rng, kind: str, layers: int, c: int, e: int, w: int, device="cpu",
                  normals: bool = False, base: int = 16):
    """The operands of body ``kind`` (``k1`` .. ``k12``), with numpy from
    ``rng``: x[l] (k6: p[l]) integers in [-4, 4] times ``base``^l, w
    integers in [-2, 2], and for k11 standard normals in f32 (most of them
    not bf16-exact, so the rounding shows). Every value is exact in bf16,
    and for L <= 4 and C <= 32 every sum is an exact integer below 2^24 (a
    dot's 3C terms, and k7's 9C, at most 2 4 16^3 each), so any summation
    order gives the same f32 result; ``base`` 8 keeps a dot's sums below
    2^24 up to L = 5 (3C 2 4 (8^5 - 1) / 7 < 2^22). The ``base``^l scale
    makes every layer differ: a kernel reading the wrong layer moves the
    output; p's other two columns are drawn alike, so reading another column
    moves it too. Returns the body's positional arguments (k6: p and the
    output's E and W).

    With ``normals`` (the dots k2, k7 and k12 only) x and w are standard
    normals instead, f32 for k2 and k7 (most of them not exact in TF32 or
    bf16: a dot that rounds its operands misses ``f32_tolerance``), rounded
    to bf16 for k12 (whose products are exact in f32: a dot that sums them
    in bf16 misses it); each is held to ``f32_tolerance``."""
    if kind not in BODIES:
        raise ValueError(f"unknown body {kind!r}; one of {sorted(BODIES)}")
    if normals:
        if kind not in DOTS:
            raise ValueError(f"normals are drawn for {DOTS}, not {kind!r}")
        taps = 9 if kind == "k7" else 3
        dtype = torch.bfloat16 if kind == "k12" else torch.float32
        return tuple(torch.tensor(rng.standard_normal(shape, dtype=np.float32)).to(device=device,
                                                                                  dtype=dtype)
                     for shape in ((layers, c, e, w), (layers, c, taps * c)))
    dtype = torch.bfloat16 if kind in ("k10", "k12") else torch.float32

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    shape = (layers, c, e, w)
    if kind == "k11":
        return (tensor(rng.standard_normal(shape, dtype=np.float32)),)
    scale = float(base) ** np.arange(layers)[:, None, None, None]
    if kind == "k6":
        return tensor(rng.integers(-4, 5, (layers, c, 3)) * scale[..., 0]), e, w
    x = tensor(rng.integers(-4, 5, shape) * scale)
    if kind in DOTS:
        return x, tensor(rng.integers(-2, 3, (layers, c, (9 if kind == "k7" else 3) * c)))
    return (x,)


def probe_cases(device, seed: int = 0, shape=(L, C, E, W)) -> List[Case]:
    """The eleven bodies (k1-k5, k10-k12, k6-k8) at the JAX files' shapes,
    operands from ``draw_operands`` with numpy from ``seed``; on ``meta``
    only their shapes."""
    layers, c, e, w = shape
    rng = np.random.default_rng(seed)
    meta = torch.device(device).type == "meta"

    def operands(kind):
        if not meta:
            return draw_operands(rng, kind, layers, c, e, w, device)
        dtype = torch.bfloat16 if kind in ("k10", "k12") else torch.float32
        if kind == "k6":
            return torch.empty(layers, c, 3, device="meta"), e, w
        x = torch.empty(shape, device="meta", dtype=dtype)
        if kind in DOTS:
            taps = 9 if kind == "k7" else 3
            return x, torch.empty(layers, c, taps * c, device="meta", dtype=dtype)
        return (x,)

    cases = []
    for body, (probe, tag, fn, plain, kwargs, replaces) in BODIES.items():
        needed, flops, staged, issued = loop_dyn_bytes(body, layers, c, e, w)
        rate = F32_FLOP_PER_S if body in F32_DOTS else BF16_FLOP_PER_S
        cases.append(Case(f"{probe} {body} {tag} [{layers},{c},{e},{w}]", fn, plain,
                          operands(body), dict(kwargs), needed, flops, staged, issued, replaces,
                          rate))
    return cases


def body_of(case: Case) -> str:
    """``k1`` .. ``k12``: the body a case runs."""
    return case.name.split()[1]


def tolerance(case: Case, ref: torch.Tensor) -> float:
    """What the kernel's output may differ from ``ref`` (the plain version)
    by, in every case: nothing. Every sum is exact (``draw_operands``), the
    copies and the x2 and x3 are exact or round once alike."""
    return 0.0


def f32_tolerance(x: torch.Tensor, w: torch.Tensor, ref: torch.Tensor) -> float:
    """What a dot's output with f32 accumulation (k2, k7; k12 on bf16
    operands) on normal operands may differ from ``ref`` (the plain float64
    sums, rounded once) by: ``2 sqrt(n) 2^-24 max |ref|``, n = L
    w.shape[-1] the terms of each output (L 3C, L 9C), summed in f32 in
    another order. Operands rounded to TF32 (10 bits), or sums kept in bf16,
    miss it by far."""
    n = x.shape[0] * w.shape[-1]
    return 2.0 * math.sqrt(n) * 2.0 ** -24 * float(ref.abs().max())


def bf16_sums(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """k12's function with its sums kept in bf16: each layer's dot (the
    plain version's) rounded to bf16 and added in bf16, widened to f32. The
    control that ``f32_tolerance`` must tell from an f32 accumulation."""
    acc = torch.zeros(x.shape[1:], device=x.device, dtype=torch.bfloat16)
    for l in range(x.shape[0]):
        acc = acc + dyn_load_dot_plain(x[l:l + 1], w[l:l + 1]).to(torch.bfloat16)
    return acc.float()


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every body once at its shapes on the card, timed as the other probes
    are (best of ``repeats`` after a warm-up call): a row per case with ms,
    the GB/s and TFLOP/s of what the function needs, the bound, the CTAs,
    threads and shared bytes, and the kernel launches the case made (``1 +
    repeats``)."""
    def row(case, ms):
        bms, by = bound(case)
        return {"gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
                "bound_ms": bms, "bound_by": by, "ctas": last_launch["grid"],
                "threads": last_launch["threads"], "smem": last_launch["smem"]}

    return run_cases(probe_cases(card_device(device), seed), repeats, row)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Runtime-indexed loop probes on the card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    rows = run_all(seed=args.seed, repeats=args.repeats)
    card = describe_card()
    for r in rows:
        print(f"{r['wrapper']} {r['name']}: {r['ms']:.6f} ms -> {r['gbps']:.1f} GB/s, "
              f"{r['tflops']:.3f} TF/s needed, bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
              f"{r['ctas']} CTAs x {r['threads']} threads, {r['smem']} B shared) [{card}]",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
