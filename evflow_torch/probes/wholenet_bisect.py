"""The whole-net bisection probes on Hopper (port of
``benchmarks/probe_wholenet_bisect.py``, ``probe_wholenet_bisect3.py``,
``probe_wholenet_bisect5.py`` and ``probe_wholenet_bisect6.py``: K8k-K8n).

The TPU probes cut the whole-network kernel down until it lowered: one
conv, seven chained convs, then two conv+LIF units in variants. Every conv
is a 3x3 conv of a channel-major ``[B, Cin, rows, W]`` bf16 window against
``w [C, 9 Cin]`` bf16 (K index ``dy 3Cin + dx Cin + c``), f32 sums, whose
rows are the window's own (``rows - 2`` out: no row padding) and whose
columns are zero-padded:

* ``bisect_a`` (K8k ``kA``): x ``[B, C, H + 2TH, W]``, ``out[:, :, r] =
  conv(x)[:, :, r + TH] * p[:, 0]`` -> ``[B, C, H, W]`` f32;
* ``bisect_b`` (K8k ``kB``): xb ``[B, C, (H / TH) E, W]``, for each block of
  E rows seven layers ``v = f32(conv(bf16(v), w) > 0)``, out = the block's
  first TH of the 18 rows left -> ``[B, C, H, W]`` f32;
* ``bisect3`` (K8l), ``bisect5`` (K8m), ``bisect6`` (K8n): two units over
  the padded x, m0, m1 ``[B, C, Hp, W]`` (Hp = H + 2TH), the rows outside
  the image read as they are (not zeroed, unlike FireNet's padding)::

      ff1 = conv(x, w0) (+ bias0);  spk1, mem1' = lif(ff1, m0)
      ff2 = conv(bf16(spk1), w1) (+ bias1)   [K8l from_scratch: conv(x, w1)]
      spk2, mem2' = lif(ff2, m1)
      o0, o1 = bf16(spk1 | mem1'), bf16(spk2 | mem2') on padded rows [TH, TH + H)
      flow = spk2 (K8l, all C channels), spk2[:2], or tanh(pw . bf16(spk2) + pb)

  with K8l's ``spk = ff + 0.5 mem > 0.5`` (o = spikes), K8m's snn.Leaky hard
  reset or that spike with ``mem' = ff`` (bias, beta, theta from p, or all
  0.5 without ``use_params``), and K8n's passthrough, one ``where`` or two
  (no bias, beta = theta = 0.5). The TPU kernels leave rows [0, TH) and
  [TH + H, Hp) of o0 and o1 unwritten; the port writes zeros there.

Each call is one launch of ``evflow_torch/csrc/probe_wholenet_bisect.cu``
(see the source's note): ``stack_kernel`` for kA and kB (CTAs of 8 columns
by 16 rows, each layer on its cone, wgmma), ``chain_kernel`` for the nine
chain variants (16 x 16, mma.sync, a warp that issues the TMA copies); x
staged by the threads' cp.async, outputs stored from shared tiles by
16-byte stores. On an NVIDIA H100 80GB HBM3 at 700 W a call takes 0.0060
ms (kA), 0.0232 (kB) and 0.0140-0.0164 (the chain) back to back.
``launch_layout`` mirrors the launch's geometry (grid, threads, shared
bytes), and the wrappers refuse with a ``ValueError`` before any launch what
it does not take (C other than 32, W not a multiple of 8). The plain
versions sum in float64 (exact on ``draw_operands``' values) and round once
to f32, then run each file's epilogue in f32. CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.

A case's bound counts what its function needs (``bisect_bytes``: the rows
its outputs reach, the outputs once); what the TPU probe stages and issues
over its windows is counted apart.

    python -m evflow_torch.probes.wholenet_bisect           # one line per case, needs CUDA
    python -m evflow_torch.probes.wholenet_bisect --split   # the time split by part

``--split`` times every case in variant builds of the source, each with one
part taken out (``SPLIT_VARIANTS``: a ``keeps(BI_CUT_<part>)`` test in the
source, built with ``-DBI_CUT=BI_CUT_<part>``), the full build first and
last, all built at once by
``conv_lif_times.compile_variants``; what a part costs is the full time
less the variant's (the parts overlap). A line a (variant, case) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from evflow_torch.device import describe_card
from evflow_torch.probes._harness import Case, bound, card_device, launch, on_card, run_cases

__all__ = [
    "bisect_a", "bisect_a_plain", "bisect_b", "bisect_b_plain", "bisect3", "bisect3_plain",
    "bisect5", "bisect5_plain", "bisect6", "bisect6_plain", "Variant", "VARIANTS", "BODIES",
    "bisect_bytes", "draw_operands", "probe_cases", "body_of", "outputs", "bound", "tolerance",
    "run_all", "WRAPPERS", "last_launch", "launch_layout", "SPLIT_VARIANTS", "split",
    "split_missing",
]

# the files' shapes (probe_wholenet_bisect.py:7-8, bisect3.py:7-10); TH is
# also the only tile height the probes' row offsets fit (r0 = i TH + 8)
C, H, W, TH = 32, 64, 256, 16
E = TH + 16
B_K8K, B_CHAIN = 1, 2
KB_LAYERS = 7

# the launch's constants (csrc/probe_wholenet_bisect.cu)
STACK_TW, CHAIN_TW = 8, 16  # owned columns per CTA of stack_kernel, chain_kernel
KA_WARPS, KB_WARPS, CHAIN_WARPS = 8, 16, 16
SMEM_LIMIT = 232448
SPITCH, WPITCH = C + 8, 9 * C + 8  # bf16 per staged pixel, per staged weight row
PBYTES, PWBYTES = C * 3 * 4, 2 * C * 2  # a unit's parameters, the pred head's weights
W_BLOCK, W_BLOCKS = C * 128, -(-9 * C // 64)  # stack_kernel's weights: 64 K values of 32 rows


def _up(v: int) -> int:
    return (v + 127) // 128 * 128


def _plane(nbytes: int) -> int:
    """Bytes from one channel's plane of a staged box or an output tile to
    the next: 16 past a multiple of 128 (``plane`` in the source)."""
    return _up(nbytes) + 16


def _stack_layout(layers: int) -> dict:
    """stack_kernel<NL>'s threads, shared bytes and fragments (``Stack`` in
    the source): the weights as 5 blocks of 64 K values (128-byte swizzled
    rows, for wgmma), the barriers, buffer 0, and buffer 1 shared by x's box
    (from a whole 16-byte piece left of the 8 owned columns), the odd
    layers' spikes and the out tile. ``fpw``: the most m16 fragments a warp
    takes in a layer (one a quad of 64 pixels its warpgroup takes)."""
    warps = KA_WARPS if layers == 1 else KB_WARPS
    halo = -(-layers // 8) * 8
    hr, hc, bx = TH + 2 * layers, STACK_TW + 2 * layers, STACK_TW + 2 * halo
    px = (hr - 2) * (hc - 2)  # layer 1's cone, the largest
    quads = -(-px // 64)
    buf = hr * hc * SPITCH * 2
    off_b1 = W_BLOCKS * W_BLOCK + 128 + _up(buf)
    smem = off_b1 + _up(max(buf if layers > 1 else 0, C * _plane(hr * bx * 2),
                            C * _plane(TH * STACK_TW * 4)))
    return {"threads": 32 * warps, "smem": smem, "frags": -(-px // 16),
            "fpw": -(-quads // (warps // 4))}


def _chain_layout() -> dict:
    """chain_kernel's threads (16 compute warps and one that issues the
    copies), shared bytes and unit 1's fragments (``Chain`` in the source):
    both weight matrices, the parameters, x's box (then o0's dense tile
    and o1's), x pixel-major, m0's dense box of 19 rows by 40 columns (then
    the flow tile), m1's of 17 by 24, and spk1."""
    tw = CHAIN_TW
    xr, xc, xb, u1 = TH + 4, tw + 4, tw + 16, TH + 2
    otile = C * _plane(TH * tw * 2)
    smem = (128 + 2 * _up(C * WPITCH * 2) + _up(2 * PBYTES + PWBYTES)
            + _up(max(C * _plane(xr * xb * 2), C * TH * tw * 2 + otile))
            + _up(xr * xc * SPITCH * 2)
            + _up(max(C * (u1 + 1) * (tw + 24) * 2, C * _plane(TH * tw * 4)))
            + _up(C * (TH + 1) * (tw + 8) * 2) + _up(u1 * u1 * SPITCH * 2))
    frags = -(-u1 * u1 // 16)
    return {"threads": 32 * (CHAIN_WARPS + 1), "smem": smem, "frags": frags,
            "fpw": -(-frags // CHAIN_WARPS)}


def launch_layout(body: str, b: int, h: int, w: int) -> Optional[dict]:
    """The launch's geometry for a body at (B, H, W), or None where the
    kernels refuse it: H a positive multiple of TH = 16, W a positive
    multiple of 8 (a row of W bf16 a whole number of 16-byte pieces, as a
    tensor copy needs), B >= 1. kA and kB (``stack_kernel``): CTAs of 8
    columns by 16 rows, W/8 x H/16 x B; the chain (``chain_kernel``): 16 x
    16, ceil(W/16) x H/16 x B. A dict with the grid, threads, shared bytes,
    the largest layer's m16 fragments and the most a warp takes (``fpw``)."""
    if b < 1 or h < TH or h % TH or w < 8 or w % 8:
        return None
    if body in ("kA", "kB"):
        lay, grid = _stack_layout(1 if body == "kA" else KB_LAYERS), w // STACK_TW * (h // TH) * b
    elif body in VARIANTS:
        lay, grid = _chain_layout(), -(-w // CHAIN_TW) * (h // TH) * b
    else:
        raise ValueError(f"no body {body!r}; one of {list(BODIES)}")
    return {"grid": grid, **lay} if lay["smem"] <= SMEM_LIMIT else None


class BisectArgs(ctypes.Structure):
    """ctypes mirror of ``BisectArgs`` in ``csrc/probe_wholenet_bisect.cu``."""

    _fields_ = [(n, ctypes.c_void_p) for n in
                ("x", "m0", "m1", "w0", "w1", "p0", "p1", "pw", "pb", "o0", "o1", "out")] + [
        (n, ctypes.c_int) for n in ("body", "B", "H", "W", "grid", "threads", "smem")]


last_launch = {"grid": 0, "threads": 0, "smem": 0}


class Variant(NamedTuple):
    """A chain variant: its file, its body number in the entry point, its
    LIF (``simple``, ``real``, ``one_where``, ``two_where``), its parameters
    (``none``: no bias, beta = theta = 0.5; ``half``: bias, beta, theta all
    0.5; ``p``: from p0, p1), its flow (``all``: spk2's C channels; ``two``:
    spk2[:2]; ``pred``: the pred head), whether o0 and o1 are the spikes
    (else mem'), and whether unit 2 reads x (K8l ``from_scratch``)."""

    file: str
    body: int
    lif: str
    params: str
    flow: str
    out_spikes: bool = False
    scratch: bool = False


# the chain's variants by the files' names for their cases, in the entry
# point's body order 2..10
VARIANTS: Dict[str, Variant] = {
    "from_scratch": Variant("bisect3", 2, "simple", "none", "all", True, True),
    "h_chain": Variant("bisect3", 3, "simple", "none", "all", True),
    "simple-lif + pred + params": Variant("bisect5", 4, "simple", "p", "pred"),
    "real-lif + nopred + params": Variant("bisect5", 5, "real", "p", "two"),
    "real-lif + pred + noparams": Variant("bisect5", 6, "real", "half", "pred"),
    "all-real": Variant("bisect5", 7, "real", "p", "pred"),
    "passthrough": Variant("bisect6", 8, "simple", "none", "two"),
    "one_where": Variant("bisect6", 9, "one_where", "none", "two"),
    "two_where": Variant("bisect6", 10, "two_where", "none", "two"),
}
KA, KB = 0, 1
BISECT5 = {  # (real_lif, use_pred, use_params) -> the file's name (bisect5.py:102-107)
    (False, True, True): "simple-lif + pred + params",
    (True, False, True): "real-lif + nopred + params",
    (True, True, False): "real-lif + pred + noparams",
    (True, True, True): "all-real",
}


# --- operand checks ------------------------------------------------------------

def _bf16(name, *ts):
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError(f"{name} takes bf16 activations and weights, got "
                         f"{[str(t.dtype) for t in ts]}")


def _weights(name, w, cin, c):
    if w.dim() != 2 or tuple(w.shape) != (c, 9 * cin):
        raise ValueError(f"{name}: w must be [C, 9 Cin] = [{c}, {9 * cin}], got {tuple(w.shape)}")


def _a_shape(x, w, p):
    _bf16("bisect_a", x, w)
    if x.dim() != 4 or x.shape[2] <= 2 * TH or (x.shape[2] - 2 * TH) % TH:
        raise ValueError(f"bisect_a takes x [B, C, H + {2 * TH}, W] with H a multiple of {TH}, "
                         f"got {tuple(x.shape)}")
    b, c, hp, wd = x.shape
    _weights("bisect_a", w, c, c)
    if p.dtype != torch.float32 or tuple(p.shape) != (c, 3):
        raise ValueError(f"bisect_a takes p [C, 3] f32, got {p.dtype} {tuple(p.shape)}")
    return b, c, hp - 2 * TH, wd


def _b_shape(xb, w):
    _bf16("bisect_b", xb, w)
    if xb.dim() != 4 or xb.shape[2] < E or xb.shape[2] % E:
        raise ValueError(f"bisect_b takes xb [B, C, n {E}, W], got {tuple(xb.shape)}")
    b, c, rows, wd = xb.shape
    _weights("bisect_b", w, c, c)
    return b, c, rows // E * TH, wd


def _chain_shape(name, v, x, m0, m1, w0, w1, p0, p1, pw, pb):
    _bf16(name, x, m0, m1, w0, w1)
    if x.dim() != 4 or x.shape[2] <= 2 * TH or (x.shape[2] - 2 * TH) % TH:
        raise ValueError(f"{name} takes x [B, Cin, H + {2 * TH}, W] with H a multiple of {TH}, "
                         f"got {tuple(x.shape)}")
    b, cin, hp, wd = x.shape
    c = m0.shape[1] if m0.dim() == 4 else -1
    if tuple(m0.shape) != (b, c, hp, wd) or tuple(m1.shape) != (b, c, hp, wd):
        raise ValueError(f"{name}: m0 {tuple(m0.shape)} and m1 {tuple(m1.shape)} must be "
                         f"[B, C, {hp}, {wd}]")
    _weights(name, w0, cin, c)
    _weights(name, w1, c, c)
    if v.scratch and cin != c:
        raise ValueError(f"{name}: unit 2 convolves x with w1, so Cin must equal C={c}")
    if v.params == "p" and any(t is None or t.dtype != torch.float32 or tuple(t.shape) != (c, 3)
                               for t in (p0, p1)):
        raise ValueError(f"{name} takes p0, p1 [C, 3] f32")
    if v.flow == "pred" and (pw is None or pb is None or pw.dtype != torch.bfloat16
                             or tuple(pw.shape) != (2, c) or pb.dtype != torch.float32
                             or tuple(pb.shape) != (2, 1)):
        raise ValueError(f"{name} takes pw [2, C] bf16 and pb [2, 1] f32")
    return b, cin, c, hp - 2 * TH, wd


def _check_card(name, wd, *channels):
    if any(c != C for c in channels):
        raise ValueError(f"{name}: the kernel takes C={C} (and Cin={C}), got {channels}")
    if wd % 8:
        raise ValueError(f"{name}: a row of W={wd} bf16 must be a multiple of 16 bytes "
                         f"(W a multiple of 8: the tensor copy's unit)")


# --- plain versions ------------------------------------------------------------

def _conv(x, w):
    """The probes' conv: x ``[N, Cin, R, W]`` against w ``[C, 9 Cin]``, rows
    valid (R - 2 out), columns zero-padded, summed in float64 (exact on the
    probes' draws) and rounded once to f32."""
    c, k = w.shape
    wt = w.double().reshape(c, 3, 3, k // 9).permute(0, 3, 1, 2)
    return F.conv2d(x.double(), wt, padding=(0, 1)).float()


def bisect_a_plain(x, w, p):
    _, _, h, _ = _a_shape(x, w, p)
    return _conv(x[:, :, TH - 1:TH + h + 1], w) * p[:, 0, None, None]


def bisect_b_plain(xb, w):
    b, c, h, wd = _b_shape(xb, w)
    n = h // TH
    v = xb.reshape(b, c, n, E, wd).transpose(1, 2).reshape(b * n, c, E, wd)
    for _ in range(KB_LAYERS):
        v = (_conv(v.to(torch.bfloat16), w) > 0).float()
    return v[:, :, :TH].reshape(b, n, c, TH, wd).transpose(1, 2).reshape(b, c, h, wd)


def _lif(v: Variant, ff, mem, p):
    """(spk, mem') of the variant's LIF on the conv sum ``ff`` (f32) and
    the membrane ``mem`` (f32), each operation rounded in f32."""
    bias = beta = theta = 0.5
    if v.params == "p":
        bias, beta, theta = (p[:, k, None, None] for k in range(3))
    if v.params != "none":
        ff = ff + bias
    if v.lif == "simple":
        return (ff + 0.5 * mem > 0.5).float(), ff
    if v.lif == "real":
        reset = (mem > theta).float()
        base = beta * mem + ff
        u = base - reset * base
        spk = (u > theta).float()
        return spk, u - (spk - reset) * u
    u = torch.where(mem > theta, torch.zeros_like(ff), beta * mem + ff)
    spk = (u > theta).float()
    return spk, (torch.where(u > theta, torch.zeros_like(u), u) if v.lif == "two_where" else u)


def _chain_plain(v: Variant, x, m0, m1, w0, w1, p0=None, p1=None, pw=None, pb=None):
    _, _, _, h, _ = _chain_shape("chain", v, x, m0, m1, w0, w1, p0, p1, pw, pb)
    rows1 = slice(TH - 1, TH + h + 1)  # unit 1 on the rows unit 2 reads
    spk1, mem1 = _lif(v, _conv(x[:, :, TH - 2:TH + h + 2], w0), m0[:, :, rows1].float(), p0)
    h2 = x[:, :, rows1] if v.scratch else spk1.to(torch.bfloat16)
    spk2, mem2 = _lif(v, _conv(h2, w1), m1[:, :, TH:TH + h].float(), p1)
    o0, o1 = torch.zeros_like(m0), torch.zeros_like(m1)
    o0[:, :, TH:TH + h] = (spk1 if v.out_spikes else mem1)[:, :, 1:1 + h].to(torch.bfloat16)
    o1[:, :, TH:TH + h] = (spk2 if v.out_spikes else mem2).to(torch.bfloat16)
    if v.flow == "all":
        flow = spk2
    elif v.flow == "two":
        flow = spk2[:, :2].contiguous()
    else:
        dot = torch.einsum("oc,bchw->bohw", pw.double(), spk2.double()).float()
        flow = torch.tanh(dot + pb.view(1, 2, 1, 1))
    return o0, o1, flow


def bisect3_plain(x, m0, m1, w0, w1, variant: str = "h_chain"):
    return _chain_plain(_variant("bisect3", variant), x, m0, m1, w0, w1)


def bisect5_plain(x, m0, m1, w0, w1, p0, p1, pw, pb, real_lif: bool = True,
                  use_pred: bool = True, use_params: bool = True):
    v = _variant("bisect5", BISECT5.get((real_lif, use_pred, use_params)))
    return _chain_plain(v, x, m0, m1, w0, w1, p0, p1, pw, pb)


def bisect6_plain(x, m0, m1, w0, w1, mode: str = "two_where"):
    return _chain_plain(_variant("bisect6", mode), x, m0, m1, w0, w1)


def _variant(name, tag) -> Variant:
    v = VARIANTS.get(tag)
    if v is None or v.file != name:
        raise ValueError(f"{name} has no case {tag!r}; one of "
                         f"{[t for t, v in VARIANTS.items() if v.file == name]}")
    return v


# --- the kernels ---------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn, body, b, h, wd, out, x, w0, **ops):
    args = BisectArgs(x=x.data_ptr(), w0=w0.data_ptr(), out=out.data_ptr(), body=body, B=b, H=h,
                      W=wd, **{k: _ptr(t) for k, t in ops.items()})
    launch("probe_wholenet_bisect", args, x.device)
    last_launch.update(grid=args.grid, threads=args.threads, smem=args.smem)
    fn.launches += 1


def bisect_a(x, w, p) -> torch.Tensor:
    """K8k ``kA``: ``conv(x)[:, :, r + TH] * p[:, 0]`` -> ``[B, C, H, W]``
    f32 (see the module's note)."""
    cuda = on_card("bisect_a", x, w, p, align=16)
    b, c, h, wd = _a_shape(x, w, p)
    if not cuda:
        return bisect_a_plain(x, w, p)
    _check_card("bisect_a", wd, c)
    out = torch.empty(b, c, h, wd, device=x.device, dtype=torch.float32)
    _launch(bisect_a, KA, b, h, wd, out, x, w, p0=p)
    return out


def bisect_b(xb, w) -> torch.Tensor:
    """K8k ``kB``: seven chained ``conv > 0`` layers per block of E rows ->
    ``[B, C, H, W]`` f32, H = TH per block."""
    cuda = on_card("bisect_b", xb, w, align=16)
    b, c, h, wd = _b_shape(xb, w)
    if not cuda:
        return bisect_b_plain(xb, w)
    _check_card("bisect_b", wd, c)
    out = torch.empty(b, c, h, wd, device=xb.device, dtype=torch.float32)
    _launch(bisect_b, KB, b, h, wd, out, xb, w)
    return out


def _chain(fn, v: Variant, x, m0, m1, w0, w1, p0=None, p1=None, pw=None, pb=None):
    ops = [t for t in (x, m0, m1, w0, w1, p0, p1, pw, pb) if t is not None]
    cuda = on_card(fn.__name__, *ops, align=16)
    b, cin, c, h, wd = _chain_shape(fn.__name__, v, x, m0, m1, w0, w1, p0, p1, pw, pb)
    if not cuda:
        return _chain_plain(v, x, m0, m1, w0, w1, p0, p1, pw, pb)
    _check_card(fn.__name__, wd, c, cin)
    o0, o1 = torch.empty_like(m0), torch.empty_like(m1)
    flow = torch.empty(b, c if v.flow == "all" else 2, h, wd, device=x.device,
                       dtype=torch.float32)
    keep = dict(p0=p0, p1=p1) if v.params == "p" else {}
    if v.flow == "pred":
        keep.update(pw=pw, pb=pb)
    _launch(fn, v.body, b, h, wd, flow, x, w0, m0=m0, m1=m1, w1=w1, o0=o0, o1=o1, **keep)
    return o0, o1, flow


def bisect3(x, m0, m1, w0, w1, variant: str = "h_chain"):
    """K8l ``build(variant)``: ``(o0, o1, flow)``, o0 and o1 the units'
    spikes ``[B, C, Hp, W]`` bf16, flow spk2 ``[B, C, H, W]`` f32; unit 2
    reads spk1 (``h_chain``) or x (``from_scratch``)."""
    return _chain(bisect3, _variant("bisect3", variant), x, m0, m1, w0, w1)


def bisect5(x, m0, m1, w0, w1, p0, p1, pw, pb, real_lif: bool = True, use_pred: bool = True,
            use_params: bool = True):
    """K8m ``build(real_lif, use_pred, use_params)``: ``(o0, o1, flow)``, o0
    and o1 the membranes ``[B, C, Hp, W]`` bf16, flow ``[B, 2, H, W]`` f32
    (the pred head, or spk2[:2]); one of the file's four cases."""
    v = _variant("bisect5", BISECT5.get((real_lif, use_pred, use_params)))
    return _chain(bisect5, v, x, m0, m1, w0, w1, p0, p1, pw, pb)


def bisect6(x, m0, m1, w0, w1, mode: str = "two_where"):
    """K8n ``build(mode)``: ``(o0, o1, flow)``, o0 and o1 the membranes
    ``[B, C, Hp, W]`` bf16, flow spk2[:2] ``[B, 2, H, W]`` f32."""
    return _chain(bisect6, _variant("bisect6", mode), x, m0, m1, w0, w1)


WRAPPERS = (bisect_a, bisect_b, bisect3, bisect5, bisect6)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probes' cases -----------------------------------------------------------

# body: (probe, wrapper, plain, the TPU pallas_call); the chain's bodies are
# its variants' names
_FILES = {
    "bisect3": ("K8l", bisect3, bisect3_plain, "benchmarks/probe_wholenet_bisect3.py:55"),
    "bisect5": ("K8m", bisect5, bisect5_plain, "benchmarks/probe_wholenet_bisect5.py:74"),
    "bisect6": ("K8n", bisect6, bisect6_plain, "benchmarks/probe_wholenet_bisect6.py:60"),
}
BODIES = {
    "kA": ("K8k", bisect_a, bisect_a_plain, "benchmarks/probe_wholenet_bisect.py:28"),
    "kB": ("K8k", bisect_b, bisect_b_plain, "benchmarks/probe_wholenet_bisect.py:63"),
    **{tag: _FILES[v.file] for tag, v in VARIANTS.items()},
}


def bisect_bytes(body: str, b: int, c: int, h: int, w: int, cin: Optional[int] = None):
    """(needed bytes, needed flops, staged bytes, issued flops) of one call.

    Needed: the input rows that reach the outputs (kA: H + 2; kB: the 30 of
    each block's 32 that the seven layers' cones reach; the chain: x on
    H + 4 rows, m0 on H + 2, m1 on H, or for ``from_scratch`` x on H + 2
    and m0 on H), the weights and the parameters the body reads, the
    outputs once (o0 and o1 on all Hp rows: the port writes their
    borders); the convs' 2 C 9Cin flops per output pixel on those rows and
    the pred head's 4 C. Staged and issued: the TPU probe's E-row windows
    (the chain's three), everything it writes, and its convs on E - 2 (and
    E - 4) rows of every window."""
    cin = c if cin is None else cin
    row, wts, n = c * w * 2, c * 9 * c * 2, h // TH  # a bf16 row of every channel
    per_px = 2 * c * 9 * c
    if body == "kA":
        out = b * c * h * w * 4
        return (b * (h + 2) * row + wts + c * 4 + out, per_px * b * h * w,
                b * n * E * row + wts + c * 12 + out, per_px * b * n * (E - 2) * w)
    if body == "kB":
        out = b * c * h * w * 4
        x_rows = TH + 2 * KB_LAYERS
        cone = sum(TH + 2 * (KB_LAYERS - l) for l in range(1, KB_LAYERS + 1))
        issued = sum(E - 2 * l for l in range(1, KB_LAYERS + 1))
        return (b * n * x_rows * row + wts + out, per_px * b * n * cone * w,
                b * n * E * row + wts + out, per_px * b * n * issued * w)
    v = VARIANTS[body]
    xrow, per_px1 = cin * w * 2, 2 * c * 9 * cin
    x_rows, m0_rows, rows1 = (h + 2, h, h) if v.scratch else (h + 4, h + 2, h + 2)
    fc = c if v.flow == "all" else 2
    params = 2 * c * 12 if v.params == "p" else 0
    pred = 2 * c * 2 + 2 * 4 if v.flow == "pred" else 0
    flow = b * fc * h * w * 4
    weights = c * 9 * cin * 2 + wts + params + pred
    pred_flops = 4 * c * b * h * w if v.flow == "pred" else 0
    needed = (b * (x_rows * xrow + (m0_rows + h) * row) + weights
              + 2 * b * (h + 2 * TH) * row + flow)
    flops = per_px1 * b * rows1 * w + per_px * b * h * w + pred_flops
    staged = b * n * E * (xrow + 2 * row) + weights + 2 * b * h * row + flow
    issued = b * n * w * (per_px1 * (E - 2) + per_px * (E - 4)) + pred_flops
    return needed, flops, staged, issued


def draw_operands(rng, body: str, b: int, c: int, h: int, w: int, device="cpu"):
    """The body's positional arguments, with numpy from ``rng``, on values
    that make every sum and product exact, so that the kernel, the plain
    version and the JAX probe agree bit for bit: activations and membranes
    integers (x in [-2, 2], m0, m1 in [-4, 4]), weights k/8 with |k| <= 4,
    p's columns k/8 (bias and kA's beta, |k| <= 8), beta k/4 in [0, 1] and
    theta an odd multiple of 1/8 in (0, 2); the pred head's pw k/8 and pb
    k/16. Every conv sum is a multiple of 1/8 below 2^9 in magnitude, every
    LIF operand a multiple of 1/8 too."""
    def bf16(a):
        return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def wts(cin):
        return bf16(rng.integers(-4, 5, (c, 9 * cin)) / 8.0)

    def params():
        return f32(np.stack([rng.integers(-8, 9, c) / 8.0, rng.integers(0, 5, c) / 4.0,
                             (2 * rng.integers(0, 8, c) + 1) / 8.0], axis=-1))

    if body == "kA":
        return bf16(rng.integers(-2, 3, (b, c, h + 2 * TH, w))), wts(c), params()
    if body == "kB":
        return bf16(rng.integers(-2, 3, (b, c, h // TH * E, w))), wts(c)
    hp = h + 2 * TH
    x = bf16(rng.integers(-2, 3, (b, c, hp, w)))
    m0, m1 = (bf16(rng.integers(-4, 5, (b, c, hp, w))) for _ in range(2))
    ops = (x, m0, m1, wts(c), wts(c))
    if VARIANTS[body].file != "bisect5":
        return ops
    return ops + (params(), params(), bf16(rng.integers(-8, 9, (2, c)) / 8.0),
                  f32(rng.integers(-8, 9, (2, 1)) / 16.0))


def _kwargs(body: str) -> dict:
    """The wrapper's keywords for a body: the file's name for its case."""
    f = VARIANTS[body].file if body in VARIANTS else None
    if f == "bisect5":
        flags = next(k for k, t in BISECT5.items() if t == body)
        return dict(zip(("real_lif", "use_pred", "use_params"), flags))
    return {"bisect3": {"variant": body}, "bisect6": {"mode": body}}.get(f, {})


def probe_cases(device, seed: int = 0, shape=(C, H, W), batch: Optional[int] = None
                ) -> List[Case]:
    """The 11 cases (kA, kB, K8l's two, K8m's four, K8n's three) at the JAX
    files' shapes (B = 1 for K8k, 2 for the chain, or ``batch`` for every
    case), operands from ``draw_operands`` with numpy from ``seed``; on
    ``meta`` only their shapes."""
    c, h, w = shape
    rng = np.random.default_rng(seed)
    meta = torch.device(device).type == "meta"
    cases = []
    for body, (probe, fn, plain, replaces) in BODIES.items():
        b = batch or (B_K8K if body in ("kA", "kB") else B_CHAIN)
        args = draw_operands(rng if not meta else np.random.default_rng(0), body, b, c, h, w)
        if meta:
            args = tuple(torch.empty_like(t, device="meta") for t in args)
        elif torch.device(device).type != "cpu":
            args = tuple(t.to(device) for t in args)
        needed, flops, staged, issued = bisect_bytes(body, b, c, h, w)
        cases.append(Case(f"{probe} {body} [{b},{c},{h},{w}]", fn, plain, args, _kwargs(body),
                          needed, flops, staged, issued, replaces))
    return cases


def body_of(case: Case) -> str:
    """``kA``, ``kB`` or the chain variant's name: the body a case runs."""
    return case.name.split(" ", 1)[1].rsplit(" [", 1)[0]


def outputs(case: Case, result) -> Dict[str, torch.Tensor]:
    """A call's outputs by name: ``out`` for kA and kB, else ``o0``, ``o1``
    and ``flow``."""
    if isinstance(result, torch.Tensor):
        return {"out": result}
    return dict(zip(("o0", "o1", "flow"), result))


def tolerance(case: Case, ref: torch.Tensor, output: str = "out") -> float:
    """What an output may differ from ``ref`` (the plain version's) by:
    nothing, but for the pred head's flow. Every sum is exact on
    ``draw_operands``' values, so the kernel's f32 sums in any order equal
    the plain version's float64 sums, and the LIF's f32 operations round
    alike. The pred flow is ``tanhf`` on the card and another tanh on the
    host: ``2 sqrt(C) 2^-24 max|out|`` (the dot's sums in another order,
    exact here) plus 4 f32 ulps of ``max|out|`` for the tanh."""
    if output != "flow" or VARIANTS[body_of(case)].flow != "pred":
        return 0.0
    c = case.args[3].shape[0]
    return (2.0 * math.sqrt(c) * 2.0 ** -24 + 4 * 2.0 ** -23) * float(ref.abs().max())


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every case once at its shapes on the card, timed as the other probes
    are (best of ``repeats`` after a warm-up call): a row per case with ms,
    the GB/s and TFLOP/s of what the function needs, the bound, the CTAs,
    threads and shared bytes, and the kernel launches the case made
    (``1 + repeats``)."""
    def row(case, ms):
        bms, by = bound(case)
        return {"gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
                "bound_ms": bms, "bound_by": by, "ctas": last_launch["grid"],
                "threads": last_launch["threads"], "smem": last_launch["smem"]}

    return run_cases(probe_cases(card_device(device), seed), repeats, row)


# the split's builds: name -> nvcc flags, a part taken out (a keeps(BI_CUT_<part>)
# test in the source)
SPLIT_VARIANTS = {
    "full": [],
    "no_x_stage": ["-DBI_CUT=BI_CUT_X_STAGE"],  # x's copy and transposition
    "no_w_stage": ["-DBI_CUT=BI_CUT_W_STAGE"],  # the weights' and parameters' copies
    "no_mma": ["-DBI_CUT=BI_CUT_MMA"],
    "no_m_loads": ["-DBI_CUT=BI_CUT_M_LOADS"],  # the chain's membranes: copies and reads
    "no_handoff": ["-DBI_CUT=BI_CUT_HANDOFF"],  # kB's inter-layer spikes, the chain's spk1
    "no_stores": ["-DBI_CUT=BI_CUT_STORES"],    # the output tiles, their stores, border rows
}


def split_missing(root: Path) -> List[str]:
    """The split's variants that ``root``'s source has no hook for (a build
    of them would time the full kernel)."""
    src = (root / "evflow_torch" / "csrc" / "probe_wholenet_bisect.cu").read_text()
    return [name for name, f in SPLIT_VARIANTS.items()
            if f and f"keeps({f[0][len('-DBI_CUT='):]})" not in src]


def split(root: Path, seed: int = 0) -> List[dict]:
    """Every case in every build of ``SPLIT_VARIANTS`` (all ``nvcc`` at
    once, ``conv_lif_times.compile_variants``), the full build first and
    last, each timed by ``wholenet_slope.device_ms``: a row per (variant,
    case) with its ms, the part's ms (the full time less the variant's)
    and the launch's CTAs, threads and shared bytes."""
    from evflow_torch.ops import cuda_build
    from evflow_torch.probes.conv_lif_times import compile_variants, load_entry
    from evflow_torch.probes.wholenet_slope import device_ms

    missing = split_missing(root)
    if missing:
        raise RuntimeError(f"the bisection kernels cannot be split for {missing}: "
                           "csrc/probe_wholenet_bisect.cu has no hook for them")
    libs = compile_variants(root, "split_bisect", {"bisect": "probe_wholenet_bisect"},
                            SPLIT_VARIANTS)
    cases = probe_cases(card_device(None), seed)
    full, rows = {}, []
    for name in list(SPLIT_VARIANTS) + ["full"]:
        load_entry(libs["bisect", name], "probe_wholenet_bisect")
        for case in cases:
            ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=50)
            full.setdefault(case.name, ms if name == "full" else None)
            rows.append({"variant": name, "flags": SPLIT_VARIANTS[name], "case": case.name,
                         "ms": ms, "part_ms": None if name == "full" else full[case.name] - ms,
                         "ctas": last_launch["grid"], "threads": last_launch["threads"],
                         "smem": last_launch["smem"]})
    cuda_build._ENTRIES.pop("probe_wholenet_bisect", None)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="Whole-net bisection probes on the card.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--split", action="store_true",
                    help="time every case in the variant builds of SPLIT_VARIANTS")
    args = ap.parse_args(argv)
    card = describe_card()
    if args.split:
        rows = split(Path(__file__).resolve().parents[2], args.seed)
        for r in rows:
            print(json.dumps({**r, "card": card}), flush=True)
        return rows
    rows = run_all(seed=args.seed, repeats=args.repeats)
    for r in rows:
        print(f"{r['wrapper']} {r['name']}: {r['ms']:.6f} ms -> {r['gbps']:.1f} GB/s, "
              f"{r['tflops']:.2f} TF/s needed, bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
              f"{r['ctas']} CTAs x {r['threads']} threads, {r['smem']} B shared) [{card}]",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
