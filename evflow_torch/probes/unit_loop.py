"""The unit-loop probes on Hopper (port of ``benchmarks/probe_loop_dyn4.py``
and ``probe_loop_dyn5.py``).

The TPU probes asked whether one whole conv+LIF unit compiles as the body
of a runtime layer loop, with its weights, parameters, membrane and
recurrent input read at the runtime layer index:

* ``unit_loop`` (K8i, ``make_kernel(with_lif, dyn_out)``): x ``[C, E, W]``,
  w ``[L, C, 18C]``, p ``[L, C, 3]`` (bias, beta, theta), mem ``[L, C, E,
  W]``, all bf16 but p (f32). ``h = x``; for each layer l::

      ff   = conv3(h, w[l][:, :9C]) + conv3(aux, w[l][:, 9C:]) + bias,  aux = h
      u    = where(mem[l] > theta, 0, beta mem[l] + ff)     (with LIF)
      spk  = u > theta;  mem2 = where(u > theta, 0, u)
      spk  = ff;         mem2 = ff + mem[l]                 (without LIF)
      out[l] = f32(bf16(mem2[:, 8:8+TH]))                   (dyn_out)
      h    = bf16(spk)

  and without ``dyn_out`` every ``out[l]`` is the final ``h[:, 8:8+TH]``.
  ``conv3`` is a 3x3 conv with zero padding outside rows [0, E) and columns
  [0, W), K index ``dy 3C + dx C + c``, bf16 products summed in f32.
* ``unit_loop_dma`` (K8j, ``k16``): the same body with LIF and ``dyn_out``
  behind a prologue that stages x ``[1, C, E, W]``, the membranes ``[L, 1,
  C, E, W]`` and two spike slots of ``spk [3, 1, C, E, W]``; ``aux`` is slot
  ``s(l)`` (0 at l=1, 1 at l=2, else 2), slot 2 being zeros. Each layer's
  spikes (rows 8:8+TH) are stored to slot ``s(l)`` of a scratch the TPU
  never outputs; ``spike_slots=True`` returns it too, ``[3, C, TH, W]``.

Each is one launch of ``evflow_torch/csrc/probe_unit_loop.cu`` (see the
source's note): CTAs of 8 columns by a few output rows, each layer computed
on its cone only, the copies through a ring of stages. ``launch_layout``
mirrors the launch's geometry (grid, threads, shared bytes, ring), and the
wrappers refuse with a ``ValueError`` before any launch what it does not
take. The plain versions sum in float64, round each conv once to f32 and
run the LIF in f32 as the kernel does. CPU tensors run the plain version;
CUDA tensors launch the kernel or raise.

A case's bound counts what its function needs (``nbytes``, ``flops``): the
outputs depend only on a cone of rows (layer l's conv on rows 8 - (L-1-l)
.. 8+TH-1 + (L-1-l)), see ``unit_loop_bytes``. What the TPU probe stages
and issues over its whole window is counted apart (``staged_bytes``,
``issued_flops``).

    python -m evflow_torch.probes.unit_loop           # one line per case, needs CUDA
    python -m evflow_torch.probes.unit_loop --split   # the time split by part

``--split`` times every case in variant builds of the source, each with one
part taken out (``SPLIT_VARIANTS``: a ``keeps(UL_CUT_<part>)`` test in the
source, built with ``-DUL_CUT=UL_CUT_<part>``), and in builds that fix the
owned rows of a CTA (``-DUL_ROWS=n``), the full build first and last, by
``conv_lif_times``' variant-build driver; what a part costs is the full
time less the variant's (the parts overlap). A line a (variant, case) with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from evflow_torch.device import describe_card
from evflow_torch.probes._harness import Case, bound, card_device, launch, on_card, run_cases

__all__ = [
    "unit_loop", "unit_loop_plain", "unit_loop_dma", "unit_loop_dma_plain", "slot_of",
    "unit_loop_bytes", "probe_cases", "bound", "tolerance", "run_all", "WRAPPERS",
    "last_launch", "launch_layout", "SPLIT_VARIANTS", "split", "split_missing",
]

# the probes' shapes (probe_loop_dyn4.py:14, probe_loop_dyn5.py:13-14), C
# being also the only width the kernel takes; R0 is the first output row,
# the files' literal 8
L, C, E, W, TH = 4, 32, 24, 256, 8
R0 = 8

# the launch's constants (csrc/probe_unit_loop.cu)
TW, TMAX, FPW = 8, 8, 4  # owned columns, most owned rows, m16 fragments a warp
MIN_WARPS, MAX_WARPS = 8, 16
SMEM_LIMIT = 232448
SPITCH, WPITCH = C + 8, 18 * C + 8  # bf16 per staged pixel, per staged weight row
PBYTES = C * 3 * 4
SMS = 132  # an H100 SXM's SMs


def _up(v: int) -> int:
    return (v + 127) // 128 * 128


def _ceil8(v: int) -> int:
    return (v + 7) // 8 * 8


DATA_OFF = _up(C * WPITCH * 2) + _up(PBYTES)  # a ring stage's boxes after its weights, parameters


def _fill(layers, e, w, t, stages, alias, slots):
    hr, hc = min(t + 2 * layers, e + 2), TW + 2 * layers  # the h buffer's rows and columns
    bx = TW + 2 * _ceil8(layers)
    mr, bm = min(t + 2 * (layers - 1), e), TW + 2 * _ceil8(layers - 1)
    xbytes, mbytes = C * hr * bx * 2, C * mr * bm * 2
    area = max(_up(xbytes), _up(mbytes))
    stage = DATA_OFF + area + (_up(xbytes) if slots and not alias else 0)
    hbytes = _up(hr * hc * SPITCH * 2)
    tile, stile = _up(C * t * TW * 4), _up(C * t * TW * 2)
    total = (128 + hbytes * (2 if slots else 1) + stages * stage + 2 * tile
             + (2 * stile if slots else 0))
    frags = -(-mr * min(w, TW + 2 * (layers - 1)) // 16)  # layer 0's cone, the largest
    fpw = 2 if frags <= 2 * MIN_WARPS else FPW  # the kernel compiled for 2 or 4 fragments a warp
    warps = MIN_WARPS if fpw == 2 else MAX_WARPS
    fits = (total <= SMEM_LIMIT and frags <= FPW * warps and hr <= 256 and bx <= 256
            and bm <= 256)
    return fits, {"t": t, "stages": stages, "alias": alias, "threads": 32 * warps,
                  "smem": total, "frags": frags, "fpw": fpw}


def launch_layout(layers: int, e: int, th: int, w: int, slots: bool = False, sms: int = SMS):
    """The launch's geometry (``make_layout`` in the source) for L, E, TH, W
    (K8j's where ``slots``) on a card of ``sms`` SMs, or None where the
    kernel cannot take it: CTAs of TW = 8 columns by t output rows, t the
    rows that let the grid cover the SMs once (at most TMAX), shrunk until
    the layout fits; a ring of two stages, else one, K8j's slot box apart
    from the membrane's, else sharing its area. A dict with the grid,
    threads, shared bytes, owned rows t, ring stages, whether the slot
    shares (``alias``), layer 0's fragments and the kernel's fragments a
    warp (``fpw``)."""
    n_ct = w // TW
    n_rt = min(th, max(-(-th // TMAX), sms // n_ct))
    for t in range(-(-th // n_rt), 0, -1):
        for stages, alias in ((2, 0), (2, 1), (1, 0), (1, 1)):
            if alias and not slots:
                continue
            fits, lay = _fill(layers, e, w, t, stages, alias, slots)
            if fits:
                return {"grid": n_ct * -(-th // t), **lay}
    return None


class UnitLoopArgs(ctypes.Structure):
    """ctypes mirror of ``UnitLoopArgs`` in ``csrc/probe_unit_loop.cu``."""

    _fields_ = [("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("p", ctypes.c_void_p),
                ("mem", ctypes.c_void_p), ("spk", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("slots_out", ctypes.c_void_p), ("L", ctypes.c_int), ("C", ctypes.c_int),
                ("E", ctypes.c_int), ("W", ctypes.c_int), ("TH", ctypes.c_int),
                ("with_lif", ctypes.c_int), ("dyn_out", ctypes.c_int), ("grid", ctypes.c_int),
                ("threads", ctypes.c_int), ("smem", ctypes.c_int)]


last_launch = {"grid": 0, "threads": 0, "smem": 0}


def slot_of(l: int) -> int:
    """The spike slot of layer ``l``: 0 at l=1, 1 at l=2, else 2 (zeros)."""
    return 0 if l == 1 else (1 if l == 2 else 2)


# --- operand checks ------------------------------------------------------------

def _shape(name, x, w, p, mem, th):
    if any(t.dtype != torch.bfloat16 for t in (x, w, mem)) or p.dtype != torch.float32:
        raise ValueError(f"{name} takes bf16 x, w, mem and f32 p, got "
                         f"{x.dtype}, {w.dtype}, {mem.dtype}, {p.dtype}")
    if x.dim() != 3 or w.dim() != 3 or p.dim() != 3 or mem.dim() != 4:
        raise ValueError(f"{name} takes x [C, E, W], w [L, C, 18C], p [L, C, 3], "
                         f"mem [L, C, E, W]")
    layers, c = w.shape[:2]
    e, wd = x.shape[1:]
    if (x.shape[0] != c or tuple(w.shape) != (layers, c, 18 * c)
            or tuple(p.shape) != (layers, c, 3) or tuple(mem.shape) != (layers, c, e, wd)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, p {tuple(p.shape)}, "
                         f"mem {tuple(mem.shape)} do not agree")
    if th < 1 or R0 + th > e:
        raise ValueError(f"{name}: rows {R0}..{R0 + th} must lie in E={e}")
    return layers, c, e, wd


def _check_card(name, device, layers, c, e, wd, th, slots):
    if c != C:
        raise ValueError(f"{name}: the kernel takes C={C}, got {c}")
    if wd % 8:
        raise ValueError(f"{name}: a row of W={wd} bf16 must be a multiple of 16 bytes "
                         f"(the tensor copy's unit)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if launch_layout(layers, e, th, wd, slots, sms) is None:
        raise ValueError(f"{name}: L={layers}, E={e}, TH={th}, W={wd}: the cone's layout does "
                         f"not fit a CTA ({SMEM_LIMIT} bytes, {FPW * MAX_WARPS} fragments)")


# --- plain versions ------------------------------------------------------------

def _conv_ff(h, aux, w_l, bias):
    """``conv3(h, w_l[:, :9C]) + conv3(aux, w_l[:, 9C:]) + bias`` summed in
    float64 (a zero ``aux`` is skipped: its products are exact zeros) and
    rounded once to f32."""
    c = h.shape[0]
    wt = w_l.double().reshape(c, 2, 3, 3, c).permute(0, 1, 4, 2, 3)  # [Co, half, Ci, dy, dx]
    if aux is None:
        src, wk = h[None].double(), wt[:, 0]
    else:
        src = torch.cat([h, aux])[None].double()
        wk = wt.reshape(c, 2 * c, 3, 3)
    return (F.conv2d(src, wk, padding=1)[0] + bias.double()[:, None, None]).float()


def _body(x, w, p, mem, aux_of, with_lif, dyn_out, th, slots=None):
    h = x
    outs = []
    for l in range(w.shape[0]):
        aux = aux_of(l, h)
        ff = _conv_ff(h, aux, w[l], p[l, :, 0])
        m = mem[l].float()
        if with_lif:
            beta, theta = p[l, :, 1, None, None], p[l, :, 2, None, None]
            u = torch.where(m > theta, torch.zeros_like(ff), beta * m + ff)
            fire = u > theta
            spk = fire.float()
            mem2 = torch.where(fire, torch.zeros_like(u), u)
        else:
            spk, mem2 = ff, ff + m
        if dyn_out:
            outs.append(mem2[:, R0:R0 + th].to(torch.bfloat16).float())
        if slots is not None:
            slots[slot_of(l)] = spk[:, R0:R0 + th].to(torch.bfloat16)
        h = spk.to(torch.bfloat16)
    if not dyn_out:
        outs = [h[:, R0:R0 + th].float()] * w.shape[0]
    return torch.stack(outs)


def unit_loop_plain(x, w, p, mem, with_lif: bool = True, dyn_out: bool = True,
                    th: int = TH) -> torch.Tensor:
    _shape("unit_loop", x, w, p, mem, th)
    return _body(x, w, p, mem, lambda l, h: h, with_lif, dyn_out, th)


def _dma_shape(x, mem, spk, w, p, th):
    if x.dim() != 4 or x.shape[0] != 1 or mem.dim() != 5 or mem.shape[1] != 1:
        raise ValueError("unit_loop_dma takes x [1, C, E, W], mem [L, 1, C, E, W]")
    if spk.dtype != torch.bfloat16 or spk.dim() != 5 or tuple(spk.shape) != (3, 1, *x.shape[1:]):
        raise ValueError(f"unit_loop_dma takes bf16 spk [3, 1, C, E, W], got "
                         f"{spk.dtype} {tuple(spk.shape)}")
    return _shape("unit_loop_dma", x[0], w, p, mem[:, 0], th)


def unit_loop_dma_plain(x, mem, spk, w, p, th: int = TH, spike_slots: bool = False):
    _dma_shape(x, mem, spk, w, p, th)
    slots = (torch.zeros(3, spk.shape[2], th, spk.shape[4], dtype=torch.bfloat16,
                         device=x.device) if spike_slots else None)
    out = _body(x[0], w, p, mem[:, 0],
                lambda l, h: spk[slot_of(l), 0] if slot_of(l) < 2 else None, True, True, th, slots)
    return (out, slots) if spike_slots else out


# --- the kernels ---------------------------------------------------------------

def _launch(x, w, p, mem, spk, out, slots, with_lif, dyn_out, th):
    """One launch of ``probe_unit_loop``: K8j's body where ``spk`` is given."""
    layers, c = w.shape[:2]
    e, wd = x.shape[-2:]
    args = UnitLoopArgs(x=x.data_ptr(), w=w.data_ptr(), p=p.data_ptr(), mem=mem.data_ptr(),
                        spk=None if spk is None else spk.data_ptr(), out=out.data_ptr(),
                        slots_out=None if slots is None else slots.data_ptr(), L=layers, C=c,
                        E=e, W=wd, TH=th, with_lif=int(with_lif), dyn_out=int(dyn_out))
    launch("probe_unit_loop", args, x.device)
    last_launch.update(grid=args.grid, threads=args.threads, smem=args.smem)


def unit_loop(x, w, p, mem, with_lif: bool = True, dyn_out: bool = True,
              th: int = TH) -> torch.Tensor:
    """K8i: the unit body in a runtime layer loop, ``[L, C, th, W]`` f32 (see
    the module's note)."""
    cuda = on_card("unit_loop", x, w, p, mem, align=16)
    layers, c, e, wd = _shape("unit_loop", x, w, p, mem, th)
    if not cuda:
        return unit_loop_plain(x, w, p, mem, with_lif, dyn_out, th)
    _check_card("unit_loop", x.device, layers, c, e, wd, th, False)
    out = torch.empty(layers, c, th, wd, device=x.device, dtype=torch.float32)
    _launch(x, w, p, mem, None, out, None, with_lif, dyn_out, th)
    unit_loop.launches += 1
    return out


def unit_loop_dma(x, mem, spk, w, p, th: int = TH, spike_slots: bool = False):
    """K8j: the unit body with LIF behind a staged prologue, aux from the
    spike slots, ``[L, C, th, W]`` f32; with ``spike_slots`` also the three
    stored slots ``[3, C, th, W]`` bf16, written by the kernel on a branch
    that the other launches skip."""
    cuda = on_card("unit_loop_dma", x, mem, spk, w, p, align=16)
    layers, c, e, wd = _dma_shape(x, mem, spk, w, p, th)
    if not cuda:
        return unit_loop_dma_plain(x, mem, spk, w, p, th, spike_slots)
    _check_card("unit_loop_dma", x.device, layers, c, e, wd, th, True)
    out = torch.empty(layers, c, th, wd, device=x.device, dtype=torch.float32)
    slots = (torch.zeros(3, c, th, wd, device=x.device, dtype=torch.bfloat16)
             if spike_slots else None)
    _launch(x, w, p, mem, spk, out, slots, True, True, th)
    unit_loop_dma.launches += 1
    return (out, slots) if spike_slots else out


WRAPPERS = (unit_loop, unit_loop_dma)
for _fn in WRAPPERS:
    _fn.launches = 0


# --- the probes' cases -----------------------------------------------------------

def _cone(layers, e, th, l, grow=0):
    """Rows of layer ``l``'s conv that the outputs need (``grow`` more on
    each side for its input), clipped to the window."""
    d = layers - 1 - l + grow
    return min(e, R0 + th + d) - max(0, R0 - d)


def unit_loop_bytes(layers, c, e, w, th, with_lif=True, dma=False):
    """(needed bytes, needed flops, staged bytes, issued flops) of one call.

    Needed: x on the rows of layer 0's cone and its ring; every layer's
    weights (for K8j only the halves whose aux is not the zero slot) and
    parameters; each layer's membrane on its cone (without LIF the membrane
    reaches only the output rows); K8j's aux slots on their layer's cone and
    ring; the f32 output. The flops are 2 C (9C per staged half) per pixel
    of each layer's cone. Staged and issued: the TPU probe's whole window
    (x, every membrane, K8j's two slots, all weights, the output) and both
    halves on all E rows of every layer."""
    row = c * w * 2  # one bf16 row of every channel
    halves = [2 if not dma or slot_of(l) < 2 else 1 for l in range(layers)]
    mem_rows = sum(_cone(layers, e, th, l) if with_lif else th for l in range(layers))
    aux_rows = sum(_cone(layers, e, th, l, 1) for l in range(layers) if dma and slot_of(l) < 2)
    out = layers * c * th * w * 4
    params = layers * c * 3 * 4
    needed = (_cone(layers, e, th, 0, 1) * row + sum(halves) * c * 9 * c * 2 + params
              + (mem_rows + aux_rows) * row + out)
    flops = sum(2 * c * 9 * c * k * _cone(layers, e, th, l) * w for l, k in enumerate(halves))
    staged = (1 + layers + (2 if dma else 0)) * e * row + layers * c * 18 * c * 2 + params + out
    issued = 2 * c * 18 * c * e * w * layers
    return needed, flops, staged, issued


def draw_operands(rng, layers, c, e, w, device="cpu", dma=False, with_lif=True):
    """Operands that make every sum exact, so that the kernel, the plain
    version and the JAX probe agree bit for bit: x and spikes in {0, 1},
    beta 0.5, thresholds odd multiples of 1/128 in (0, 1), so that no u
    ties a threshold. With LIF, weights and biases k/16 with |k| <= 4 and
    membranes j/16 with |j| <= 16. Without LIF h grows with every layer, so
    weights and biases are integers in [-1, 1], which keeps every h an
    integer and every sum an integer far below 2^24; layer l's membranes are
    j 2^s(l) with |j| <= 16 and 2^s(l) the layer's growth, sqrt(12 C) per
    layer, so that a membrane term missing or read from another layer moves
    the output by about as much as ff does."""
    def bf16(a):
        return torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=torch.bfloat16)

    x = bf16(rng.random((c, e, w)) < 0.5)
    wt = bf16(rng.integers(-4, 5, (layers, c, 18 * c)) / 16.0 if with_lif
              else rng.integers(-1, 2, (layers, c, 18 * c)))
    bias = rng.integers(-4, 5, (layers, c)) / 16.0 if with_lif else rng.integers(-1, 2, (layers, c))
    p = np.stack([bias, np.full((layers, c), 0.5),
                  (2 * rng.integers(0, 64, (layers, c)) + 1) / 128.0], axis=-1)
    p = torch.tensor(p.astype(np.float32), device=device)
    grow = 0.5 * np.log2(12 * c)
    mem_scale = (np.full(layers, 1 / 16.0) if with_lif
                 else 2.0 ** np.floor(grow * np.arange(layers)))
    mem = bf16(rng.integers(-16, 17, (layers, c, e, w)) * mem_scale[:, None, None, None])
    if not dma:
        return x, wt, p, mem
    spk = bf16(rng.random((3, 1, c, e, w)) < 0.5)
    return x[None], mem[:, None], spk, wt, p


def probe_cases(device, seed: int = 0, shape=(L, C, E, W, TH)) -> List[Case]:
    """K8i's three cases (13 the full body, 14 without LIF, 15 without the
    per-layer output) and K8j at the JAX files' shapes, operands from
    ``draw_operands`` with numpy from ``seed``; on ``meta`` only their
    shapes."""
    layers, c, e, w, th = shape
    rng = np.random.default_rng(seed)
    meta = torch.device(device).type == "meta"

    def operands(dma, with_lif=True):
        if meta:
            bf = torch.bfloat16
            x = torch.empty(c, e, w, device="meta", dtype=bf)
            wt = torch.empty(layers, c, 18 * c, device="meta", dtype=bf)
            p = torch.empty(layers, c, 3, device="meta")
            mem = torch.empty(layers, c, e, w, device="meta", dtype=bf)
            if not dma:
                return x, wt, p, mem
            spk = torch.empty(3, 1, c, e, w, device="meta", dtype=bf)
            return x[None], mem[:, None], spk, wt, p
        return draw_operands(rng, layers, c, e, w, device, dma, with_lif)

    cases = []
    dims = f"[{layers},{c},{e},{w}] TH={th}"
    for tag, with_lif, dyn_out in (("13 full body", True, True), ("14 no LIF", False, True),
                                   ("15 no dyn out", True, False)):
        needed, flops, staged, issued = unit_loop_bytes(layers, c, e, w, th, with_lif)
        cases.append(Case(f"K8i {tag} {dims}", unit_loop, unit_loop_plain,
                          operands(False, with_lif),
                          {"with_lif": with_lif, "dyn_out": dyn_out, "th": th}, needed, flops,
                          staged, issued, "benchmarks/probe_loop_dyn4.py:73"))
    needed, flops, staged, issued = unit_loop_bytes(layers, c, e, w, th, dma=True)
    cases.append(Case(f"K8j 16 staged prologue {dims}", unit_loop_dma, unit_loop_dma_plain,
                      operands(True), {"th": th}, needed, flops, staged, issued,
                      "benchmarks/probe_loop_dyn5.py:81"))
    return cases


def tolerance(case: Case, ref: torch.Tensor) -> float:
    """What the kernel's output may differ from ``ref`` (the plain version)
    by, in every case: nothing. Every sum is exact (``draw_operands``), so
    the kernel's f32 sums in any order equal the plain version's float64
    sums, the LIF's f32 operations round alike and the outputs are bf16
    roundings of equal values."""
    return 0.0


def run_all(device: Optional[str] = None, seed: int = 0, repeats: int = 3) -> List[dict]:
    """Every unit-loop case once at its shapes on the card, timed as the
    other probes are (best of ``repeats`` after a warm-up call): a row per
    case with ms, the GB/s and TFLOP/s of what the function needs, the
    bound, the CTAs, threads and shared bytes, and the kernel
    launches the case made (``1 + repeats``)."""
    def row(case, ms):
        bms, by = bound(case)
        return {"gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
                "bound_ms": bms, "bound_by": by, "ctas": last_launch["grid"],
                "threads": last_launch["threads"], "smem": last_launch["smem"]}

    return run_cases(probe_cases(card_device(device), seed), repeats, row)


# the split's builds: name -> nvcc flags, a part taken out (a keeps(UL_CUT_<part>)
# test in the source) or the owned rows of a CTA fixed
SPLIT_VARIANTS = {
    "full": [],
    "no_x_stage": ["-DUL_CUT=UL_CUT_X_STAGE"],        # x's copy and transposition
    "no_slot_stage": ["-DUL_CUT=UL_CUT_SLOT_STAGE"],  # K8j's slot copies and transpositions
    "no_ring": ["-DUL_CUT=UL_CUT_RING"],              # weight, parameter, membrane copies
    "no_mma": ["-DUL_CUT=UL_CUT_MMA"],
    "no_loads": ["-DUL_CUT=UL_CUT_LOADS"],            # the epilogue's parameters, membranes
    "no_stores": ["-DUL_CUT=UL_CUT_STORES"],          # the output and slot tiles, their stores
    "rows1": ["-DUL_ROWS=1"],
    "rows4": ["-DUL_ROWS=4"],
    "rows8": ["-DUL_ROWS=8"],
}


def split_missing(root: Path) -> List[str]:
    """The split's variants that ``root``'s source has no hook for (a build
    of them would time the full kernel)."""
    src = (root / "evflow_torch" / "csrc" / "probe_unit_loop.cu").read_text()
    hooks = {f[0][len("-DUL_CUT="):]: f"keeps({f[0][len('-DUL_CUT='):]})"
             for f in SPLIT_VARIANTS.values() if f and f[0].startswith("-DUL_CUT=")}
    missing = [name for name, f in SPLIT_VARIANTS.items()
               if f and f[0].startswith("-DUL_CUT=") and hooks[f[0][9:]] not in src]
    if "#ifdef UL_ROWS" not in src:
        missing += [name for name, f in SPLIT_VARIANTS.items() if f and "UL_ROWS" in f[0]]
    return missing


def split(root: Path, seed: int = 0) -> List[dict]:
    """Every case in every build of ``SPLIT_VARIANTS`` (all ``nvcc`` at
    once, ``conv_lif_times.compile_variants``), the full build first and
    last, each timed by ``wholenet_slope.device_ms``: a row per (variant,
    case) with its ms, the part's ms (the full time less the variant's) and
    the launch's CTAs, threads and shared bytes."""
    from evflow_torch.ops import cuda_build
    from evflow_torch.probes.conv_lif_times import compile_variants, load_entry
    from evflow_torch.probes.wholenet_slope import device_ms

    missing = split_missing(root)
    if missing:
        raise RuntimeError(f"the unit loop cannot be split for {missing}: "
                           "csrc/probe_unit_loop.cu has no hook for them")
    libs = compile_variants(root, "split_unit_loop", {"unit_loop": "probe_unit_loop"},
                            SPLIT_VARIANTS)
    cases = probe_cases(card_device(None), seed)
    full, rows = {}, []
    for name in list(SPLIT_VARIANTS) + ["full"]:
        load_entry(libs["unit_loop", name], "probe_unit_loop")
        for case in cases:
            ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=50)
            full.setdefault(case.name, ms if name == "full" else None)
            base = full[case.name]
            rows.append({"variant": name, "flags": SPLIT_VARIANTS[name], "case": case.name,
                         "ms": ms, "part_ms": None if name == "full" else base - ms,
                         "ctas": last_launch["grid"], "threads": last_launch["threads"],
                         "smem": last_launch["smem"]})
    cuda_build._ENTRIES.pop("probe_unit_loop", None)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="Unit-loop probes on the card.")
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
