"""The whole FireNet inference step in one launch (port of
``benchmarks/pallas_archive/fused_net.py``, K3).

One window runs every unit (conv3x3 + folded BN + snn.Leaky) and the 1x1
pred head with tanh in a single kernel, so inter-unit spikes never round-trip
device memory. Five schedules compute this one function; this module holds
what they share and the K3 schedule:

* ``WholeNetWeights`` / ``fold_wholenet``: the kernel operands folded from a
  port ``FusedFireNet`` (per-unit ``pack_weights`` matrices, ``[L, 3, C]``
  bias/beta/theta, the pred head in f32);
* ``firenet_step_plain``: the plain PyTorch version shared by all five
  kernels: per unit ``F.conv2d`` on bf16-rounded values with f32 sums, the
  folded bias, ``leaky_step``, the state rounded to the state dtype; then
  pred and tanh;
* ``fused_firenet_step`` (K3) and its runner ``WholeNetFireNet``.

Every unit's input is zero outside the image, FireNet's SAME padding. The
TPU kernels recompute halo rows without zeroing the rows outside the image,
so their border rows differ from FireNet (``tests/test_torch_wholenet.py``
records the difference); the port does not copy that.

States are unpadded ``[B, C, H, W]`` in the state dtype (f32 or bf16). The
TPU runners' ``H + 2*tile_rows`` padded arrays existed for 8-row-aligned
DMAs and have no counterpart here. Input ``x`` is ``[B, H, W, Cin]`` and the
flow ``[B, H, W, 2]``, as the JAX runners take and return them. The kernels
take Cin <= 32 (the head packed to 16 or 32 channels, ``packed_channels``;
K4 only 16) and 1..7 units, any of them after the head recurrent (K4 only
the layouts it compiles).

``fused_firenet_step`` launches ``evflow_torch/csrc/fused_net.cu`` for CUDA
tensors (counted in ``fused_firenet_step.launches``) and runs
``firenet_step_plain`` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from evflow_torch.ops.conv_lif import conv_packed, packed_channels
from evflow_torch.ops.lif import leaky_step

__all__ = [
    "WholeNetWeights",
    "fold_wholenet",
    "firenet_step_plain",
    "fused_firenet_step",
    "WholeNetFireNet",
]

MAX_UNITS = 7
KERNEL_CHANNELS = 32  # the kernels' unit width (LIFFireNet's)
STATE_DTYPES = (torch.float32, torch.bfloat16)


class WholeNetWeights(NamedTuple):
    """Folded operands of the whole-network step.

    ``wk[l]``: bf16 ``[C, 9*Ck]`` (``pack_weights``; Ck 16 or 32 for the
    head, C feedforward, 2C recurrent); ``params``: f32 ``[L, 3, C]`` (bias, beta,
    theta); ``pred_w`` f32 ``[C, 2]``, ``pred_b`` f32 ``[2]``.
    """

    recurrent: Tuple[bool, ...]
    wk: Tuple[torch.Tensor, ...]
    params: torch.Tensor
    pred_w: torch.Tensor
    pred_b: torch.Tensor
    hard_reset: bool

    @property
    def channels(self) -> int:
        return self.params.shape[-1]

    @property
    def num_units(self) -> int:
        return len(self.recurrent)


def fold_wholenet(fused) -> WholeNetWeights:
    """The whole-network operands of a port ``FusedFireNet`` (any layout)."""
    names = [u.name for u in fused.units]
    if len(names) > MAX_UNITS:
        raise ValueError(f"at most {MAX_UNITS} units, got {len(names)}")
    if fused.units[0].recurrent:
        raise ValueError("the first unit must be feedforward")
    params = torch.stack([
        torch.stack([fused.params[n]["bias"], fused.params[n]["beta"], fused.params[n]["theta"]])
        for n in names])
    return WholeNetWeights(
        recurrent=tuple(u.recurrent for u in fused.units),
        wk=tuple(fused.params[n]["wk"] for n in names),
        params=params.float().contiguous(),
        pred_w=fused.params["pred"]["w"].float().contiguous(),
        pred_b=fused.params["pred"]["b"].float().contiguous(),
        hard_reset=fused.hard_reset,
    )


def stack_weights(weights: WholeNetWeights) -> torch.Tensor:
    """The units' packed matrices in one bf16 ``[L, C, 9*2C]`` tensor; unit
    l's ``[C, 9*Ck]`` matrix fills the front of slice l (see ``unit_weights``)."""
    C = weights.channels
    out = weights.wk[0].new_zeros(weights.num_units, C * 9 * 2 * C)
    for l, wk in enumerate(weights.wk):
        out[l, : wk.numel()] = wk.reshape(-1)
    return out.reshape(weights.num_units, C, 9 * 2 * C)


def unit_weights(stacked: torch.Tensor, weights: WholeNetWeights) -> Tuple[torch.Tensor, ...]:
    """Views of unit l's ``[C, 9*Ck]`` matrix inside ``stack_weights``' tensor."""
    return tuple(stacked[l].reshape(-1)[: wk.numel()].view(wk.shape)
                 for l, wk in enumerate(weights.wk))


def firenet_step_plain(x: torch.Tensor, mems: Sequence[torch.Tensor],
                       prevs: Sequence[Optional[torch.Tensor]], weights: WholeNetWeights):
    """Plain PyTorch version of every whole-network kernel.

    Args:
      x: ``[B, H, W, Cin]`` window.
      mems: per unit ``[B, C, H, W]`` membranes in the state dtype.
      prevs: per unit the previous spikes ``[B, C, H, W]`` of a recurrent
        unit, ``None`` for a feedforward one.
    Returns:
      ``(flow [B, H, W, 2] f32, mems', spikes)``: new membranes and every
      unit's spikes, in the state dtype.
    """
    h = x.float().permute(0, 3, 1, 2)
    reset = "zero" if weights.hard_reset else "subtract"
    new_mems, spikes = [], []
    for l, (mem, prev) in enumerate(zip(mems, prevs)):
        xin = h if prev is None else torch.cat([h, prev.float()], dim=1)
        bias, beta, theta = (p[:, None, None] for p in weights.params[l])
        ff = conv_packed(xin, weights.wk[l]) + bias
        spk, mem2 = leaky_step(ff, mem.float(), beta, theta, reset=reset)
        new_mems.append(mem2.to(mem.dtype))
        spikes.append(spk.to(mem.dtype))
        h = spk
    flow = torch.tanh(torch.matmul(h.permute(0, 2, 3, 1), weights.pred_w) + weights.pred_b)
    return flow, new_mems, spikes


# --- the C operand struct (csrc/fused_net_common.cuh: WholeNetArgs) ---------

_Ptrs = ctypes.c_void_p * MAX_UNITS


class WholeNetArgs(ctypes.Structure):
    _fields_ = [
        ("x", ctypes.c_void_p),
        ("mem_in", _Ptrs), ("mem_out", _Ptrs), ("spk_in", _Ptrs), ("spk_out", _Ptrs),
        ("wk", _Ptrs),
        ("params", ctypes.c_void_p), ("pred_w", ctypes.c_void_p),
        ("pred_b", ctypes.c_void_p), ("flow", ctypes.c_void_p),
        ("ck", ctypes.c_int * MAX_UNITS),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("W", ctypes.c_int),
        ("Cin", ctypes.c_int), ("L", ctypes.c_int), ("hard_reset", ctypes.c_int),
        ("state_bf16", ctypes.c_int), ("grid", ctypes.c_int),
    ]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_wholenet(entry: str, x: torch.Tensor, mems: Sequence[torch.Tensor],
                    prevs: Sequence[Optional[torch.Tensor]], wks: Sequence[torch.Tensor],
                    weights: WholeNetWeights, mem_outs: Sequence[torch.Tensor],
                    spk_outs: Sequence[Optional[torch.Tensor]],
                    flow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Validate the operands of a whole-network kernel and launch it on the
    current stream. ``mem_outs`` / ``spk_outs`` (per unit; ``None`` where a
    unit's spikes are not kept) and ``flow`` (``[B, H, W, 2]`` f32, made
    here where not given) are written by the kernel and must not alias the
    inputs. Returns the flow; ``launch_wholenet.grid`` holds the CTAs of the
    last launch. Raises on anything the kernel does not take and on a failed
    launch."""
    from evflow_torch.ops.cuda_build import entry_point

    L = weights.num_units
    C = weights.channels
    if C != KERNEL_CHANNELS:
        raise ValueError(f"the whole-network kernels run C={KERNEL_CHANNELS} units, got C={C}")
    if not (len(mems) == len(prevs) == len(wks) == len(mem_outs) == len(spk_outs) == L):
        raise ValueError(f"expected {L} entries per unit")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous() or x.shape[-1] > 32:
        raise ValueError("x must be a contiguous float32 [B, H, W, Cin] tensor, Cin <= 32")
    B, H, W, cin = x.shape
    dtype = mems[0].dtype
    if dtype not in STATE_DTYPES:
        raise ValueError(f"state dtype must be float32 or bfloat16, got {dtype}")
    shape = (B, C, H, W)
    for l in range(L):
        if (prevs[l] is not None) != weights.recurrent[l]:
            raise ValueError(f"unit {l}: previous spikes go with recurrent units only")
        for name, t in (("mem", mems[l]), ("prev_spk", prevs[l]), ("mem_out", mem_outs[l]),
                        ("spk_out", spk_outs[l])):
            if t is not None and (t.device != x.device or t.dtype != dtype
                                  or not t.is_contiguous() or tuple(t.shape) != shape):
                raise ValueError(f"unit {l}: {name} must be contiguous {dtype} {shape} "
                                 f"on {x.device}")
        ck = wks[l].shape[1] // 9
        if (wks[l].device != x.device or wks[l].dtype != torch.bfloat16
                or not wks[l].is_contiguous() or tuple(wks[l].shape) != tuple(weights.wk[l].shape)
                or wks[l].data_ptr() % 16):
            raise ValueError(f"unit {l}: packed weights must be 16-byte aligned contiguous "
                             f"bfloat16 {tuple(weights.wk[l].shape)} on {x.device}")
        if ck != (packed_channels(cin, C, False) if l == 0
                  else (2 * C if weights.recurrent[l] else C)):
            raise ValueError(f"unit {l}: packed weights of {ck} channels do not fit the kernel")
    for name, t in (("params", weights.params), ("pred_w", weights.pred_w),
                    ("pred_b", weights.pred_b)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if flow is None:
        flow = torch.empty((B, H, W, 2), device=x.device, dtype=torch.float32)
    elif (flow.device != x.device or flow.dtype != torch.float32 or not flow.is_contiguous()
          or tuple(flow.shape) != (B, H, W, 2)):
        raise ValueError(f"flow must be a contiguous float32 {(B, H, W, 2)} tensor on {x.device}")
    args = WholeNetArgs(
        x=x.data_ptr(),
        mem_in=_Ptrs(*[_ptr(t) for t in mems]), mem_out=_Ptrs(*[_ptr(t) for t in mem_outs]),
        spk_in=_Ptrs(*[_ptr(t) for t in prevs]), spk_out=_Ptrs(*[_ptr(t) for t in spk_outs]),
        wk=_Ptrs(*[_ptr(t) for t in wks]),
        params=weights.params.data_ptr(), pred_w=weights.pred_w.data_ptr(),
        pred_b=weights.pred_b.data_ptr(), flow=flow.data_ptr(),
        ck=(ctypes.c_int * MAX_UNITS)(*[t.shape[1] // 9 for t in wks]),
        B=B, H=H, W=W, Cin=cin, L=L, hard_reset=int(weights.hard_reset),
        state_bf16=int(dtype == torch.bfloat16),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry_point(entry)(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with cudaError_t {err}")
    launch_wholenet.grid = args.grid
    return flow


launch_wholenet.grid = 0


def check_device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    return x.device.type == "cuda"


def fused_firenet_step(x: torch.Tensor, mems: Sequence[torch.Tensor],
                       spks: Sequence[torch.Tensor], weights: WholeNetWeights):
    """One window through the whole network (K3 schedule).

    Args:
      x: ``[B, H, W, Cin]`` window.
      mems: per unit ``[B, C, H, W]`` membranes (f32 or bf16 state).
      spks: per recurrent unit its previous spikes, like ``mems``.
    Returns:
      ``(flow [B, H, W, 2], mems', spks')`` with ``spks'`` the recurrent
      units' spikes only, as ``PallasFusedFireNet`` keeps them.

    CPU tensors run ``firenet_step_plain``; CUDA tensors launch the kernel
    (counted in ``fused_firenet_step.launches``) or raise.
    """
    cuda = check_device(x, "fused_firenet_step")
    rec = [l for l, r in enumerate(weights.recurrent) if r]
    if len(spks) != len(rec):
        raise ValueError(f"expected spikes of {len(rec)} recurrent units, got {len(spks)}")
    prevs: List[Optional[torch.Tensor]] = [None] * weights.num_units
    for l, s in zip(rec, spks):
        prevs[l] = s
    if not cuda:
        flow, new_mems, spikes = firenet_step_plain(x, mems, prevs, weights)
        return flow, tuple(new_mems), tuple(spikes[l] for l in rec)
    mem_outs = [torch.empty_like(m) for m in mems]
    spk_outs = [torch.empty_like(mems[l]) if r else None
                for l, r in enumerate(weights.recurrent)]
    flow = launch_wholenet("fused_net", x.float().contiguous(), mems, prevs, weights.wk,
                           weights, mem_outs, spk_outs)
    fused_firenet_step.launches += 1
    return flow, tuple(mem_outs), tuple(spk_outs[l] for l in rec)


fused_firenet_step.launches = 0


class WholeNetFireNet:
    """Whole-network runner over ``fused_firenet_step`` (counterpart of
    ``PallasFusedFireNet``): states are ``(mems, spks)``, a membrane per unit
    and spikes per recurrent unit, ``[B, C, H, W]`` in ``state_dtype``.

    Build from a port ``FusedFireNet`` (``FusedFireNet.from_firenet``).
    """

    def __init__(self, fused, state_dtype: torch.dtype = torch.bfloat16):
        if state_dtype not in STATE_DTYPES:
            raise ValueError(f"state_dtype must be float32 or bfloat16, got {state_dtype}")
        self.weights = fold_wholenet(fused)
        self.state_dtype = state_dtype
        self.C = self.weights.channels
        self.num_bins = fused.num_bins

    @property
    def device(self) -> torch.device:
        return self.weights.params.device

    @property
    def num_units(self) -> int:
        return self.weights.num_units

    def zeros(self, *lead: int, batch: int, height: int, width: int) -> torch.Tensor:
        return torch.zeros(*lead, batch, self.C, height, width, device=self.device,
                           dtype=self.state_dtype)

    def init_states(self, batch: int, height: int, width: int):
        mems = tuple(self.zeros(batch=batch, height=height, width=width)
                     for _ in range(self.num_units))
        spks = tuple(self.zeros(batch=batch, height=height, width=width)
                     for _ in range(sum(self.weights.recurrent)))
        return mems, spks

    def unit_states(self, states) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """``(mems, spikes)`` per unit from this runner's states (spikes
        ``None`` where the layout does not keep them)."""
        mems, spks = states
        it = iter(spks)
        return list(mems), [next(it) if r else None for r in self.weights.recurrent]

    @torch.no_grad()
    def step(self, x: torch.Tensor, states):
        """x ``[B, H, W, Cin]`` -> (flow ``[B, H, W, 2]``, states)."""
        mems, spks = states
        flow, mems, spks = fused_firenet_step(x, mems, spks, self.weights)
        return flow, (mems, spks)

    def scan_windows(self, windows: torch.Tensor, states):
        """Run ``step`` over ``[T, B, H, W, Cin]`` windows; returns
        ``(final states, flows [T, B, H, W, 2])``."""
        flows = []
        for x in windows:
            flow, states = self.step(x, states)
            flows.append(flow)
        return states, torch.stack(flows)
