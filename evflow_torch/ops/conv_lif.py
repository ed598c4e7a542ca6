"""Fused conv3x3 + folded BatchNorm + LIF step, NHWC (port of
``evflow/ops/pallas/conv_lif.py``).

One call runs one FireNet unit at inference::

    ff = conv3x3_SAME(bf16 [x | prev_spk], bf16 W) + bias   (f32 accumulation)
    spk, mem' = snn.Leaky inference update of (ff, mem)

``fused_conv_lif`` launches the hand-written CUDA kernel
(``evflow_torch/csrc/conv_lif.cu``) for CUDA tensors and runs the plain
PyTorch version, ``conv_lif_plain``, for CPU tensors; any other device
raises. The weights come packed by ``pack_weights``: a bf16 ``[C, 9*Ck]``
matrix over the channel concatenation ``[x | prev_spk]`` padded to
``Ck = ceil16(Cin (+ C))`` channels, tap-major (``k = (dy*3 + dx)*Ck + ch``),
which both layouts' kernels read directly. ``FusedFireNet`` packs once per
model. The kernels take any ``C <= 64`` whose unit fits a CTA's shared
memory (``layer_smem``); the wrapper refuses the rest before launch.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from evflow_torch.ops.lif import leaky_step

__all__ = [
    "fused_conv_lif",
    "conv_lif_plain",
    "pack_weights",
    "fold_bn",
    "packed_channels",
    "layer_smem",
]

SMEM_LIMIT = 232_448  # dynamic shared memory of one CTA on an H100
MAX_CHANNELS = 64     # output channels the kernels' fragments take
_TILE, _PAD = 16, 8   # the tile's width (csrc/conv_lif_layer.cuh: LT); bf16 row padding


def packed_channels(cin: int, c: int, recurrent: bool) -> int:
    """Input channels of the packed weight matrix: ``Cin (+ C)`` rounded up
    to the kernel's k-step of 16."""
    n = cin + (c if recurrent else 0)
    return -(-n // 16) * 16


def layer_smem(cin: int, c: int, recurrent: bool, tile_h: int = _TILE) -> int:
    """Dynamic shared memory of a K1/K2 CTA (``csrc/conv_lif_layer.cuh::
    layer_layout``): the input tile, ``tile_h + 2`` by 18 halo pixels of
    ``Ck + 8`` bf16, the weights ``[CH][9 Ck + 8]`` bf16 with ``CH`` = C
    rounded up to 16, the parameters ``[3][CH]`` f32 and the weights'
    mbarrier. The launch refuses a unit whose 16-row tile exceeds
    ``SMEM_LIMIT``."""
    ck = packed_channels(cin, c, recurrent)
    ch = -(-c // 16) * 16
    return ((tile_h + 2) * (_TILE + 2) * (ck + _PAD) * 2 + ch * (9 * ck + _PAD) * 2
            + 3 * ch * 4 + 16)


def pack_weights(w: torch.Tensor, w_rec: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HWIO ``w [3,3,Cin,C]`` (and ``w_rec [3,3,C,C]``) -> bf16 ``[C, 9*Ck]``."""
    kh, kw, cin, c = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(w.shape)}")
    ck = packed_channels(cin, c, w_rec is not None)
    wc = w.new_zeros(3, 3, ck, c, dtype=torch.float32)
    wc[:, :, :cin] = w
    if w_rec is not None:
        if tuple(w_rec.shape) != (3, 3, c, c):
            raise ValueError(f"w_rec must be [3,3,{c},{c}], got {tuple(w_rec.shape)}")
        wc[:, :, cin:cin + c] = w_rec
    return wc.reshape(9 * ck, c).t().contiguous().to(torch.bfloat16)


def fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold inference BatchNorm into HWIO conv weights + bias."""
    g = bn_scale / torch.sqrt(bn_var + eps)
    return kernel * g, bn_bias - bn_mean * g


def conv_packed(xin_nchw: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of NCHW f32 input channels ``[x | prev_spk]`` against
    packed weights, on bf16-rounded values with f32 accumulation.

    bf16 values are exact in TF32, so cuDNN's TF32 default does not change
    the products; only the summation order differs from the kernel's.
    """
    c = wk.shape[0]
    ck = wk.shape[1] // 9
    n = xin_nchw.shape[1]
    wt = wk.float().reshape(c, 3, 3, ck)[..., :n].permute(0, 3, 1, 2)
    xb = xin_nchw.to(torch.bfloat16).float()
    return F.conv2d(xb, wt, padding=1)


def conv_lif_plain(x, mem, wk, bias, beta, theta, prev_spk=None,
                   hard_reset: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the NHWC kernel: ``F.conv2d`` on
    bf16-rounded f32 inputs, then the same LIF math."""
    xin = x if prev_spk is None else torch.cat([x, prev_spk], dim=-1)
    ff = conv_packed(xin.permute(0, 3, 1, 2), wk).permute(0, 2, 3, 1) + bias
    return leaky_step(ff, mem, beta, theta, reset="zero" if hard_reset else "subtract")


def check_and_launch(entry: str, cmajor: bool, x, mem, wk, bias, beta, theta,
                     prev_spk, hard_reset: bool):
    """Validate the operands of a conv+LIF kernel and launch it on the
    current stream; returns ``(spk, mem_out)``. Raises on anything the
    kernel does not take and on a failed launch."""
    from evflow_torch.ops.cuda_build import entry_point

    if cmajor:
        B, cin, H, W = x.shape
        C = mem.shape[1]
        state_shape = (B, C, H, W)
    else:
        B, H, W, cin = x.shape
        C = mem.shape[-1]
        state_shape = (B, H, W, C)
    recurrent = prev_spk is not None
    ck = packed_channels(cin, C, recurrent)
    dev = x.device
    operands = (x, mem, bias, beta, theta, prev_spk) if recurrent else (x, mem, bias, beta, theta)
    for name, t in zip(("x", "mem", "bias", "beta", "theta", "prev_spk"), operands):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
    if mem.shape != state_shape or (recurrent and prev_spk.shape != state_shape):
        raise ValueError(f"mem/prev_spk must have shape {state_shape}")
    if bias.shape != (C,) or beta.shape != (C,) or theta.shape != (C,):
        raise ValueError(f"bias, beta and theta must have shape ({C},)")
    if (wk.device != dev or wk.dtype != torch.bfloat16 or not wk.is_contiguous()
            or wk.shape != (C, 9 * ck)):
        raise ValueError(f"wk must be contiguous bfloat16 [{C}, {9 * ck}] on "
                         f"{x.device} (pack_weights)")
    if C > MAX_CHANNELS:
        raise ValueError(f"the kernel takes C <= {MAX_CHANNELS} channels, got {C}")
    smem = layer_smem(cin, C, recurrent)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {'recurrent' if recurrent else 'feedforward'} unit of Cin={cin}, "
                         f"C={C} needs {smem} bytes of shared memory, over a CTA's "
                         f"{SMEM_LIMIT}")
    if max(cin, C) * H * W >= 2 ** 31:
        raise ValueError(f"max(Cin, C) * H * W = {max(cin, C) * H * W} must stay below 2^31 "
                         "(32-bit offsets in an image)")
    if wk.data_ptr() % 16 != 0:
        raise ValueError("wk must start on a 16-byte boundary (TMA bulk copies)")
    spk = torch.empty_like(mem)
    mem_out = torch.empty_like(mem)
    # the kernel launches on the current device: switch only where x lies elsewhere
    on_x = (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))
    with on_x:
        stream = torch.cuda.current_stream().cuda_stream
        err = entry_point(entry)(
            x.data_ptr(), prev_spk.data_ptr() if recurrent else None,
            mem.data_ptr(), wk.data_ptr(), bias.data_ptr(), beta.data_ptr(),
            theta.data_ptr(), spk.data_ptr(), mem_out.data_ptr(),
            B, H, W, cin, C, ck, int(hard_reset), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed with cudaError_t {err}")
    return spk, mem_out


def fused_conv_lif(x, mem, wk, bias, beta, theta, prev_spk=None,
                   hard_reset: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused conv3x3(+rec conv)+folded-BN+LIF step, NHWC.

    Args:
      x: ``[B, H, W, Cin]`` f32 input.
      mem: ``[B, H, W, C]`` f32 membrane.
      wk: packed bf16 weights from ``pack_weights(w, w_rec)``.
      bias, beta, theta: ``[C]`` f32 (folded BN bias, leak clipped to
        [0, 1], threshold clamped to >= 0.01).
      prev_spk: ``[B, H, W, C]`` previous spikes of a recurrent unit.
    Returns:
      ``(spk, mem_out)``, both ``[B, H, W, C]`` f32.

    CPU tensors run ``conv_lif_plain``; CUDA tensors launch the kernel
    (counted in ``fused_conv_lif.launches``) or raise.
    """
    if x.device.type == "cpu":
        return conv_lif_plain(x, mem, wk, bias, beta, theta, prev_spk, hard_reset)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_lif runs on cpu or cuda, got {x.device}")
    out = check_and_launch("conv_lif", False, x, mem, wk, bias, beta, theta,
                           prev_spk, hard_reset)
    fused_conv_lif.launches += 1
    return out


fused_conv_lif.launches = 0
