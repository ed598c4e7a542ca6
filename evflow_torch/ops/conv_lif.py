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
model.
"""

from __future__ import annotations

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
]


def packed_channels(cin: int, c: int, recurrent: bool) -> int:
    """Input channels of the packed weight matrix: ``Cin (+ C)`` rounded up
    to the kernel's k-step of 16."""
    n = cin + (c if recurrent else 0)
    return -(-n // 16) * 16


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
    operands = {"x": x, "mem": mem, "bias": bias, "beta": beta, "theta": theta}
    if recurrent:
        operands["prev_spk"] = prev_spk
    for name, t in operands.items():
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if tuple(mem.shape) != state_shape or (recurrent and tuple(prev_spk.shape) != state_shape):
        raise ValueError(f"mem/prev_spk must have shape {state_shape}")
    if any(tuple(t.shape) != (C,) for t in (bias, beta, theta)):
        raise ValueError(f"bias, beta and theta must have shape ({C},)")
    if (wk.device != x.device or wk.dtype != torch.bfloat16 or not wk.is_contiguous()
            or tuple(wk.shape) != (C, 9 * ck)):
        raise ValueError(f"wk must be contiguous bfloat16 [{C}, {9 * ck}] on "
                         f"{x.device} (pack_weights)")
    if C not in (8, 16, 32, 64):
        raise ValueError(f"the kernel supports C in (8, 16, 32, 64), got {C}")
    spk = torch.empty_like(mem)
    mem_out = torch.empty_like(mem)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
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
