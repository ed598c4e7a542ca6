"""dy-packed 3x3 convolution (port of ``evflow/ops/dypack.py``).

A SAME stride-1 3x3 conv as one GEMM whose output holds the three vertical
taps side by side::

    cols[b, y, x, (dx, ci)] = x[b, y, x + dx - 1, ci]        # [BHW, 3 Cin]
    Z = cols @ W'                                            # [BHW, 3 C]
    y[r, co] = Z[r - 1, (0, co)] + Z[r, (1, co)] + Z[r + 1, (2, co)]

with ``W'[(dx, ci), (dy, co)] = w[co, ci, dy, dx]`` for the port's OIHW
weights. Activations are NHWC, as at the port's cell interface.

``conv3x3_dypack`` and ``conv3x3_dypack_dual`` are the reference's
``int8=True`` convs (``conv_impl: dypack_int8``): the packed weights
quantised per tensor (``s = max|W'| / 127``, ``round(W' / s)``), the input
rounded and clipped to int8 (exact for spikes and integer counts), an
int8 x int8 -> int32 GEMM (``int8_matmul``: ``torch._int_mm``), then
``Z`` cast to bf16 and scaled by ``s`` in bf16. Every op rounds to bf16 by
itself, in the reference's order: int32 -> bf16, ``* s``, and in the
epilogue ``Z0 + Z1``, then ``+ Z2``. The int8 conv runs forward only: a
backward through it raises (ROADMAP.md queue 3), where the reference's
gradient reaches only each conv's largest weight, through its scale.
The reference's float branch (``conv_impl: dypack``) computes the cells'
f32 conv by another summation order; the port's cells run
``models.cells.conv_nhwc`` for it, which the tests hold against that
branch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pack_kernel_dy", "cols_dx", "cols_dx_dual", "dy_epilogue", "conv3x3_dypack",
           "conv3x3_dypack_dual", "int8_matmul"]

_INT8_BACKWARD = ("the dypack_int8 conv runs forward only: its rounding has no gradient, and "
                  "the reference's reaches each conv's largest weight through its scale alone "
                  "(ROADMAP.md queue 3, 'dypack_int8 under autograd')")


def pack_kernel_dy(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, 3, 3]`` -> ``[(dx, ci), (dy, co)] = [3 Cin, 3 Cout]``."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"dy-packing needs 3x3 kernels, got {kh}x{kw}")
    return w.permute(3, 1, 2, 0).reshape(3 * cin, 3 * cout)


def cols_dx(x: torch.Tensor) -> torch.Tensor:
    """The dx-shifted patch buffer of NHWC ``x``: ``[B, H, W, 3 C]``."""
    W = x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1))
    return torch.cat([xp[:, :, dx:dx + W, :] for dx in range(3)], dim=-1)


def cols_dx_dual(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cat([cols_dx(a), cols_dx(b)], -1)``: the rows of the dual packed
    kernel ``[pack(k_a); pack(k_b)]``."""
    return torch.cat([cols_dx(a), cols_dx(b)], dim=-1)


def dy_epilogue(Z: torch.Tensor, H: int, C: int) -> torch.Tensor:
    """``y[r] = Z[r-1, dy0] + Z[r, dy1] + Z[r+1, dy2]`` (zero rows outside)."""
    Zp = F.pad(Z, (0, 0, 0, 0, 1, 1))
    return (Zp[:, 0:H, :, 0:C] + Zp[:, 1:1 + H, :, C:2 * C]) + Zp[:, 2:2 + H, :, 2 * C:3 * C]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` -> int32 ``[M, N]``, exact.

    ``torch._int_mm`` (cuBLASLt on the card), with K and N padded by zeros
    to multiples of 8, as the card's GEMM requires, and M to a multiple of
    32: cuBLASLt refuses some int8 shapes otherwise (on the H100 M = 300 at
    K = 8, N = 96 is ``CUBLAS_STATUS_NOT_SUPPORTED``). The padding is exact:
    the padded terms are 0. A GEMM that cannot run raises; nothing falls
    back to floats."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    M, (K, N) = a.shape[0], b.shape
    pm, pk, pn = -M % 32, -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N] if pm or pn else out


def _quantize_per_tensor(wp: torch.Tensor):
    """``(int8 weights, f32 scale)``: ``s = max(max|wp|, 1e-12) / 127``.
    The divisors are device tensors: CUDA divides by a host scalar as a
    multiplication by its reciprocal, which can miss the quotient by an ulp."""
    amax = torch.clamp_min(wp.abs().amax(), 1e-12)
    s = amax / amax.new_full((), 127.0)
    return torch.clamp(torch.round(wp / s), -127, 127).to(torch.int8), s


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -127, 127).to(torch.int8)


def _int8_gemm(cols: torch.Tensor, wp: torch.Tensor, B: int, H: int, W: int, C: int):
    w_i8, s = _quantize_per_tensor(wp)
    Z = int8_matmul(cols.reshape(-1, cols.shape[-1]), w_i8).to(torch.bfloat16)
    return dy_epilogue(Z.reshape(B, H, W, 3 * C) * s.to(torch.bfloat16), H, C)


class _Int8Conv(torch.autograd.Function):
    """The int8 conv (single or dual) where an input needs a gradient: the
    forward as it is, a backward that raises."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_INT8_BACKWARD)


def _refusing_backward(fn, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Int8Conv.apply(fn, *tensors)
    return fn(*tensors)


def _conv_int8(x, w):
    B, H, W, _ = x.shape
    return _int8_gemm(cols_dx(_to_int8(x)), pack_kernel_dy(w), B, H, W, w.shape[0])


def _dual_int8(x1, x2, w1, w2):
    B, H, W, _ = x1.shape
    wp = torch.cat([pack_kernel_dy(w1), pack_kernel_dy(w2)], dim=0)
    return _int8_gemm(cols_dx_dual(_to_int8(x1), _to_int8(x2)), wp, B, H, W, w1.shape[0])


def conv3x3_dypack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv of NHWC ``x`` by OIHW ``w`` as the int8
    dy-packed GEMM; bf16 out."""
    return _refusing_backward(_conv_int8, x, w)


def conv3x3_dypack_dual(x1: torch.Tensor, x2: torch.Tensor, w1: torch.Tensor,
                        w2: torch.Tensor) -> torch.Tensor:
    """``conv(x1, w1) + conv(x2, w2)`` as one int8 dy-packed GEMM over
    ``[pack(w1); pack(w2)]``, one weight scale for both; bf16 out."""
    return _refusing_backward(_dual_int8, x1, x2, w1, w2)
