"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "describe_card", "HBM_BYTES_PER_S", "BF16_FLOP_PER_S",
           "INT8_OP_PER_S", "F32_FLOP_PER_S"]

# H100 SXM data sheet, the rates every bound in the port is taken against:
# HBM bandwidth, dense bf16 tensor-core, dense int8 tensor-core and f32 rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU.

    Entry points run on ``cuda`` unless the caller asks for another device
    (the tests pass ``"cpu"``). Without CUDA, a CUDA device (the default or
    one asked for) raises instead of silently running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def describe_card() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports them,
    to print beside every measurement (a card capped below its maximum
    power runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
