"""Quantized checkpoints: save, load, inspect (port of
``evflow/quant/qcheckpoint.py``) on the port's ``.pth`` checkpoints
(``evflow_torch.utils.checkpoint``).

``save_quantized_checkpoint`` fake-quantises every conv kernel of the
state's ``model_state_dict`` (per-tensor symmetric int8), writes the
checkpoint and beside it ``quant_metadata.yaml``: ``num_bits``,
``weight_scales`` and ``zero_points`` (0: symmetric) by state-dict key,
``lif_params`` (each unit's ``beta``/``threshold`` or ``leak``/``thresh``)
and ``state_quant_ranges`` (``{"default": [-250, 1]}`` unless given).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import yaml

from evflow_torch.quant.fake_quant import quantize_weights_symmetric
from evflow_torch.utils.checkpoint import load_training_checkpoint, save_checkpoint

__all__ = ["save_quantized_checkpoint", "load_quantized_checkpoint",
           "inspect_quantized_checkpoint"]

_META = "quant_metadata.yaml"


def _extract_lif_params(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, list]]:
    out: Dict[str, Dict[str, list]] = {}
    for key, v in state_dict.items():
        unit, _, leaf = key.rpartition(".")
        if leaf in ("beta", "threshold", "leak", "thresh"):
            out.setdefault(unit or "root", {})[leaf] = v.detach().cpu().reshape(-1).tolist()
    return out


def save_quantized_checkpoint(directory: str, state: Dict[str, Any],
                              config: Optional[dict] = None, num_bits: int = 8,
                              state_quant_ranges: Optional[Dict[str, Tuple[float, float]]] = None
                              ) -> str:
    """Write ``state`` with its conv kernels fake-quantised, and the
    metadata sidecar; returns the checkpoint's path."""
    qsd, scales = quantize_weights_symmetric(state["model_state_dict"], num_bits)
    path = save_checkpoint(directory, dict(state, model_state_dict=qsd), config)
    metadata = {
        "num_bits": num_bits,
        "weight_scales": scales,
        "zero_points": {k: 0 for k in scales},
        "lif_params": _extract_lif_params(qsd),
        "state_quant_ranges": ({k: list(v) for k, v in state_quant_ranges.items()}
                               if state_quant_ranges else {"default": [-250.0, 1.0]}),
    }
    with open(os.path.join(directory, _META), "w") as f:
        yaml.safe_dump(metadata, f)
    return path


def _read_metadata(path: str) -> Optional[Dict[str, Any]]:
    directory = path if os.path.isdir(path) else os.path.dirname(path)
    meta = os.path.join(directory, _META)
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return yaml.safe_load(f)


def load_quantized_checkpoint(path: str):
    """``(state, metadata)`` of a quantized checkpoint (a file or its
    directory); the metadata None without a sidecar."""
    return load_training_checkpoint(path), _read_metadata(path)


def inspect_quantized_checkpoint(path: str, verbose: bool = True) -> Dict[str, Any]:
    """The sidecar's summary: ``num_bits``, ``weight_scales``,
    ``state_quant_ranges`` and the LIF units; printed with ``verbose``."""
    directory = path if os.path.isdir(path) else os.path.dirname(path)
    meta = _read_metadata(path)
    report: Dict[str, Any] = {}
    if meta is not None:
        report["num_bits"] = meta.get("num_bits")
        report["weight_scales"] = meta.get("weight_scales", {})
        report["state_quant_ranges"] = meta.get("state_quant_ranges", {})
        report["lif_units"] = sorted(meta.get("lif_params", {}))
        if verbose:
            print(f"quantized checkpoint: {directory}")
            print(f"  num_bits: {report['num_bits']}")
            print(f"  membrane ranges: {report['state_quant_ranges']}")
            for k, s in sorted(report["weight_scales"].items()):
                print(f"  {k:40s} scale={s:.6g}")
    elif verbose:
        print(f"no {_META} in {directory}")
    return report
