"""PTQ calibration: conv activation scales, membrane-range profiling, the
per-layer auto-tuned membrane quant (port of ``evflow/quant/calibrate.py``).

* ``collect_activation_scales``: the brevitas calibration pass. Observer
  hooks in the conv quant slots record each unit's ``max|x|`` of the conv
  input (``<unit>/input``: the raw event input for the head, the previous
  unit's spikes elsewhere, ``pred/input`` the last unit's) and of its conv
  outputs (``<unit>/output``: the max over ff and rec, ``pred/output``),
  the model's own hooks still applied after them; the scale is the max
  over the batches over ``qmax``.
* ``profile_membrane_ranges``: every unit's membrane min, max and a
  1024-bin histogram over ``[-300, 10]`` per batch, accumulated on the
  model's device and fetched once. The bins are ``jnp.histogram``'s:
  ``searchsorted`` (``torch.bucketize``, right side) on its float32
  ``linspace`` edges, the last bin closed, so the counts equal the
  reference's. Percentiles come from the histogram.
* ``recommend_ranges``, ``build_per_layer_state_quants``: the auto-tune
  policy (lower bound P2.5, at most -15, at least -250; upper 1).
* ``calibrate_model_ptq``: modes ``full`` (int8 convs and membranes),
  ``conv_only`` and ``states_only``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from evflow_torch.quant.fake_quant import state_quant_from_range

__all__ = ["collect_activation_scales", "profile_membrane_ranges", "recommend_ranges",
           "build_per_layer_state_quants", "calibrate_model_ptq", "hist_edges"]

# histogram support for membrane profiling: [-300, 10] covers the observed
# ranges (the default quant range is [-250, 1])
_HIST_LO, _HIST_HI, _HIST_BINS = -300.0, 10.0, 1024
MODES = ("full", "conv_only", "states_only")


def hist_edges() -> np.ndarray:
    """``jnp.linspace(-300, 10, 1025)`` in float32 as the reference computes
    it: ``lo * (1 - s) + hi * s`` with ``s = i / 1024``, then ``hi``."""
    s = np.arange(_HIST_BINS, dtype=np.float32) / np.float32(_HIST_BINS)
    lo, hi = np.float32(_HIST_LO), np.float32(_HIST_HI)
    return np.append(lo * (np.float32(1.0) - s) + hi * s, hi).astype(np.float32)


def _histogram(mem: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(clip(mem, lo, hi), 1024, (lo, hi))[0]`` as float64."""
    a = mem.clamp(_HIST_LO, _HIST_HI).reshape(-1)
    idx = torch.bucketize(a, edges, right=True)
    idx = torch.where(a == edges[-1], _HIST_BINS, idx)
    counts = torch.zeros(_HIST_BINS + 1, dtype=torch.float64, device=a.device)
    counts.index_add_(0, idx, torch.ones_like(a, dtype=torch.float64))
    return counts[1:]


def _batch_input(model, batch, device) -> torch.Tensor:
    key = "event_voxel" if model.encoding == "voxel" else "event_cnt"
    return torch.from_numpy(np.ascontiguousarray(batch[key], np.float32)).to(device)


def _stream_batches(model, stream, num_batches: int):
    """Yield ``(input on the model's device, states)`` for up to
    ``num_batches`` batches, the states reset at a sequence rollover."""
    loader = stream.config["loader"]
    B = int(loader.get("batch_size", 1))
    H, W = loader["resolution"]
    states = model.init_states(B, H, W)
    for _ in range(num_batches):
        batch = stream.next_batch()
        if batch["epoch_done"]:
            break
        if batch["new_seq"].any():
            stream.new_seq = False
            states = model.init_states(B, H, W)
        x = _batch_input(model, batch, model.device)
        args = (x, None) if model.encoding == "voxel" else (None, x)
        _, states = model(*args, states)
        yield x, states


@torch.no_grad()
def profile_membrane_ranges(model, stream, num_batches: int = 100,
                            hists: Optional[Dict[str, np.ndarray]] = None
                            ) -> Dict[str, Dict[str, float]]:
    """Stream batches through ``model`` (eval mode) and summarise each
    unit's membrane (keyed by unit index as a string): min, max, the
    percentiles P1, P2.5, P50, P97.5, P99 and the mean, from the histogram.
    ``hists``, if given, receives each unit's histogram counts."""
    model.eval()
    edges = torch.from_numpy(hist_edges()).to(model.device)
    agg: Dict[str, List[torch.Tensor]] = {}
    for _, states in _stream_batches(model, stream, num_batches):
        for i, st in enumerate(states):
            h, lo, hi = _histogram(st.mem, edges), st.mem.min(), st.mem.max()
            if str(i) in agg:
                a = agg[str(i)]
                agg[str(i)] = [a[0] + h, torch.minimum(a[1], lo), torch.maximum(a[2], hi)]
            else:
                agg[str(i)] = [h, lo, hi]
    host = {k: (v[0].cpu().numpy(), float(v[1]), float(v[2])) for k, v in agg.items()}
    if hists is not None:
        hists.update({k: v[0] for k, v in host.items()})

    e = hist_edges().astype(np.float64)
    centers = (e[:-1] + e[1:]) / 2
    out = {}
    for k, (h, mn, mx) in host.items():
        total = h.sum()
        if total == 0:
            out[k] = {"min": 0.0, "max": 0.0, "p01": 0.0, "p2_5": 0.0, "p50": 0.0,
                      "p97_5": 0.0, "p99": 0.0, "mean": 0.0}
            continue
        cdf = np.cumsum(h) / total

        def pct(q):
            return float(centers[np.searchsorted(cdf, q, side="left").clip(0, _HIST_BINS - 1)])

        out[k] = {"min": mn, "max": mx, "p01": pct(0.01), "p2_5": pct(0.025),
                  "p50": pct(0.50), "p97_5": pct(0.975), "p99": pct(0.99),
                  "mean": float((h * centers).sum() / total)}
    return out


def recommend_ranges(profiles: Dict[str, Dict[str, float]], floor: float = -15.0,
                     hard_min: float = -250.0, upper: float = 1.0
                     ) -> Dict[str, Tuple[float, float]]:
    """Per-layer membrane quant range: the lower bound P2.5, at most
    ``floor`` (never shallower than -15) and at least ``hard_min``; the
    upper bound the spike-reset ceiling."""
    out = {}
    for k, p in profiles.items():
        lo = max(min(p["p2_5"], floor), hard_min)
        out[k] = (float(lo), float(upper))
    return out


def build_per_layer_state_quants(ranges: Dict[str, Tuple[float, float]], num_units: int,
                                 num_bits: int = 8):
    """One membrane quantiser per unit (None where no range) for
    ``FireNet(state_quant_per_layer=...)``."""
    quants: List[Optional[Any]] = []
    for i in range(num_units):
        r = ranges.get(str(i))
        quants.append(state_quant_from_range(*r, num_bits) if r else None)
    return tuple(quants)


@torch.no_grad()
def collect_activation_scales(model, stream, num_batches: int = 50,
                              num_bits: int = 8) -> Dict[str, float]:
    """Per-layer conv input/output scales over calibration batches,
    ``{"<unit>/input": s, "<unit>/output": s, ..., "pred/...": s}``, keyed
    as ``static_conv_quant`` looks them up (see the module's docstring).
    The model's own hooks are put back after."""
    qmax = 2 ** (num_bits - 1) - 1
    units = list(model.unit_names)
    maxima: Dict[str, torch.Tensor] = {}

    def bump(key: str, m: torch.Tensor):
        maxima[key] = torch.maximum(maxima[key], m) if key in maxima else m

    def observer(layer: str, inner):
        def hook(x: torch.Tensor, tag: str) -> torch.Tensor:
            if not (layer == units[0] and tag == "input"):  # the head's: the raw input
                bump(f"{layer}/{tag}", x.detach().abs().amax())
            return x if inner is None else inner(x, tag)
        return hook

    saved = {k: getattr(model, k) for k in ("conv_fake_quant", "conv_fake_quant_per_layer")}
    model.set_quant(conv_fake_quant_per_layer=tuple(
        observer(u, model._layer_conv_quant(i)) for i, u in enumerate((*units, "pred"))))
    try:
        for x, _ in _stream_batches(model.eval(), stream, num_batches):
            bump(f"{units[0]}/input", x.abs().amax())
    finally:
        model.set_quant(**saved)
    keys = list(maxima)
    values = torch.stack([maxima[k] for k in keys]).cpu().tolist() if keys else []
    got = dict(zip(keys, values))
    for u in units:  # a zero output scale means the unit's conv was never observed
        if got.get(f"{u}/output", 0.0) <= 0.0:
            raise RuntimeError(f"calibration captured no conv output for unit {u!r}")
    return {k: v / qmax for k, v in got.items()}


UNET_FAKE_QUANT = ("the fake-quant modes (ptq, hybrid, mixed, full_qat) hook the FireNet "
                   "family's cells; SpikingRecEVFlowNet serves quantised on its int8 engine "
                   "(eval_flow_quant --mode deploy)")


def calibrate_model_ptq(config: Dict[str, Any],
                        state_dict: Optional[Dict[str, torch.Tensor]] = None,
                        mode: str = "full", num_batches: int = 50, auto_tune: bool = False,
                        profile_batches: int = 100,
                        device: Optional[Union[str, torch.device]] = None,
                        stats: Optional[Dict[str, Any]] = None):
    """The PTQ model of the config's FP32 model with ``state_dict``'s
    weights (the model's seeded ones if None), on ``device`` (the GPU
    unless asked): the same model with quantization hooks.

    ``mode``: ``full`` (int8 conv activations and membranes),
    ``conv_only`` (fp32 membranes) or ``states_only`` (fp32 convs). The
    conv activations are quantised at static per-layer scales calibrated
    over ``num_batches`` batches (``collect_activation_scales``), or with
    ``num_batches=0`` at each tensor's own absmax. The membranes use the
    default ``[-250, 1]`` range, or with ``auto_tune`` each unit's
    recommended range from ``profile_batches`` batches. ``stats``, if
    given, receives ``scales``, ``profiles`` and ``ranges`` where computed.
    """
    from evflow_torch import registry
    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.quant.fake_quant import (dynamic_conv_quant, state_quant_fn,
                                               static_conv_quant)

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if registry.is_unet(config["model"]):
        raise ValueError(UNET_FAKE_QUANT)
    model_cfg = dict(config["model"])
    model = registry.build_model(model_cfg, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    stats = {} if stats is None else stats

    def stream():
        return H5EventStream(config, model_cfg.get("num_bins", 2))

    hooks: Dict[str, Any] = dict(state_quant=None, state_quant_per_layer=None,
                                 conv_fake_quant=None, conv_fake_quant_per_layer=None)
    if mode in ("full", "states_only"):
        if auto_tune:
            s = stream()
            try:
                stats["profiles"] = profile_membrane_ranges(model, s, profile_batches)
            finally:
                s.close()
            stats["ranges"] = recommend_ranges(stats["profiles"])
            hooks["state_quant_per_layer"] = build_per_layer_state_quants(
                stats["ranges"], model.num_units)
        else:
            hooks["state_quant"] = state_quant_fn()
    if mode in ("full", "conv_only"):
        if num_batches > 0:
            s = stream()
            try:
                stats["scales"] = collect_activation_scales(model, s, num_batches)
            finally:
                s.close()
            hooks["conv_fake_quant_per_layer"] = tuple(
                static_conv_quant(stats["scales"], layer=u) for u in (*model.unit_names, "pred"))
        else:
            hooks["conv_fake_quant"] = dynamic_conv_quant()
    return model.set_quant(**hooks)
