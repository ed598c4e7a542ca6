"""The quantization path on the card, held and measured.

    python -m evflow_torch.probes.quant_step [--steps 20] [--warm 3]

* ``compare_small``: one QAT TBPTT step (full, and ``Conv_only``) at the
  sizes of the port's CPU tests (LIFFireNet_short, 8 channels, B=2, 16x16,
  P=3, Adam with the clip active, ``remat`` full) on the card and on the
  CPU, through ``probes.train_step.compare_small``: the same seeded weights
  (kernels and the pred bias on a 2^-12 grid, so that a conv of spikes sums
  exactly and both devices quantise the same values) and streamed window;
  the loss within 1e-5 relative and every gradient within rtol 5e-4, atol
  5e-7, provided no membrane lies within 1e-5 of its threshold at a spike,
  no membrane quantiser index within 4e-5 of where its rounding or clip
  turns (``membrane_quant_margins``), and no ``x / s`` of a conv output
  whose sum depends on its order (the head's, whose input is quantised
  counts) within 1e-4 of one (``conv_quant_margins``); the seed of each
  mode is one where all hold. Then a sigmoid-family LIFFireNet (8
  channels, B=2, 16x16) over 3 windows on both devices: flow and
  membranes within 1e-5, spikes equal (spike margins as above).
* ``measure_qat``: ``configs/train_SNN.yml``'s cell through ``train`` with
  ``quantization.enabled`` (full, then ``Conv_only``) and without, each
  measured by ``probes.train_step.measure_full`` (``remat`` full): steps/s,
  windows/s, the split, the card's kernel time and launches a step, its
  busy share, peak memory, host syncs inside a step, the first loss
  against the CPU's.
* ``compare_calibration``: ``calibrate_model_ptq`` on the card and on the
  CPU over the same stream: the activation scales within rtol 1e-5, the
  recommended membrane ranges equal; the card's seconds.

Prints one JSON line (the CLI); ``chip_smoke.py`` phase ``quant`` calls
these and checks them.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.ops import surrogate
from evflow_torch.probes import train_step
from evflow_torch.probes.train_step import GRAD_BAR, MARGIN, SMALL
from evflow_torch.quant import fake_quant

QUANT_MODES = {"full": {"enabled": True}, "conv_only": {"enabled": True, "Conv_only": True}}
# the seeded weights of the small QAT step in each mode, where every margin holds
SMALL_QAT_SEEDS = {"full": 57, "conv_only": 26}
# The least distance of a quantiser's index to where its rounding or its clip
# turns. A membrane's (u - qmin) / step lies near 255, where an f32 ulp is
# 1.5e-5, and a difference in u far below that moves the f32 index by at most
# 2 ulps: 4e-5 is more than 2. An inexact conv output's x / s: 1e-4.
MEMBRANE_QUANT_MARGIN = 4e-5
CONV_QUANT_MARGIN = 1e-4
SMALL_SIGMOID_SEED = 3
_GRID = (".ff.weight", ".rec.weight", "pred.conv2d.weight", "pred.conv2d.bias")


def on_grid(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The conv kernels and the pred bias rounded to multiples of 2^-12:
    a conv of spikes or counts then sums exactly in f32, in any order."""
    return {k: torch.round(v * 4096) / 4096 if k.endswith(_GRID) else v for k, v in sd.items()}


def _half_margin(v: torch.Tensor) -> torch.Tensor:
    """Each element's distance to the nearest half-integer."""
    v = v.double()
    return (v - torch.floor(v) - 0.5).abs()


@contextlib.contextmanager
def membrane_quant_margins():
    """Collects, per call of the membrane quantiser, the least distance of
    ``(u - qmin) / step`` to a half-integer (where its rounding turns) or
    to 0 or ``2^b - 1`` (the clip's kinks) into the yielded list."""
    out: List[float] = []
    real = fake_quant.fake_quant_minmax

    def tracked(x, qmin, qmax, num_bits=8):
        levels = 2 ** num_bits - 1
        step = (qmax - qmin) / levels
        u = x.detach()
        v = (u.clamp(qmin, qmax) - qmin) / torch.full((), step, device=x.device)
        raw = (u.double() - qmin) / step
        out.append(float(torch.minimum(_half_margin(v), torch.minimum(
            raw.abs(), (raw - levels).abs())).min()))
        return real(x, qmin, qmax, num_bits)

    fake_quant.fake_quant_minmax = tracked
    try:
        yield out
    finally:
        fake_quant.fake_quant_minmax = real


@contextlib.contextmanager
def conv_quant_margins():
    """Collects, per conv-quant hook call on a conv output that may differ
    between packages or devices, the least distance of its ``x / s`` to a
    half-integer (where the rounding turns) or to ``+-qmax`` (the clip's
    kinks) into the yielded list. It wraps the hooks that
    ``dynamic_conv_quant`` and ``static_conv_quant`` make inside the block
    (the registry makes them when it builds a model).

    With the kernels and the pred bias on the 2^-12 grid (``on_grid``), a
    conv whose quantised input is integer-valued (spikes: a spike quantises
    to exactly 1) sums exactly in any order, and its output lies on that
    grid: every device and both packages quantise the same value. The
    head's input, event counts quantised to ``k * s``, is not
    integer-valued, so the head's conv sums depend on the summation order:
    its outputs are tracked, as is any output off the grid. A dynamic
    scale puts the largest ``|x|`` on the kink by construction: there the
    guard asks instead that ``a / (a / qmax)`` falls on the same side of
    ``qmax`` for every ``a`` within 4 ulps of the largest ``|x|``, so that
    its clip gradient (half, all or none) cannot differ."""
    out: List[float] = []
    state = {"integral": True, "track": False, "dynamic": False}
    real = fake_quant.fake_quant_symmetric
    factories = {n: getattr(fake_quant, n) for n in ("dynamic_conv_quant", "static_conv_quant")}

    def tracked_quant(x, scale, num_bits=8):
        if state["track"]:
            qmax = 2 ** (num_bits - 1) - 1
            s = scale if torch.is_tensor(scale) else torch.full((), scale, device=x.device)
            v = x.detach() / torch.maximum(s, s.new_full((), 1e-12))
            m = torch.minimum(_half_margin(v.clamp(-qmax, qmax)),
                              (v.double().abs() - qmax).abs())
            a = x.detach().abs().amax()
            if state["dynamic"] and bool(a > 0):
                m = m[x.detach().abs() != a]
                near = (a.float().view(torch.int32)
                        + torch.arange(-4, 5, dtype=torch.int32, device=x.device))
                near = near.view(torch.float32)
                sides = torch.sign(near / (near / torch.full((), float(qmax), device=x.device))
                                   - qmax)
                if not bool((sides == sides[4]).all()):
                    m = m.new_zeros(1)
            out.append(float(m.min()) if m.numel() else 0.5)
        return real(x, scale, num_bits)

    def wrap(factory, dynamic):
        def make(*args, **kw):
            hook = factory(*args, **kw)

            def tracked(x, tag):
                if tag == "input":
                    y = hook(x, tag)
                    state["integral"] = bool(torch.equal(y, torch.round(y)))
                    return y
                g = x.detach() * 4096
                state["track"] = not (state["integral"] and bool(torch.equal(g, torch.round(g))))
                state["dynamic"] = dynamic
                try:
                    return hook(x, tag)
                finally:
                    state["track"] = False
            return tracked
        return make

    fake_quant.fake_quant_symmetric = tracked_quant
    for n, f in factories.items():
        setattr(fake_quant, n, wrap(f, n == "dynamic_conv_quant"))
    try:
        yield out
    finally:
        fake_quant.fake_quant_symmetric = real
        for n, f in factories.items():
            setattr(fake_quant, n, f)


@contextlib.contextmanager
def sigmoid_margins():
    """Collects min |v - thresh| of every sigmoid-family spike call."""
    out: List[float] = []
    real = dict(surrogate.SURROGATES)

    def tracked(fn):
        def spike(x, thresh=1.0, width=10.0):
            out.append(float((x - thresh).detach().abs().min()))
            return fn(x, thresh, width)
        return spike

    surrogate.SURROGATES.update({k: tracked(f) for k, f in real.items()})
    try:
        yield out
    finally:
        surrogate.SURROGATES.update(real)


# the small QAT step's guards beside its spike margin (``train_step.small_step``)
QAT_GUARDS = {"membrane_quant": (membrane_quant_margins, MEMBRANE_QUANT_MARGIN),
              "conv_quant": (conv_quant_margins, CONV_QUANT_MARGIN)}


def sigmoid_config(C: int = 8) -> Dict[str, Any]:
    return {"name": "LIFFireNet", "num_bins": 2, "base_num_channels": C, "kernel_size": 3,
            "encoding": "cnt", "cell_family": "sigmoid",
            "activations": ["arctanspike", "arctanspike"],
            "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8], "act_width": 10.0}}


def compare_sigmoid(device: str = "cuda", windows: int = 3,
                    seed: int = SMALL_SIGMOID_SEED) -> Dict[str, Any]:
    """The sigmoid-family LIFFireNet on ``device`` against the CPU."""
    from evflow_torch.weights import seeded_state_dict

    cfg = sigmoid_config()
    cpu = registry.build_model(cfg, device="cpu")
    cpu.load_state_dict(on_grid(seeded_state_dict(cpu, seed=seed)))
    dev = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed)
    sc = sd = None
    flow_diff = mem_diff = 0.0
    spikes_equal = True
    with sigmoid_margins() as m, torch.no_grad():
        for _ in range(windows):
            x = torch.from_numpy(rng.poisson(0.6, (SMALL["B"], SMALL["H"], SMALL["W"], 2))
                                 .astype(np.float32))
            oc, sc = cpu(None, x, sc)
            od, sd = dev(None, x.to(device), sd)
            flow_diff = max(flow_diff, float((od["flow"][0].cpu() - oc["flow"][0]).abs().max()))
            for a, b in zip(sc, sd):
                mem_diff = max(mem_diff, float((b.mem.cpu() - a.mem).abs().max()))
                spikes_equal &= bool(torch.equal(b.spk.cpu(), a.spk))
    rates = [float(s.spk.mean()) for s in sc]
    ok = (min(m) > MARGIN and flow_diff <= 1e-5 and mem_diff <= 1e-5 and spikes_equal
          and min(rates) > 0)
    return {"flow_max_abs_diff": flow_diff, "mem_max_abs_diff": mem_diff,
            "spikes_equal": spikes_equal, "spike_margin": min(m), "spike_rates": rates,
            "ok": ok}


def compare_small(root: str, device: str = "cuda") -> Dict[str, Any]:
    """The small QAT step (full, conv_only) and the sigmoid forward on
    ``device`` against the CPU."""
    out: Dict[str, Any] = {
        mode: train_step.compare_small(root, device, quantization=q, seed=SMALL_QAT_SEEDS[mode],
                                       weights=on_grid, guards=QAT_GUARDS)
        for mode, q in QUANT_MODES.items()}
    out["sigmoid_forward"] = compare_sigmoid(device)
    out["ok"] = all(r["ok"] for r in out.values())
    return out


def measure_qat(root: str, steps: int = 20, warm: int = 3) -> Dict[str, Any]:
    """The full-width training cell unquantised, full QAT and Conv_only
    QAT (``measure_full`` with ``remat`` full), on one set of sequences."""
    data = train_step.full_data(os.path.join(root, "data"))
    return {name: train_step.measure_full(os.path.join(root, name), steps, warm,
                                          quantization=q, remats=("full",), data=data)
            for name, q in (("fp32", None), *QUANT_MODES.items())}


def compare_calibration(config: Dict[str, Any], state_dict, mode: str, batches: int = 50,
                        profile_batches: int = 100, device: str = "cuda") -> Dict[str, Any]:
    """``calibrate_model_ptq(mode, auto_tune=True)`` on ``device`` and on
    the CPU over the config's stream: (the card's model, record)."""
    from evflow_torch.quant.calibrate import calibrate_model_ptq

    kw = dict(mode=mode, num_batches=batches, auto_tune=True, profile_batches=profile_batches)
    dev_stats: Dict[str, Any] = {}
    cpu_stats: Dict[str, Any] = {}
    t0 = time.perf_counter()
    model = calibrate_model_ptq(config, state_dict, device=device, stats=dev_stats, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    calibrate_model_ptq(config, state_dict, device="cpu", stats=cpu_stats, **kw)
    cpu_seconds = time.perf_counter() - t0
    scales_dev, scales_cpu = dev_stats.get("scales", {}), cpu_stats.get("scales", {})
    rel = max((abs(scales_dev[k] / v - 1.0) for k, v in scales_cpu.items()), default=0.0)
    ranges_equal = dev_stats["ranges"] == cpu_stats["ranges"]
    ok = (set(scales_dev) == set(scales_cpu) and rel <= 1e-5 and ranges_equal
          and (mode == "states_only" or len(scales_dev) > 0))
    return model, {"mode": mode, "batches": batches, "profile_batches": profile_batches,
                   "seconds_card": seconds, "seconds_cpu": cpu_seconds,
                   "scales_max_rel_diff": rel, "ranges_equal": ranges_equal,
                   "ranges": dev_stats["ranges"], "scales": scales_dev, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)
    from evflow_torch.device import describe_card

    with tempfile.TemporaryDirectory(prefix="evflow_quant_") as d:
        out = {"card": describe_card(), "small": compare_small(os.path.join(d, "small")),
               "qat": measure_qat(d, args.steps, args.warm), "grad_bar": GRAD_BAR}
    for r in out["qat"].values():
        r.pop("losses")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
