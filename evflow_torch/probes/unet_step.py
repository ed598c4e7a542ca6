"""The spiking UNet and its int8 engine on the card (``chip_smoke.py``
phase ``unet``) and the bar the CPU tests hold it to against the
reference.

* ``engine_agreement``: two runs' states and flows, window by window:
  bit-equal, or the fallback bar for the port against the reference (the
  packages' ``sigmoid`` and ``tanh`` differ in the last f32 bits): in
  every state slot the spikes agree on all but 1e-5 of the elements, the
  membranes within one bf16 ulp where the spikes agree, the flows within
  1e-4. The card is held bit-equal to the CPU.
* ``run_engine``: an engine (or the f32 model) stepped over windows:
  ``[(flows, states)]`` a window, on the CPU.
* ``compare_card_cpu``: the engine of one model on the card (at B and at
  B=1) and on the CPU over the same windows, tier by tier
  (``phase_decoders`` off, and on for the hybrid tier), bit-equal, with
  each state slot's spike rate.
* ``profile_step``: kernels a step and their device ms by
  ``torch.profiler``, with the int8 GEMM's share.
* ``feedback_saturation``: the share of the resize decoders' prediction
  inputs that sit at the int8 clip (the reference engine's double scaling
  of its prediction feedback, ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from evflow_torch.probes.deploy_step import bf16_ulps

__all__ = ["engine_agreement", "run_engine", "compare_card_cpu", "profile_step",
           "feedback_saturation", "SPIKE_SHARE", "FLOW_ATOL", "TIER_CASES"]

SPIKE_SHARE = 1e-5  # the share of a slot's spikes that may differ
FLOW_ATOL = 1e-4
# (compute, phase_decoders) as phase ``unet`` runs them
TIER_CASES = (("bfloat16", False), ("int8", False), ("hybrid", False), ("hybrid8", False),
              ("hybrid", True))


@torch.no_grad()
def run_engine(engine, windows) -> List[Tuple[list, list]]:
    """``[(flows, [(mem, spk)])]`` a window of ``engine`` (a port engine or
    model) over ``windows`` (``[B, H, W, 2]`` counts, numpy or tensors on
    the engine's device), from its zero states; returned on the CPU."""
    dev = engine.device
    st = engine.init_states(*np.shape(windows[0])[:3])
    out = []
    for x in windows:
        o, st = engine(None, torch.as_tensor(x).to(dev), st)
        out.append(([f.float().cpu() for f in o["flow"]],
                    [(s.mem.cpu(), s.spk.cpu()) for s in st]))
    return out


def _t(a) -> torch.Tensor:
    """A tensor of ``a`` (numpy arrays, bf16 ones included, as f32)."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, np.float32 if str(a.dtype) == "bfloat16" else a.dtype))


def engine_agreement(ref: Sequence, got: Sequence) -> Dict[str, Any]:
    """Compare two runs of ``run_engine``'s form (``ref`` may hold numpy
    arrays); returns the measures and ``ok``."""
    bit_equal = True
    spike_share = 0.0
    mem_ulps = 0
    flow_err = 0.0
    for (rf, rs), (gf, gs) in zip(ref, got):
        for a, b in zip(rf, gf):
            a = _t(a).float()
            flow_err = max(flow_err, float((a - b).abs().max()))
            bit_equal &= bool(torch.equal(a, b))
        for (rm, rz), (gm, gz) in zip(rs, gs):
            rm, rz = _t(rm), _t(rz)
            agree = rz.float() == gz.float()
            spike_share = max(spike_share, 1.0 - float(agree.float().mean()))
            if agree.any():
                mem_ulps = max(mem_ulps, bf16_ulps(rm.float()[agree], gm.float()[agree]))
            bit_equal &= bool(torch.equal(rm.float(), gm.float())) and bool(agree.all())
    ok = bit_equal or (spike_share <= SPIKE_SHARE and mem_ulps <= 1 and flow_err <= FLOW_ATOL)
    return {"bit_equal": bit_equal, "spike_share_differ": spike_share,
            "mem_max_bf16_ulps": mem_ulps, "flow_max_abs_err": flow_err, "ok": ok}


def _first_slots(run: Sequence, b: int) -> list:
    """``run_engine``'s output cut to its first ``b`` batch slots."""
    return [([f[:b] for f in fl], [(m[:b], z[:b]) for m, z in st]) for fl, st in run]


def compare_card_cpu(model_gpu, model_cpu, windows: torch.Tensor) -> List[Dict[str, Any]]:
    """Each ``TIER_CASES`` (compute, phase_decoders) engine on the card and
    on the CPU (built once a case) over ``windows`` (``[T, B, H, W, 2]``
    on the card): prepared tensors equal; the card at B, and at B=1 on the
    first slot, against the CPU's one run at B (its first slot for B=1:
    the engine mixes no slots), every state and flow bit-equal; each slot's
    spike rate. One record a case and batch."""
    from evflow_torch.deploy_unet import Int8UNetEngine

    out = []
    batch = int(windows.shape[1])
    for compute, phase in TIER_CASES:
        eg = Int8UNetEngine(model_gpu, compute=compute, phase_decoders=phase)
        ec = Int8UNetEngine(model_cpu, compute=compute, phase_decoders=phase)
        params_equal = all(torch.equal(a.cpu(), b) for a, b in zip(eg.buffers(), ec.buffers()))
        rc = run_engine(ec, windows.cpu())
        for b in (batch, 1):
            rg = run_engine(eg, windows[:, :b])
            rec = engine_agreement(_first_slots(rc, b), rg)
            rates = [float(z.float().mean()) for _, z in rg[-1][1]]
            finite = all(bool(torch.isfinite(f).all()) for fl, _ in rg for f in fl)
            out.append({"compute": compute, "phase_decoders": phase, "windows": len(windows),
                        "batch": b, "cpu_batch": batch, "params_equal": params_equal, **rec,
                        "spike_rates": rates, "flow_finite": finite,
                        "ok": rec["bit_equal"] and params_equal and finite and min(rates) > 0})
    return out


@torch.no_grad()
def profile_step(step, window: torch.Tensor, states, n: int = 8) -> Dict[str, Any]:
    """``deploy_step.profile_engine``'s measures of ``step(x, states) ->
    (flow, states)``, with the int8 GEMM kernels' share of the device ms."""
    from torch.profiler import ProfilerActivity, profile

    _, states = step(window, states)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _, states = step(window, states)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    total = sum(r[2] for r in rows)
    # cuBLASLt's int8 GEMMs (torch._int_mm): imma/i8 kernels by name
    gemm = sum(r[2] for r in rows if any(t in r[0].lower() for t in ("imma", "i8", "int8", "s8")))
    rows.sort(key=lambda r: -r[2])
    return {"kernels_per_step": sum(r[1] for r in rows) / n, "kernel_ms_per_step": total / n,
            "int8_gemm_share": gemm / total if total else None,
            "top_kernels": [{"name": k[:80], "launches": c, "ms": ms} for k, c, ms in rows[:5]]}


@torch.no_grad()
def feedback_saturation(engine, windows) -> Dict[str, float]:
    """Run a resize-decoder engine over ``windows`` from zero states and
    return, per decoder after the first, the share of its requantised
    prediction channels (the first ``num_output_channels`` of its conv
    input) at ±127."""
    npred = engine.num_output_channels
    hits: Dict[str, List[float]] = {}
    conv = engine._conv_ff

    def spy(x, name, stride=1):
        if name.startswith("dec") and name != "dec0":
            hits.setdefault(name, []).append(float((x[..., :npred].float().abs() == 127)
                                                   .float().mean()))
        return conv(x, name, stride)

    engine._conv_ff = spy
    try:
        run_engine(engine, windows)
    finally:
        del engine._conv_ff
    return {k: float(np.mean(v)) for k, v in hits.items()}
