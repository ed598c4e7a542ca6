#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (``evflow_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA card

Phases, each printing JSON lines; any failure exits non-zero:

1. ``build``: compile the hand-written CUDA kernels from ``evflow_torch/csrc``
   (one ``nvcc`` per source, started together) into ``evflow_torch/_build``.
2. ``kernels``: every kernel against its plain PyTorch version on the card at
   full width (B=2, 256x256, C=32): head (Cin=2), feedforward, recurrent and
   subtract reset, in both layouts. mem' within 1e-4 where the spikes agree
   (f32 sums in another order than cuDNN's, bf16 operands), spikes equal
   wherever |u - theta| > 1e-4, and at most 1e-5 of the elements differ.
3. ``model``: LIFFireNet (32 channels, 7 units, seeded weights) over 8
   windows at 128x128 of the phase-4 data: fused (both layouts) against the
   unfused port FireNet with bf16 convs (|dflow| > 0.05 on < 2% of the
   pixels, head spike agreement > 0.999, every unit > 0.95; layouts within
   1e-5), and every unit's spike rate within 0.1%..60%.
4. ``protocol``: ``evaluate(config, fused=True)`` with the settings of
   ``configs/eval_MVSEC.yml`` on a 2-sequence synthetic 256x256 dataset,
   past a rollover, once per layout; each run sets the launch counters to 0
   just before and reads them just after (7 launches per window). AEE per
   file within 2% of ``evaluate(fused=False)`` (f32 convs).
5. ``times``: CUDA-event times of every phase-2 case, its plain version and
   cuDNN's bf16 conv alone, beside the case's bound; then FusedFireNet
   windows/s over a long scan at B=2, 256x256, cnt input ~5% active.

The line before the last is one JSON object with a row per kernel (times
summed over one window's 7 launches at the bench shape: the head once,
feedforward units 4 times, recurrent units twice); the last is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time

PHASES = ("build", "kernels", "model", "protocol", "times")

# H100 SXM data sheet: HBM bandwidth, dense bf16 tensor-core and f32 rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

B_BENCH, H_BENCH, W_BENCH, C_BENCH = 2, 256, 256, 32
# (case, Cin, recurrent, hard reset)
CASES = (("head", 2, False, True), ("ff", 32, False, True),
         ("rec", 32, True, True), ("soft", 32, False, False))
PER_WINDOW = {"head": 1, "ff": 4, "rec": 2}  # LIFFireNet launches per window
KERNELS = (  # name, layout, source, the TPU kernel's pallas_call
    ("fused_conv_lif", "nhwc", "evflow_torch/csrc/conv_lif.cu",
     "evflow/ops/pallas/conv_lif.py:151"),
    ("fused_conv_lif_cmajor", "cmajor", "evflow_torch/csrc/conv_lif_cmajor.cu",
     "evflow/ops/pallas/conv_lif_cmajor.py:156"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_fns(layout):
    """(wrapper, plain version) of the layout's kernel."""
    from evflow_torch.ops.conv_lif import conv_lif_plain, fused_conv_lif
    from evflow_torch.ops.conv_lif_cmajor import conv_lif_cmajor_plain, fused_conv_lif_cmajor

    if layout == "nhwc":
        return fused_conv_lif, conv_lif_plain
    return fused_conv_lif_cmajor, conv_lif_cmajor_plain


def make_case(cin, recurrent, layout, seed):
    """Operands of one unit at the bench shape, on the card: counts for the
    head, binary spikes for the other units, kernels in the flax init range
    scaled by a BN gain, per-channel bias / beta / theta."""
    import numpy as np
    import torch

    from evflow_torch.ops.conv_lif import pack_weights

    rng = np.random.default_rng(seed)
    B, H, W, C = B_BENCH, H_BENCH, W_BENCH, C_BENCH
    x = rng.poisson(0.3, (B, H, W, cin)) if cin == 2 else rng.random((B, H, W, cin)) < 0.2
    g = rng.uniform(0.5, 2.0, C)
    w = rng.uniform(-1, 1, (3, 3, cin, C)) * math.sqrt(1.0 / cin) * g
    w_rec = rng.uniform(-1, 1, (3, 3, C, C)) * math.sqrt(1.0 / C) * g if recurrent else None
    arrays = dict(x=x, mem=rng.normal(0, 0.5, (B, H, W, C)), bias=rng.normal(0, 0.3, C),
                  beta=rng.uniform(0, 1, C), theta=rng.uniform(0.01, 0.8, C),
                  prev_spk=(rng.random((B, H, W, C)) < 0.2) if recurrent else None)
    t = {k: None if v is None else torch.tensor(np.asarray(v, np.float32), device="cuda")
         for k, v in arrays.items()}
    if layout == "cmajor":
        for k in ("x", "mem", "prev_spk"):
            if t[k] is not None:
                t[k] = t[k].permute(0, 3, 1, 2).contiguous()
    t["wk"] = pack_weights(*(None if a is None else torch.tensor(a.astype(np.float32),
                                                               device="cuda")
                             for a in (w, w_rec)))
    return t


def conv_input(t, layout):
    """``[x | prev_spk]`` as NCHW, the input of the case's conv."""
    import torch

    if layout == "cmajor":
        return t["x"] if t["prev_spk"] is None else torch.cat([t["x"], t["prev_spk"]], 1)
    xin = t["x"] if t["prev_spk"] is None else torch.cat([t["x"], t["prev_spk"]], -1)
    return xin.permute(0, 3, 1, 2)


def pre_spike(t, layout, hard):
    """The membrane u tested against theta, from the plain conv."""
    from evflow_torch.ops.conv_lif import conv_packed

    ff = conv_packed(conv_input(t, layout), t["wk"])
    shp = (-1, 1, 1)
    if layout == "nhwc":
        ff, shp = ff.permute(0, 2, 3, 1), (-1,)
    ff = ff + t["bias"].reshape(shp)
    beta, theta = t["beta"].reshape(shp), t["theta"].reshape(shp)
    reset = (t["mem"] > theta).float()
    base = beta * t["mem"] + ff
    return base - reset * (base if hard else theta), theta


def call(fn, t, hard):
    return fn(t["x"], t["mem"], t["wk"], t["bias"], t["beta"], t["theta"],
              prev_spk=t["prev_spk"], hard_reset=hard)


def bound(cin, recurrent):
    """Least time of one unit at the bench shape: each input read once and
    each output written once at the HBM rate, against its bf16 conv and f32
    LIF operations at the peak rates. Returns (ms, "bytes"|"operations")."""
    px = B_BENCH * H_BENCH * W_BENCH
    C = C_BENCH
    k_in = cin + (C if recurrent else 0)
    nbytes = 4 * px * (k_in + 3 * C) + 2 * C * 9 * k_in + 4 * 3 * C
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * px * C * 9 * k_in / BF16_FLOP_PER_S + 10 * px * C / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def seeded_firenet(compute_dtype=None):
    """LIFFireNet at full width on the card, weights from seed 0."""
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    cfg = dict(eval_config("")["model"])
    if compute_dtype is not None:
        cfg["compute_dtype"] = compute_dtype
    model = build_model(cfg, device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed=0))
    return model


def eval_config(root):
    """The settings of configs/eval_MVSEC.yml on a synthetic dataset."""
    return {
        "data": {"path": root, "mode": "gtflow_dt1", "window": 1},
        "model": {"name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
                  "base_num_channels": 32, "kernel_size": 3, "mask_output": True,
                  "norm_input": False, "round_encoding": False,
                  "tebn": {"enabled": False, "num_timesteps": 4},
                  "mpbn": {"enabled": False},
                  "spiking_neuron": {"leak": [0.0, 1.0], "thresh": [0.0, 0.8],
                                     "learn_leak": True, "learn_thresh": True,
                                     "hard_reset": True}},
        "metrics": {"name": ["AEE", "AAE", "AE_ofMeans"], "flow_scaling": 128,
                    "heat_map": False},
        "loader": {"batch_size": 1, "resolution": [128, 128],
                   "std_resolution": [256, 256], "keep_gt_full_res": True,
                   "augment": [], "seed": 0},
        "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5, "max_rate": 0.8},
    }


def dataset(state):
    """The phase-3/4 dataset: 2 synthetic sequences of 10 windows at 256x256,
    written once per run into a temporary directory (as numpy archives: the
    GPU host need not have h5py)."""
    if "root" not in state:
        from evflow_torch.data.synthetic import make_dataset

        state["tmp"] = tempfile.TemporaryDirectory(prefix="evflow_smoke_")
        state["root"] = state["tmp"].name
        make_dataset(state["root"], num_sequences=2, seed=0, duration=1.0,
                     resolution=(256, 256), events_per_sec=50_000, fmt="npz")
    return state["root"]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(state):
    from evflow_torch.ops import cuda_build

    t0 = time.perf_counter()
    per_source = cuda_build.build()
    ptxas = {}
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.ptxas.txt"
        if log.exists():
            ptxas[name] = [ln.split("info    :")[-1].strip() for ln in log.read_text().splitlines()
                           if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": per_source, "ptxas": ptxas})


def phase_kernels(state):
    import torch

    for kname, layout, _, _ in KERNELS:
        fused, plain = kernel_fns(layout)
        worst = 0.0
        for seed, (case, cin, rec, hard) in enumerate(CASES):
            t = make_case(cin, rec, layout, seed=seed)
            spk_k, mem_k = call(fused, t, hard)
            spk_p, mem_p = call(plain, t, hard)
            torch.cuda.synchronize()
            u, theta = pre_spike(t, layout, hard)
            near = (u - theta).abs() <= 1e-4
            flips = spk_k != spk_p
            dmem = (mem_k - mem_p).abs()
            err = float(dmem[~flips].max())
            mismatches = int((flips | (dmem > 1e-4)).sum())
            far = int((flips & ~near).sum())
            n = mem_k.numel()
            ok = (far == 0 and err <= 1e-4 and mismatches <= 1e-5 * n
                  and bool(torch.isfinite(mem_k).all()))
            worst = max(worst, err)
            emit({"phase": "kernels", "kernel": kname, "case": case, "max_abs_err": err,
                  "mismatches": mismatches, "spike_flips_near_threshold": int(flips.sum()) - far,
                  "spike_flips_far": far, "elements": n, "spike_rate": float(spk_k.mean()),
                  "ok": ok})
            if not ok:
                raise SystemExit(f"{kname}/{case} disagrees with its plain version")
        state.setdefault("max_abs_err", {})[kname] = worst


def phase_model(state):
    import torch

    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.models.fused import FusedFireNet

    stream = H5EventStream(eval_config(dataset(state)), 2)
    wins = [torch.tensor(stream.next_batch()["event_cnt"], device="cuda") for _ in range(8)]
    stream.close()
    B, H, W = wins[0].shape[:3]
    model = seeded_firenet()
    unfused = seeded_firenet("bfloat16")
    nets = {layout: FusedFireNet.from_firenet(model, layout=layout)
            for layout in ("nhwc", "cmajor")}
    runs = {}
    with torch.no_grad():
        for name, net in (("unfused_bf16", unfused), *nets.items()):
            st = net.init_states(B, H, W)
            flows, spikes = [], []
            for x in wins:
                if name == "unfused_bf16":
                    out, st = net(None, x, st)
                    flow = out["flow"][0]
                else:
                    flow, st = net.step(x, st)
                flows.append(flow)
                spk = [s.spk if name != "cmajor" else s.spk.permute(0, 2, 3, 1) for s in st]
                spikes.append(spk)
            runs[name] = (torch.stack(flows), spikes)
    ref_flow, ref_spk = runs["unfused_bf16"]
    flow, spk = runs["nhwc"]
    frac = float(((flow - ref_flow).abs() > 0.05).float().mean())
    n_units = len(ref_spk[0])
    agree = [float(torch.stack([(spk[t][i] == ref_spk[t][i]).float().mean()
                                for t in range(len(wins))]).mean()) for i in range(n_units)]
    rates = [float(torch.stack([spk[t][i].mean() for t in range(len(wins))]).mean())
             for i in range(n_units)]
    layouts = float((runs["cmajor"][0] - flow).abs().max())
    ok = (frac < 0.02 and agree[0] > 0.999 and min(agree) > 0.95 and layouts <= 1e-5
          and all(1e-3 <= r <= 0.6 for r in rates) and bool(torch.isfinite(flow).all()))
    active = float(torch.stack([(x.sum(-1) > 0).float().mean() for x in wins]).mean())
    emit({"phase": "model", "windows": len(wins), "batch": B, "resolution": [H, W],
          "input_active_px": active,
          "flow_absmax": float(flow.abs().max()), "frac_dflow_gt_0.05": frac,
          "spike_agreement": agree, "spike_rates": rates,
          "layouts_max_abs_diff": layouts, "ok": ok})
    if not ok:
        raise SystemExit("the fused model disagrees with the unfused one, or a unit "
                         "is silent or saturated")


def phase_protocol(state):
    import numpy as np

    from evflow_torch.eval import evaluate

    cfg = eval_config(dataset(state))
    model = seeded_firenet()
    wrappers = {kn: kernel_fns(lay)[0] for kn, lay, _, _ in KERNELS}
    results = {}
    launches = {}
    for kname, layout, _, _ in KERNELS:
        # the counters of this path: 0 just before, read just after
        for w in wrappers.values():
            w.launches = 0
        stats = {}
        results[layout] = evaluate(cfg, model=model, fused=True, layout=layout, stats=stats)
        counts = {kn: w.launches for kn, w in wrappers.items()}
        launches[kname] = counts[kname]
        ok = (counts[kname] == 7 * stats["windows"] and stats["windows"] > 0
              and sum(counts.values()) == counts[kname])
        emit({"phase": "protocol", "fused": True, "layout": layout,
              "windows": stats["windows"], "seconds": stats["seconds"],
              "launches": counts, "metrics": results[layout], "ok": ok})
        if not ok:
            raise SystemExit(f"evaluate(fused=True, layout={layout!r}) launched "
                             f"{counts} for {stats['windows']} windows")
    stats = {}
    results["unfused"] = evaluate(cfg, model=model, fused=False, stats=stats)
    emit({"phase": "protocol", "fused": False, "windows": stats["windows"],
          "seconds": stats["seconds"], "metrics": results["unfused"]})
    ref = results["unfused"]["AEE"]
    rel = {layout: {f: abs(float(results[layout]["AEE"][f]) / float(v) - 1.0)
                    for f, v in ref.items()}
           for layout in ("nhwc", "cmajor")}
    values = [float(v) for r in results.values() for m in r.values() for v in m.values()]
    ok = (len(ref) == 2 and all(set(results[lay]["AEE"]) == set(ref) for lay in rel)
          and max(max(d.values()) for d in rel.values()) <= 0.02
          and bool(np.isfinite(values).all()))
    emit({"phase": "protocol", "aee_rel_diff_fused_vs_unfused": rel, "ok": ok})
    if not ok:
        raise SystemExit("the fused protocol's AEE is not within 2% of the unfused one")
    state["launches"] = launches


def phase_times(state):
    import torch
    import torch.nn.functional as F

    from evflow_torch.models.fused import FusedFireNet

    name = card()

    def device_ms(fn, iters=40):
        # the card sleeps while the host enqueues, so the events time the
        # launches back to back and not the host's enqueue rate
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    sums = {}
    for kname, layout, _, _ in KERNELS:
        fused, plain = kernel_fns(layout)
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bound_by=set())
        for case, cin, rec, hard in CASES:
            t = make_case(cin, rec, layout, seed=7)
            # cuDNN's bf16 conv of the same input and weights, the conv alone
            fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
            xb = conv_input(t, layout).to(torch.bfloat16).contiguous(memory_format=fmt)
            c, n_in = t["wk"].shape[0], xb.shape[1]
            wb = (t["wk"].reshape(c, 3, 3, -1)[..., :n_in].permute(0, 3, 1, 2)
                  .contiguous(memory_format=fmt))
            ms = device_ms(lambda: call(fused, t, hard))
            plain_ms = device_ms(lambda: call(plain, t, hard))
            lib_ms = device_ms(lambda: F.conv2d(xb, wb, padding=1))
            bms, by = bound(cin, rec)
            emit({"phase": "times", "kernel": kname, "case": case, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                  "bound_by": by, "card": name})
            w = PER_WINDOW.get(case, 0)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                           ("library_ms", lib_ms)):
                tot[key] += w * v
            if w:
                tot["bound_by"].add(by)
        tot["bound_by"] = "bytes" if tot["bound_by"] == {"bytes"} else "operations"
        sums[kname] = tot
    state["times"] = sums

    model = seeded_firenet()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_win = 300
    shape = (n_win, B_BENCH, H_BENCH, W_BENCH, 1)
    active = torch.rand(shape, generator=gen, device="cuda") < 0.05
    cnt = (active * torch.randint(1, 4, shape[:-1] + (2,), generator=gen, device="cuda")).float()
    for layout in ("nhwc", "cmajor"):
        net = FusedFireNet.from_firenet(model, layout=layout)
        st = net.init_states(B_BENCH, H_BENCH, W_BENCH)
        for i in range(10):
            _, st = net.step(cnt[i], st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_win):
            _, st = net.step(cnt[i], st)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        emit({"phase": "times", "scan": "FusedFireNet", "layout": layout, "batch": B_BENCH,
              "resolution": [H_BENCH, W_BENCH], "active_px": float(active.float().mean()),
              "windows": n_win, "windows_per_s": n_win * B_BENCH / dt,
              "ms_per_step": 1e3 * dt / n_win, "card": name})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import evflow_torch  # noqa: F401  (fails outside a checkout of the repository)

    # the f32 references run in full f32: no TF32 in cuDNN convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    state = {}
    table = {"build": phase_build, "kernels": phase_kernels, "model": phase_model,
             "protocol": phase_protocol, "times": phase_times}
    try:
        for p in PHASES:
            if p in phases:
                t0 = time.perf_counter()
                table[p](state)
                emit({"phase_done": p, "seconds": time.perf_counter() - t0})
    finally:
        if "tmp" in state:
            state["tmp"].cleanup()

    rows = []
    for kname, _, source, replaces in KERNELS:
        tm = state.get("times", {}).get(kname, {})
        rows.append({"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": state.get("launches", {}).get(kname),
                     "max_abs_err": state.get("max_abs_err", {}).get(kname),
                     **{k: tm.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}})
    print(card(), flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
