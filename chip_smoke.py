#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (``evflow_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                        # every phase, needs one CUDA card
    python3 chip_smoke.py --phases build,wholenet   # a subset

Phases, each printing JSON lines; any failure exits non-zero:

1. ``build``: compile the hand-written CUDA kernels from ``evflow_torch/csrc``
   (one ``nvcc`` per source, started together) and, beside them, the host
   library of the data path (``csrc/evflow_host.cpp`` with g++, its
   seconds printed) into ``evflow_torch/_build``, and print ptxas's
   registers, stack and spill bytes of the redesigned
   kernels (K1's and K2's four ``conv_lif_kernel`` instantiations each, one
   a padded output width of 16, 32, 48 or 64 channels, K7's two ``fused_net_batch_kernel`` instantiations, K5's two
   ``fused_net_loop2_kernel``, K4's eight ``fused_net_loop_kernel``, K3's
   14 ``fused_net_kernel`` (L = 1..7) and K6's two ``fused_net_lgrid_kernel``
   ones, the in-kernel dot's 12 ``probe_kernel`` instantiations, k2's
   ``load_dot_f32_kernel``, k12's ``load_dot_bf16_kernel``, k7's
   ``conv_sum_kernel``, K8e's 4 ``layer_grid_kernel`` instantiations, the
   ``store_kernel`` of k3 and k11 and the ``store_bulk_kernel`` of k4 and
   k8, K8i's and K8j's 10 ``unit_loop_kernel`` instantiations, and the
   bisection probes' 2 ``stack_kernel`` and 9 ``chain_kernel`` ones),
   failing if ptxas reports any of them not at all, or with a stack or
   spills.
2. ``kernels``: every kernel against its plain PyTorch version on the card at
   full width (C=32): head (Cin=2), feedforward, recurrent and subtract
   reset, and a feedforward and a recurrent unit of C=24 (padded to 32
   output channels), in both layouts, each at B=2, 256x256 (16 x 16 tiles)
   and at B=1, 128x128 (``evaluate``'s shape: 8 x 16 tiles). mem' within 1e-4 where the spikes agree
   (f32 sums in another order than cuDNN's, bf16 operands), spikes equal
   wherever |u - theta| > 1e-4, and at most 1e-5 of the elements differ.
3. ``model``: LIFFireNet (32 channels, 7 units, seeded weights) over 8
   windows at 128x128 of the phase-4 data: fused (both layouts) against the
   unfused port FireNet with bf16 convs (|dflow| > 0.05 on < 2% of the
   pixels, head spike agreement > 0.999, every unit > 0.95; layouts within
   1e-5), and every unit's spike rate within 0.1%..60%.
4. ``protocol``: the evaluation protocol with the settings of
   ``configs/eval_MVSEC.yml`` (32 channels, cnt, 256x256 pooled to 128x128,
   B=1, seeded weights) on 2 synthetic sequences of 80 windows, in five
   modes: per window, ``chunk=8`` (one CUDA graph replay a chunk) and
   ``chunk=8`` with ``device_metrics``, each fused in both layouts, and the
   unfused per-window path. Each mode runs over the whole set for windows/s
   and launches (counters 0 just before, read just after: 7 a window), then
   over its first 64 windows for the host split of a window (each part
   between syncs: waiting on the prefetcher, encode+upload, enqueue, device
   ms by CUDA events, metric sync plus host math, and the first chunk's
   eager run and capture); the device's idle share is 1 - the split's
   device ms a window over the first run's wall ms a window.
   Chunked results within 1e-6 of per-window, device metrics within 1e-5
   of the host's, every fused AEE within 2% of the unfused (f32 convs).
   Then ``python3 -m evflow_torch.eval_flow`` in a subprocess on a seeded
   ``.pth`` with ``--fused --chunk 8 --device_metrics``: its
   ``metrics_0.yml`` equal to the in-process results. Every run prints the
   stream's encoder (``native_fused``: the host library's one-pass window
   assembly). Then ``model.temporal_cnt`` (signed counts, crossing as f32)
   fused nhwc in chunks of 8 with ``device_metrics`` and unfused per window
   (the fused AEE within 2%); then the visual protocol
   (``configs/eval_MVSEC_visual.yml``: LIFFireFlowNet, the mask and GT
   pooled too, AEE and AAE, ``vis.store``) with ``collect_vis``, per window
   (the IWE on the card) and in chunks of 8 (the IWE on the host), both
   layouts: each window's IWE equal to the CPU's IWE of the same flow and
   event list, chunks within 1e-6 of per window, 7 launches a window; and
   the CLI with ``--fused`` on that config, its ``metrics_0.yml`` equal to
   the in-process per-window run (a host without cv2 renders the panels and
   writes none, saying so on stderr).
5. ``times``: CUDA-event times of every 32-channel phase-2 case at B=2,
   256x256 and at B=1, 128x128 (``evaluate``'s shape), its plain version
   and cuDNN's bf16 conv alone, beside the case's bound at that shape, and
   the sums of a window's 7 launches at each shape; then FusedFireNet
   windows/s over a long scan at B=2, 256x256, cnt input ~5% active, and
   over 7 rounds of 50 steps enqueued while the card sleeps: the host's
   enqueue time a step and the card's time a step, medians of the rounds
   (the scan is the larger of the two).
6. ``wholenet``: the whole-network step in one launch (K3 ``fused_net``, K4
   ``fused_net_loop``, K5 ``fused_net_loop2``, K6 ``fused_net_lgrid``, K7
   ``fused_net_batch``) at full width, 256x256, at B=2 over 8 windows and
   at B=8 (the bench entry point's batch) over 4, in f32 and bf16 state:
   each kernel step against ``firenet_step_plain`` on the same states
   (phase 2's bars, flow within 1e-4 on all but 1e-5 of its elements) and
   against the per-layer FusedFireNet (phase 3's bar; its free-running f32
   trajectory too, held for f32 state only), the five kernels' flows
   bit-equal; device times at B=2 and B=8 beside the plain version, the
   bound and the mma work issued (K3, K4, K5 and K7 share the item body of
   ``csrc/fused_net_item.cuh``: each unit over the 16x16 tile grown by
   L-1-l pixels, in 16-pixel fragments; K6 runs its pieces over the 16x16
   tiles with no halo), the per-layer step and 7 cuDNN convs as
   yardsticks; K7's, K5's, K3's and K6's times over the first L = 1, 3, 5,
   7 units at B=2 and B=8 in bf16 state and their fit
   (``probes/wholenet_slope.py``); 300-window
   scans of each runner, and the ``evflow_torch.bench_wholenet`` entry point
   over all five at B=8, 32 windows, each with the launch counters set to 0
   just before and read just after (1 launch per window).
7. ``probes``: the in-kernel dot probes (``evflow_torch.probes.inkernel_dot``)
   through their entry point ``run_all`` at the JAX probes' shapes
   (launch counters 0 just before, read just after; exactly 1 + repeats
   launches per case), each against its plain version (f32 accumulation
   within ``2 sqrt(K L S) 2^-24 max|out|``; int8 exact; bf16 accumulation,
   on integer operands that make every dot exact, equal, and an f32
   accumulation of the same operands must fail that check), with device
   ms, TF/s, the CTA count, the bound (operations over 989 TFLOP/s bf16 or
   1979 TOP/s int8) and cuBLAS's time for the same products, one product of
   the L stacked weight matrices per step (``torch.matmul`` bf16,
   ``torch._int_mm`` int8), as the yardstick, and the kernel's time over
   each (``x_bound``, ``x_library``).
8. ``staging``: the staging probes (``evflow_torch.probes.staging``: K8c,
   K8d row windows staged by TMA bulk copies, K8e's layer loop, and K8c at
   H=2048) through ``run_all`` (launch counters 0 just before, read just
   after; exactly 1 + repeats launches per case), each against its plain
   version (row windows bit-equal, and the sums of their halo rows' words
   as the kernel read them from shared memory equal to x's, and their
   launch floor: one channel's one tile, one CTA; the layer grid
   within ``2 sqrt(9C L) 2^-24 max|out|``), with device ms, GB/s of what
   the function needs and of what it stages, issued TFLOP/s, the bound
   (the function's bytes over 3.35 TB/s or operations over 989 TFLOP/s) and a
   yardstick the port never calls: ``torch.mul(x[0, :, halo:halo+H], 2.0,
   out=...)`` for a row window (no halo staged), one ``torch.matmul`` of
   the stacked ``[C, L 9C]`` weights against prebuilt ``[L 9C, P]`` patches
   for the layer grid. Then K8e at L = 1, 3, 5 and 7 layers
   (``probes/staging_slope.py``) and the slope of its time over L: what
   staging one more layer costs.
9. ``unitloop``: the unit-loop probes (``evflow_torch.probes.unit_loop``: K8i's
   three cases, one conv+LIF unit in a runtime layer loop with and without
   the LIF and the per-layer output, and K8j, the same body behind staged
   spike slots) at the JAX probes' shapes through ``run_all`` (launch
   counters 0 just before, read just after; exactly 1 + repeats launches
   per case), each against its plain version (equal, case 14 too, on
   operands that make every sum exact: ``unit_loop.draw_operands``) and K8j's
   stored spike slots equal to the plain slots, with device ms, the bound
   (the bytes and operations of the cone of rows the outputs need), the
   CTAs, threads and shared bytes, and L cuDNN bf16 convs of ``[1, 2C, E,
   W]`` by ``[C, 2C, 3, 3]`` (the conv alone) as the yardstick.
10. ``loopdyn``: the runtime-indexed loop probes (``evflow_torch.probes.loop_dyn``:
   K8f's k1-k5, K8h's k10-k12 and K8g's k6-k8, a layer loop reading and
   writing a shared-memory scratch at the runtime layer index) at the JAX
   probes' shapes (L=4, C=32, E=24, W=256; k6's p ``[4,32,3]``, k7's w
   ``[4,32,288]``, k8's TH=8) through ``run_all`` (launch counters 0 just
   before, read just after; exactly 1 + repeats launches per case), each
   against its plain version (equal, on integer operands scaled 16^l per
   layer that make every sum exact: ``loop_dyn.draw_operands``; the f32
   dots k2 and k7 also on f32 normals, within ``loop_dyn.f32_tolerance``,
   which a dot on TF32 or bf16 operands misses, and k12 on bf16 normals
   within the same, which its sums kept in bf16 must miss), k3's and
   k11's whole scratch (``scratch=True``) equal to the plain one, and k4
   launched into a NaN-filled output, every element written; with device
   ms, the bound (the function's bytes over 3.35 TB/s, or its operations
   over 67 TFLOP/s f32 or 989 bf16; for k3, k4, k7, k8, k11 and k12 also
   the bound of what the kernel moves through device memory, for k3 and
   k11 every layer of x and the output; for every body the launch floor:
   the same kernel at one CTA, ``loop_dyn.floor_args``), GB/s and TFLOP/s of what
   it needs, the CTAs, threads and shared bytes, and one PyTorch call for
   the same function as the yardstick: ``x.sum(0)``, ``torch.mul(x[0], 2)``,
   ``torch.mul(x, 3)``, ``torch.tensordot`` of the slot counts [1, 1, 2, 0]
   with x, one ``torch.matmul`` of the stacked ``[C, L 3C] @ [L 3C, E W]``
   operands (k12 also ``torch.mm`` of them with an f32 output, as the
   kernel writes: ``library_f32_ms``); k6 ``p[:, :, 1].sum(0)`` broadcast,
   k7 one ``F.conv2d`` of ``[1, L C, E, W]`` (f32, TF32 off), k8
   ``torch.mul(x[:, :, 8:16], 2)``; and the kernel's time over the bound
   and over the yardstick.
11. ``mosaicops``: the Mosaic-ops probes (``evflow_torch.probes.mosaic_ops``:
   K8o's k_misc and k_roll on ``csrc/probe_mosaic_ops.cu``, k_dot3 on the
   in-kernel dot kernel) at the JAX probe's shapes (C=32, K=288, E=32,
   W=256, bf16 normals) through ``run_all`` (launch counters as in phase
   10), each against its plain version (k_misc and k_roll equal, each bf16
   sum rounded once alike; k_dot3 within ``2 sqrt(K) 2^-24 max|out|``),
   with device ms, the launch floor of k_misc and k_roll (one row of v,
   one CTA), the bound, and the yardstick: ``(torch.roll(v, 1, 2) +
   torch.roll(v, 1, 1)).float()``, ``(v + torch.where(w > 0, v,
   0)).float()``, ``torch.mm`` on the bf16 operands with an f32 output
   (``out_dtype``), and the kernel's time over the bound and the yardstick.
12. ``bisect``: the whole-net bisection probes (``evflow_torch.probes.wholenet_bisect``:
   K8k's kA and kB, K8l's two, K8m's four and K8n's three chain variants, on
   ``csrc/probe_wholenet_bisect.cu``) at the JAX files' shapes (C=32, H=64,
   W=256, TH=16; B=1 for K8k, 2 for the chain) through ``run_all`` (launch
   counters as in phase 10), every output of each case (kA's and kB's out;
   the chain's o0, o1 and flow) against its plain version: equal, on
   operands that make every sum exact (``wholenet_bisect.draw_operands``),
   the pred flow within ``2 sqrt(C) 2^-24 max|out|`` plus 4 f32 ulps; with
   device ms, the bound, the CTAs, threads and shared bytes, and cuDNN bf16
   convs of the same shapes as the yardstick (kA one, kB seven chained,
   the chain two chained over ``[B, 32, Hp, W]``).

The line before the last is one JSON object with a row per kernel (for the
per-layer kernels, times summed over one window's 7 launches at the bench
shape: the head once, feedforward units 4 times, recurrent units twice; for
the whole-network kernels one launch in bf16 state, the runners' default,
with the launches of the bench entry point's run; for the probes one
launch at the JAX probe's shape, with the launches of its case in
``run_all``);
the last is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import tempfile
import time

PHASES = ("build", "kernels", "model", "protocol", "times", "wholenet", "probes", "staging",
          "unitloop", "loopdyn", "mosaicops", "bisect")

B_BENCH, H_BENCH, W_BENCH, C_BENCH = 2, 256, 256, 32
# K1's and K2's cases (case, Cin, recurrent, hard reset), their launches a
# LIFFireNet window and the shapes they are timed at (the bench's, B=2,
# 256x256, and evaluate's, B=1, 128x128) are evflow_torch.probes.conv_lif_times';
# phase 2 also runs these at a width the kernels pad to 32 output channels
CASES_24 = (("ff24", 24, False, True), ("rec24", 24, True, True))
KERNELS = (  # name, layout, source, the TPU kernel's pallas_call
    ("fused_conv_lif", "nhwc", "evflow_torch/csrc/conv_lif.cu",
     "evflow/ops/pallas/conv_lif.py:151"),
    ("fused_conv_lif_cmajor", "cmajor", "evflow_torch/csrc/conv_lif_cmajor.cu",
     "evflow/ops/pallas/conv_lif_cmajor.py:156"),
)
WHOLENET = (  # name, module under evflow_torch.ops, runner, source, the TPU kernel's pallas_call
    ("fused_firenet_step", "fused_net", "WholeNetFireNet", "evflow_torch/csrc/fused_net.cu",
     "benchmarks/pallas_archive/fused_net.py:228"),
    ("fused_firenet_step_loop", "fused_net_loop", "UnrolledLoopFireNet",
     "evflow_torch/csrc/fused_net_loop.cu", "benchmarks/pallas_archive/fused_net_loop.py:157"),
    ("fused_firenet_step_loop2", "fused_net_loop2", "LoopFireNet",
     "evflow_torch/csrc/fused_net_loop2.cu", "benchmarks/pallas_archive/fused_net_loop2.py:179"),
    ("fused_firenet_step_lgrid", "fused_net_lgrid", "LayerGridFireNet",
     "evflow_torch/csrc/fused_net_lgrid.cu", "benchmarks/pallas_archive/fused_net_lgrid.py:170"),
    ("fused_firenet_step_batch", "fused_net_batch", "BatchFireNet",
     "evflow_torch/csrc/fused_net_batch.cu", "benchmarks/pallas_archive/fused_net_batch.py:181"),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    from evflow_torch.device import describe_card

    return describe_card()


def kernel_fns(layout):
    """(wrapper, plain version) of the layout's kernel."""
    from evflow_torch.ops.conv_lif import conv_lif_plain, fused_conv_lif
    from evflow_torch.ops.conv_lif_cmajor import conv_lif_cmajor_plain, fused_conv_lif_cmajor

    if layout == "nhwc":
        return fused_conv_lif, conv_lif_plain
    return fused_conv_lif_cmajor, conv_lif_cmajor_plain


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


def seeded_firenet(compute_dtype=None, name="LIFFireNet"):
    """A FireNet (LIFFireNet unless ``name``) at full width on the card,
    weights from seed 0."""
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    cfg = dict(eval_config("")["model"], name=name)
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
    """The phase-3/4 dataset: 2 synthetic sequences of 80 windows at
    256x256 (20 chunks of 8), written once per run into a temporary
    directory (as numpy archives: the GPU host need not have h5py)."""
    if "root" not in state:
        from evflow_torch.data.synthetic import make_dataset

        state["tmp"] = tempfile.TemporaryDirectory(prefix="evflow_smoke_")
        state["root"] = state["tmp"].name
        make_dataset(state["root"], num_sequences=2, seed=0, duration=8.0,
                     resolution=(256, 256), events_per_sec=50_000, fmt="npz")
    return state["root"]


def device_ms(fn, iters=40):
    """CUDA-event ms per call of ``fn``, after warm-up. The card sleeps
    while the host enqueues, so the events time the launches back to back
    and not the host's enqueue rate."""
    import torch

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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(state):
    import threading

    from evflow_torch.data import native
    from evflow_torch.ops import cuda_build

    # the host library (g++) builds while the nvcc processes run
    host = {}

    def build_host():
        try:
            host["seconds"] = native.build()
        except Exception as e:  # raised below
            host["error"] = e

    host_thread = threading.Thread(target=build_host)
    host_thread.start()
    t0 = time.perf_counter()
    per_source = cuda_build.build()
    host_thread.join()
    if "error" in host:
        raise SystemExit(f"the host library did not build: {host['error']}")
    emit({"phase": "build", "host_library": native.library_path().name,
          "host_seconds": host["seconds"]})
    ptxas = {}
    for name in cuda_build.SOURCES:
        log = cuda_build.BUILD_DIR / f"{name}.ptxas.txt"
        if log.exists():
            ptxas[name] = [ln.split("info    :")[-1].strip() for ln in log.read_text().splitlines()
                           if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": per_source, "ptxas": ptxas})
    redesigned, missing = cuda_build.ptxas_kernels(REDESIGNED)
    spill_free = not missing and all(
        r["stack"] == 0 and r["spill_stores"] == 0 and r["spill_loads"] == 0
        for r in redesigned.values())
    emit({"phase": "build", "redesigned": redesigned, "missing": missing,
          "spill_free": spill_free})
    if missing:
        raise SystemExit(f"ptxas reports no registers for the redesigned kernels {missing}")
    if not spill_free:
        raise SystemExit(f"a redesigned kernel has a stack frame or spills: {redesigned}")


# the kernels redesigned for the card's speed, per source: K1's and K2's for
# each padded output width (conv_lif_layer.cuh's launch), the K7, K5 and
# K6 instantiations (f32 and bf16 state), K4's for each compiled unit layout
# (units, recurrent mask) and state, K3's for each unit count and state,
# every instantiation
# probe_kernel<MT, MODE, PIXM, SPLITK> that the launch can choose, k2, k12,
# k7, every layer_grid_kernel<MF> (K8e, C <= 16 MF), the store kernel of k3
# and k11 and the bulk store of k4 and k8, the unit loop's K8i and K8j, and
# the bisection probes' K8k (kA, kB) and chain (K8l-K8n)
REDESIGNED = {
    "conv_lif": tuple(f"conv_lif_kernel<{ch},1>" for ch in (16, 32, 48, 64)),
    "conv_lif_cmajor": tuple(f"conv_lif_kernel<{ch},0>" for ch in (16, 32, 48, 64)),
    "fused_net_batch": ("fused_net_batch_kernel<float>", "fused_net_batch_kernel<__nv_bfloat16>"),
    "fused_net_loop2": ("fused_net_loop2_kernel<float>", "fused_net_loop2_kernel<__nv_bfloat16>"),
    "fused_net_loop": tuple(f"fused_net_loop_kernel<{layout},{s}>"
                            for layout in ("7,18", "5,10", "7,0", "5,0")
                            for s in ("float", "__nv_bfloat16")),
    "fused_net": tuple(f"fused_net_kernel<{n},{s}>" for n in range(1, 8)
                       for s in ("float", "__nv_bfloat16")),
    "fused_net_lgrid": ("fused_net_lgrid_kernel<float>", "fused_net_lgrid_kernel<__nv_bfloat16>"),
    "probe_inkernel_dot": tuple(f"probe_kernel<{a}>" for a in (
        "32,0,1,0", "32,0,1,1",                          # f32 accumulation, pixel-major
        "32,0,0,0", "32,0,0,1", "16,0,0,0", "16,0,0,1",  # f32, channel-major
        "32,1,0,0", "16,1,0,0",                          # bf16 accumulation (no split K)
        "32,2,0,0", "32,2,0,1", "16,2,0,0", "16,2,0,1",  # int8
    )),
    "probe_loop_dyn": ("load_dot_f32_kernel", "load_dot_bf16_kernel", "store_kernel<float>",
                       "store_kernel<__nv_bfloat16>", "store_bulk_kernel", "conv_sum_kernel"),
    "probe_staging": tuple(f"layer_grid_kernel<{mf}>" for mf in (1, 2, 3, 4)),
    "probe_unit_loop": tuple(f"unit_loop_kernel<{v},{fpw}>" for v in (
        "1,1,0", "1,0,0", "0,1,0", "0,0,0", "1,1,1") for fpw in (2, 4)),  # <LIF, DYN, SLOTS, FPW>
    # kA, kB, and the chain's nine variants <LIF, PRM, FLOW, OUT_SPK, SCRATCH>
    "probe_wholenet_bisect": ("stack_kernel<1>", "stack_kernel<7>") + tuple(
        f"chain_kernel<{v}>" for v in (
            "0,0,0,1,1", "0,0,0,1,0", "0,2,2,0,0", "1,2,1,0,0", "1,1,2,0,0", "1,2,2,0,0",
            "0,0,1,0,0", "2,0,1,0,0", "3,0,1,0,0")),
}


def phase_kernels(state):
    import torch

    from evflow_torch.probes.conv_lif_times import CASES, SHAPES, make_case

    for kname, layout, _, _ in KERNELS:
        fused, plain = kernel_fns(layout)
        worst = 0.0
        # the bench's 16 x 16 tiles and evaluate's 8 x 16 ones (B=1, 128x128)
        for (seed, (case, cin, rec, hard)), (B, H, W) in itertools.product(
                enumerate(CASES + CASES_24), SHAPES):
            t = make_case(cin, rec, layout, seed=seed, B=B, H=H, W=W,
                          c=24 if (case, cin, rec, hard) in CASES_24 else C_BENCH)
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
            emit({"phase": "kernels", "kernel": kname, "case": case, "B": B, "H": H, "W": W,
                  "max_abs_err": err,
                  "mismatches": mismatches, "spike_flips_near_threshold": int(flips.sum()) - far,
                  "spike_flips_far": far, "elements": n, "spike_rate": float(spk_k.mean()),
                  "ok": ok})
            if not ok:
                raise SystemExit(f"{kname}/{case} at B={B}, {H}x{W} disagrees with its plain "
                                 "version")
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


SPLIT_WINDOWS = 64  # windows of a host-split run: 8 chunks of 8
PROTOCOL_MODES = (  # name, evaluate's keywords: fused runs in both layouts, then unfused
    ("window", dict()),
    ("chunk8", dict(chunk=8)),
    ("chunk8_dm", dict(chunk=8, device_metrics=True)),
)


def protocol_run(cfg, model, wrappers, **kw):
    """One evaluate run (``debug`` unless ``kw`` says otherwise) with the
    launch counters set to 0 just before and read just after, then the
    first SPLIT_WINDOWS windows again with the host split measured (a sync
    between the parts); returns (what evaluate returned, record)."""
    from evflow_torch.eval import evaluate

    kw.setdefault("debug", True)
    for w in wrappers.values():
        w.launches = 0
    stats = {}
    results = evaluate(cfg, model=model, stats=stats, **kw)
    launches = {kn: w.launches for kn, w in wrappers.items()}
    split = {"split": True}
    evaluate(cfg, model=model, stats=split, max_windows=SPLIT_WINDOWS, **kw)
    wall_ms = 1e3 * stats["seconds"]
    dev = split["split_ms"]["device"]
    rec = {"windows": stats["windows"], "seconds": stats["seconds"], "encoder": stats["encoder"],
           "windows_per_s": stats["windows"] / stats["seconds"],
           "ms_per_window": wall_ms / stats["windows"],
           "split_windows": split["windows"], "split_ms_per_window": split["split_ms"],
           "split_slow_enqueues": split["slow_enqueues"],
           "device_idle_share": 1.0 - dev * stats["windows"] / wall_ms,
           "launches": launches,
           "launches_per_window": {kn: n / stats["windows"] for kn, n in launches.items()}}
    return results, rec


def phase_protocol(state):
    """The evaluation protocol as users run it (configs/eval_MVSEC.yml's
    settings, seeded weights, 2 sequences of 80 windows): per window,
    chunks of 8 as CUDA graph replays, and chunks of 8 with the metrics on
    the device, in both layouts, and the unfused per-window path; then the
    eval CLI in a subprocess."""
    import numpy as np

    cfg = eval_config(dataset(state))
    model = seeded_firenet()
    wrappers = {kn: kernel_fns(lay)[0] for kn, lay, _, _ in KERNELS}
    name = card()
    from evflow_torch.eval import evaluate

    # loads the kernels and cuBLAS, and warms the host (a process's first
    # streams and graph captures run slower): not measured
    for _, layout, _, _ in KERNELS:
        evaluate(cfg, model=model, fused=True, layout=layout, debug=True, max_windows=2)
        evaluate(cfg, model=model, fused=True, layout=layout, debug=True, max_windows=40,
                 chunk=8, device_metrics=True)
    results, launches = {}, {}
    fails = []
    for kname, layout, _, _ in KERNELS:
        for mode, kw in PROTOCOL_MODES:
            res, rec = protocol_run(cfg, model, wrappers, fused=True, layout=layout, **kw)
            results[(layout, mode)] = res
            counts = rec["launches"]
            ok = (counts[kname] == 7 * rec["windows"] and rec["windows"] >= 160
                  and sum(counts.values()) == counts[kname])
            if mode == "chunk8_dm":
                launches[kname] = counts[kname]
            emit({"phase": "protocol", "fused": True, "layout": layout, "mode": mode, **kw,
                  **rec, "metrics": res, "card": name, "ok": ok})
            if not ok:
                fails.append(f"{layout} {mode}: {counts} launches for {rec['windows']} windows")
    res, rec = protocol_run(cfg, model, wrappers, fused=False)
    results["unfused"] = res
    emit({"phase": "protocol", "fused": False, "mode": "window", **rec, "metrics": res,
          "card": name})

    def rel_diff(a, b):
        return max(abs(float(a[m][f]) / float(v) - 1.0) if float(v) else abs(float(a[m][f]))
                   for m, per_file in b.items() for f, v in per_file.items())

    ref = results["unfused"]["AEE"]
    checks = {}
    for _, layout, _, _ in KERNELS:
        base = results[(layout, "window")]
        checks[f"{layout}_chunk8_vs_window"] = rel_diff(results[(layout, "chunk8")], base)
        checks[f"{layout}_dm_vs_window"] = rel_diff(results[(layout, "chunk8_dm")], base)
        for mode, _ in PROTOCOL_MODES:
            checks[f"{layout}_{mode}_aee_vs_unfused"] = rel_diff(
                {"AEE": results[(layout, mode)]["AEE"]}, {"AEE": ref})
    values = [float(v) for r in results.values() for m in r.values() for v in m.values()]
    ok = (len(ref) == 2 and bool(np.isfinite(values).all())
          and all(set(r) == set(results["unfused"]) for r in results.values())
          and all(v <= (1e-6 if k.endswith("chunk8_vs_window") else
                        1e-5 if k.endswith("dm_vs_window") else 0.02)
                  for k, v in checks.items()))
    emit({"phase": "protocol", "rel_diffs": checks, "ok": ok})
    if not ok:
        fails.append("chunked results beyond 1e-6 of per-window, device metrics beyond 1e-5 "
                     "of the host's, or a fused AEE beyond 2% of the unfused one")
    cli = protocol_cli(cfg, model, results[("nhwc", "chunk8_dm")])
    if not cli:
        fails.append("the eval CLI's metrics_0.yml differs from the in-process results")
    fails += protocol_temporal(state, wrappers, name)
    fails += protocol_visual(state, wrappers, name)
    if fails:
        raise SystemExit("; ".join(fails))
    state["launches"] = launches


def protocol_temporal(state, wrappers, name) -> list:
    """``model.temporal_cnt`` (counts of the window's signed pos - neg and
    the previous window's, crossing as f32) in the users' mode, fused nhwc
    ``chunk=8`` with ``device_metrics``, and unfused per window: 7 launches
    a window, finite results, the fused AEE within 2% of the unfused."""
    import numpy as np

    cfg = eval_config(dataset(state))
    cfg["model"]["temporal_cnt"] = True
    model = seeded_firenet()
    kname, layout = KERNELS[0][:2]
    fused, rec = protocol_run(cfg, model, wrappers, fused=True, layout=layout, chunk=8,
                              device_metrics=True)
    counts = rec["launches"]
    emit({"phase": "protocol", "temporal_cnt": True, "fused": True, "layout": layout,
          "mode": "chunk8_dm", **rec, "metrics": fused, "card": name})
    unfused, rec_u = protocol_run(cfg, model, wrappers, fused=False)
    emit({"phase": "protocol", "temporal_cnt": True, "fused": False, "mode": "window", **rec_u,
          "metrics": unfused, "card": name})
    aee = max(abs(float(fused["AEE"][f]) / float(v) - 1.0) for f, v in unfused["AEE"].items())
    values = [float(v) for r in (fused, unfused) for m in r.values() for v in m.values()]
    ok = (counts[kname] == 7 * rec["windows"] and rec["windows"] >= 160
          and len(unfused["AEE"]) == 2 and set(fused) == set(unfused)
          and bool(np.isfinite(values).all()) and aee <= 0.02)
    emit({"phase": "protocol", "temporal_cnt": True, "aee_vs_unfused": aee, "ok": ok})
    return [] if ok else [f"temporal_cnt: {counts} launches for {rec['windows']} windows, or "
                          f"the fused AEE {aee:.4f} off the unfused one"]


VISUAL_MODES = (("window", dict()), ("chunk8", dict(chunk=8)))


def visual_config(root):
    """configs/eval_MVSEC_visual.yml (LIFFireFlowNet, 32 channels, 256x256
    pooled to 128x128 with the mask and GT, hot filter, AEE and AAE,
    ``vis.store`` as videos) on the phase's dataset."""
    import os

    from evflow_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                   "eval_MVSEC_visual.yml"))
    cfg["data"]["path"] = root
    return cfg


def protocol_visual(state, wrappers, name) -> list:
    """The visual protocol: ``evaluate(fused=True, collect_vis=True)`` with
    ``vis.store`` (not debug: the panels render, and a host without cv2
    writes none) per window (each window's IWE on the card beside the step)
    and in chunks of 8 (the IWE on the host), both layouts; each window's
    IWE equal to the CPU's IWE of the same flow over the window's event
    list (``round_idx`` splats sums of ones: exact), 7 launches a window,
    chunks equal to per window within 1e-6; then the CLI on the config."""
    import os

    import numpy as np
    import torch

    from evflow_torch.data.h5_stream import H5EventStream
    from evflow_torch.ops.iwe import compute_pol_iwe

    cfg = visual_config(dataset(state))
    model = seeded_firenet(name="LIFFireFlowNet")
    stream = H5EventStream(cfg, 2)
    batches = []
    while True:
        b = stream.next_batch()
        if b["epoch_done"]:
            break
        batches.append({k: b[k] for k in ("event_list", "event_list_pol_mask", "event_valid")})
    stream.close()
    H, W = cfg["loader"]["resolution"]
    scaling = cfg["metrics"]["flow_scaling"]
    fails, results = [], {}
    with tempfile.TemporaryDirectory(prefix="evflow_vis_") as out:
        for kname, layout, _, _ in KERNELS:
            for mode, kw in VISUAL_MODES:
                (res, frames), rec = protocol_run(cfg, model, wrappers, fused=True, layout=layout,
                                                  collect_vis=True, debug=False, path_results=out,
                                                  **kw)
                results[(layout, mode)] = res
                t0 = time.perf_counter()
                iwe_equal = len(frames) == len(batches)
                for f, b in zip(frames, batches):
                    pm = torch.from_numpy(b["event_list_pol_mask"])
                    host = compute_pol_iwe(torch.from_numpy(f["flow"]),
                                           torch.from_numpy(b["event_list"]), (H, W), pm[..., 0],
                                           pm[..., 1], flow_scaling=scaling, round_idx=True,
                                           valid=torch.from_numpy(b["event_valid"]))
                    iwe_equal &= bool(np.array_equal(f["iwe"], host.numpy()))
                counts = rec["launches"]
                ok = (counts[kname] == 7 * rec["windows"] and rec["windows"] >= 160 and iwe_equal
                      and all(np.isfinite(f["flow"]).all() for f in frames)
                      and sum(float(f["iwe"].sum()) for f in frames) > 0)
                emit({"phase": "protocol", "visual": True, "fused": True, "layout": layout,
                      "mode": mode, **kw, **rec, "metrics": res, "frames": len(frames),
                      "iwe_equal_to_cpu": iwe_equal,
                      "cpu_iwe_ms_per_window": 1e3 * (time.perf_counter() - t0) / len(frames),
                      "files_written": sum(len(fs) for _, _, fs in os.walk(out)),
                      "card": name, "ok": ok})
                if not ok:
                    fails.append(f"visual {layout} {mode}: {counts} launches for "
                                 f"{rec['windows']} windows, IWE equal to the CPU's: {iwe_equal}")
        for _, layout, _, _ in KERNELS:
            a, b = results[(layout, "chunk8")], results[(layout, "window")]
            diff = max(abs(float(a[m][f]) / float(v) - 1.0) if float(v) else abs(float(a[m][f]))
                       for m, per_file in b.items() for f, v in per_file.items())
            emit({"phase": "protocol", "visual": True, "layout": layout,
                  "chunk8_vs_window": diff, "ok": diff <= 1e-6})
            if diff > 1e-6:
                fails.append(f"visual {layout}: chunk8 {diff} off per window")
    if not protocol_cli(cfg, model, results[("nhwc", "window")], chunked=False):
        fails.append("the eval CLI's metrics_0.yml on the visual config differs from the "
                     "in-process results")
    return fails


def protocol_cli(cfg, model, expected, chunked=True) -> bool:
    """``python3 -m evflow_torch.eval_flow <seeded .pth> --fused --chunk 8
    --device_metrics`` (or without chunks: ``--fused`` alone) in a
    subprocess, on the config written as YAML; its metrics_0.yml against
    the in-process results."""
    import os
    import subprocess
    from pathlib import Path

    import torch
    import yaml

    with tempfile.TemporaryDirectory(prefix="evflow_cli_") as d:
        ckpt, cfg_path, out = Path(d) / "seeded.pth", Path(d) / "eval.yml", Path(d) / "results"
        torch.save(model.state_dict(), ckpt)
        cfg_path.write_text(yaml.safe_dump(cfg))
        cmd = [sys.executable, "-m", "evflow_torch.eval_flow", str(ckpt), "--config",
               str(cfg_path), "--fused", "--path_results", str(out)]
        if chunked:
            cmd[-2:-2] = ["--chunk", "8", "--device_metrics"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        metrics_file = out / "seeded.pth" / "metrics_0.yml"
        got = yaml.safe_load(metrics_file.read_text()) if metrics_file.exists() else {}
    runid = got.pop("runid", None)
    ok = proc.returncode == 0 and runid == "seeded.pth" and got == expected
    emit({"phase": "protocol", "cli": " ".join(["python3", *cmd[1:]]), "rc": proc.returncode,
          "seconds": seconds, "metrics_0": got, "equal_to_in_process": got == expected,
          "stderr_tail": proc.stderr[-2000:], "ok": ok})
    return ok


def phase_times(state):
    import torch
    import torch.nn.functional as F

    from evflow_torch.models.fused import FusedFireNet

    name = card()

    from evflow_torch.probes.conv_lif_times import CASES, PER_WINDOW, SHAPES, bound, make_case

    sums = {}
    for kname, layout, _, _ in KERNELS:
        fused, plain = kernel_fns(layout)
        for B, H, W in SHAPES:
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bound_by=set())
            for case, cin, rec, hard in CASES:
                t = make_case(cin, rec, layout, seed=7, B=B, H=H, W=W)
                # cuDNN's bf16 conv of the same input and weights, the conv alone
                fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
                xb = conv_input(t, layout).to(torch.bfloat16).contiguous(memory_format=fmt)
                c, n_in = t["wk"].shape[0], xb.shape[1]
                wb = (t["wk"].reshape(c, 3, 3, -1)[..., :n_in].permute(0, 3, 1, 2)
                      .contiguous(memory_format=fmt))
                ms = device_ms(lambda: call(fused, t, hard))
                plain_ms = device_ms(lambda: call(plain, t, hard))
                lib_ms = device_ms(lambda: F.conv2d(xb, wb, padding=1))
                bms, by = bound(cin, rec, B, H, W)
                emit({"phase": "times", "kernel": kname, "case": case, "B": B, "H": H, "W": W,
                      "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                      "bound_by": by, "card": name})
                w = PER_WINDOW.get(case, 0)
                for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                               ("library_ms", lib_ms)):
                    tot[key] += w * v
                if w:
                    tot["bound_by"].add(by)
            tot["bound_by"] = "bytes" if tot["bound_by"] == {"bytes"} else "operations"
            emit({"phase": "times", "kernel": kname, "window": PER_WINDOW, "B": B, "H": H,
                  "W": W, **tot, "card": name})
            if (B, H, W) == (B_BENCH, H_BENCH, W_BENCH):
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
        # 7 rounds of 50 steps enqueued while the card sleeps: the host's
        # enqueue time a step, and the card's time a step with the launches
        # back to back (medians; the host's clock varies by tens of percent)
        host, dev = [], []
        for _ in range(7):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(int(5e8))
            t0 = time.perf_counter()
            start.record()
            for i in range(50):
                _, st = net.step(cnt[i], st)
            end.record()
            host.append(1e3 * (time.perf_counter() - t0) / 50)
            torch.cuda.synchronize()
            dev.append(start.elapsed_time(end) / 50)
        emit({"phase": "times", "scan": "FusedFireNet", "layout": layout, "batch": B_BENCH,
              "resolution": [H_BENCH, W_BENCH], "active_px": float(active.float().mean()),
              "windows": n_win, "windows_per_s": n_win * B_BENCH / dt,
              "ms_per_step": 1e3 * dt / n_win, "host_enqueue_ms_per_step": statistics.median(host),
              "host_enqueue_ms_runs": host, "device_ms_per_step": statistics.median(dev),
              "card": name})


def wholenet_fns(kname):
    """(wrapper, runner class) of a whole-network kernel."""
    import importlib

    module, runner = next(k[1:3] for k in WHOLENET if k[0] == kname)
    mod = importlib.import_module(f"evflow_torch.ops.{module}")
    return getattr(mod, kname), getattr(mod, runner)


def event_windows(n, batch, seed=0):
    """``[n, batch, 256, 256, 2]`` count windows on the card, ~5% of the
    pixels active (the ``bench.py`` workload)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n, batch, H_BENCH, W_BENCH, 1)
    active = torch.rand(shape, generator=gen, device="cuda") < 0.05
    return (active * torch.randint(1, 4, shape[:-1] + (2,), generator=gen,
                                   device="cuda")).float()


def unit_inputs(runner, states):
    """(mems, previous spikes of recurrent units) per unit of a runner's
    states, the operands of ``firenet_step_plain``."""
    mems, spikes = runner.unit_states(states)
    return mems, [s if r else None for s, r in zip(spikes, runner.weights.recurrent)]


def wholenet_bound(runner, batch):
    """Least time of one window of the runner's kernel at ``batch`` x 256^2:
    its own state, input, weight and flow bytes once each at the HBM rate,
    against its bf16 conv and f32 LIF operations. Returns (ms, by)."""
    from evflow_torch.device import BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S

    w = runner.weights
    px = batch * H_BENCH * W_BENCH
    n = px * w.channels
    s = runner.state_dtype.itemsize
    mems, spikes = runner.unit_states(runner.init_states(1, 1, 1))
    kept = sum(sp is not None for sp in spikes)
    nbytes = (4 * px * runner.num_bins + 2 * w.num_units * n * s + sum(w.recurrent) * n * s
              + kept * n * s + 4 * px * 2 + sum(2 * t.numel() for t in w.wk)
              + 4 * (w.params.numel() + w.pred_w.numel() + w.pred_b.numel()))
    k_in = [runner.num_bins if l == 0 else w.channels * (2 if r else 1)
            for l, r in enumerate(w.recurrent)]
    t_ops = (sum(2 * n * 9 * k for k in k_in) + 4 * px * w.channels) / BF16_FLOP_PER_S \
        + 10 * n * w.num_units / F32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timed_scan(net, windows, states):
    """``net.scan_windows`` timed by the host clock (seconds, ending in a
    sync) and by CUDA events around it (device ms from the first launch to
    the last one's end): their difference is time the card waited."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = net.scan_windows(windows, states)
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def issued_flops(kname, runner, batch):
    """bf16 tensor-core flops that the kernel's mma instructions issue for
    one window at ``batch`` x 256^2, halo recompute, channel padding (the
    head's 2 channels run as 16) and ragged 16-pixel fragments included;
    the tile shapes are those of ``evflow_torch/csrc``: K3, K4, K5 and K7
    each unit over its item's extent, K6 every unit over the 16 x 16 tiles
    with no halo."""
    from evflow_torch.ops.fused_net_item import item_count, item_extent

    w = runner.weights
    L = w.num_units
    ck = [t.shape[1] // 9 for t in w.wk]

    def frags(px):  # output pixels rounded up to whole 16-pixel m16 fragments
        return -(-px // 16) * 16

    items = item_count(batch, H_BENCH, W_BENCH)
    if kname == "fused_firenet_step_lgrid":  # 16 x 16 tiles, no halo recompute
        px = [frags(16 * 16) * items] * L
    else:  # K3 / K4 / K5 / K7: 16x16 items, unit l's extent grown by L-1-l
        px = [frags(item_extent(l, L)[0] * item_extent(l, L)[1]) * items for l in range(L)]
    return sum(2 * p * w.channels * 9 * k for p, k in zip(px, ck))


def hold_wholenet(perlayer, wins, dtypes, worst):
    """Each whole-network kernel, in each state dtype, stepped over ``wins``
    and held at every step against ``firenet_step_plain`` and the per-layer
    FusedFireNet on the same states, and against the per-layer free-running
    f32 trajectory; the five kernels' flows bit-equal. ``worst`` gets each
    kernel's largest membrane error."""
    import torch

    from evflow_torch.ops.fused_net import firenet_step_plain
    from evflow_torch.ops.lif import LIFState

    B = wins.shape[1]
    # per-layer reference trajectory (f32 state)
    st = perlayer.init_states(B, H_BENCH, W_BENCH)
    ref = []
    with torch.no_grad():
        for x in wins:
            flow, st = perlayer.step(x, st)
            ref.append((flow, [s.mem for s in st], [s.spk for s in st]))

    first_flows = {}
    for kname, *_ in WHOLENET:
        _, cls = wholenet_fns(kname)
        for dt, dtype in dtypes.items():
            runner = cls(perlayer, state_dtype=dtype)
            states = runner.init_states(B, H_BENCH, W_BENCH)
            err, mism, elems, flow_bad, flow_elems = 0.0, 0, 0, 0, 0
            step_frac, step_agree, free_frac, free_agree, flows = [], [], [], [], []
            for t, x in enumerate(wins):
                mems_in, prevs = unit_inputs(runner, states)
                with torch.no_grad():
                    pflow, pmems, pspikes = firenet_step_plain(x, mems_in, prevs, runner.weights)
                    # the per-layer path on the same states (held in f32)
                    lst = [LIFState(m.float(), torch.zeros_like(m, dtype=torch.float32)
                                    if p is None else p.float())
                           for m, p in zip(mems_in, prevs)]
                    sflow, sst = perlayer.step(x, lst)
                flow, states = runner.step(x, states)
                torch.cuda.synchronize()
                kmems, kspikes = runner.unit_states(states)
                for l, (km, pm) in enumerate(zip(kmems, pmems)):
                    dmem = (km.float() - pm.float()).abs()
                    bad = dmem > 1e-4
                    if kspikes[l] is not None:
                        bad |= kspikes[l] != pspikes[l]
                    mism += int(bad.sum())
                    elems += km.numel()
                    if bool((~bad).any()):
                        err = max(err, float(dmem[~bad].max()))
                    if not bool(torch.isfinite(km.float()).all()):
                        mism += km.numel()
                flows.append(flow)
                flow_bad += int(((flow - pflow).abs() > 1e-4).sum())
                flow_elems += flow.numel()
                for (rflow, rspk), fr, ag in (((sflow, [s.spk for s in sst]), step_frac,
                                               step_agree),
                                              ((ref[t][0], ref[t][2]), free_frac, free_agree)):
                    fr.append(float(((flow - rflow).abs() > 0.05).float().mean()))
                    ag.append([None if ks is None else float((ks.float() == rs).float().mean())
                               for ks, rs in zip(kspikes, rspk)])

            def model_bar(frac, agree):
                units = [min(a[l] for a in agree) if agree[0][l] is not None else None
                         for l in range(len(agree[0]))]
                kept = [a for a in units if a is not None]
                ok = max(frac) < 0.02 and min(kept) > 0.95 and (units[0] is None
                                                                 or units[0] > 0.999)
                return ok, {"frac_dflow_gt_0.05": max(frac), "spike_agreement": units}

            ok_plain = (err <= 1e-4 and mism <= 1e-5 * elems and flow_bad <= 1e-5 * flow_elems
                        and bool(torch.isfinite(flow).all()))
            ok_step, step = model_bar(step_frac, step_agree)
            ok_free, free = model_bar(free_frac, free_agree)
            # the five schedules share the mainloop's k order and the epilogue,
            # so their trajectories are bit-equal
            first = first_flows.setdefault(dt, flows)
            equal = all(torch.equal(f, g) for f, g in zip(flows, first))
            # a free-running bf16-state trajectory is another function than the
            # f32 one (a random net this wide is chaotic): reported, not held
            ok = ok_plain and ok_step and equal and (ok_free or dtype == torch.bfloat16)
            emit({"phase": "wholenet", "kernel": kname, "state": dt, "batch": B,
                  "resolution": [H_BENCH, W_BENCH], "windows": len(wins),
                  "flows_equal_to_" + WHOLENET[0][0]: equal,
                  "vs_plain": {"max_abs_err": err, "mismatches": mism, "elements": elems,
                               "flow_mismatches": flow_bad, "flow_elements": flow_elems},
                  "vs_per_layer_same_states": step, "vs_per_layer_f32_trajectory": free,
                  "ok": ok})
            if not ok:
                raise SystemExit(f"{kname} ({dt} state, B={B}) disagrees with its plain "
                                 "version or with the per-layer FusedFireNet")
            worst[kname] = max(worst.get(kname, 0.0), err)


def phase_wholenet(state):
    """K3, K4, K5, K6, K7 at full LIFFireNet width, 256x256, at B=2 over 8
    windows and B=8 over 4: each kernel step against ``firenet_step_plain``
    on the same states (mem' within 1e-4 where spikes agree, at most 1e-5 of
    the elements mismatched, flow within 1e-4 on all but 1e-5 of the
    elements), each runner against the per-layer FusedFireNet (cmajor, f32)
    over the same windows under phase 3's bar; then device times,
    300-window scans with the launch counters (1 per window), the bench
    entry point and the yardsticks."""
    import torch
    import torch.nn.functional as F

    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.ops.fused_net import firenet_step_plain

    name = card()
    model = seeded_firenet()
    perlayer = FusedFireNet.from_firenet(model, layout="cmajor")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = {}
    for batch, n_win in ((B_BENCH, 8), (8, 4)):  # B=8: the bench entry point's batch
        hold_wholenet(perlayer, event_windows(n_win, batch, seed=1), dtypes, worst)
    state.setdefault("max_abs_err", {}).update(worst)

    # device ms per launch, the plain version and the bound, B=2 and B=8
    times = {}
    for batch in (B_BENCH, 8):
        x = event_windows(1, batch, seed=2)[0]
        for kname, *_ in WHOLENET:
            _, cls = wholenet_fns(kname)
            for dt, dtype in dtypes.items():
                runner = cls(perlayer, state_dtype=dtype)
                st0 = runner.init_states(batch, H_BENCH, W_BENCH)
                _, st0 = runner.step(x, st0)  # spiking states, not zeros
                ms = device_ms(lambda: runner.step(x, st0))
                mems_in, prevs = unit_inputs(runner, st0)
                with torch.no_grad():
                    plain_ms = device_ms(lambda: firenet_step_plain(x, mems_in, prevs,
                                                                    runner.weights), iters=10)
                bms, by = wholenet_bound(runner, batch)
                flops = issued_flops(kname, runner, batch)
                emit({"phase": "wholenet", "kernel": kname, "state": dt, "batch": batch,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "issued_gflop": flops / 1e9, "issued_tflop_per_s": flops / ms / 1e9,
                      "card": name})
                if batch == B_BENCH and dtype == torch.bfloat16:  # the runners' default
                    times[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                        library_ms=None)
        # yardsticks: no single PyTorch call computes the whole step
        st = perlayer.init_states(batch, H_BENCH, W_BENCH)
        _, st = perlayer.step(x, st)
        with torch.no_grad():
            step_ms = device_ms(lambda: perlayer.step(x, st))
        convs = []
        h = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for u, s in zip(perlayer.units, st):
            wk = perlayer.params[u.name]["wk"]
            xin = h if not u.recurrent else torch.cat([h, s.spk.to(torch.bfloat16)], 1)
            xin = xin.contiguous(memory_format=torch.channels_last)
            wb = (wk.reshape(wk.shape[0], 3, 3, -1)[..., :xin.shape[1]].permute(0, 3, 1, 2)
                  .contiguous(memory_format=torch.channels_last))
            convs.append((xin, wb))
            h = s.spk.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cudnn_ms = device_ms(lambda: [F.conv2d(a, b, padding=1) for a, b in convs])
        emit({"phase": "wholenet", "yardstick": "FusedFireNet.step (cmajor, f32 state, 7 "
              "launches)", "batch": batch, "ms": step_ms, "card": name})
        emit({"phase": "wholenet", "yardstick": "7 cuDNN bf16 convs (NHWC), the convs alone",
              "batch": batch, "ms": cudnn_ms, "card": name})
    state.setdefault("times", {}).update(times)

    # K7's, K5's, K3's and K6's time against their unit count (the first L
    # units of the seeded net): the slope is what one more unit costs
    from evflow_torch.probes.wholenet_slope import KERNELS as SLOPE_KERNELS
    from evflow_torch.probes.wholenet_slope import unit_times

    for kname in SLOPE_KERNELS:
        for batch in (B_BENCH, 8):
            rows, line = unit_times(kname, batch, "bf16")
            emit({"phase": "wholenet", "slope": kname, "batch": batch, "state": "bf16",
                  "points_ms": {r["L"]: r["ms"] for r in rows}, **line, "card": name})

    # each runner's 300-window scan, launch counters 0 just before and read
    # just after (1 launch per window)
    n_win = 300
    cnt = event_windows(n_win, B_BENCH, seed=0)
    wrappers = {kn: wholenet_fns(kn)[0] for kn, *_ in WHOLENET}
    for kname, *_ in WHOLENET:
        _, cls = wholenet_fns(kname)
        for dt, dtype in dtypes.items():
            runner = cls(perlayer, state_dtype=dtype)
            st = runner.init_states(B_BENCH, H_BENCH, W_BENCH)
            st, _ = runner.scan_windows(cnt[:10], st)
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            (st, flows), dt_s, dev_ms = timed_scan(runner, cnt, st)
            counts = {kn: w.launches for kn, w in wrappers.items()}
            ok = (counts[kname] == n_win and sum(counts.values()) == n_win
                  and bool(torch.isfinite(flows).all()))
            emit({"phase": "wholenet", "scan": kname, "state": dt, "batch": B_BENCH,
                  "windows": n_win, "windows_per_s": n_win * B_BENCH / dt_s,
                  "ms_per_step": 1e3 * dt_s / n_win, "device_ms_per_step": dev_ms / n_win,
                  "launches": counts, "card": name, "ok": ok})
            if not ok:
                raise SystemExit(f"{kname} scan launched {counts} for {n_win} windows")
    # this slice's main path, the bench entry point (the TPU scripts'
    # counterpart), over all five runners at B=8, 32 windows, counters 0
    # just before and read just after: the kernels line's launches
    from evflow_torch import bench_wholenet

    for w in wrappers.values():
        w.launches = 0
    n_bench = 32
    rows = bench_wholenet.main(["--batch", "8", "--windows", str(n_bench)])
    counts = {kn: w.launches for kn, w in wrappers.items()}
    ok = (all(n == (1 + bench_wholenet.REPEATS) * n_bench for n in counts.values())
          and all(r["finite"] for r in rows))
    emit({"phase": "wholenet", "bench_wholenet": rows, "launches": counts, "card": name,
          "ok": ok})
    if not ok:
        raise SystemExit(f"bench_wholenet launched {counts}")
    state.setdefault("launches", {}).update(counts)
    st = perlayer.init_states(B_BENCH, H_BENCH, W_BENCH)
    st, _ = perlayer.scan_windows(cnt[:10], st)
    _, dt_s, dev_ms = timed_scan(perlayer, cnt, st)
    emit({"phase": "wholenet", "scan": "FusedFireNet", "layout": "cmajor", "state": "f32",
          "batch": B_BENCH, "windows": n_win, "windows_per_s": n_win * B_BENCH / dt_s,
          "ms_per_step": 1e3 * dt_s / n_win, "device_ms_per_step": dev_ms / n_win,
          "card": name})


PROBES = {  # probe wrapper: the JAX probe's pallas_call
    "dot_pixel_major": "benchmarks/probe_inkernel_dot.py:68",
    "dot_channel_major": "benchmarks/probe_inkernel_dot.py:103",
    "dot_channel_major_s8": "benchmarks/probe_inkernel_dot.py:138",
    "dot_ksplit": "benchmarks/probe_inkernel_dot.py:177",
    "dot_variant": "benchmarks/probe_inkernel_dot2.py:47",
}
PROBE_SOURCE = "evflow_torch/csrc/probe_inkernel_dot.cu"
STAGING_SOURCE = "evflow_torch/csrc/probe_staging.cu"
UNITLOOP_SOURCE = "evflow_torch/csrc/probe_unit_loop.cu"
LOOPDYN_SOURCE = "evflow_torch/csrc/probe_loop_dyn.cu"
MOSAIC_SOURCE = "evflow_torch/csrc/probe_mosaic_ops.cu"
BISECT_SOURCE = "evflow_torch/csrc/probe_wholenet_bisect.cu"


def probe_row_name(case):
    """The kernels-line name of a probe case: its wrapper, and for dot2 the
    case."""
    fn = case.fn.__name__
    return fn if fn != "dot_variant" else f"{fn}[{case.name[len('dot2 '):]}]"


def library_call(case):
    """The yardstick (never called by the port), as (fn, calls per probe):
    one cuBLAS product of the L weight matrices stacked into one operand
    against X per step (``torch.matmul`` bf16, ``torch._int_mm`` int8), S
    times. It computes the same products and writes the L dots apart, where
    the probe sums them."""
    import torch

    x, w = case.args
    steps = case.kwargs["steps"]
    fn = case.fn.__name__
    if fn == "dot_pixel_major":  # x [Np, K] against w [L, K, C] as [K, L C]
        ws = w.permute(1, 0, 2).reshape(w.shape[1], -1).contiguous()
        return (lambda: torch.matmul(x, ws)), steps
    if fn == "dot_ksplit":  # x [3, 96, Np] as [288, Np], w [L, 3, C, 96] as [L C, 288]
        xs = x.reshape(-1, x.shape[-1])
        ws = w.permute(0, 2, 1, 3).reshape(w.shape[0] * w.shape[2], -1).contiguous()
    else:  # w [L, M, K] as [L M, K]
        xs, ws = x, w.reshape(-1, w.shape[-1])
    if case.int8:
        return (lambda: torch._int_mm(ws, xs)), steps
    return (lambda: torch.matmul(ws, xs)), steps


def factors(ms, bound_ms, library_ms):
    """The kernel's time over its bound and over its yardstick's, measured
    in the same run (None where the yardstick could not run)."""
    return {"x_bound": ms / bound_ms,
            "x_library": None if library_ms is None else ms / library_ms}


def counted_run_all(module, phase, name, repeats=3):
    """``module.run_all`` (a probe module's entry point) with the launch
    counters set to 0 just before and read just after; fails unless every
    case ran and made exactly 1 + ``repeats`` launches. Returns the
    launches per case name."""
    for fn in module.WRAPPERS:
        fn.launches = 0
    rows = module.run_all(repeats=repeats)
    counts = {fn.__name__: fn.launches for fn in module.WRAPPERS}
    per_case = {r["name"]: r["launches"] for r in rows}
    ok = (len(rows) == len(module.probe_cases("meta"))
          and all(n == 1 + repeats for n in per_case.values())
          and all(counts[fn] == sum(r["launches"] for r in rows if r["wrapper"] == fn)
                  for fn in counts))
    emit({"phase": phase, "run_all": rows, "launches": counts, "card": name, "ok": ok})
    if not ok:
        raise SystemExit(f"{module.__name__}.run_all launched {counts}, per case {per_case}")
    return per_case


def phase_probes(state):
    """The in-kernel dot probes at the JAX probes' shapes: the entry point
    ``run_all`` with the launch counters 0 just before and read just after,
    then each kernel against its plain version (within ``inkernel_dot.tolerance``)
    and its times beside the bound and cuBLAS."""
    import torch

    from evflow_torch.device import BF16_FLOP_PER_S, HBM_BYTES_PER_S, INT8_OP_PER_S
    from evflow_torch.probes import inkernel_dot as P
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(P, "probes", name)

    times, errs, launches = {}, {}, {}
    for case in P.probe_cases("cuda", seed=0):
        out = case.fn(*case.args, **case.kwargs)
        ctas, tile = P.last_launch["grid"], P.last_launch["tile_m"]
        ref = case.plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        res = compare(out, ref, P.tolerance(case, ref))
        if case.kwargs.get("acc_dtype") == torch.bfloat16:
            # the check tells the accumulations apart: f32 sums of the same
            # operands must fail it
            control = case.fn(*case.args, **dict(case.kwargs, acc_dtype=torch.float32))
            res["f32_control"] = compare(control, ref, P.tolerance(case, ref))
            res["ok"] = res["ok"] and not res["f32_control"]["ok"]
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        x, w = case.args
        nbytes = x.numel() * x.element_size() + w.numel() * w.element_size() + out.numel() * 4
        t_ops = case.flops / (INT8_OP_PER_S if case.int8 else BF16_FLOP_PER_S)
        t_bytes = nbytes / HBM_BYTES_PER_S
        lib, calls = library_call(case)
        try:
            lib_ms = calls * device_ms(lib, iters=10)
            lib_err = None
        except RuntimeError as e:  # the yardstick only: the port never calls it
            lib_ms, lib_err = None, str(e).splitlines()[0]
        row = probe_row_name(case)
        emit({"phase": "probes", "case": case.name, "kernel": row, **res, "ms": ms,
              "tflops": case.flops / ms / 1e9, "ctas": ctas, "tile_m": tile,
              "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes",
              "library_ms": lib_ms, "library_tflops": None if lib_ms is None
              else case.flops / lib_ms / 1e9, "library_error": lib_err,
              **factors(ms, 1e3 * max(t_ops, t_bytes), lib_ms), "card": name})
        if not res["ok"]:
            raise SystemExit(f"probe {case.name} disagrees with its plain version: {res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes else "bytes",
                          library_ms=lib_ms)
        errs[row] = res["max_abs_err"]
        launches[row] = per_case[case.name]
        state.setdefault("probe_rows", []).append((row, PROBE_SOURCE, PROBES[case.fn.__name__]))
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


def staging_yardstick(case):
    """One PyTorch call for the case's function, never called by the port:
    the row window's interior times 2 into an f32 output (no halo staged);
    the layer grid as one product of the stacked weights ``[C, L 9C]``
    against the stacked patches ``[L 9C, P]``, both built here."""
    import torch

    from evflow_torch.probes import staging as S

    if case.fn is S.row_window_copy:
        (x,), halo = case.args, case.kwargs["halo"]
        h = x.shape[2] - 2 * halo
        out = torch.empty(x.shape[1], h, x.shape[3], device=x.device, dtype=torch.float32)
        inner = x[0, :, halo:halo + h]
        return lambda: torch.mul(inner, 2.0, out=out)
    w_all, m = case.args
    e = case.kwargs["e"]
    layers, c, _ = w_all.shape
    s = m[:, :, :e - 2].reshape(layers, c, -1).clone()
    s[1::2] = 0
    patches = torch.cat([s] * 9, dim=1).reshape(layers * 9 * c, -1).contiguous()
    stacked = w_all.permute(1, 0, 2).reshape(c, -1).contiguous()
    return lambda: torch.matmul(stacked, patches)


def phase_staging(state):
    """The staging probes at the JAX probes' shapes and K8c at H=2048: the
    entry point ``run_all`` with the launch counters 0 just before and read
    just after, then each kernel against its plain version (a row window
    also with the sums of its halo rows as the kernel read them from shared
    memory), and its times beside the bound and the yardstick."""
    import torch

    from evflow_torch.probes import staging as S
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(S, "staging", name)

    times, errs, launches = {}, {}, {}
    for case in S.probe_cases("cuda", seed=0):
        out = case.fn(*case.args, **case.kwargs)
        launch = dict(S.last_launch)
        ref = case.plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        res = compare(out, ref, S.tolerance(case, ref))
        if case.fn is S.row_window_copy:
            # the halo rows as they landed in shared memory, summed by the kernel
            _, sums = case.fn(*case.args, **case.kwargs, halo_sums=True)
            res["halo_rows_staged"] = torch.equal(sums, S.halo_sums_plain(*case.args,
                                                                          **case.kwargs))
            res["ok"] = res["ok"] and res["halo_rows_staged"]
            small, small_kw = S.floor_args(case)  # the launch floor: one CTA
            res["floor_ms"] = device_ms(lambda: case.fn(*small, **small_kw), iters=20)
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        lib_ms = device_ms(staging_yardstick(case), iters=20)
        bms, by = S.bound(case)
        row = f"{case.fn.__name__}[{case.name.split(' [')[0]}]"
        emit({"phase": "staging", "case": case.name, "kernel": row, **res, "ms": ms,
              "gbps": case.nbytes / ms / 1e6, "staged_gbps": case.staged_bytes / ms / 1e6,
              "issued_tflops": case.issued_flops / ms / 1e9,
              "ctas": launch["grid"], "channels_per_cta": launch["cpc"],
              "smem": launch["smem"], "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
              "library_ms": lib_ms, "card": name})
        if not res["ok"]:
            raise SystemExit(f"staging probe {case.name} disagrees with its plain version: {res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        errs[row] = res["max_abs_err"]
        launches[row] = per_case[case.name]
        state.setdefault("probe_rows", []).append((row, STAGING_SOURCE, case.replaces))
    # K8e over L = 1, 3, 5, 7: the slope is what staging one more layer costs
    from evflow_torch.probes.staging_slope import layer_times

    rows, line = layer_times(S.layer_grid)
    emit({"phase": "staging", "layer_slope": rows, **line, "card": name})
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


def unitloop_yardstick(case):
    """L cuDNN bf16 convs, never called by the port: the case's input twice
    (h and aux) ``[1, 2C, E, W]`` by each layer's weights as ``[C, 2C, 3,
    3]``, padding 1; the conv alone, no LIF, no chain."""
    import torch
    import torch.nn.functional as F

    from evflow_torch.probes import unit_loop as U

    x, w = (case.args[0], case.args[1]) if case.fn is U.unit_loop else (case.args[0][0],
                                                                        case.args[3])
    layers, c = w.shape[:2]
    inp = torch.cat([x, x])[None].contiguous()
    wts = [w[l].reshape(c, 2, 3, 3, c).permute(0, 1, 4, 2, 3).reshape(c, 2 * c, 3, 3).contiguous()
           for l in range(layers)]
    return lambda: [F.conv2d(inp, k, padding=1) for k in wts]


def phase_unitloop(state):
    """The unit-loop probes at the JAX probes' shapes: the entry point
    ``run_all`` with the launch counters 0 just before and read just after,
    then each kernel against its plain version (K8j also with the spike
    slots it stored), and its times beside the bound and the yardstick."""
    import torch

    from evflow_torch.probes import unit_loop as U
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(U, "unitloop", name)

    times, errs, launches = {}, {}, {}
    for case in U.probe_cases("cuda", seed=0):
        out = case.fn(*case.args, **case.kwargs)
        launch = dict(U.last_launch)
        ref = case.plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        res = compare(out, ref, U.tolerance(case, ref))
        if case.fn is U.unit_loop_dma:
            # the runtime-index stores to the spike slots, which the output cannot show
            out2, slots = case.fn(*case.args, **case.kwargs, spike_slots=True)
            _, ref_slots = case.plain(*case.args, **case.kwargs, spike_slots=True)
            res["spike_slots_equal"] = torch.equal(slots, ref_slots) and torch.equal(out2, out)
            res["spike_slot_rate"] = float(ref_slots.float().mean())
            res["ok"] = res["ok"] and res["spike_slots_equal"]
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        lib_ms = device_ms(unitloop_yardstick(case), iters=20)
        bms, by = U.bound(case)
        row = f"{case.fn.__name__}[{case.name.split(' [')[0]}]"
        emit({"phase": "unitloop", "case": case.name, "kernel": row, **res, "ms": ms,
              "gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
              "ctas": launch["grid"], "threads": launch["threads"], "smem": launch["smem"],
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
              "card": name})
        if not res["ok"]:
            raise SystemExit(f"unit-loop probe {case.name} disagrees with its plain version: {res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        errs[row] = res["max_abs_err"]
        launches[row] = per_case[case.name]
        state.setdefault("probe_rows", []).append((row, UNITLOOP_SOURCE, case.replaces))
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


def loopdyn_yardstick(case):
    """One PyTorch call for the body's function, never called by the port:
    the layer sum ``x.sum(0)`` in f32 (k1, k10); ``torch.tensordot`` of
    each layer's count among the slots read ([1, 1, 2, 0]) with x (k5);
    ``torch.mul(x[0], 2)`` (k3, k11, in f32: the x2 alone, no bf16 scratch);
    ``torch.mul(x, 3)`` (k4); one product of the stacked weights ``[C, L
    3C]`` against the stacked, thrice repeated layers ``[L 3C, E W]``, both
    built here (k2 in f32 without TF32, k12 in bf16); the narrow column's
    sum broadcast (k6); one f32 conv (TF32 off) of the layers stacked as
    channels by ``conv_weights(w)`` (k7); ``torch.mul`` of the row window
    (k8)."""
    import torch
    import torch.nn.functional as F

    from evflow_torch.probes import loop_dyn as D

    body, x = D.body_of(case), case.args[0]
    layers = x.shape[0]
    if body == "k6":
        _, e, w = case.args
        return lambda: x[:, :, 1].sum(0)[:, None, None].expand(x.shape[1], e, w).contiguous()
    if body == "k7":
        inp = x.reshape(1, -1, *x.shape[2:])
        wc = D.conv_weights(case.args[1]).contiguous()
        return lambda: F.conv2d(inp, wc, padding=1)
    if body == "k8":
        row0, rows, scale = (case.kwargs[k] for k in ("row0", "rows", "scale"))
        return lambda: torch.mul(x[:, :, row0:row0 + rows], scale)
    if body in ("k1", "k10"):
        return lambda: x.sum(0, dtype=torch.float32)
    if body == "k5":
        coef = torch.tensor([sum(D.slot_of(l) == j for l in range(layers)) for j in range(layers)],
                            dtype=x.dtype, device=x.device)
        return lambda: torch.tensordot(coef, x, dims=1)
    if body in ("k3", "k11"):
        return lambda: torch.mul(x[0], 2)
    if body == "k4":
        return lambda: torch.mul(x, 3)
    stacked, layers3 = stacked_operands(case)
    return lambda: torch.matmul(stacked, layers3)


def stacked_operands(case):
    """A dot body's (k2, k12) stacked weights ``[C, L 3C]`` and stacked,
    thrice repeated layers ``[L 3C, E W]``: one product of the two is the
    body's function."""
    x, w = case.args
    layers, c = w.shape[:2]
    stacked = w.permute(1, 0, 2).reshape(c, -1).contiguous()
    layers3 = x.reshape(layers, c, -1).repeat(1, 3, 1).reshape(layers * 3 * c, -1).contiguous()
    return stacked, layers3


def phase_loopdyn(state):
    """The runtime-indexed loop probes at the JAX probes' shapes: the entry
    point ``run_all`` with the launch counters 0 just before and read just
    after, then each body against its plain version (k3 and k11 also with
    their whole scratch, k4 also into a NaN-filled output), and its times
    beside the bound and the yardstick."""
    import numpy as np
    import torch

    from evflow_torch.device import HBM_BYTES_PER_S
    from evflow_torch.probes import loop_dyn as D
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(D, "loopdyn", name)

    times, errs, launches = {}, {}, {}
    for case in D.probe_cases("cuda", seed=0):
        body = D.body_of(case)
        out = case.fn(*case.args, **case.kwargs)
        launch = dict(D.last_launch)
        ref = case.plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        res = compare(out, ref, D.tolerance(case, ref))
        if body in ("k3", "k11"):
            # the runtime-index stores to every layer, which the output cannot show
            out2, scr = case.fn(*case.args, **case.kwargs, scratch=True)
            _, ref_scr = case.plain(*case.args, **case.kwargs, scratch=True)
            res["scratch_equal"] = torch.equal(scr, ref_scr) and torch.equal(out2, out)
            res["ok"] = res["ok"] and res["scratch_equal"]
        if body == "k4":
            filled = torch.full_like(ref, float("nan"))
            case.fn(*case.args, out=filled)
            res["nan_out_written"] = torch.equal(filled, ref)
            res["ok"] = res["ok"] and res["nan_out_written"]
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        lib_ms = device_ms(loopdyn_yardstick(case), iters=20)
        bms, by = D.bound(case)
        row = f"{case.fn.__name__}[{body}]"
        if body in ("k3", "k4", "k7", "k8", "k11", "k12"):
            # the bound of what the kernel moves through device memory beside
            # the function's (k3 and k11: every layer of x and the output, the
            # function x[0]; the others each input once, the function's bytes)
            moved = D.store_kernel_bytes(*case.args[0].shape) if body in ("k3", "k11") else (
                case.nbytes)
            res["kernel_bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
        # the launch floor: the same kernel at one CTA
        small, small_kw = D.floor_args(case)
        res["floor_ms"] = device_ms(lambda: case.fn(*small, **small_kw), iters=20)
        if body == "k12":  # the one call with the kernel's f32 output
            stacked, layers3 = stacked_operands(case)
            res["library_f32_ms"] = device_ms(
                lambda: torch.mm(stacked, layers3, out_dtype=torch.float32), iters=20)
        emit({"phase": "loopdyn", "case": case.name, "kernel": row, **res, "ms": ms,
              "gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
              "ctas": launch["grid"], "threads": launch["threads"], "smem": launch["smem"],
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
              **factors(ms, bms, lib_ms), "card": name})
        if not res["ok"]:
            raise SystemExit(f"loop probe {case.name} disagrees with its plain version: {res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        errs[row] = res["max_abs_err"]
        launches[row] = per_case[case.name]
        state.setdefault("probe_rows", []).append((row, LOOPDYN_SOURCE, case.replaces))
        if body in D.DOTS:
            # the integer draw cannot show operands rounded to TF32 or bf16, or
            # sums kept in bf16: normals can
            args = D.draw_operands(np.random.default_rng(1), body, *case.args[0].shape,
                                   device="cuda", normals=True)
            out = case.fn(*args)
            ref = case.plain(*args)
            torch.cuda.synchronize()
            tol = D.f32_tolerance(*args, ref)
            res = compare(out, ref, tol)
            if body == "k12":  # the check tells the sums apart: bf16 sums must fail it
                res["bf16_sums_fail"] = not compare(D.bf16_sums(*args), ref, tol)["ok"]
                res["ok"] = res["ok"] and res["bf16_sums_fail"]
            kind = "bf16" if body == "k12" else "f32"
            emit({"phase": "loopdyn", "case": f"{case.name} {kind} normals", "kernel": row,
                  **res, "card": name})
            if not res["ok"]:
                raise SystemExit(f"loop probe {case.name} on {kind} normals is off its plain "
                                 f"version by more than f32 rounding: {res}")
            errs[row] = max(errs[row], res["max_abs_err"])
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


def mosaicops_yardstick(case):
    """One PyTorch call for the body's function, never called by the port:
    the two ``torch.roll`` added in bf16 and widened (k_roll); v plus its
    ``torch.where``-masked self in bf16, widened (k_misc); ``torch.mm`` of
    the bf16 operands with an f32 output, as the kernel writes (k_dot3)."""
    import torch

    from evflow_torch.probes import mosaic_ops as M

    body = M.body_of(case)
    if body == "k_dot3":
        w, x3 = case.args
        x2 = x3.reshape(x3.shape[0], -1)
        return lambda: torch.mm(w, x2, out_dtype=torch.float32)
    (v,) = case.args
    if body == "k_roll":
        return lambda: (torch.roll(v, 1, 2) + torch.roll(v, 1, 1)).float()
    lane = torch.arange(v.shape[2], device=v.device)
    return lambda: (v + torch.where(lane > 0, v, 0)).float()


def phase_mosaicops(state):
    """The Mosaic-ops probes at the JAX probe's shapes: the entry point
    ``run_all`` with the launch counters 0 just before and read just after,
    then each body against its plain version, and its times beside the
    bound and the yardstick."""
    import torch

    from evflow_torch.probes import mosaic_ops as M
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(M, "mosaicops", name)

    times, errs, launches = {}, {}, {}
    for case in M.probe_cases("cuda", seed=0):
        body = M.body_of(case)
        out = case.fn(*case.args, **case.kwargs)
        launch = dict(M.last_launch)
        ref = case.plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        res = compare(out, ref, M.tolerance(case, ref))
        if body != "k_dot3":  # the launch floor: the same kernel at one CTA
            small, small_kw = M.floor_args(case)
            res["floor_ms"] = device_ms(lambda: case.fn(*small, **small_kw), iters=20)
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        lib_ms = device_ms(mosaicops_yardstick(case), iters=20)
        bms, by = M.bound(case)
        row = f"{case.fn.__name__}[{body}]"
        emit({"phase": "mosaicops", "case": case.name, "kernel": row, **res, "ms": ms,
              "gbps": case.nbytes / ms / 1e6, "tflops": case.flops / ms / 1e9,
              "ctas": launch["grid"], "smem": launch["smem"], "plain_ms": plain_ms,
              "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
              **factors(ms, bms, lib_ms), "card": name})
        if not res["ok"]:
            raise SystemExit(f"Mosaic-ops probe {case.name} disagrees with its plain version: "
                             f"{res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        errs[row] = res["max_abs_err"]
        launches[row] = per_case[case.name]
        source = PROBE_SOURCE if body == "k_dot3" else MOSAIC_SOURCE
        state.setdefault("probe_rows", []).append((row, source, case.replaces))
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


def bisect_yardstick(case):
    """cuDNN bf16 convs of the body's shapes, never called by the port,
    padding (0, 1) as the probes pad: kA one conv of the H + 2 rows it
    reads; kB seven chained over the ``[B n, C, E, W]`` blocks; the chain
    two chained over ``[B, 32, Hp, W]``. The convs alone: no epilogue."""
    import torch.nn.functional as F

    from evflow_torch.probes import wholenet_bisect as M

    def kernel(w):  # [C, 9 Cin] -> [C, Cin, 3, 3]
        return w.reshape(w.shape[0], 3, 3, -1).permute(0, 3, 1, 2).contiguous()

    body = M.body_of(case)
    if body == "kA":
        x, w, _ = case.args
        xs, wt = x[:, :, M.TH - 1:x.shape[2] - M.TH + 1].contiguous(), kernel(w)
        return lambda: F.conv2d(xs, wt, padding=(0, 1))
    if body == "kB":
        xb, w = case.args
        b, c, rows, wd = xb.shape
        xs = xb.reshape(b, c, rows // M.E, M.E, wd).transpose(1, 2).reshape(-1, c, M.E, wd)
        xs, wt = xs.contiguous(), kernel(w)

        def seven():
            v = xs
            for _ in range(M.KB_LAYERS):
                v = F.conv2d(v, wt, padding=(0, 1))
            return v
        return seven
    x, w0, w1 = case.args[0], kernel(case.args[3]), kernel(case.args[4])
    return lambda: F.conv2d(F.conv2d(x, w0, padding=(0, 1)), w1, padding=(0, 1))


def phase_bisect(state):
    """The whole-net bisection probes at the JAX files' shapes: the entry
    point ``run_all`` with the launch counters 0 just before and read just
    after, then every output of each case against its plain version, and
    its times beside the bound and the yardstick."""
    import torch

    from evflow_torch.probes import wholenet_bisect as M
    from evflow_torch.probes._harness import compare

    name = card()
    per_case = counted_run_all(M, "bisect", name)

    times, errs, launches = {}, {}, {}
    for case in M.probe_cases("cuda", seed=0):
        body = M.body_of(case)
        outs = M.outputs(case, case.fn(*case.args, **case.kwargs))
        launch = dict(M.last_launch)
        refs = M.outputs(case, case.plain(*case.args, **case.kwargs))
        torch.cuda.synchronize()
        res = {k: compare(outs[k], refs[k], M.tolerance(case, refs[k], k)) for k in outs}
        nonzero = {k: float((refs[k] != 0).float().mean()) for k in refs}
        ms = device_ms(lambda: case.fn(*case.args, **case.kwargs), iters=20)
        plain_ms = device_ms(lambda: case.plain(*case.args, **case.kwargs), iters=3)
        lib_ms = device_ms(bisect_yardstick(case), iters=20)
        bms, by = M.bound(case)
        row = f"{case.fn.__name__}[{body}]"
        ok = all(r["ok"] for r in res.values())
        emit({"phase": "bisect", "case": case.name, "kernel": row, "ok": ok, "outputs": res,
              "nonzero_share": nonzero, "ms": ms, "gbps": case.nbytes / ms / 1e6,
              "tflops": case.flops / ms / 1e9, "ctas": launch["grid"],
              "threads": launch["threads"], "smem": launch["smem"], "plain_ms": plain_ms,
              "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, "card": name})
        if not ok:
            raise SystemExit(f"bisection probe {case.name} disagrees with its plain version: "
                             f"{res}")
        times[row] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
        errs[row] = max(r["max_abs_err"] for r in res.values())
        launches[row] = per_case[case.name]
        state.setdefault("probe_rows", []).append((row, BISECT_SOURCE, case.replaces))
    state.setdefault("times", {}).update(times)
    state.setdefault("max_abs_err", {}).update(errs)
    state.setdefault("launches", {}).update(launches)


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
             "protocol": phase_protocol, "times": phase_times, "wholenet": phase_wholenet,
             "probes": phase_probes, "staging": phase_staging, "unitloop": phase_unitloop,
             "loopdyn": phase_loopdyn, "mosaicops": phase_mosaicops, "bisect": phase_bisect}
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
    for kname, *_, source, replaces in KERNELS + WHOLENET + tuple(state.get("probe_rows", [])):
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
