"""K3's and K6's unit time split by part, for a checkout whose K3 and K6
still run their own pieces (``stage_x``, ``stage_spikes``,
``stage_unit_weights``, ``conv_region``, ``UnitEpilogue``, ``pred_tile`` in
``csrc/fused_net_common.cuh``), which have no ``ITEM_CUT`` hooks.

    python3 evflow_torch/probes/wholenet_split_old.py --tree DIR

It copies ``DIR/evflow_torch/csrc`` to ``DIR/evflow_torch/_build/split_old/src``
and patches the copy's text (``PATCHES``): each part becomes a test of the
macro ``PCUT`` (a number from ``PARTS``), which a build with ``-DPCUT=n``
takes out and the default build (``PCUT`` 0) keeps, so that the full build
is the checkout's own code. A patch whose text is not found exactly once
refuses the tree. Each kernel (``fused_net.cu``, ``fused_net_lgrid.cu``) is
built in every variant it has (``nvcc`` with ``cuda_build.NVCC_FLAGS``, all
started together), each library loaded in place of the kernel's entry
point, and the runner timed at B=2, 256x256, bf16 state, on LIFFireNet's
seven units (``bench_wholenet.MODEL``, weights from seed 0; one
Poisson(0.05) window from numpy seed 0), by CUDA events
(``wholenet_slope.device_ms`` of the tree), the full build first and last.
A variant computes wrong results: it times, nothing more. What a part
costs is the full time less the variant's; the parts overlap.

Prints a JSON line a variant, with the card's name and power limit; needs a
CUDA card. The variant builds' ptxas reports go beside their libraries.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PARTS = {  # PCUT value: the part taken out
    1: "state_loads",      # the epilogue's membrane loads read as zeros
    2: "state_stores",     # no membrane or kept-spike store
    3: "epilogue",         # no LIF update, state load or store (spikes 0)
    4: "event_stage",      # the event input is not staged
    5: "weight_stage",     # no weight copy: the buffer is read as it lies
    6: "mma",              # no fragment load and no mma
    7: "spike_stage",      # the recurrent units' previous spikes are not staged
    8: "input_stage",      # K6: unit l's input (unit l-1's spikes) is not staged
    9: "grid_barrier",     # K6: no grid barrier between units
    10: "flow",            # the pred head is not run
}
KERNELS = {  # name: (source module, runner module, runner class, its parts)
    "K3": ("fused_net", "fused_net", "WholeNetFireNet", (1, 2, 3, 4, 5, 6, 7, 10)),
    "K6": ("fused_net_lgrid", "fused_net_lgrid", "LayerGridFireNet", tuple(PARTS)),
}
# (file, text, text with the part behind PCUT)
PATCHES = (
    ("fused_net_common.cuh", '#include "conv_lif_common.cuh"\n',
     '#include "conv_lif_common.cuh"\n#ifndef PCUT\n#define PCUT 0\n#endif\n'),
    ("fused_net_common.cuh", "lif_update(acc + prm[c], ld_state<S>(mem_in, i),",
     "lif_update(acc + prm[c], PCUT == 1 ? 0.f : ld_state<S>(mem_in, i),"),
    ("fused_net_common.cuh", "if (h >= th0 && h < th1 && w >= tw0 && w < tw1) {",
     "if (PCUT != 2 && h >= th0 && h < th1 && w >= tw0 && w < tw1) {"),
    ("fused_net_common.cuh", "if (h >= 0 && h < H && w >= 0 && w < W) {\n      const size_t i",
     "if (PCUT != 3 && h >= 0 && h < H && w >= 0 && w < W) {\n      const size_t i"),
    ("fused_net_common.cuh", "        mma_k16(hbuf, hpitch,",
     "        if (PCUT != 6) mma_k16(hbuf, hpitch,"),
    ("fused_net_common.cuh", "          mma_k16(pbuf, SPITCH,",
     "          if (PCUT != 6) mma_k16(pbuf, SPITCH,"),
    ("fused_net.cu", "  stage_x(a, b,", "  if (PCUT != 4) stage_x(a, b,"),
    ("fused_net.cu", "    stage_unit_weights(a.wk[l], ck, wsm);",
     "    if (PCUT != 5) stage_unit_weights(a.wk[l], ck, wsm);"),
    ("fused_net.cu", "    if (rec) stage_spikes<S>(", "    if (PCUT != 7 && rec) stage_spikes<S>("),
    ("fused_net.cu", "  pred_tile(a,", "  if (PCUT != 10) pred_tile(a,"),
    ("fused_net_lgrid.cu", "        stage_x(a, b,",
     "        if (PCUT != 4) stage_x(a, b,"),
    ("fused_net_lgrid.cu", "        stage_spikes<S>(a, a.spk_out[l - 1],",
     "        if (PCUT != 8) stage_spikes<S>(a, a.spk_out[l - 1],"),
    ("fused_net_lgrid.cu", "    stage_unit_weights(a.wk[l], ck, wsm);",
     "    if (PCUT != 5) stage_unit_weights(a.wk[l], ck, wsm);"),
    ("fused_net_lgrid.cu", "      if (rec) stage_spikes<S>(",
     "      if (PCUT != 7 && rec) stage_spikes<S>("),
    ("fused_net_lgrid.cu", "    if (!last) grid.sync();",
     "    if (PCUT != 9 && !last) grid.sync();"),
    ("fused_net_lgrid.cu", "        pred_tile(a, obuf,",
     "        if (PCUT != 10) pred_tile(a, obuf,"),
)


def patched_sources(root: Path) -> Path:
    """The tree's ``csrc`` copied and patched (``PATCHES``); raises where a
    patch's text is not found exactly once."""
    src = root / "evflow_torch" / "csrc"
    dst = root / "evflow_torch" / "_build" / "split_old" / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, old, new in PATCHES:
        text = (dst / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times, not once: "
                               "the tree's K3 and K6 are not the ones this script patches")
        (dst / name).write_text(text.replace(old, new))
    return dst


def build(root: Path, src: Path):
    """Every kernel in every variant, one ``nvcc`` each, all started
    together: {(kernel, pcut): library}."""
    from evflow_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    procs, libs = {}, {}
    for kernel, (module, _, _, parts) in KERNELS.items():
        for pcut in (0,) + parts:
            d = src.parent / kernel / str(pcut)
            d.mkdir(parents=True, exist_ok=True)
            libs[kernel, pcut] = d / f"lib{module}.so"
            procs[kernel, pcut] = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, f"-DPCUT={pcut}", "-o", str(libs[kernel, pcut]),
                 str(src / f"{module}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    failed = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        (libs[key].parent / "ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed[f"{key[0]}/{key[1]}"] = log[-2000:]
    if failed:
        raise RuntimeError(f"variant builds failed: {failed}")
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the checkout whose K3 and K6 to split")
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wholenet_split_old: CUDA is not available", file=sys.stderr)
        return 1
    import importlib

    import evflow_torch
    from evflow_torch.bench_wholenet import MODEL
    from evflow_torch.device import describe_card
    from evflow_torch.models.fused import FusedFireNet
    from evflow_torch.ops import cuda_build
    from evflow_torch.probes.wholenet_slope import device_ms
    from evflow_torch.registry import build_model
    from evflow_torch.weights import seeded_state_dict

    if not Path(evflow_torch.__file__).resolve().is_relative_to(root):
        print(f"wholenet_split_old: evflow_torch came from {evflow_torch.__file__}",
              file=sys.stderr)
        return 1
    card = describe_card()
    libs = build(root, patched_sources(root))
    model = build_model(dict(MODEL), device="cuda")
    model.load_state_dict(seeded_state_dict(model, seed=0))
    fused = FusedFireNet.from_firenet(model, layout="cmajor")
    x = torch.tensor(np.random.default_rng(0).poisson(0.05, (2, 256, 256, 2)).astype(np.float32),
                     device="cuda")
    for kernel, (module, rmod, rcls, parts) in KERNELS.items():
        cls = getattr(importlib.import_module(f"evflow_torch.ops.{rmod}"), rcls)
        full = []
        for pcut in (0,) + parts + (0,):
            fn = getattr(ctypes.CDLL(str(libs[kernel, pcut])), module)
            fn.argtypes = cuda_build.SIGNATURES[module]
            fn.restype = ctypes.c_int
            cuda_build._ENTRIES[module] = fn
            runner = cls(fused, state_dtype=torch.bfloat16)
            states = runner.init_states(2, 256, 256)
            _, states = runner.step(x, states)  # spiking states, not zeros
            ms = device_ms(lambda: runner.step(x, states))
            if pcut == 0:
                full.append(ms)
            print(json.dumps({"tree": str(root), "kernel": kernel, "pcut": pcut,
                              "cut": PARTS.get(pcut, "none"), "ms": ms,
                              "part_ms": None if pcut == 0 else full[0] - ms,
                              "batch": 2, "state": "bf16", "L": 7, "card": card}), flush=True)
        cuda_build._ENTRIES.pop(module, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
