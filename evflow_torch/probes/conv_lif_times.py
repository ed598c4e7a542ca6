"""K1's and K2's cases, their bound, and their time split by part.

K1 (``fused_conv_lif``, ``csrc/conv_lif.cu``) and K2
(``fused_conv_lif_cmajor``, ``csrc/conv_lif_cmajor.cu``) run one FireNet
unit a launch. ``CASES`` are LIFFireNet's four kinds of unit (the head of
2 input channels, a feedforward unit, a recurrent unit, a feedforward unit
with subtract reset) at 32 channels; ``SHAPES`` the bench shape (B=2,
256x256) and the shape ``evaluate`` runs (B=1, 128x128). ``make_case``
draws a case's operands with numpy, ``bound`` gives its least time on the
card; ``chip_smoke.py`` times every case with them.

The split times each case in variant builds of the two sources, each with
one part taken out, the full build first and last (what a part costs is the
full time less the variant's; the parts overlap):

    python3 evflow_torch/probes/conv_lif_times.py              # this checkout
    python3 evflow_torch/probes/conv_lif_times.py --tree DIR   # another one

A part is an ``item_keeps(ITEM_CUT_<part>)`` test in
``csrc/conv_lif_layer.cuh`` (``VARIANTS``; the parts are those of the item
body's ``enum ItemCut``), taken out by a build with
``-DITEM_CUT=ITEM_CUT_<part>``; a tree without those tests is refused. Every
variant's ``nvcc``
(``cuda_build.NVCC_FLAGS``) starts at once; each library is loaded in place
of the kernel's entry point and the tree's wrapper timed by CUDA events
(``wholenet_slope.device_ms`` of the tree). A variant computes wrong
results: it times, nothing more. Prints a JSON line a (variant, shape,
case), with the card's name and power limit; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

C = 32  # LIFFireNet's channels
# (case, Cin, recurrent, hard reset)
CASES = (("head", 2, False, True), ("ff", 32, False, True),
         ("rec", 32, True, True), ("soft", 32, False, False))
PER_WINDOW = {"head": 1, "ff": 4, "rec": 2}  # LIFFireNet launches per window
SHAPES = ((2, 256, 256), (1, 128, 128))  # (B, H, W): the bench's, evaluate's
KERNELS = {"K1": ("conv_lif", "fused_conv_lif", "nhwc"),
           "K2": ("conv_lif_cmajor", "fused_conv_lif_cmajor", "cmajor")}
# this checkout's variants: name -> the part taken out (csrc/fused_net_item.cuh,
# enum ItemCut), None for the full kernel
VARIANTS = {
    "full": None,
    "no_x_stage": "ITEM_CUT_EVENT_STAGE",      # x's channels of the input tile
    "no_spike_stage": "ITEM_CUT_SPIKE_STAGE",  # prev_spk's channels of the input tile
    "no_weight_stage": "ITEM_CUT_WEIGHT_STAGE",
    "no_mma": "ITEM_CUT_MMA",
    "no_state_loads": "ITEM_CUT_STATE_LOADS",
    "no_state_stores": "ITEM_CUT_STATE_STORES",
}
LAYER_HEADER = "conv_lif_layer.cuh"


def make_case(cin, recurrent, layout, seed, B=2, H=256, W=256, c=C, device="cuda"):
    """Operands of one unit, drawn with numpy from ``seed``: counts for a
    2-channel head, binary spikes for the other units' input, kernels in
    the flax init range scaled by a BN gain, per-channel bias, beta and
    theta, mem normal; x, mem and prev_spk in ``layout`` (NHWC or NCHW)."""
    import numpy as np
    import torch

    from evflow_torch.ops.conv_lif import pack_weights

    rng = np.random.default_rng(seed)
    x = rng.poisson(0.3, (B, H, W, cin)) if cin == 2 else rng.random((B, H, W, cin)) < 0.2
    g = rng.uniform(0.5, 2.0, c)
    w = rng.uniform(-1, 1, (3, 3, cin, c)) * math.sqrt(1.0 / cin) * g
    w_rec = rng.uniform(-1, 1, (3, 3, c, c)) * math.sqrt(1.0 / c) * g if recurrent else None
    arrays = dict(x=x, mem=rng.normal(0, 0.5, (B, H, W, c)), bias=rng.normal(0, 0.3, c),
                  beta=rng.uniform(0, 1, c), theta=rng.uniform(0.01, 0.8, c),
                  prev_spk=(rng.random((B, H, W, c)) < 0.2) if recurrent else None)
    t = {k: None if v is None else torch.tensor(np.asarray(v, np.float32), device=device)
         for k, v in arrays.items()}
    if layout == "cmajor":
        for k in ("x", "mem", "prev_spk"):
            if t[k] is not None:
                t[k] = t[k].permute(0, 3, 1, 2).contiguous()
    t["wk"] = pack_weights(*(None if a is None else torch.tensor(a.astype(np.float32),
                                                               device=device)
                             for a in (w, w_rec)))
    return t


def bound(cin, recurrent, B, H, W, c=C):
    """Least time of one unit: x, mem (and prev_spk) read once and spk and
    mem' written once in f32, the packed weights and the [3, C] parameters
    read once, at the HBM rate, against its bf16 conv and f32 LIF
    operations at the peak rates. Returns (ms, "bytes"|"operations")."""
    from evflow_torch.device import BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S

    px = B * H * W
    k_in = cin + (c if recurrent else 0)
    nbytes = 4 * px * (k_in + 3 * c) + 2 * c * 9 * k_in + 4 * 3 * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * px * c * 9 * k_in / BF16_FLOP_PER_S + 10 * px * c / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def call(fn, t, hard):
    return fn(t["x"], t["mem"], t["wk"], t["bias"], t["beta"], t["theta"],
              prev_spk=t["prev_spk"], hard_reset=hard)


def missing_hooks(root: Path):
    """The variants whose part the tree's ``conv_lif_layer.cuh`` has no
    ``item_keeps(ITEM_CUT_<part>)`` test for, and the kernels whose source
    does not include that header (a build with a part taken out would time
    the full kernel)."""
    csrc = root / "evflow_torch" / "csrc"
    header = csrc / LAYER_HEADER
    text = header.read_text() if header.exists() else ""
    missing = [name for name, cut in VARIANTS.items()
               if cut is not None and f"item_keeps({cut})" not in text]
    return missing + [k for k, (src, _, _) in KERNELS.items()
                      if f'#include "{LAYER_HEADER}"' not in (csrc / f"{src}.cu").read_text()]


def compile_variants(root: Path, subdir: str, modules, flags):
    """Each kernel's source (``modules``: kernel -> ``csrc`` module) in each
    variant (``flags``: variant -> extra ``nvcc`` flags), one ``nvcc``
    (``cuda_build.NVCC_FLAGS``) each, all started together, into
    ``evflow_torch/_build/<subdir>/<kernel>/<variant>/lib<module>.so`` with
    its ptxas report beside it as ``ptxas.txt``: {(kernel, variant):
    library}. Raises on a failed build."""
    from evflow_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    src = root / "evflow_torch" / "csrc"
    out = root / "evflow_torch" / "_build" / subdir
    libs, procs = {}, {}
    for kernel, module in modules.items():
        for name, f in flags.items():
            d = out / kernel / name
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            libs[kernel, name] = d / f"lib{module}.so"
            procs[kernel, name] = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, *f, "-o", str(libs[kernel, name]),
                 str(src / f"{module}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        (libs[key].parent / "ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed["/".join(key)] = log[-2000:]
    if failed:
        raise RuntimeError(f"variant builds failed: {failed}")
    return libs


def load_entry(lib: Path, module: str):
    """``lib``'s entry point in place of ``module``'s for the wrappers that
    launch it (``cuda_build.entry_point``)."""
    from evflow_torch.ops import cuda_build

    fn = getattr(ctypes.CDLL(str(lib)), module)
    fn.argtypes = cuda_build.SIGNATURES[module]
    fn.restype = ctypes.c_int
    cuda_build._ENTRIES[module] = fn


def build_variants(root: Path):
    """Each kernel's library in each variant (``compile_variants``):
    {(kernel, variant): library}."""
    missing = missing_hooks(root)
    if missing:
        raise RuntimeError(f"K1 and K2 cannot be split for {missing}: no item_keeps "
                           f"test, or the source does not include {LAYER_HEADER}")
    flags = {name: [] if cut is None else [f"-DITEM_CUT={cut}"] for name, cut in VARIANTS.items()}
    return compile_variants(root, "split_k12", {k: m for k, (m, _, _) in KERNELS.items()}, flags)


def split(root: Path):
    """Every case at every shape in every variant build of K1 and K2, the
    full build first and last: a JSON-ready row each."""
    import importlib

    from evflow_torch.ops import cuda_build
    from evflow_torch.probes.wholenet_slope import device_ms

    libs = build_variants(root)
    names = list(VARIANTS) + ["full"]
    rows = []
    for kernel, (module, wrapper, layout) in KERNELS.items():
        fn_mod = importlib.import_module(f"evflow_torch.ops.{module}")
        fused = getattr(fn_mod, wrapper)
        cases = {(shape, case): make_case(cin, rec, layout, seed=7, B=shape[0], H=shape[1],
                                          W=shape[2])
                 for shape in SHAPES for case, cin, rec, _ in CASES}
        full = {}
        for name in names:
            load_entry(libs[kernel, name], module)
            for shape in SHAPES:
                for case, _, _, hard in CASES:
                    t = cases[shape, case]
                    ms = device_ms(lambda: call(fused, t, hard))
                    full.setdefault((shape, case), ms if name == "full" else None)
                    base = full[shape, case]
                    rows.append({"kernel": kernel, "variant": name,
                                 "B": shape[0], "H": shape[1], "W": shape[2], "case": case,
                                 "ms": ms, "part_ms": None if name == "full" else base - ms})
        cuda_build._ENTRIES.pop(module, None)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="the checkout whose K1 and K2 to split (default: this one)")
    args = ap.parse_args(argv)
    root = Path(args.tree).resolve() if args.tree else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("conv_lif_times: CUDA is not available", file=sys.stderr)
        return 1
    import evflow_torch
    from evflow_torch.device import describe_card

    if not Path(evflow_torch.__file__).resolve().is_relative_to(root):
        print(f"conv_lif_times: evflow_torch came from {evflow_torch.__file__}, not {root}",
              file=sys.stderr)
        return 1
    card = describe_card()
    for r in split(root):
        print(json.dumps({"tree": str(root), **r, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
