"""The protocol's host work a window, each part alone, on this machine's CPU.

    python -m evflow_torch.probes.protocol_host [--windows 40] [--threads 8,4,2,1]

With the settings of ``configs/eval_MVSEC.yml`` (256x256 pooled to 128x128,
hot filter, ``keep_gt_full_res``, AEE / AAE / AE_ofMeans) on a synthetic
sequence of 50 k events/s:

* the ms a window of ``H5EventStream.next_batch`` (what the ``Prefetcher``
  thread does) by each encoder (``native_fused``, ``native``, ``numpy``),
  and its split: ``read`` (the window's events, its GT map), ``assemble``
  (formatting, augmentation, encodings and event list), ``hot_filter``,
  ``pool`` (the downsampling, the event list's rescale included),
  ``stack`` (the batch, its padded event lists) and ``other`` (the rest),
  the parts timed inside one pass. A first pass warms the process (the
  first streams of a process run their reads and stacks up to 4x slower),
  then the encoders run in turns, each twice (ABC CBA); both passes are
  printed;
* the ms a window of the host metric protocol of ``evaluate``'s host path
  (upsampling a 128x128 flow to the GT's 256x256, association and the
  three criteria on CPU tensors) at each count of torch's intra-op
  threads, three passes over the windows after one that warms the thread
  pool;
* the ms a window of the visual protocol's IWE on the CPU
  (``compute_pol_iwe`` of a 128x128 flow over the window's event list, as
  ``evaluate`` runs it in a chunk) at each thread count.

Nothing runs on a card; no other thread runs beside the timed part. Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from evflow_torch import registry
from evflow_torch.config import load_config
from evflow_torch.data.h5_stream import ENCODERS, H5EventStream
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.ops.iwe import compute_pol_iwe, upsample_flow

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "eval_MVSEC.yml"
PARTS = ("read", "assemble", "hot_filter", "pool", "stack")


class TimedStream(H5EventStream):
    """The stream with the wall time of each part of ``next_batch`` summed
    into ``ms``."""

    def __init__(self, *args, **kwargs):
        self.ms = dict.fromkeys(PARTS, 0.0)
        super().__init__(*args, **kwargs)

    def _timed(self, part, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.ms[part] += 1e3 * (time.perf_counter() - t0)
        return out

    def _read_window(self, b):
        return self._timed("read", super()._read_window, b)

    def _targets(self, b):
        return self._timed("read", super()._targets, b)

    def _assemble(self, b, *events):
        return self._timed("assemble", super()._assemble, b, *events)

    def _hot_filter(self, b, *encodings):
        return self._timed("hot_filter", super()._hot_filter, b, *encodings)

    def _downsample(self, out, pooled_voxel):
        return self._timed("pool", super()._downsample, out, pooled_voxel)

    def _stack(self, items, flags):
        return self._timed("stack", super()._stack, items, flags)


def stream_split(cfg, encoder: str, windows: int):
    """(batches, {"next_batch": ms a window, part: ms a window}) of one pass
    over ``windows`` windows after the file is opened."""
    cfg["loader"].update(native_encoder=encoder != "numpy",
                         fused_assembly=encoder == "native_fused")
    stream = TimedStream(cfg, cfg["model"]["num_bins"])
    stream.next_batch()  # opens the file, builds the library
    stream.ms = dict.fromkeys(PARTS, 0.0)
    t0 = time.perf_counter()
    batches = [stream.next_batch() for _ in range(windows)]
    total = 1e3 * (time.perf_counter() - t0) / windows
    stream.close()
    split = {p: v / windows for p, v in stream.ms.items()}
    split["other"] = total - sum(split.values())
    return batches, {"next_batch": total, **split}


def by_threads(threads, fn, windows):
    """ms a window of ``fn()`` (one pass over the windows) at each torch
    thread count: passes 2-4, the first warms the pool."""
    before = torch.get_num_threads()
    out = {}
    for n in threads:
        torch.set_num_threads(n)
        runs = []
        for _ in range(4):
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0) / windows)
        out[n] = runs[1:]
    torch.set_num_threads(before)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--threads", default="8,4,2,1")
    args = ap.parse_args(argv)
    threads = [int(t) for t in args.threads.split(",")]
    cfg = load_config(str(CONFIG))
    per_encoder = {}
    with tempfile.TemporaryDirectory(prefix="evflow_host_") as root:
        make_dataset(root, num_sequences=1, seed=0, duration=args.windows / 10 + 0.2,
                     resolution=tuple(cfg["loader"]["std_resolution"]),
                     events_per_sec=50_000, fmt="npz")
        cfg["data"]["path"] = root
        stream_split(cfg, ENCODERS[0], args.windows)  # warms the process: not kept
        for encoder in ENCODERS + ENCODERS[::-1]:
            batches, split = stream_split(cfg, encoder, args.windows)
            per_encoder.setdefault(encoder, []).append(split)
    H, W = cfg["loader"]["resolution"]
    gh, gw = batches[0]["gtflow"].shape[1:3]
    scaling = cfg["metrics"]["flow_scaling"] * (H / 128) / 2
    criteria = registry.build_metrics(cfg, scaling)
    flow = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (1, H, W, 2))
                            .astype(np.float32))
    scale = torch.tensor([gw / W, gh / H])

    def metrics_pass():
        for b in batches:
            f = upsample_flow(flow, gh, gw) * scale
            inputs = {k: torch.from_numpy(np.ascontiguousarray(b[k]))
                      for k in ("gtflow", "event_mask", "dt_gt", "dt_input")}
            for c in criteria:
                c.event_flow_association([f], inputs)
                c()
                c.reset()

    lists = [{k: torch.from_numpy(b[k]) for k in ("event_list", "event_list_pol_mask",
                                                   "event_valid")} for b in batches]

    def iwe_pass():
        for t in lists:
            pm = t["event_list_pol_mask"]
            compute_pol_iwe(flow, t["event_list"], (H, W), pm[..., 0], pm[..., 1],
                            flow_scaling=cfg["metrics"]["flow_scaling"], round_idx=True,
                            valid=t["event_valid"])

    events = float(np.mean([b["event_valid"].sum() for b in batches]))
    print(json.dumps({"probe": "protocol_host", "windows": args.windows,
                      "resolution": [H, W], "gt_resolution": [gh, gw],
                      "events_per_window": events,
                      "next_batch_ms": {e: [r["next_batch"] for r in runs]
                                        for e, runs in per_encoder.items()},
                      "next_batch_split_ms": per_encoder,
                      "host_metrics_ms_by_threads": by_threads(threads, metrics_pass,
                                                               len(batches)),
                      "iwe_ms_by_threads": by_threads(threads, iwe_pass, len(batches)),
                      "cpus": torch.get_num_threads()}))


if __name__ == "__main__":
    main()
