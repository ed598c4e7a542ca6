"""The protocol's host work a window, each part alone, on this machine's CPU.

    python -m evflow_torch.probes.protocol_host [--windows 40] [--threads 8,4,2,1]

With the settings of ``configs/eval_MVSEC.yml`` (256x256 pooled to 128x128,
hot filter, ``keep_gt_full_res``, AEE / AAE / AE_ofMeans) on a synthetic
sequence: the ms a window of ``H5EventStream.next_batch`` (read, count,
hot filter, pool: what the ``Prefetcher`` thread does), and of the host
metric protocol of ``evaluate``'s host path (upsampling a 128x128 flow to
the GT's 256x256, association and the three criteria on CPU tensors) at
each count of torch's intra-op threads, three passes over the windows after
one that warms the thread pool. Nothing runs on a card; no other
thread runs beside the timed part. Prints one JSON line.
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
from evflow_torch.data.h5_stream import H5EventStream
from evflow_torch.data.synthetic import make_dataset
from evflow_torch.ops.iwe import upsample_flow

CONFIG = Path(__file__).resolve().parents[2] / "configs" / "eval_MVSEC.yml"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--threads", default="8,4,2,1")
    args = ap.parse_args(argv)
    cfg = load_config(str(CONFIG))
    with tempfile.TemporaryDirectory(prefix="evflow_host_") as root:
        make_dataset(root, num_sequences=1, seed=0, duration=args.windows / 10 + 0.1,
                     resolution=tuple(cfg["loader"]["std_resolution"]),
                     events_per_sec=50_000, fmt="npz")
        cfg["data"]["path"] = root
        stream = H5EventStream(cfg, cfg["model"]["num_bins"])
        stream.next_batch()  # opens the file
        t0 = time.perf_counter()
        batches = [stream.next_batch() for _ in range(args.windows)]
        data_ms = 1e3 * (time.perf_counter() - t0) / args.windows
        stream.close()
    H, W = cfg["loader"]["resolution"]
    gh, gw = batches[0]["gtflow"].shape[1:3]
    scaling = cfg["metrics"]["flow_scaling"] * (H / 128) / 2
    criteria = registry.build_metrics(cfg, scaling)
    flow = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (1, H, W, 2))
                            .astype(np.float32))
    scale = torch.tensor([gw / W, gh / H])
    before = torch.get_num_threads()
    metrics_ms = {}
    for n in (int(t) for t in args.threads.split(",")):
        torch.set_num_threads(n)
        runs = []
        for rep in range(4):  # the first pass warms the thread pool: not kept
            t0 = time.perf_counter()
            for b in batches:
                f = upsample_flow(flow, gh, gw) * scale
                inputs = {k: torch.from_numpy(np.ascontiguousarray(b[k]))
                          for k in ("gtflow", "event_mask", "dt_gt", "dt_input")}
                for c in criteria:
                    c.event_flow_association([f], inputs)
                    c()
                    c.reset()
            runs.append(1e3 * (time.perf_counter() - t0) / len(batches))
        metrics_ms[n] = runs[1:]
    torch.set_num_threads(before)
    print(json.dumps({"probe": "protocol_host", "windows": args.windows,
                      "resolution": [H, W], "gt_resolution": [gh, gw],
                      "next_batch_ms": data_ms, "host_metrics_ms_by_threads": metrics_ms,
                      "cpus": torch.get_num_threads()}))


if __name__ == "__main__":
    main()
