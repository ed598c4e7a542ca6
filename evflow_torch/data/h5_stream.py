"""Host-side streaming event loader over reference-format sequence files
(port of ``evflow/data/h5_stream.py`` for the ground-truth-flow window modes).

File schema: ``events/{xs, ys, ts, ps}`` (ts absolute, attr ``t0``) and
``flow_dt1``/``flow_dt4`` groups of GT flow maps with a ``timestamp`` attr,
in HDF5 (``.h5``, read with ``h5py``) or in a numpy archive holding the same
schema (``.npz``: one member per dataset, ``attrs/<name>`` for the file's
attrs and ``<dataset>@timestamp`` for a GT map's time), for hosts without
``h5py``. ``evflow_torch.data.synthetic`` writes both.

What this stream keeps of the reference loader, for ``data.mode`` in
``gtflow_dt1``/``gtflow_dt4``:

* one open file per batch slot; on sequence end a slot moves on to
  ``max(batch_idx) + 1`` and reports the rollover as data (``new_seq``);
* GT-indexed windows with the fractional-window arithmetic of the reference
  (``window < 1`` splits a GT interval);
* polarity to +-1, per-slot flip augmentation, hot-pixel filtering with
  per-slot running event rates;
* average-pool downsampling when ``resolution < std_resolution``, with
  ``keep_gt_full_res`` keeping the event mask and GT at full resolution.

Batches are numpy NHWC dicts. The event lists of the training and
visualisation paths, the other window modes and the native encoder come
with later slices. The shard of the files this process streams comes from
``loader.shard_index``/``loader.num_shards`` (default 0 of 1).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from evflow_torch.data import encodings as enc

__all__ = ["H5EventStream", "Prefetcher"]

GT_MODES = ("gtflow_dt1", "gtflow_dt4")


def _avg_pool(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """``[H, W, C]`` average pooling with kernel = stride = ``(ph, pw)``."""
    H, W, C = img.shape
    return img[: H - H % ph, : W - W % pw].reshape(
        H // ph, ph, W // pw, pw, C).mean(axis=(1, 3))


class _H5Sequence:
    """One HDF5 sequence file: ``t0``, the raw event timestamps ``ts``, the
    GT group's map names and times, event slices and GT maps."""

    def __init__(self, path: str, gt_group: str):
        import h5py

        self.filename = path
        self._f = h5py.File(path, "r")
        self.t0 = float(self._f.attrs["t0"])
        self._gt = self._f[gt_group]
        self.gt_names: List[str] = []
        self.gt_ts: List[float] = []

        def visit(name, obj):
            if hasattr(obj, "dtype") and name not in self.gt_names:
                self.gt_names.append(name)
                self.gt_ts.append(obj.attrs["timestamp"])

        self._gt.visititems(visit)
        self.ts = self._f["events/ts"][...]

    def events(self, i0: int, i1: int):
        return tuple(self._f[f"events/{k}"][i0:i1] for k in ("xs", "ys", "ts", "ps"))

    def gt(self, name: str) -> np.ndarray:
        return self._gt[name][:]

    def close(self):
        self._f.close()


class _NpzSequence:
    """The same schema in a numpy archive, read whole at open."""

    def __init__(self, path: str, gt_group: str):
        self.filename = path
        with np.load(path) as z:
            self.t0 = float(z["attrs/t0"])
            self._ev = {k: z[f"events/{k}"] for k in ("xs", "ys", "ts", "ps")}
            prefix = gt_group + "/"
            self.gt_names = sorted(k[len(prefix):] for k in z.files
                                   if k.startswith(prefix) and "@" not in k)
            self.gt_ts = [float(z[f"{prefix}{n}@timestamp"]) for n in self.gt_names]
            self._gt = {n: z[prefix + n] for n in self.gt_names}
        self.ts = self._ev["ts"]

    def events(self, i0: int, i1: int):
        return tuple(self._ev[k][i0:i1] for k in ("xs", "ys", "ts", "ps"))

    def gt(self, name: str) -> np.ndarray:
        return self._gt[name]

    def close(self):
        pass


def open_sequence(path: str, gt_group: str):
    """Reader of a ``.h5`` or ``.npz`` sequence file."""
    return (_NpzSequence if path.endswith(".npz") else _H5Sequence)(path, gt_group)


class H5EventStream:
    """Stateful multi-slot event stream producing full batches."""

    def __init__(self, config: Dict[str, Any], num_bins: int, round_encoding: bool = False):
        self.num_bins = num_bins
        self.round_encoding = round_encoding
        self.mode = config["data"]["mode"]
        if self.mode not in GT_MODES:
            raise NotImplementedError(
                f"data.mode {self.mode!r}: only {GT_MODES} are ported")
        self.window = config["data"]["window"]
        loader = config["loader"]
        self.batch_size = int(loader.get("batch_size", 1))
        self.target_resolution = tuple(loader["resolution"])
        self.std_resolution = tuple(loader.get("std_resolution", loader["resolution"]))
        self.resolution = self.std_resolution
        self.keep_gt_full_res = bool(loader.get("keep_gt_full_res", False))
        self.augment = list(loader.get("augment", []))
        self.augment_prob = list(loader.get("augment_prob") or [])
        if self.augment and len(self.augment_prob) < len(self.augment):
            self.augment_prob += [0.5] * (len(self.augment) - len(self.augment_prob))
        self.rng = np.random.default_rng(int(loader.get("seed", 0)))
        model_cfg = config.get("model")
        if model_cfg and model_cfg.get("temporal_cnt"):
            raise NotImplementedError("temporal_cnt windows are not ported yet")
        model_enc = model_cfg.get("encoding", "cnt") if model_cfg else None
        self.build_voxel = model_enc != "cnt" or bool(loader.get("build_all_encodings", False))

        self.seq_num = 0
        self.new_seq = False
        self.slot_ts = np.zeros(self.batch_size, np.float64)

        self.files: List[str] = []
        for root, _dirs, files in os.walk(config["data"]["path"]):
            for f in sorted(files):
                if f.endswith((".h5", ".npz")):
                    self.files.append(os.path.join(root, f))
        if not self.files:
            raise FileNotFoundError(f"No .h5/.npz files under {config['data']['path']}")
        self.num_shards = int(loader.get("num_shards", 1))
        self.shard_index = int(loader.get("shard_index", 0))
        if self.num_shards > 1:
            self.files = self.files[self.shard_index::self.num_shards]
            if not self.files:
                raise ValueError(f"shard {self.shard_index}/{self.num_shards} has no files")

        B = self.batch_size
        self.batch_idx = list(range(B))
        self.batch_row: List[float] = [0.0] * B
        self.open_files: List[Any] = [None] * B  # _H5Sequence / _NpzSequence
        self.slot_aug: List[Dict[str, bool]] = [dict() for _ in range(B)]
        hot = config.get("hot_filter", {})
        self.hot_enabled = bool(hot.get("enabled", False))
        self.hot_cfg = hot
        self.hot_idx = [0] * B
        self.hot_events = [np.zeros(self.resolution, np.float32) for _ in range(B)]
        for b in range(B):
            self._open_slot(b, self.files[b % len(self.files)])
            self._resample_aug(b)

    # -- slots ---------------------------------------------------------------

    def _open_slot(self, b: int, path: str):
        if self.open_files[b] is not None:
            self.open_files[b].close()
        self.open_files[b] = open_sequence(path, self.mode.replace("gtflow_", "flow_"))

    def _resample_aug(self, b: int):
        for mech, prob in zip(self.augment, self.augment_prob):
            self.slot_aug[b][mech] = bool(self.rng.random() < prob)

    def _reset_sequence(self, b: int):
        self.seq_num += 1
        self.batch_row[b] = 0.0
        self.batch_idx[b] = max(self.batch_idx) + 1
        self._open_slot(b, self.files[self.batch_idx[b] % len(self.files)])
        self._resample_aug(b)
        if self.hot_enabled:
            self.hot_idx[b] = 0
            self.hot_events[b] = np.zeros(self.resolution, np.float32)

    # -- events --------------------------------------------------------------

    def _event_range(self, b: int) -> Tuple[int, int]:
        """Event indices of slot ``b``'s window between two GT timestamps,
        split proportionally for fractional windows."""
        w, row = self.window, self.batch_row[b]
        gt_ts, ts = self.open_files[b].gt_ts, self.open_files[b].ts
        i0, i1 = int(np.floor(row)), int(np.ceil(row + w))
        if w < 1.0 and i1 - i0 > 1:
            i0 += i1 - i0 - 1
        e0 = int(np.searchsorted(ts, gt_ts[i0], side="left"))
        e1 = int(np.searchsorted(ts, gt_ts[i1], side="left"))
        if w < 1.0:
            c0, c1 = row - i0, row + w - i0
            delta = e1 - e0
            e0, e1 = int(e0 + c0 * delta), int(e0 + c1 * delta)
        return e0, e1

    def _get_events(self, b: int, i0: int, i1: int):
        f = self.open_files[b]
        xs, ys, ts, ps = f.events(i0, i1)
        return (xs.astype(np.float32), ys.astype(np.float32),
                ts.astype(np.float64) - f.t0, ps.astype(np.float32))

    def _slot_item(self, b: int) -> Tuple[Dict[str, np.ndarray], bool]:
        new_seq = False
        restarts = 0
        while int(np.ceil(self.batch_row[b] + self.window)) >= len(self.open_files[b].gt_ts):
            if restarts > 2 * len(self.files):
                raise ValueError(f"no sequence can produce a window (window={self.window})")
            new_seq = self.new_seq = True
            restarts += 1
            self._reset_sequence(b)
        xs, ys, ts, ps = self._get_events(b, *self._event_range(b))
        if xs.shape[0] <= 10:
            xs = ys = ts = ps = np.empty(0, np.float32)

        H, W = self.resolution
        aug = self.slot_aug[b]
        dt_input = float(ts[-1] - ts[0]) if ts.shape[0] > 0 else 0.0
        if ts.shape[0] > 0:
            self.slot_ts[b] = float(ts[-1])
        ps = ps * 2.0 - 1.0 if ps.size and ps.min() >= 0 else ps
        tsn = ts.astype(np.float64)
        if tsn.size and not np.isfinite(tsn).all():
            raise ValueError(f"NaN/Inf event timestamps in {self.open_files[b].filename}")
        if tsn.size:
            span = tsn.max() - tsn.min()
            tsn = (tsn - tsn.min()) / span if span > 0 else np.zeros_like(tsn)
        tsn = tsn.astype(np.float32)
        if aug.get("Horizontal"):
            xs = W - 1 - xs
        if aug.get("Vertical"):
            ys = H - 1 - ys
        if aug.get("Polarity"):
            ps = -ps

        event_cnt = enc.np_events_to_channels(xs, ys, ps, (H, W))
        event_mask = enc.np_events_to_mask(xs, ys, ps, (H, W))
        event_voxel = (enc.np_events_to_voxel(xs, ys, tsn, ps, self.num_bins, (H, W),
                                              self.round_encoding)
                       if self.build_voxel else None)

        out: Dict[str, Any] = {}
        if self.hot_enabled:
            self.hot_events[b] += (event_cnt.sum(-1) > 0).astype(np.float32)
            self.hot_idx[b] += 1
            hot_mask = enc.np_hot_event_mask(
                self.hot_events[b] / self.hot_idx[b], self.hot_idx[b],
                max_px=int(self.hot_cfg.get("max_px", 100)),
                min_obvs=int(self.hot_cfg.get("min_obvs", 5)),
                max_rate=float(self.hot_cfg.get("max_rate", 0.8)))
            event_cnt *= hot_mask[..., None]
            if event_voxel is not None:
                event_voxel *= hot_mask[..., None]
            event_mask *= hot_mask[..., None]
            out["hot_mask"] = hot_mask.astype(np.uint8)

        # GT flow at the window's end, stored [2, H, W] -> [H, W, 2]
        f = self.open_files[b]
        gt_ts = f.gt_ts
        idx = int(np.ceil(self.batch_row[b] + self.window))
        fm = f.gt(f.gt_names[idx])
        if fm.ndim == 3 and fm.shape[0] == 2:
            fm = np.moveaxis(fm, 0, -1)
        if aug.get("Horizontal"):
            fm = np.flip(fm, 1).copy()
            fm[..., 0] *= -1.0
        if aug.get("Vertical"):
            fm = np.flip(fm, 0).copy()
            fm[..., 1] *= -1.0
        dt_gt = float(gt_ts[idx] - gt_ts[idx - 1]) if idx > 0 else 0.0
        self.batch_row[b] += self.window

        out.update(
            event_cnt=event_cnt,
            event_voxel=event_voxel if event_voxel is not None else event_cnt,
            event_mask=event_mask,
            gtflow=fm.astype(np.float32),
            dt_input=np.float32(dt_input),
            dt_gt=np.float32(dt_gt),
        )

        th, tw = self.target_resolution
        oh, ow = event_cnt.shape[:2]
        if th < oh or tw < ow:
            ph, pw = oh // th, ow // tw
            if ph == 0 or pw == 0:
                raise ValueError(f"Invalid pooling kernel ({ph}, {pw})")
            out["event_cnt"] = _avg_pool(out["event_cnt"], ph, pw)
            out["event_voxel"] = (_avg_pool(out["event_voxel"], ph, pw)
                                  if event_voxel is not None else out["event_cnt"])
            if not self.keep_gt_full_res:
                out["event_mask"] = _avg_pool(out["event_mask"], ph, pw)
                out["gtflow"] = _avg_pool(out["gtflow"], ph, pw)
        return out, new_seq

    # -- batches -------------------------------------------------------------

    def next_batch(self) -> Dict[str, Any]:
        """One stacked batch, plus ``new_seq [B]`` rollover flags,
        ``epoch_done``, ``seq_num``, ``file_names`` and per-slot ``ts``."""
        items, flags = zip(*(self._slot_item(b) for b in range(self.batch_size)))
        batch: Dict[str, Any] = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["new_seq"] = np.array(flags, np.bool_)
        batch["epoch_done"] = self.seq_num >= len(self.files)
        batch["seq_num"] = self.seq_num
        batch["file_names"] = [
            os.path.basename(self.files[self.batch_idx[b] % len(self.files)])
            for b in range(self.batch_size)]
        batch["ts"] = self.slot_ts.copy()
        if batch["epoch_done"]:
            # roll the cursor producer-side so a prefetch thread can run ahead
            self.seq_num = self.seq_num % len(self.files)
        return batch

    def close(self):
        for f in self.open_files:
            if f is not None:
                f.close()


class Prefetcher:
    """Background thread that keeps up to ``depth`` batches ready, so host
    reads and encodings overlap the device step."""

    def __init__(self, stream: H5EventStream, depth: int = 2):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._dead: Optional[BaseException] = None
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self.stream.next_batch()
            except Exception as e:  # surfaced in the consumer
                self.q.put(e)
                return
            self.q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        if self._dead is not None:
            raise RuntimeError(f"prefetch worker died: {self._dead!r}") from self._dead
        item = self.q.get()
        if isinstance(item, Exception):
            self._dead = item
            raise item
        return item

    def close(self):
        """Stop and join the worker, so the caller may close the files."""
        self._stop.set()
        while self.t.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
            self.t.join(timeout=0.05)
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
