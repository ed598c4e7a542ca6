"""Host-side streaming event loader over reference-format sequence files
(port of ``evflow/data/h5_stream.py``).

File schema: ``events/{xs, ys, ts, ps}`` (ts absolute; attrs ``t0`` and
``duration``), ``flow_dt1``/``flow_dt4`` groups of GT flow maps and an
``images`` group of frames, each map with a ``timestamp`` attr, in HDF5
(``.h5``, read with ``h5py``) or in a numpy archive holding the same schema
(``.npz``: one member per dataset, ``attrs/<name>`` for the file's attrs and
``<dataset>@timestamp`` for a map's time), for hosts without ``h5py``.
``evflow_torch.data.synthetic`` writes both.

What the stream keeps of the reference loader:

* one open file per batch slot; on sequence end a slot moves on to
  ``max(batch_idx) + 1`` and reports the rollover as data (``new_seq``);
* the window modes ``events`` (a fixed count), ``time`` (seconds),
  ``frames`` and ``gtflow_dt1``/``gtflow_dt4`` (index windows between two
  frame or GT times, ``window < 1`` splitting an interval), with their
  restart rules, and the spatially filtered read (a centre crop in event
  space) in ``events`` mode when ``resolution < std_resolution``;
* polarity to +-1, per-window min-max timestamps, per-slot flip
  augmentation resampled on rollover (frames and GT maps flipped alike),
  hot-pixel filtering with per-slot running event rates, ``temporal_cnt``
  counts (channel 0 the window's signed count, channel 1 the previous
  window's);
* average-pool downsampling when ``resolution < std_resolution`` (event
  coordinates rescaled and clamped, frames centre-cropped), with
  ``keep_gt_full_res`` keeping the event mask and GT at full resolution;
* the whole-file event cache (``loader.event_cache_bytes``), the per-file
  timestamp cache (``loader.ts_cache_bytes``, else a bisection over the
  dataset) and the per-slot thread pool (``loader.fetch_workers``).

Encoders. Each window's counts, mask, voxel grid, event list and polarity
mask come from the port's host library (``evflow_torch.data.native``): by
default from ``ev_window_assemble``, one pass over the events
(``encoder == "native_fused"``); with ``loader.fused_assembly: false``
from its separate functions after numpy formatting (``"native"``); with
``loader.native_encoder: false`` from numpy (``"numpy"``). The three are
bit-equal. A failed build of the library raises.

Batches are numpy NHWC dicts. The event lists are padded to one length a
batch (the window in ``events`` mode, else the next power of two from 256)
with ``event_valid`` marking the real events. The shard of the files this
process streams comes from ``loader.shard_index``/``loader.num_shards``
(default 0 of 1).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from evflow_torch.data import encodings as enc

__all__ = ["H5EventStream", "Prefetcher", "bucket_size", "open_sequence", "ENCODERS"]

ENCODERS = ("native_fused", "native", "numpy")
GT_MODES = ("gtflow_dt1", "gtflow_dt4")
MODES = ("events", "time", "frames") + GT_MODES


def bucket_size(n: int, minimum: int = 256) -> int:
    """The next power of two from ``minimum`` that holds ``n``."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _avg_pool(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """``[H, W, C]`` average pooling with kernel = stride = ``(ph, pw)``, as
    strided slice sums, bit-equal to ``img.reshape(H/ph, ph, W/pw, pw,
    C).mean(axis=(1, 3))``: numpy sums a window's elements in the order of
    its iteration, which follows the memory layout. When the pixel's
    channels are its innermost axis (C > 1, channel stride the smallest) it
    adds the ``ph * pw`` elements one after the other; otherwise it sums
    each row of ``pw`` first (a short pairwise sum, sequential below 8
    elements) and adds the rows. Other layouts, and rows of 8 or more, take
    numpy's own mean."""
    H, W, C = img.shape
    Ho, Wo = H // ph, W // pw
    per_element = C > 1 and img.strides[2] < img.strides[1] < img.strides[0]
    per_row = C == 1 or img.strides[1] < img.strides[0] < img.strides[2]
    if pw >= 8 or not (per_element or per_row):
        return img[: Ho * ph, : Wo * pw].reshape(Ho, ph, Wo, pw, C).mean(axis=(1, 3))
    out = None
    for a in range(ph):
        row = None
        for c in range(pw):
            v = img[a: Ho * ph: ph, c: Wo * pw: pw]
            if per_element:
                out = v.copy() if out is None else np.add(out, v, out=out)
            else:
                row = v.copy() if row is None else np.add(row, v, out=row)
        if not per_element:
            out = row if out is None else np.add(out, row, out=out)
    return np.divide(out, ph * pw, out=out)


def _hot_update(cnt: np.ndarray) -> np.ndarray:
    """``cnt.sum(-1) > 0`` as f32 (which pixels saw events), as adds of the
    channel planes."""
    s = cnt[..., 0]
    for k in range(1, cnt.shape[-1]):
        s = s + cnt[..., k]
    return (s > 0).astype(np.float32)


class _H5Sequence:
    """One HDF5 sequence file: its attrs, the event datasets and the timed
    groups (GT flow, frames)."""

    def __init__(self, path: str):
        import h5py

        self.filename = path
        self._f = h5py.File(path, "r")
        self.attrs = {k: self._f.attrs[k] for k in self._f.attrs}
        self.xs, self.ys, self.ts, self.ps = (self._f[f"events/{k}"]
                                              for k in ("xs", "ys", "ts", "ps"))
        self.t0 = float(self.attrs["t0"])
        self.ts_cache: Optional[np.ndarray] = None
        self._groups: Dict[str, Any] = {}

    def timed(self, group: str) -> Tuple[List[str], List[float]]:
        """Names and timestamps of a group's maps, in the order HDF5 visits
        them."""
        names: List[str] = []
        ts: List[float] = []

        def visit(name, obj):
            if hasattr(obj, "dtype") and name not in names:
                names.append(name)
                ts.append(obj.attrs["timestamp"])

        self._f[group].visititems(visit)
        return names, ts

    def timed_map(self, group: str, name: str) -> np.ndarray:
        g = self._groups.get(group)
        if g is None:
            g = self._groups[group] = self._f[group]
        return g[name][:]

    def close(self):
        self._f.close()


class _NpzSequence:
    """The same schema in a numpy archive, read whole at open."""

    def __init__(self, path: str):
        self.filename = path
        with np.load(path) as z:
            self._z = {k: z[k] for k in z.files}
        self.attrs = {k[len("attrs/"):]: self._z[k][()] for k in self._z
                      if k.startswith("attrs/")}
        self.xs, self.ys, self.ts, self.ps = (self._z[f"events/{k}"]
                                              for k in ("xs", "ys", "ts", "ps"))
        self.t0 = float(self.attrs["t0"])
        self.ts_cache: Optional[np.ndarray] = None

    def timed(self, group: str) -> Tuple[List[str], List[float]]:
        prefix = group + "/"
        names = sorted(k[len(prefix):] for k in self._z if k.startswith(prefix) and "@" not in k)
        return names, [self._z[f"{prefix}{n}@timestamp"][()] for n in names]

    def timed_map(self, group: str, name: str) -> np.ndarray:
        return self._z[f"{group}/{name}"]

    def close(self):
        pass


def open_sequence(path: str):
    """Reader of a ``.h5`` or ``.npz`` sequence file."""
    return (_NpzSequence if path.endswith(".npz") else _H5Sequence)(path)


class H5EventStream:
    """Stateful multi-slot event stream producing full batches."""

    def __init__(self, config: Dict[str, Any], num_bins: int, round_encoding: bool = False):
        self.config = config
        self.num_bins = num_bins
        self.round_encoding = round_encoding
        self.mode = config["data"]["mode"]
        if self.mode not in MODES:
            raise ValueError(f"Unknown mode {self.mode!r}")
        self.window = config["data"]["window"]
        loader = config["loader"]
        self.batch_size = int(loader.get("batch_size", 1))
        self.target_resolution = tuple(loader["resolution"])
        self.std_resolution = tuple(loader.get("std_resolution", loader["resolution"]))
        self.resolution = self.target_resolution if self.mode == "events" else self.std_resolution
        self.keep_gt_full_res = bool(loader.get("keep_gt_full_res", False))
        self.augment = list(loader.get("augment", []))
        self.augment_prob = list(loader.get("augment_prob") or [])
        if self.augment and len(self.augment_prob) < len(self.augment):
            self.augment_prob += [0.5] * (len(self.augment) - len(self.augment_prob))
        self.rng = np.random.default_rng(int(loader.get("seed", 0)))
        model_cfg = config.get("model")
        model_enc = model_cfg.get("encoding", "cnt") if model_cfg else None
        self.build_voxel = model_enc != "cnt" or bool(loader.get("build_all_encodings", False))
        self.temporal_cnt = bool((model_cfg or {}).get("temporal_cnt", False))

        self.epoch = 0
        self.seq_num = 0
        self.samples = 0
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

        self.ts_cache_bytes = int(loader.get("ts_cache_bytes", 256 << 20))
        # whole-file event arrays, pre-cast, keyed by path (shared by slots
        # on one file, kept across rollovers), FIFO-evicted against the budget
        self._ev_cache: Dict[str, tuple] = {}
        self._ev_cache_used = 0
        self.event_cache_bytes = int(loader.get("event_cache_bytes", 1 << 30))
        # the slots' read and encode on pool threads; rollovers (the shared
        # rng and counters) and the event cache are guarded by the lock
        workers = int(loader.get("fetch_workers", 1))
        self._slot_lock = threading.Lock()
        self._pool = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=min(workers, self.batch_size),
                                            thread_name_prefix="evflow-slot")

        B = self.batch_size
        self.batch_idx = list(range(B))
        self.batch_row: List[float] = [0.0] * B
        self.open_files: List[Any] = [None] * B  # _H5Sequence / _NpzSequence
        self.batch_last_ts: List[float] = [0.0] * B
        self.slot_timed: List[Optional[Tuple[List[str], List[float]]]] = [None] * B
        self.slot_aug: List[Dict[str, bool]] = [dict() for _ in range(B)]
        hot = config.get("hot_filter", {})
        self.hot_enabled = bool(hot.get("enabled", False))
        self.hot_cfg = hot
        self.hot_idx = [0] * B
        self.hot_events = [np.zeros(self.resolution, np.float32) for _ in range(B)]
        self.prev_cnt: List[Optional[np.ndarray]] = [None] * B

        self._native = None
        self.encoder = "numpy"
        if bool(loader.get("native_encoder", True)):
            from evflow_torch.data.native import NativeEncoder

            self._native = NativeEncoder()
            self.encoder = "native_fused" if bool(loader.get("fused_assembly", True)) else "native"
        for b in range(B):
            self._open_slot(b, self.files[b % len(self.files)])
            self._resample_aug(b)

    # -- slots ---------------------------------------------------------------

    def _timed_group(self) -> Optional[str]:
        if self.mode == "frames":
            return "images"
        if self.mode in GT_MODES:
            return self.mode.replace("gtflow_", "flow_")
        return None

    def _open_slot(self, b: int, path: str):
        if self.open_files[b] is not None:
            self.open_files[b].close()
        f = self.open_files[b] = open_sequence(path)
        self.batch_last_ts[b] = f.ts[-1] - f.attrs["t0"]
        group = self._timed_group()
        if group is not None:
            self.slot_timed[b] = f.timed(group)

    def _resample_aug(self, b: int):
        for mech, prob in zip(self.augment, self.augment_prob):
            self.slot_aug[b][mech] = bool(self.rng.random() < prob)

    def _reset_sequence(self, b: int):
        with self._slot_lock:
            self.seq_num += 1
            self.batch_row[b] = 0.0
            self.batch_idx[b] = max(self.batch_idx) + 1
            self._open_slot(b, self.files[self.batch_idx[b] % len(self.files)])
            self._resample_aug(b)
            if self.hot_enabled:
                self.hot_idx[b] = 0
                self.hot_events[b] = np.zeros(self.resolution, np.float32)

    def shuffle(self, flag: bool = True):
        if flag:
            self.rng.shuffle(self.files)

    def get_iters(self, b: int) -> int:
        """Windows of slot ``b``'s open sequence."""
        f = self.open_files[b]
        if self.mode == "events":
            it = len(f.xs)
        elif self.mode == "time":
            it = f.attrs["duration"]
        else:
            it = len(self.slot_timed[b][1]) - 1
        return int(it // self.window)

    # -- events --------------------------------------------------------------

    def _find_ts_index(self, f, timestamp: float) -> int:
        """bisect_left over the file's timestamps: a search in the cached
        array when it fits ``ts_cache_bytes``, else a bisection that reads
        one element a probe."""
        dts = f.ts
        c = f.ts_cache
        if c is None and dts.size * dts.dtype.itemsize <= self.ts_cache_bytes:
            c = f.ts_cache = dts[...]
        if c is not None:
            return int(np.searchsorted(c, timestamp, side="left"))
        lo, hi = 0, dts.shape[0]
        while lo < hi:
            mid = (lo + hi) // 2
            if dts[mid] < timestamp:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _cached_events(self, f):
        """The file's events pre-cast (xs, ys, ps f32; ts f64 less t0) when
        they fit the cache's budget, else None."""
        path = f.filename
        c = self._ev_cache.get(path)
        if c is not None or self.event_cache_bytes <= 0:
            return c
        n = f.xs.shape[0]
        nbytes = n * (4 + 4 + 8 + 4)
        if nbytes > self.event_cache_bytes:
            return None
        with self._slot_lock:
            c = self._ev_cache.get(path)
            if c is not None:
                return c
            while self._ev_cache and self._ev_cache_used + nbytes > self.event_cache_bytes:
                oldest = next(iter(self._ev_cache))
                self._ev_cache_used -= self._ev_cache.pop(oldest)[0]
            c = (nbytes, f.xs[...].astype(np.float32), f.ys[...].astype(np.float32),
                 f.ts[...].astype(np.float64) - f.t0, f.ps[...].astype(np.float32))
            self._ev_cache[path] = c
            self._ev_cache_used += nbytes
        return c

    def _get_events(self, f, i0: int, i1: int):
        c = self._cached_events(f)
        if c is not None:
            # read-only views: every consumer copies before it mutates
            return c[1][i0:i1], c[2][i0:i1], c[3][i0:i1], c[4][i0:i1]
        return (f.xs[i0:i1].astype(np.float32), f.ys[i0:i1].astype(np.float32),
                f.ts[i0:i1].astype(np.float64) - f.t0, f.ps[i0:i1].astype(np.float32))

    def _event_index(self, b: int) -> Tuple[int, int]:
        """The event indices of slot ``b``'s window."""
        f = self.open_files[b]
        w, row = self.window, self.batch_row[b]
        if self.mode == "events":
            return int(row), int(row + w)
        if self.mode == "time":
            t0 = f.attrs["t0"]
            return self._find_ts_index(f, row + t0), self._find_ts_index(f, row + t0 + w)
        timed_ts = self.slot_timed[b][1]
        i0, i1 = int(np.floor(row)), int(np.ceil(row + w))
        if w < 1.0 and i1 - i0 > 1:
            i0 += i1 - i0 - 1
        e0 = self._find_ts_index(f, timed_ts[i0])
        e1 = self._find_ts_index(f, timed_ts[i1])
        if w < 1.0:
            # a fractional window takes its share of the interval's events
            c0, c1 = row - i0, row + w - i0
            delta = e1 - e0
            e0, e1 = int(e0 + c0 * delta), int(e0 + c1 * delta)
        return e0, e1

    def _get_events_spatially_filtered(self, b: int, target_n: int):
        """The first ``target_n`` events inside the centred crop of the
        target resolution, in crop coordinates, reading chunks that grow
        until enough are found; moves the slot's cursor past what it read."""
        f = self.open_files[b]
        sh, sw = self.std_resolution
        th, tw = self.target_resolution
        y0, x0 = (sh - th) // 2, (sw - tw) // 2
        y1, x1 = y0 + th, x0 + tw
        cur = int(self.batch_row[b])
        chunk = target_n * 2
        out = [[], [], [], []]
        collected, searched = 0, 0
        n_total = len(f.xs)
        while collected < target_n and searched < target_n * 10:
            end = min(cur + chunk, n_total)
            if cur >= end:
                break
            xs, ys, ts, ps = f.xs[cur:end], f.ys[cur:end], f.ts[cur:end], f.ps[cur:end]
            m = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
            take = np.where(m)[0][: target_n - collected]
            if take.size:
                for lst, a in zip(out, (xs, ys, ts, ps)):
                    lst.append(a[take])
                collected += take.size
            cur = end
            searched += chunk
            if collected < target_n * 0.5:
                chunk = min(chunk * 2, target_n * 5)
        if collected == 0:
            return (np.empty(0, np.float32),) * 4
        xs, ys, ts, ps = (np.concatenate(a) for a in out)
        xs = (xs - x0).astype(np.float32)
        ys = (ys - y0).astype(np.float32)
        ts = ts.astype(np.float64) - f.attrs["t0"]
        ps = ps.astype(np.float32)
        m = (ys >= 0) & (ys < th) & (xs >= 0) & (xs < tw)
        self.batch_row[b] = float(cur)
        return xs[m], ys[m], ts[m], ps[m]

    # -- one slot's window ---------------------------------------------------

    def _read_window(self, b: int):
        """The raw events of slot ``b``'s next window, rolling the slot over
        to the next sequence (maybe more than once) when its sequence has no
        window left; returns ``(xs, ys, ts, ps, new_seq)``."""
        new_seq = False
        restarts = 0
        while True:
            if restarts > 2 * len(self.files):
                raise ValueError(
                    f"no sequence can produce a window (mode={self.mode!r}, "
                    f"window={self.window}): all {len(self.files)} files are shorter "
                    "than one window")
            restart = False
            if self.mode not in ("events", "time"):
                if int(np.ceil(self.batch_row[b] + self.window)) >= len(self.slot_timed[b][1]):
                    restart = True
            xs = ys = ts = ps = np.empty(0, np.float32)
            if not restart:
                if self.mode == "events" and (
                        self.target_resolution[0] < self.std_resolution[0]
                        or self.target_resolution[1] < self.std_resolution[1]):
                    # the filtered read moves the cursor and the window's
                    # advance still applies after it, as in the reference
                    xs, ys, ts, ps = self._get_events_spatially_filtered(b, int(self.window))
                else:
                    xs, ys, ts, ps = self._get_events(self.open_files[b], *self._event_index(b))
            if self.mode == "events" and xs.shape[0] < self.window:
                restart = True
            if self.mode == "time" and self.batch_row[b] + self.window >= self.batch_last_ts[b]:
                restart = True
            if xs.shape[0] <= 10:
                xs = ys = ts = ps = np.empty(0, np.float32)
            if not restart:
                return xs, ys, ts, ps, new_seq
            new_seq = self.new_seq = True
            restarts += 1
            self._reset_sequence(b)

    def _assemble(self, b: int, xs, ys, ts, ps):
        """Formatting, augmentation and every encoding of one window by the
        stream's encoder: ``(cnt, mask, voxel or None, event_list,
        pol_mask, dt_input)``."""
        H, W = self.resolution
        aug = self.slot_aug[b]
        if self.encoder == "native_fused":
            try:
                cnt, mask, voxel, event_list, pol_mask, dt_input, last_ts = \
                    self._native.window_assemble(
                        xs, ys, ts, ps, (H, W), self.num_bins,
                        flip_h=bool(aug.get("Horizontal")), flip_v=bool(aug.get("Vertical")),
                        flip_p=bool(aug.get("Polarity")), build_voxel=self.build_voxel,
                        round_ts=self.round_encoding)
            except ValueError:
                raise ValueError(f"NaN/Inf event timestamps in {self.open_files[b].filename}")
            if ts.shape[0] > 0:
                self.slot_ts[b] = last_ts
            return cnt, mask, voxel, event_list, pol_mask, dt_input

        # polarity to +-1 unless some is negative, min-max timestamps
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
        lib = self._native if self.encoder == "native" else None
        if lib is not None:
            cnt = lib.count_encoding(xs, ys, ps, (H, W))
            mask = lib.mask_encoding(xs, ys, ps, (H, W))
            voxel = (lib.voxel_encoding(xs, ys, tsn, ps, self.num_bins, (H, W),
                                        self.round_encoding) if self.build_voxel else None)
            pol_mask = lib.polarity_mask(ps) if ps.size else np.zeros((0, 2), np.float32)
        else:
            cnt = enc.np_events_to_channels(xs, ys, ps, (H, W))
            mask = enc.np_events_to_mask(xs, ys, ps, (H, W))
            voxel = (enc.np_events_to_voxel(xs, ys, tsn, ps, self.num_bins, (H, W),
                                            self.round_encoding) if self.build_voxel else None)
            pol_mask = enc.np_polarity_mask(ps) if ps.size else np.zeros((0, 2), np.float32)
        event_list = (np.stack([tsn, ys, xs, ps], axis=-1) if xs.size
                      else np.zeros((0, 4), np.float32))
        return cnt, mask, voxel, event_list, pol_mask, dt_input

    def _temporal(self, b: int, cnt: np.ndarray) -> np.ndarray:
        """``temporal_cnt`` counts: the window's (pos - neg) and the previous
        window's."""
        curr = (cnt[..., 0] - cnt[..., 1])[..., None]
        prev = self.prev_cnt[b]
        if prev is None:
            prev = np.zeros_like(curr)
        self.prev_cnt[b] = curr.copy()
        return np.concatenate([curr, prev], axis=-1)

    def _hot_filter(self, b: int, cnt, voxel, mask) -> np.ndarray:
        """Update slot ``b``'s event rates and zero the hot pixels of the
        window's encodings in place; returns the ``[H, W]`` f32 mask."""
        self.hot_events[b] += _hot_update(cnt)
        self.hot_idx[b] += 1
        hot_mask = enc.np_hot_event_mask(
            self.hot_events[b] / self.hot_idx[b], self.hot_idx[b],
            max_px=int(self.hot_cfg.get("max_px", 100)),
            min_obvs=int(self.hot_cfg.get("min_obvs", 5)),
            max_rate=float(self.hot_cfg.get("max_rate", 0.8)))
        cnt *= hot_mask[..., None]
        if voxel is not None:
            voxel *= hot_mask[..., None]
        mask *= hot_mask[..., None]
        return hot_mask

    def _targets(self, b: int) -> Dict[str, Any]:
        """The window's frames (``frames`` mode) or GT flow and ``dt_gt``
        (GT modes), flipped with the slot's augmentation."""
        aug = self.slot_aug[b]
        f = self.open_files[b]
        out: Dict[str, Any] = {"dt_gt": 0.0}
        if self.mode == "frames":
            names = self.slot_timed[b][0]
            c = int(np.floor(self.batch_row[b]))
            n = int(np.ceil(self.batch_row[b] + self.window))

            def aug_frame(img):
                if aug.get("Horizontal"):
                    img = np.flip(img, 1)
                if aug.get("Vertical"):
                    img = np.flip(img, 0)
                return img

            out["frames"] = np.stack([aug_frame(f.timed_map("images", names[c])),
                                      aug_frame(f.timed_map("images", names[n]))], axis=-1)
        elif self.mode in GT_MODES:
            names, gt_ts = self.slot_timed[b]
            idx = int(np.ceil(self.batch_row[b] + self.window))
            fm = f.timed_map(self._timed_group(), names[idx])
            if fm.ndim == 3 and fm.shape[0] == 2:
                fm = np.moveaxis(fm, 0, -1)  # [2, H, W] -> [H, W, 2] (x, y)
            if aug.get("Horizontal"):
                fm = np.flip(fm, 1).copy()
                fm[..., 0] *= -1.0
            if aug.get("Vertical"):
                fm = np.flip(fm, 0).copy()
                fm[..., 1] *= -1.0
            out["gtflow"] = fm.astype(np.float32)
            if idx > 0:
                out["dt_gt"] = float(gt_ts[idx] - gt_ts[idx - 1])
        return out

    def _downsample(self, out: Dict[str, Any], pooled_voxel: bool):
        """Pool the encodings (and, unless ``keep_gt_full_res``, the mask and
        GT) to the target resolution, rescale and clamp the event list's
        coordinates and centre-crop the frames, in place."""
        th, tw = self.target_resolution
        oh, ow = out["event_cnt"].shape[:2]
        if not (th < oh or tw < ow):
            return
        ph, pw = oh // th, ow // tw
        if ph == 0 or pw == 0:
            raise ValueError(f"Invalid pooling kernel ({ph}, {pw})")
        out["event_cnt"] = _avg_pool(out["event_cnt"], ph, pw)
        out["event_voxel"] = (_avg_pool(out["event_voxel"], ph, pw) if pooled_voxel
                              else out["event_cnt"])
        if not self.keep_gt_full_res:
            out["event_mask"] = _avg_pool(out["event_mask"], ph, pw)
        if out["event_list"].size:
            el = out["event_list"].copy()
            el[:, 1] = np.clip(el[:, 1] * (th / oh), 0, th - 1)
            el[:, 2] = np.clip(el[:, 2] * (tw / ow), 0, tw - 1)
            out["event_list"] = el
        if "gtflow" in out and not self.keep_gt_full_res:
            out["gtflow"] = _avg_pool(out["gtflow"], ph, pw)
        if "frames" in out:
            cy, cx = (oh - th) // 2, (ow - tw) // 2
            out["frames"] = out["frames"][cy: cy + th, cx: cx + tw]

    def _slot_item(self, b: int) -> Tuple[Dict[str, Any], bool]:
        xs, ys, ts, ps, new_seq = self._read_window(b)
        cnt, mask, voxel, event_list, pol_mask, dt_input = self._assemble(b, xs, ys, ts, ps)
        if self.temporal_cnt:
            cnt = self._temporal(b, cnt)
        hot_mask = self._hot_filter(b, cnt, voxel, mask) if self.hot_enabled else None
        targets = self._targets(b)
        self.batch_row[b] += self.window
        out: Dict[str, Any] = {
            "event_cnt": cnt,
            # the counts stand in for a voxel grid that was not built
            "event_voxel": voxel if voxel is not None else cnt,
            "event_mask": mask,
            "event_list": event_list,
            "event_list_pol_mask": pol_mask,
            "dt_input": np.float32(dt_input),
            "dt_gt": np.float32(targets.pop("dt_gt")),
        }
        if hot_mask is not None:
            # the filter zeroes count and mask pixels but keeps the events
            out["hot_mask"] = hot_mask.astype(np.uint8)
        out.update(targets)
        self._downsample(out, voxel is not None)
        return out, new_seq

    # -- batches -------------------------------------------------------------

    def _stack(self, items, flags) -> Dict[str, Any]:
        """One batch of the slots' items, the event lists padded to one
        length with ``event_valid`` marking the real events."""
        n_max = max(it["event_list"].shape[0] for it in items)
        n_pad = max(int(self.window), 1) if self.mode == "events" else bucket_size(max(n_max, 1))
        batch: Dict[str, Any] = {k: np.stack([it[k] for it in items]) for k in items[0]
                                 if k not in ("event_list", "event_list_pol_mask")}
        B = self.batch_size
        el = np.zeros((B, n_pad, 4), np.float32)
        pm = np.zeros((B, n_pad, 2), np.float32)
        va = np.zeros((B, n_pad), np.float32)
        for b, it in enumerate(items):
            n = min(it["event_list"].shape[0], n_pad)
            el[b, :n] = it["event_list"][:n]
            pm[b, :n] = it["event_list_pol_mask"][:n]
            va[b, :n] = 1.0
        batch.update(event_list=el, event_list_pol_mask=pm, event_valid=va,
                     new_seq=np.array(flags, np.bool_))
        return batch

    def next_batch(self) -> Dict[str, Any]:
        """One stacked batch, plus ``event_valid [B, N]``, ``new_seq [B]``
        rollover flags, ``epoch_done``, ``seq_num``, ``file_names`` and
        per-slot ``ts`` (the last event's time), stamped when the batch is
        made (a prefetch thread runs ahead of its consumer)."""
        if self._pool is not None and self.batch_size > 1:
            results = list(self._pool.map(self._slot_item, range(self.batch_size)))
        else:
            results = [self._slot_item(b) for b in range(self.batch_size)]
        batch = self._stack([r[0] for r in results], [r[1] for r in results])
        batch["epoch_done"] = self.seq_num >= len(self.files)
        batch["seq_num"] = self.seq_num
        batch["file_names"] = [os.path.basename(self.files[self.batch_idx[b] % len(self.files)])
                               for b in range(self.batch_size)]
        batch["ts"] = self.slot_ts.copy()
        if batch["epoch_done"]:
            # roll the cursor producer-side so a prefetch thread can run ahead
            self.seq_num = self.seq_num % len(self.files)
        return batch

    def end_epoch(self):
        """The consumer's epoch bookkeeping (the sequence cursor rolls in
        ``next_batch``)."""
        self.epoch += 1
        self.samples = 0

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
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
