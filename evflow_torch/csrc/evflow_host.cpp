// evflow_torch host runtime: the event-stream encodings and a reference LIF,
// as plain single-threaded C++ (the port's own copy of the reference
// package's native/evflow_host.cpp; the same functions, bit for bit).
//
// Role: the hot host-side data path. Each window's counts, mask, voxel grid,
// event list and polarity mask are built here on the loader's thread
// (evflow_torch/data/h5_stream.py) before the window is uploaded to the card.
// ctypes releases the GIL around these calls, so the loader's per-slot thread
// pool (loader.fetch_workers) runs one call per batch slot concurrently.
// Scatter-adds stay serial on purpose: events alias pixels, and atomics cost
// more than they save at window sizes.
//
// Plain C ABI, bound with ctypes by evflow_torch/data/native.py, which builds
// this file with the host compiler (g++ -O3 -fPIC -std=c++17 -shared) into
// evflow_torch/_build/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Per-polarity count image: out[H, W, 2], channel 0 = +, 1 = -.
// Matches dataloader/encodings.py:70-85 with ps in {-1, +1}.
void ev_count_encoding(const float* xs, const float* ys, const float* ps,
                       int64_t n, int64_t H, int64_t W, float* out /*H*W*2*/) {
  std::memset(out, 0, sizeof(float) * H * W * 2);
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)xs[i];
    int64_t y = (int64_t)ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    float p = ps[i];
    out[(y * W + x) * 2 + (p > 0.f ? 0 : 1)] += p * p;  // ps^2 == |count|
  }
}

// Temporal-bilinear voxel grid: out[H, W, B]; ts normalized to [0, 1].
// Matches dataloader/encodings.py:48-67 (weight max(0, 1-|ts*(B-1)-b|)).
void ev_voxel_encoding(const float* xs, const float* ys, const float* ts,
                       const float* ps, int64_t n, int64_t bins, int64_t H,
                       int64_t W, int round_ts, float* out /*H*W*bins*/) {
  std::memset(out, 0, sizeof(float) * H * W * bins);
  const float scale = (float)(bins - 1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)xs[i];
    int64_t y = (int64_t)ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    float tb = ts[i] * scale;
    if (round_ts) tb = std::nearbyint(tb);
    float* px = out + (y * W + x) * bins;
    // at most two adjacent bins get nonzero weight
    int64_t b0 = (int64_t)std::floor(tb);
    for (int64_t b = std::max<int64_t>(0, b0); b <= std::min(bins - 1, b0 + 1); ++b) {
      float w = 1.f - std::fabs(tb - (float)b);
      if (w > 0.f) px[b] += ps[i] * w;
    }
  }
}

// Binary event-presence mask: out[H, W] in {0, 1}
// (dataloader/base.py:172-184, accumulate=False last-write).
void ev_mask_encoding(const float* xs, const float* ys, const float* ps,
                      int64_t n, int64_t H, int64_t W, float* out /*H*W*/) {
  std::memset(out, 0, sizeof(float) * H * W);
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)xs[i];
    int64_t y = (int64_t)ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    out[y * W + x] = std::fabs(ps[i]) > 0.f ? 1.f : 0.f;
  }
}

// Accumulating scatter image (dataloader/encodings.py:30-45).
void ev_image(const float* xs, const float* ys, const float* vals, int64_t n,
              int64_t H, int64_t W, float* out /*H*W*/) {
  std::memset(out, 0, sizeof(float) * H * W);
  for (int64_t i = 0; i < n; ++i) {
    int64_t x = (int64_t)xs[i];
    int64_t y = (int64_t)ys[i];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    out[y * W + x] += vals[i];
  }
}

// Polarity mask [N, 2] (dataloader/base.py:223-235).
void ev_polarity_mask(const float* ps, int64_t n, float* out /*N*2*/) {
  for (int64_t i = 0; i < n; ++i) {
    float p = ps[i];
    out[i * 2 + 0] = p > 0.f ? p : 0.f;
    out[i * 2 + 1] = p < 0.f ? -p : 0.f;
  }
}

// Deployment LIF reference kernel, NHWC with per-channel beta/theta.
// Semantics of ONNX_LIF_operator/src/lif_op.cpp:41-49:
//   u = beta*mem + x; spike = (u >= theta); mem' = spike ? 0 : u.
void lif_forward(const float* x, const float* mem, const float* beta,
                 const float* theta, int64_t n_px, int64_t C, float* spike,
                 float* mem_out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const float* xi = x + i * C;
    const float* mi = mem + i * C;
    float* si = spike + i * C;
    float* oi = mem_out + i * C;
    for (int64_t c = 0; c < C; ++c) {
      float u = beta[c] * mi[c] + xi[c];
      if (u >= theta[c]) {
        si[c] = 1.f;
        oi[c] = 0.f;
      } else {
        si[c] = 0.f;
        oi[c] = u;
      }
    }
  }
}

// Fused per-window assembly: polarity formatting, timestamp normalization,
// flip augmentation, and all consumed encodings in ONE pass over the events
// (plus one prepass for min/max/finiteness). Replaces the sequence of
// numpy/ctypes calls of the split path in H5EventStream, whose per-call
// overhead dominates the host pipeline on small windows;
// semantics are bit-identical to the separate kernels above and to
// dataloader/base.py:71-127 + encodings.py:30-103.
//
// In:  xs/ys f32, ts f64 (raw, absolute), ps f32 raw (0/1 or ±1), n events.
// Out: cnt [H,W,2], mask [H,W,1], voxel [H,W,bins] (when build_voxel),
//      event_list [n,4] rows (tsn, y, x, p) of AUGMENTED values,
//      pol_mask [n,2], dt_out = raw ts[n-1]-ts[0], last_ts_out = raw ts[n-1].
// Returns 0 on success, 1 when any timestamp is non-finite (caller raises —
// the corrupted-recording guard of base.py:90-98).
int ev_window_assemble(const float* xs, const float* ys, const double* ts,
                       const float* ps_in, int64_t n, int64_t H, int64_t W,
                       int64_t bins, int flip_h, int flip_v, int flip_p,
                       int build_voxel, int round_ts, float* cnt /*H*W*2*/,
                       float* mask /*H*W*/, float* voxel /*H*W*bins*/,
                       float* event_list /*n*4*/, float* pol_mask /*n*2*/,
                       double* dt_out, double* last_ts_out) {
  std::memset(cnt, 0, sizeof(float) * H * W * 2);
  std::memset(mask, 0, sizeof(float) * H * W);
  if (build_voxel) std::memset(voxel, 0, sizeof(float) * H * W * bins);
  *dt_out = 0.0;
  *last_ts_out = 0.0;
  if (n == 0) return 0;

  // prepass: ts range + finiteness, ps minimum (the ±1 conversion rule of
  // base.py:85-88 converts only all-non-negative polarity streams)
  double lo = ts[0], hi = ts[0];
  float ps_min = ps_in[0];
  bool finite = true;
  for (int64_t i = 0; i < n; ++i) {
    double t = ts[i];
    if (!std::isfinite(t)) finite = false;
    lo = std::min(lo, t);
    hi = std::max(hi, t);
    ps_min = std::min(ps_min, ps_in[i]);
  }
  if (!finite) return 1;
  *dt_out = ts[n - 1] - ts[0];
  *last_ts_out = ts[n - 1];
  const bool to_pm1 = ps_min >= 0.f;
  const double range = hi - lo;
  const float vscale = (float)(bins - 1);

  for (int64_t i = 0; i < n; ++i) {
    float x = flip_h ? (float)(W - 1) - xs[i] : xs[i];
    float y = flip_v ? (float)(H - 1) - ys[i] : ys[i];
    float p = to_pm1 ? ps_in[i] * 2.f - 1.f : ps_in[i];
    if (flip_p) p = -p;
    // numpy computes (ts-min)/range in f64 then casts f32 — match exactly
    // (true division, not multiply-by-reciprocal: last-ulp parity)
    float tn = range > 0 ? (float)((ts[i] - lo) / range) : 0.f;

    event_list[i * 4 + 0] = tn;
    event_list[i * 4 + 1] = y;
    event_list[i * 4 + 2] = x;
    event_list[i * 4 + 3] = p;
    pol_mask[i * 2 + 0] = p > 0.f ? p : 0.f;
    pol_mask[i * 2 + 1] = p < 0.f ? -p : 0.f;

    int64_t xi = (int64_t)x;
    int64_t yi = (int64_t)y;
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    int64_t px = yi * W + xi;
    cnt[px * 2 + (p > 0.f ? 0 : 1)] += p * p;
    mask[px] = std::fabs(p) > 0.f ? 1.f : 0.f;
    if (build_voxel) {
      float tb = tn * vscale;
      if (round_ts) tb = std::nearbyint(tb);
      float* vp = voxel + px * bins;
      int64_t b0 = (int64_t)std::floor(tb);
      for (int64_t b = std::max<int64_t>(0, b0);
           b <= std::min(bins - 1, b0 + 1); ++b) {
        float w = 1.f - std::fabs(tb - (float)b);
        if (w > 0.f) vp[b] += p * w;
      }
    }
  }
  return 0;
}

// Normalize timestamps to [0, 1] in place and return (last-first) duration
// (dataloader/base.py:89-99).
double ev_normalize_ts(double* ts, int64_t n) {
  if (n == 0) return 0.0;
  double lo = ts[0], hi = ts[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = std::min(lo, ts[i]);
    hi = std::max(hi, ts[i]);
  }
  double range = hi - lo;
  if (range > 0) {
    for (int64_t i = 0; i < n; ++i) ts[i] = (ts[i] - lo) / range;
  } else {
    for (int64_t i = 0; i < n; ++i) ts[i] = 0.0;
  }
  return range;
}

}  // extern "C"
