"""The port's host library (``evflow_torch/csrc/evflow_host.cpp`` through
``evflow_torch.data.native``) against the reference package's
``NativeEncoder``, function by function and bit for bit; its build at first
use (concurrent builds, a failed build raising with the compiler's output)
and the stream's pool and hot-filter update against the reference's
formulas."""

import shutil
import threading

import numpy as np
import pytest

from evflow.data import native as jnative
from evflow_torch.data import h5_stream as port_stream
from evflow_torch.data import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no host C++ compiler")


@pytest.fixture(scope="module")
def encoders():
    return native.NativeEncoder(), jnative.NativeEncoder()


def draw_events(seed, n=600, H=24, W=20, pm01=False, frac=False):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, W + 1, n) if frac else rng.integers(0, W, n)
    ys = rng.uniform(-1, H + 1, n) if frac else rng.integers(0, H, n)
    ts = np.sort(rng.uniform(0, 1, n)) + 100.0
    ps = rng.integers(0, 2, n) if pm01 else rng.choice([-1.0, 1.0], n)
    return (xs.astype(np.float32), ys.astype(np.float32), ts, ps.astype(np.float32), (H, W))


@pytest.mark.parametrize("frac", [False, True], ids=["integer_xy", "fractional_xy"])
def test_encodings_bit_equal_reference(encoders, frac):
    ours, ref = encoders
    xs, ys, ts, ps, res = draw_events(0, frac=frac)
    tsn = ((ts - ts[0]) / (ts[-1] - ts[0])).astype(np.float32)
    np.testing.assert_array_equal(ours.count_encoding(xs, ys, ps, res),
                                  ref.count_encoding(xs, ys, ps, res))
    np.testing.assert_array_equal(ours.mask_encoding(xs, ys, ps, res),
                                  ref.mask_encoding(xs, ys, ps, res))
    np.testing.assert_array_equal(ours.image(xs, ys, ps * 0.3, res),
                                  ref.image(xs, ys, ps * 0.3, res))
    np.testing.assert_array_equal(ours.polarity_mask(ps), ref.polarity_mask(ps))
    for bins, rnd in ((2, False), (5, False), (3, True)):
        np.testing.assert_array_equal(ours.voxel_encoding(xs, ys, tsn, ps, bins, res, rnd),
                                      ref.voxel_encoding(xs, ys, tsn, ps, bins, res, rnd))
    a, ra = ours.normalize_ts(ts.copy())  # in place, as the reference's
    b, rb = ref.normalize_ts(ts.copy())
    np.testing.assert_array_equal(a, b)
    assert ra == rb


@pytest.mark.parametrize("flips,pm01,voxel,rnd", [
    ((False, False, False), True, True, False),
    ((True, True, True), False, True, True),
    ((True, False, False), True, False, False),
])
def test_window_assemble_bit_equal_reference(encoders, flips, pm01, voxel, rnd):
    ours, ref = encoders
    xs, ys, ts, ps, res = draw_events(1, pm01=pm01)
    kw = dict(flip_h=flips[0], flip_v=flips[1], flip_p=flips[2], build_voxel=voxel,
              round_ts=rnd)
    a = ours.window_assemble(xs, ys, ts, ps, res, 4, **kw)
    b = ref.window_assemble(xs, ys, ts, ps, res, 4, **kw)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
    empty = ours.window_assemble(xs[:0], ys[:0], ts[:0], ps[:0], res, 4, **kw)
    assert empty[3].shape == (0, 4) and not empty[0].any() and empty[5:] == (0.0, 0.0)
    ts_bad = ts.copy()
    ts_bad[7] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        ours.window_assemble(xs, ys, ts_bad, ps, res, 4, **kw)


def test_lif_forward_bit_equal_reference():
    rng = np.random.default_rng(2)
    x, mem = (rng.normal(size=(2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    beta = rng.uniform(0, 1, 3).astype(np.float32)
    theta = rng.uniform(0.1, 0.8, 3).astype(np.float32)
    for a, b in zip(native.lif_forward(x, mem, beta, theta),
                    jnative.lif_forward(x, mem, beta, theta)):
        np.testing.assert_array_equal(a, b)


def test_library_is_the_ports_own_build():
    """Built from the port's source into its build directory, never the
    reference package's prebuilt library."""
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "evflow_torch"
    assert native.SOURCE.parent.name == "csrc"


def test_concurrent_builds_and_failed_build(tmp_path, monkeypatch):
    """Builds started at once each write their own temporary file and move
    it into place; a source that does not compile raises with the
    compiler's message, leaving no library behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    errors = []

    def one():
        try:
            native.build()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert [p.name for p in (tmp_path / "build").iterdir()] == [native.library_path().name]
    assert native.build() == 0.0

    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f() { return undeclared_name; }\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not native.library_path().exists()


def ref_pool(img, ph, pw):
    """The reference stream's pool."""
    H, W, C = img.shape
    return img[: H - H % ph, : W - W % pw].reshape(H // ph, ph, W // pw, pw, C).mean(axis=(1, 3))


@pytest.mark.parametrize("shape,kernel,layout", [
    ((64, 64, 2), (2, 2), "contiguous"), ((64, 64, 1), (2, 2), "contiguous"),
    ((65, 67, 5), (2, 2), "contiguous"), ((48, 48, 2), (3, 3), "contiguous"),
    ((64, 64, 2), (2, 2), "channel_planes"), ((64, 64, 2), (4, 2), "channel_planes"),
    ((32, 64, 2), (2, 8), "contiguous"),
])
def test_avg_pool_bit_equal_reference(shape, kernel, layout):
    """The strided pool against the reference's mean, on counts and on f32
    normals (where the order of the sums shows), in the layouts the stream
    pools: contiguous encodings and GT maps moved from ``[2, H, W]``."""
    rng = np.random.default_rng(3)
    H, W, C = shape
    for draw in (rng.poisson(0.7, (C, H, W)).astype(np.float32),
                 (rng.normal(size=(C, H, W)) * 1e3).astype(np.float32)):
        img = (np.moveaxis(draw, 0, -1) if layout == "channel_planes"
               else np.ascontiguousarray(np.moveaxis(draw, 0, -1)))
        np.testing.assert_array_equal(port_stream._avg_pool(img, *kernel), ref_pool(img, *kernel))


def test_hot_update_matches_reference_formula():
    rng = np.random.default_rng(4)
    cnt = rng.poisson(0.5, (40, 40, 2)).astype(np.float32)
    cnt[..., 0] -= rng.poisson(0.5, (40, 40))  # signed, as temporal_cnt's channel 0
    cnt[::7, ::5] = [1.0, -1.0]
    np.testing.assert_array_equal(port_stream._hot_update(cnt),
                                  (cnt.sum(-1) > 0).astype(np.float32))
