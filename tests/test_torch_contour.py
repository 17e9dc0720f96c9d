"""The port's contour tracer (vaeplay_torch.ops.contour) against the JAX
package's (vaeplay_tpu.ops.contour): the same native source, compiled by the
port into its own build directory. Random blobs, the hand-computed
marching-squares goldens (rebuilt here), an empty mask, decimation and RDP,
and the build itself: its place, a failed build raising with the compiler's
output, and concurrent builds."""

import threading

import numpy as np
import pytest

from vaeplay_torch.ops import _build
from vaeplay_torch.ops import contour as T
from vaeplay_tpu.ops import contour as J


def _blobs(rng, b, h, w, soft: bool):
    """b maps of up to three ellipses each; soft ones scale the inside by
    uniform noise, so a threshold cuts through them."""
    ys, xs = np.mgrid[0:h, 0:w]
    out = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.2, 0.8, 2) * (w, h)
            rx, ry = rng.uniform(2, 0.3 * min(h, w), 2)
            out[i] += (((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0)
    out = np.minimum(out, 1.0)
    if soft:
        out *= rng.uniform(0.2, 1.0, out.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("seed,soft,max_points,threshold",
                         [(0, False, 256, 0.5), (1, True, 32, 0.5), (2, True, 16, 0.7),
                          (3, False, 64, 0.5)])
def test_batch_trace_matches_jax(seed, soft, max_points, threshold):
    """pts and counts equal the JAX module's, element for element, on a
    batch of random masks (the decimation to max_points included)."""
    masks = _blobs(np.random.default_rng(seed), 4, 66, 50, soft)
    got = T.batch_find_contours(masks, max_points, threshold=threshold)
    want = J.batch_find_contours(masks, max_points, threshold=threshold)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].max() > 0


@pytest.mark.parametrize("seed", [4, 5])
def test_find_resample_and_rdp_match_jax(seed):
    """find_contour at level 0.8 (int64 [x, y]), resample_points and
    rdp_simplify (epsilon 4 and 1.5) equal the JAX module's."""
    for mask in _blobs(np.random.default_rng(seed), 3, 40, 48, False):
        got, want = T.find_contour(mask * 255.0), J.find_contour(mask * 255.0)
        assert got.dtype == np.int64 and len(got) > 0
        np.testing.assert_array_equal(got, want)
        for mp in (8, 30, 1000):
            np.testing.assert_array_equal(T.resample_points(got, mp), J.resample_points(want, mp))
        for eps in (4.0, 1.5):
            np.testing.assert_array_equal(T.rdp_simplify(got, eps), J.rdp_simplify(want, eps))


def _cycle_key(pts):
    """A closed boundary up to rotation and direction."""
    pts = [tuple(int(v) for v in p) for p in pts]
    return min(tuple(seq[s:] + seq[:s]) for seq in (pts, pts[::-1]) for s in range(len(seq)))


def _mask(pixels, shape):
    m = np.zeros(shape, np.float32)
    for r, c in pixels:
        m[r, c] = 1.0
    return m


# (inside pixels (row, col), shape, expected [x, y] cycle): at level 0.8 the
# crossing sits 0.8 of the way from an outside pixel to its inside
# neighbour, so every vertex rounds onto the inside boundary pixel; a saddle
# cell averages 0.5 < 0.8, so diagonal neighbours disconnect
GOLDENS = {
    "2x2 block": ([(1, 1), (1, 2), (2, 1), (2, 2)], (4, 4),
                  [(1, 1), (2, 1), (2, 2), (1, 2)]),
    "3x2 block": ([(1, 1), (1, 2), (1, 3), (2, 1), (2, 2), (2, 3)], (5, 6),
                  [(1, 1), (2, 1), (3, 1), (3, 2), (2, 2), (1, 2)]),
    "block + saddle-diagonal pixel": ([(1, 1), (1, 2), (2, 1), (2, 2), (3, 3)], (5, 5),
                                      [(1, 1), (2, 1), (2, 2), (1, 2)]),
    "largest of two blocks": ([(1, 1), (1, 2), (2, 1), (2, 2), (5, 5), (5, 6), (5, 7), (6, 5),
                               (6, 6), (6, 7), (7, 5), (7, 6), (7, 7)], (9, 9),
                              [(5, 5), (6, 5), (7, 5), (7, 6), (7, 7), (6, 7), (5, 7), (5, 6)]),
    # a lone pixel's crossings all round onto it: empty after the dedupe
    "single pixel": ([(2, 2)], (5, 5), []),
    "two saddle pixels": ([(1, 1), (2, 2)], (4, 4), []),
    "empty mask": ([], (6, 7), []),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_goldens(name):
    """The hand-computed cases, through find_contour and through the batched
    trace (threshold 0.5 of the same binary mask), as the JAX module gives
    them."""
    pixels, shape, expected = GOLDENS[name]
    mask = _mask(pixels, shape)
    got = T.find_contour(mask)
    np.testing.assert_array_equal(got, J.find_contour(mask))
    assert len(got) == len(expected)
    if expected:
        assert _cycle_key(got) == _cycle_key(expected)
    pts, counts = T.batch_find_contours(mask[None], max_points=16)
    assert counts[0] == len(expected) and not pts[0, counts[0]:].any()
    np.testing.assert_array_equal(pts[0, :counts[0]], got.astype(np.float32))


def test_built_by_the_port_not_the_tracked_library():
    """The library is the port's own build under vaeplay_torch/_build/, next
    to the CUDA libraries; the tracked native/libvaeplay_contour.so is not
    what is loaded."""
    lib = T.load()
    assert lib._name == str(T.library_path())
    assert T.library_path().parent == _build.BUILD_DIR
    assert T.library_path().name.startswith("contour-")
    assert "native" not in T.library_path().parts


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "contour.cpp"
    bad.write_text("int vaeplay_batch_contours( { this is not C++\n")
    monkeypatch.setattr(T, "SOURCE", bad)
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as info:
        T.build()
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*"))  # no half-written library left


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Builds racing in several threads each rename a whole library into
    place; the result loads and traces."""
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(T.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    import ctypes

    ctypes.CDLL(str(paths[0])).vaeplay_batch_contours
