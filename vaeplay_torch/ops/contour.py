"""Contour extraction on the host -- port of vaeplay_tpu/ops/contour.py (the
reference's skimage/cv2/rdp trio, tools/utils.py:73-125, and
find_tensor_contour, networks_BC.py:26-36).

The tracer is the repo's C++ marching squares (native/contour.cpp), which
the port compiles itself with g++ at first use into
`vaeplay_torch/_build/contour-<digest>.so` (the digest covers the source and
the flags) and loads with ctypes. It does not load the tracked
native/libvaeplay_contour.so, which is built with -march=native for
whichever machine made it. A failed build raises with the compiler's
output: there is no pure-Python tracer to fall back to, which on the card's
path would hide a trace a hundred times slower.

Batched outputs are fixed capacity plus a count: (B, max_points, 2) float32
[x, y] points and (B,) int32 counts.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from vaeplay_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "contour.cpp"
# no -march=native: the library is built where it runs, for any x86-64 or
# arm64 host; no contraction into FMAs, so that every build rounds alike
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off"]

_F32P = ctypes.POINTER(ctypes.c_float)
_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"contour-{digest}.so"


def build() -> Path:
    """Compile native/contour.cpp unless it is built already; returns the
    library's path. The compiler writes a name of this process and thread,
    which is then renamed into place, so concurrent builds (test workers)
    never load a half-written file. Raises with the compiler's output when
    the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the contour tracer from {SOURCE} failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The tracer library, built on first use, with its C signatures set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.vaeplay_find_largest_contour.restype = ctypes.c_int
            lib.vaeplay_find_largest_contour.argtypes = [
                _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _F32P]
            lib.vaeplay_batch_contours.restype = None
            lib.vaeplay_batch_contours.argtypes = [
                _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, _F32P, ctypes.POINTER(ctypes.c_int32)]
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def find_contour(mask_img: np.ndarray, level: float = 0.8) -> np.ndarray:
    """Largest contour of a (binary) mask as [x, y] int64 points -- the
    reference's tools/utils.py:73-109 (round half-even, drop consecutive
    repeats and the closing point, flip to [x, y]); (0, 2) when there is
    none."""
    img = np.ascontiguousarray(mask_img, np.float32)
    h, w = img.shape
    out = np.empty((h * w, 2), np.float32)
    n = load().vaeplay_find_largest_contour(_ptr(img), h, w, level, h * w, _ptr(out))
    return out[:n].astype(np.int64) if n else np.empty((0, 2), np.int64)


def resample_points(contour: np.ndarray, max_points: int = 256) -> np.ndarray:
    """Uniform decimation keeping both ends (reference tools/utils.py:111-125)."""
    n = len(contour)
    if n > max_points:
        step = (n - 2) / (max_points - 2)
        select = np.round(np.arange(1, max_points - 1) * step, decimals=1)
        select = np.concatenate([[0], select, [n - 1]], axis=0).astype(np.int32)
        return np.asarray(contour[select])
    return contour


def rdp_simplify(points: np.ndarray, epsilon: float = 4.0) -> np.ndarray:
    """Ramer-Douglas-Peucker simplification of a polyline (the `rdp` package
    of reference datasets/dataset.py:253, epsilon 4), iterative; distances on
    the first two columns."""
    n = len(points)
    if n < 3:
        return np.asarray(points)
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    xy = np.asarray(points[:, :2], np.float64)
    while stack:
        s, e = stack.pop()
        if e <= s + 1:
            continue
        a, d = xy[s], xy[e] - xy[s]
        norm = np.hypot(d[0], d[1])
        seg = xy[s + 1:e]
        if norm < 1e-12:
            dist = np.hypot(seg[:, 0] - a[0], seg[:, 1] - a[1])
        else:
            dist = np.abs(d[0] * (a[1] - seg[:, 1]) - d[1] * (a[0] - seg[:, 0])) / norm
        imax = int(np.argmax(dist))
        if dist[imax] > epsilon:
            idx = s + 1 + imax
            keep[idx] = True
            stack.append((s, idx))
            stack.append((idx, e))
    return np.asarray(points[keep])


def batch_find_contours(masks: np.ndarray, max_points: int = 256, threshold: float = 0.5,
                        level: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """find_tensor_contour (networks_BC.py:26-36), batched: each (H, W) map of
    `masks` (B, H, W) is thresholded at `threshold`, its largest contour
    traced at `level` and decimated to max_points. Returns (pts (B,
    max_points, 2) float32 [x, y], zero past each count; counts (B,) int32).
    One C call, single-threaded."""
    masks = np.ascontiguousarray(masks, np.float32)
    b, h, w = masks.shape
    out = np.zeros((b, max_points, 2), np.float32)
    counts = np.zeros((b,), np.int32)
    load().vaeplay_batch_contours(_ptr(masks), b, h, w, threshold, level, max_points,
                                  _ptr(out), _ptr(counts, ctypes.c_int32))
    return out, counts
