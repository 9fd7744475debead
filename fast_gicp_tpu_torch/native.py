"""ctypes loader for the repo's native host library (libfast_gicp_native.so,
`native/src/fast_gicp_native.cpp`, built by cmake into `native/build/`).

The port uses its multithreaded kd-tree kNN: the reference's
CPU_PARALLEL_KDTREE covariance feeder (fast_vgicp_cuda_impl.hpp:152-167),
host code that hands neighbour lists to the device; and its single-pass
`absmax` and int16 `quantize_i16`, which stage the ragged int16 upload of
`utils/kitti.run_odometry_scan`.  Without the built library each falls
back to numpy (an exact search; the same rint rounding, ties to even);
`available()` and `quantize_available()` say which one runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATHS = [
    os.path.join(_NATIVE_DIR, "build", "libfast_gicp_native.so"),
    os.path.join(os.path.dirname(__file__), "libfast_gicp_native.so"),
]

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for path in _LIB_PATHS:
        if os.path.exists(path):
            lib = ctypes.CDLL(path)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.knn_search.restype = None
            lib.knn_search.argtypes = [
                f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, i32p, f32p,
            ]
            if hasattr(lib, "absmax_f32"):  # builds of the library since the int16 upload
                lib.absmax_f32.restype = ctypes.c_float
                lib.absmax_f32.argtypes = [f32p, ctypes.c_longlong]
                lib.quantize_i16.restype = None
                lib.quantize_i16.argtypes = [f32p, ctypes.c_longlong, ctypes.c_float,
                                             ctypes.POINTER(ctypes.c_int16)]
            _lib = lib
            return lib
    return None


def available() -> bool:
    """Whether the native library is built and loads."""
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def knn_search(points: np.ndarray, queries: np.ndarray, k: int,
               n_threads: int = 0):
    """Exact kNN of each query among `points` on the host; returns
    (idx (Q, k) int32, sq_dist (Q, k) float32), nearest first.  A cloud of
    fewer than k points repeats its last neighbour, as the kd-tree does."""
    lib = _load()
    points = np.ascontiguousarray(points[:, :3], np.float32)
    queries = np.ascontiguousarray(queries[:, :3], np.float32)
    nq = queries.shape[0]
    idx = np.empty((nq, k), np.int32)
    dist = np.empty((nq, k), np.float32)
    if lib is None:
        # exact, chunked over the queries (a full Q x N distance matrix of a
        # raw scan would not fit), argpartition before the sort
        p_sq = np.einsum("ij,ij->i", points, points)[None, :]
        kk = min(k, points.shape[0])
        chunk = max(1, min(4096, nq))
        for lo in range(0, nq, chunk):
            q = queries[lo: lo + chunk]
            d = np.einsum("ij,ij->i", q, q)[:, None] - 2.0 * q @ points.T + p_sq
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            dp = np.take_along_axis(d, part, axis=1)
            order = np.argsort(dp, axis=1)
            ii = np.take_along_axis(part, order, axis=1)
            dd = np.maximum(np.take_along_axis(dp, order, axis=1), 0.0)
            if kk < k:
                ii = np.concatenate([ii, np.repeat(ii[:, -1:], k - kk, axis=1)], axis=1)
                dd = np.concatenate([dd, np.repeat(dd[:, -1:], k - kk, axis=1)], axis=1)
            idx[lo: lo + chunk] = ii
            dist[lo: lo + chunk] = dd
        return idx, dist
    lib.knn_search(_f32p(points), points.shape[0], _f32p(queries), nq, k,
                   n_threads, _i32p(idx), _f32p(dist))
    return idx, dist


def quantize_available() -> bool:
    """Whether the native `absmax` and `quantize_i16` run (else numpy)."""
    lib = _load()
    return lib is not None and hasattr(lib, "absmax_f32")


def absmax(a: np.ndarray) -> float:
    """max(|a|) over a float32 array, in one native pass (numpy without the
    library); NaN propagates in both."""
    a = np.ascontiguousarray(a, np.float32)
    if not quantize_available():
        return float(np.max(np.abs(a))) if a.size else 0.0
    return float(_lib.absmax_f32(_f32p(a), ctypes.c_longlong(a.size)))


def quantize_i16(src: np.ndarray, inv_scale: float, out: np.ndarray) -> None:
    """out[:] = rint(src * inv_scale) as int16, the product in float32 and
    ties rounded to even, in one native pass (numpy without the library).

    `out` must be C-contiguous int16 of src's size (it is written through);
    a `src` that is not contiguous float32 is copied first."""
    if out.dtype != np.int16 or out.size != src.size:
        raise ValueError(f"out must be int16 with {src.size} elements, got "
                         f"{out.dtype}/{out.size}")
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous (it is written through)")
    src = np.ascontiguousarray(src, np.float32)
    if not quantize_available():
        np.copyto(out.reshape(src.shape),
                  np.rint(src * np.float32(inv_scale)).astype(np.int16))
        return
    _lib.quantize_i16(_f32p(src), ctypes.c_longlong(src.size), ctypes.c_float(inv_scale),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
