"""Per-point covariances: RBF kernel density and k nearest neighbours
(port of the RBF and fused-kNN paths of `fast_gicp_tpu.ops.covariance`).

RBF: for each query q, w_j = exp(-kernel_width |q - x_j|^2) if
|q - x_j| <= max_dist else 0; mean = sum w x / sum w;
cov = sum w x x^T / sum w - mean mean^T (covariance_estimation_rbf.cu:40-84).
The moments come from the RBF kernel (`cuda_kernels.rbf_moments`) about the
cloud's masked mean: covariances are translation-invariant, and centering
keeps the E[x x^T] - mu mu^T finalize from cancelling at large coordinates.

kNN: the second moment of each point's k nearest neighbours about their
mean (fast_gicp_impl.hpp:253-298), from the fused selection-and-moments
kernel (`cuda_kernels.knn_moments`) over bbox-ranked candidate slabs, with
moments about each query tile's first point.

Both end in PLANE (or no) regularization.  The other regularizations, the
exact (approx=False) kNN search and the adaptive-radius estimator run
kernels that are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..precision import f32_matmuls
from . import cuda_kernels, soa
from .neighbors import _masked_target, select_candidate_tiles

_PORTED_REGULARIZATIONS = ("plane", "none")


def _check_regularization(method):
    if method not in _PORTED_REGULARIZATIONS:
        raise NotImplementedError(
            f"regularization {method!r}: only 'plane' and 'none' are ported; "
            "the others are queued with the rest of GICP (ROADMAP.md)"
        )


def masked_mean(points, mask):
    """Mean of the valid rows of (N, 3) points (zeros if none)."""
    valid = mask.to(points.dtype)
    return torch.sum(points * valid[:, None], dim=0) / torch.clamp(
        torch.sum(valid), min=1.0
    )


def rbf_covariance_cols(points, mask, kernel_width: float = 0.5,
                        max_dist: float = 3.0, method: str = "plane"):
    """RBF covariances as sym-6 columns (6, N) on the points' device.
    `method` is "plane" or "none"."""
    _check_regularization(method)
    m = cuda_kernels.rbf_moments(points, mask, points, mask,
                                 masked_mean(points, mask), kernel_width,
                                 max_dist)
    inv_w = 1.0 / torch.clamp(m[0], min=1e-12)
    mean = [m[1] * inv_w, m[2] * inv_w, m[3] * inv_w]
    cov6 = torch.stack(
        [
            m[4] * inv_w - mean[0] * mean[0],
            0.5 * (m[5] + m[7]) * inv_w - mean[0] * mean[1],
            0.5 * (m[6] + m[10]) * inv_w - mean[0] * mean[2],
            m[8] * inv_w - mean[1] * mean[1],
            0.5 * (m[9] + m[11]) * inv_w - mean[1] * mean[2],
            m[12] * inv_w - mean[2] * mean[2],
        ]
    )
    return soa.plane_covs_cols(cov6) if method == "plane" else cov6


@f32_matmuls
def rbf_covariances(points, mask, kernel_width: float = 0.5,
                    max_dist: float = 3.0, method: str = "plane",
                    device="cuda"):
    """(N, 3, 3) RBF kernel-density covariances of an (N, 3) cloud with an
    (N,) bool mask.  Defaults match fast_vgicp_cuda_impl.hpp:24-31.  Runs on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    points = _device.as_f32(points, dev)
    mask = _device.as_bool(mask, dev)
    cols = rbf_covariance_cols(points, mask, kernel_width, max_dist, method)
    return soa.sym_cols_to_rows9(cols).reshape(points.shape[0], 3, 3)


_CAND_TILE = 128  # target points per candidate tile
_CAND_TILES = 16  # candidate tiles per 256-query tile: a 2,048-wide slab


def _knn_moment_cols_fused(points, mask, k):
    """Raw kNN moment rows (10, N), k-th distances (N,) and the excluded
    tiles' squared bbox gaps (N / 256,) from the fused kernel: each
    256-query tile searches its 16 nearest 128-point target tiles.  mom
    rows are [count, sum y (3), sym-6 sum y y^T] about per-tile local
    origins (center-invariant finalize only)."""
    n = points.shape[0]
    Q, T = n // cuda_kernels.KNN_TILE, n // _CAND_TILE
    tgt = _masked_target(points, mask)
    cidx, excluded_sq = select_candidate_tiles(
        points.reshape(Q, cuda_kernels.KNN_TILE, 3),
        tgt.reshape(T, _CAND_TILE, 3),
        min(_CAND_TILES, T),
    )
    ones = torch.ones(n, dtype=torch.bool, device=points.device)
    mom, kth = cuda_kernels.knn_moments(points, ones, points, mask, cidx, k,
                                        cand_tile=_CAND_TILE)
    return mom, kth, excluded_sq


def _finalize_mom_cols(mom):
    """(10, N) raw moment rows -> (6, N) sym covariance columns (divides
    by the valid-neighbour count; the reference divides by k, identical
    whenever the cloud has >= k valid points)."""
    inv = 1.0 / torch.clamp(mom[0], min=1.0)
    mean = mom[1:4] * inv
    return torch.stack(
        [
            mom[4] * inv - mean[0] * mean[0],
            mom[5] * inv - mean[0] * mean[1],
            mom[6] * inv - mean[0] * mean[2],
            mom[7] * inv - mean[1] * mean[1],
            mom[8] * inv - mean[1] * mean[2],
            mom[9] * inv - mean[2] * mean[2],
        ]
    )


def knn_covariance_cols(points, mask, k: int = 20, method: str = "plane",
                        approx: bool = True):
    """kNN covariances as sym-6 columns (6, N) on the points' device.

    The fused selection-and-moments contract on every device: the card
    runs the `knn_moments` kernel, the CPU its plain version.  Each query
    tile of 256 points searches its 16 nearest 128-point target tiles by
    bbox gap, with distance ties broken at 2^-11 relative quantization
    (the TPU kernel's packed keys).  Needs N a multiple of 256 and at
    least 512 (padded clouds are 2048-multiples).  `method` is "plane" or
    "none"; approx=False (the exact full search) is not ported yet."""
    _check_regularization(method)
    if not approx:
        raise NotImplementedError(
            "exact kNN covariances (approx=False) run the k-NN slab kernel, "
            "which is queued with the rest of GICP (ROADMAP.md)"
        )
    n = points.shape[0]
    if n % cuda_kernels.KNN_TILE or n < 2 * cuda_kernels.KNN_TILE:
        raise ValueError(
            f"knn covariances need a cloud of >= 512 points in a multiple of "
            f"256 (pad it: utils.padding.pad_points), got {n}"
        )
    mom, _kth, _excluded = _knn_moment_cols_fused(points, mask, k)
    cov6 = _finalize_mom_cols(mom)
    return soa.plane_covs_cols(cov6) if method == "plane" else cov6


@f32_matmuls
def knn_covariances(points, mask, k: int = 20, method: str = "plane",
                    approx: bool = True, device="cuda"):
    """(N, 3, 3) kNN covariances of an (N, 3) cloud with an (N,) bool mask
    (includes the point itself, like the reference kd-tree,
    fast_gicp_impl.hpp:257-265).  Runs on `device` (CUDA unless the caller
    asks for the CPU)."""
    dev = _device.resolve(device)
    points = _device.as_f32(points, dev)
    mask = _device.as_bool(mask, dev)
    cols = knn_covariance_cols(points, mask, k, method, approx)
    return soa.sym_cols_to_rows9(cols).reshape(points.shape[0], 3, 3)


def estimate_covariance_cols(points, mask, method: str, k: int = 20,
                             regularization: str = "plane",
                             kernel_width: float = 0.5,
                             kernel_max_dist: float = 3.0):
    """Covariance estimation selector, sym-6 columns (6, N): "knn" or
    "rbf" (the one-dispatch fresh registrations' in-graph estimators)."""
    if method == "knn":
        return knn_covariance_cols(points, mask, k=k, method=regularization)
    if method == "rbf":
        return rbf_covariance_cols(points, mask, kernel_width=kernel_width,
                                   max_dist=kernel_max_dist, method=regularization)
    if method == "adaptive":
        raise NotImplementedError(
            "adaptive-radius covariances run the count and window kernels, "
            "which are queued with the rest of GICP (ROADMAP.md)"
        )
    raise ValueError(f"no in-graph estimator for method: {method}")
