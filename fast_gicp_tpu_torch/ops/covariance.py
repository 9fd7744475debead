"""Per-point covariances: RBF kernel density, k nearest neighbours and
adaptive-radius windows, with the reference's five regularizations (port
of `fast_gicp_tpu.ops.covariance`).

RBF: for each query q, w_j = exp(-kernel_width |q - x_j|^2) if
|q - x_j| <= max_dist else 0; mean = sum w x / sum w;
cov = sum w x x^T / sum w - mean mean^T (covariance_estimation_rbf.cu:40-84).
The moments come from the RBF kernel (`cuda_kernels.rbf_moments`) about the
cloud's masked mean: covariances are translation-invariant, and centering
keeps the E[x x^T] - mu mu^T finalize from cancelling at large coordinates.

kNN: the second moment of each point's k nearest neighbours about their
mean (fast_gicp_impl.hpp:253-298).  As on the JAX package's TPU path:
  * approx=True with `plane` or `none`: the fused selection-and-moments
    kernel (`cuda_kernels.knn_moments`) over bbox-ranked slabs of 128-point
    candidate tiles, moments about each query tile's first point;
  * approx=True with the other regularizations: the neighbour lists of
    `neighbors.knn_search_culled` (the `knn_slab` kernel over the 16
    nearest 256-point tiles), then a plain-torch gather of the neighbours
    and their moments;
  * approx=False: the exact lists of `neighbors.knn_search` (the same
    `knn_slab` kernel with every target tile a candidate; the JAX package
    runs an XLA top_k there), then the same epilogue.

Adaptive: each point's k-th-neighbour distance bracketed on a geometric
squared-radius ladder (`cuda_kernels.radius_count`), then the moments of
every point inside that radius about the cloud's masked mean
(`cuda_kernels.radius_window`, full f32).

Regularizations (fast_gicp_impl.hpp:267-297): none, plane, min_eig,
normalized_min_eig and frobenius, the same in every estimator
(`regularize_cov_cols` on sym-6 columns, `regularize_covariances` on
(N, 3, 3) matrices).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import device as _device
from ..precision import f32_matmuls
from . import cuda_kernels, linalg3, soa
from .neighbors import (  # noqa: F401  (masked_mean is part of this module's API)
    _masked_target, knn_search, knn_search_culled, masked_mean, select_candidate_tiles,
)

REGULARIZATION_METHODS = ("none", "plane", "min_eig", "normalized_min_eig", "frobenius")
_MIN_EIG = 1e-3  # the reference's eigenvalue floor and Frobenius lambda


def _frobenius(covs):
    """((C + 1e-3 I)^-1 / ||.||_F)^-1 of (..., 3, 3) (fast_gicp_impl.hpp:269-274)."""
    C = covs + _MIN_EIG * torch.eye(3, dtype=covs.dtype, device=covs.device)
    C_inv = linalg3.inv3(C)
    nrm = torch.sqrt(torch.sum(C_inv * C_inv, dim=(-2, -1), keepdim=True))
    return linalg3.inv3(C_inv / nrm)


def regularize_cov_cols(C, method: str):
    """A reference regularization mode on sym-6 covariance columns (..., 6, N):
    plane: I - (1 - 1e-3) v v^T with v the smallest eigenvector;
    min_eig: eigenvalues clamped at >= 1e-3; normalized_min_eig: the clamp
    of C / max(|e_big|, 1e-30); frobenius: as `_frobenius`; none: C."""
    if method == "none":
        return C
    if method == "plane":
        return soa.plane_covs_cols(C)
    if method == "min_eig":
        return soa.clamp_eigs_cols(C, _MIN_EIG)
    if method == "normalized_min_eig":
        # V max(w / w_big, eps) V^T == clamp(C / e_big, eps)
        _e_small, _e_mid, e_big = soa.eigvals_sym_cols(C)
        return soa.clamp_eigs_cols(C / torch.clamp(e_big.abs(), min=1e-30)[..., None, :],
                                   _MIN_EIG)
    if method == "frobenius":
        covs = soa.sym_cols_to_rows9(C).reshape(*C.shape[:-2], C.shape[-1], 3, 3)
        return soa.sym_cols_from_covs(_frobenius(covs))
    raise ValueError(f"unknown regularization method: {method}")


def regularize_covariances(covs, method: str):
    """A reference regularization mode on (..., N, 3, 3) covariances: none
    returns them, frobenius works on the matrices as given, the others on
    their symmetric part through `regularize_cov_cols`."""
    if method == "none":
        return covs
    if method == "frobenius":
        return _frobenius(covs)
    if method not in REGULARIZATION_METHODS:
        raise ValueError(f"unknown regularization method: {method}")
    cols = regularize_cov_cols(soa.sym_cols_from_covs(linalg3.symmetrize(covs)), method)
    return soa.sym_cols_to_rows9(cols).reshape(covs.shape)


def _finalize_rows16(m, min_weight: float):
    """(16, N) moment rows [w, sum w y (3), sum w y y^T (9, row-major), pad]
    -> (6, N) sym covariance columns, the off-diagonal sums symmetrized."""
    inv_w = 1.0 / torch.clamp(m[0], min=min_weight)
    mean = [m[1] * inv_w, m[2] * inv_w, m[3] * inv_w]
    return torch.stack(
        [
            m[4] * inv_w - mean[0] * mean[0],
            0.5 * (m[5] + m[7]) * inv_w - mean[0] * mean[1],
            0.5 * (m[6] + m[10]) * inv_w - mean[0] * mean[2],
            m[8] * inv_w - mean[1] * mean[1],
            0.5 * (m[9] + m[11]) * inv_w - mean[1] * mean[2],
            m[12] * inv_w - mean[2] * mean[2],
        ]
    )


def rbf_covariance_cols(points, mask, kernel_width: float = 0.5,
                        max_dist: float = 3.0, method: str = "plane"):
    """RBF covariances as sym-6 columns (6, N) on the points' device,
    regularized by `method`."""
    m = cuda_kernels.rbf_moments(points, mask, points, mask,
                                 masked_mean(points, mask), kernel_width,
                                 max_dist)
    return regularize_cov_cols(_finalize_rows16(m, 1e-12), method)


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


def _neighbour_cov_cols(points, idx, sq):
    """(6, N) covariance columns of the (N, k) neighbour lists `idx` with
    squared distances `sq`: the neighbours' second moment about their mean,
    divided by the valid-neighbour count.  Parked (masked) sentinels
    (sq >= 1e17) are weighted out, or the padding they index would drag a
    covariance toward it; the gather reads the uncentered points."""
    w = (sq < 1e17).to(points.dtype)  # (N, k)
    cnt = torch.clamp(w.sum(1), min=1.0)
    nbrs = points[idx.long()]  # (N, k, 3)
    mean = (w[:, :, None] * nbrs).sum(1) / cnt[:, None]
    c = (nbrs - mean[:, None, :]) * w[:, :, None]
    c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
    inv = 1.0 / cnt
    return torch.stack([(c0 * c0).sum(-1) * inv, (c0 * c1).sum(-1) * inv,
                        (c0 * c2).sum(-1) * inv, (c1 * c1).sum(-1) * inv,
                        (c1 * c2).sum(-1) * inv, (c2 * c2).sum(-1) * inv])


def knn_covariance_cols(points, mask, k: int = 20, method: str = "plane",
                        approx: bool = True):
    """kNN covariances as sym-6 columns (6, N) on the points' device.

    approx=True needs N a multiple of 256 and at least 512 (padded clouds
    are 2048-multiples).  With `plane` or `none` it runs the fused
    selection-and-moments contract: each query tile of 256 points searches
    its 16 nearest 128-point target tiles by bbox gap, with distance ties
    broken at 2^-11 relative quantization (the TPU kernel's packed keys).
    With `min_eig`, `normalized_min_eig` or `frobenius` it takes the
    neighbour lists of `knn_search_culled` (16 nearest 256-point tiles,
    exact f32 distances).  approx=False takes the exact k-NN of
    `knn_search` on any N.  The slab searches keep k <= 32."""
    n = points.shape[0]
    if approx:
        if n % cuda_kernels.KNN_TILE or n < 2 * cuda_kernels.KNN_TILE:
            raise ValueError(
                f"knn covariances need a cloud of >= 512 points in a multiple of "
                f"256 (pad it: utils.padding.pad_points), got {n}"
            )
        if method in ("plane", "none"):
            mom, _kth, _excluded = _knn_moment_cols_fused(points, mask, k)
            return regularize_cov_cols(_finalize_mom_cols(mom), method)
        idx, sq, _certified = knn_search_culled(points, points, mask, k,
                                                device=points.device)
    else:
        idx, sq = knn_search(points, points, mask, k, device=points.device)
    return regularize_cov_cols(_neighbour_cov_cols(points, idx, sq), method)


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


def covariances_from_neighbors(points, neighbor_idx, method: str = "plane"):
    """(N, 3, 3) covariances of (N, 3) points from externally supplied kNN
    indices (N, k), on the points' device: the device half of the
    reference's CPU_PARALLEL_KDTREE path (a host kd-tree feeds the
    neighbour lists, fast_vgicp_cuda_impl.hpp:152-167): each neighbourhood's
    second moment about its mean, divided by k, then `method`."""
    idx = torch.as_tensor(neighbor_idx, device=points.device).long()
    nbrs = points[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = (centered[..., :, None] * centered[..., None, :]).sum(dim=1) / idx.shape[1]
    return regularize_covariances(cov, method)


def default_radius_ladder(r0: float = 0.04, ratio: float = 1.3, num: int = 20):
    """Squared-radius ladder of the adaptive-radius estimator: geometric
    radii r0 * ratio^l (0.04 m .. ~5.9 m by default), squared, float32."""
    r = r0 * ratio ** np.arange(num)
    return (r * r).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ladder_on(ladder: tuple, device: torch.device):
    """The (L,) float32 squared-radius ladder as a constant on `device`,
    uploaded once a device and ladder from pinned memory (`device.upload`):
    a pageable copy made each call waited on the stream and could not be
    captured in a CUDA graph."""
    return _device.upload(np.asarray(ladder, np.float32), device)


def radius_window_moments(query, qmask, target, tmask, r2_ladder, k: int, center):
    """(16, Nq) moment rows [n, sum y (3), sum y y^T (9), 0 (3)], y = x -
    center, over each query's k-th-neighbour window: the smallest rung of
    the (L,) squared-radius ladder that holds >= k targets, or the last
    rung if none does.  `center` must be the full cloud's mean.  The
    clouds are packed, and the target's tile boxes built, once for both
    passes."""
    inputs = cuda_kernels.radius_inputs(query, qmask, target, tmask, center)
    cnt = cuda_kernels.radius_count(query, qmask, target, tmask, center, r2_ladder, inputs)
    return cuda_kernels.radius_window(query, qmask, target, tmask, center,
                                      window_radii(cnt, r2_ladder, k), inputs)


def window_radii(cnt, r2_ladder, k: int):
    """(Nq,) squared window radius of each query from its (L, Nq) ladder
    counts: the smallest rung holding >= k targets, or the last rung."""
    enough = cnt >= float(k)
    first = torch.argmax(enough.to(torch.int32), dim=0)  # the first maximum
    rung = torch.where(enough.any(dim=0), first, torch.full_like(first, cnt.shape[0] - 1))
    return r2_ladder[rung].contiguous()


def adaptive_radius_covariance_cols(points, mask, k: int = 20, method: str = "plane",
                                    ladder=None):
    """Adaptive-radius covariances as sym-6 columns (6, N) on the points'
    device: the moments of every point within each point's k-th-neighbour
    radius (bracketed on `ladder`, default `default_radius_ladder()`),
    about the cloud's masked mean, then `method`."""
    r2 = _ladder_on(tuple(np.asarray(default_radius_ladder() if ladder is None else ladder,
                                     np.float32).tolist()), points.device)
    m = radius_window_moments(points, mask, points, mask, r2, k, masked_mean(points, mask))
    return regularize_cov_cols(_finalize_rows16(m, 1.0), method)


@f32_matmuls
def adaptive_radius_covariances(points, mask, k: int = 20, method: str = "plane",
                                ladder=None, device="cuda"):
    """(N, 3, 3) view of `adaptive_radius_covariance_cols` for an (N, 3)
    cloud with an (N,) bool mask.  Runs on `device` (CUDA unless the caller
    asks for the CPU)."""
    dev = _device.resolve(device)
    points = _device.as_f32(points, dev)
    mask = _device.as_bool(mask, dev)
    cols = adaptive_radius_covariance_cols(points, mask, k, method, ladder)
    return soa.sym_cols_to_rows9(cols).reshape(points.shape[0], 3, 3)


def estimate_covariance_cols(points, mask, method: str, k: int = 20,
                             regularization: str = "plane",
                             kernel_width: float = 0.5,
                             kernel_max_dist: float = 3.0):
    """Covariance estimation selector, sym-6 columns (6, N): "knn", "rbf"
    or "adaptive" (the one-dispatch fresh registrations' in-graph
    estimators)."""
    if method == "knn":
        return knn_covariance_cols(points, mask, k=k, method=regularization)
    if method == "rbf":
        return rbf_covariance_cols(points, mask, kernel_width=kernel_width,
                                   max_dist=kernel_max_dist, method=regularization)
    if method == "adaptive":
        return adaptive_radius_covariance_cols(points, mask, k=k, method=regularization)
    raise ValueError(f"no in-graph estimator for method: {method}")
