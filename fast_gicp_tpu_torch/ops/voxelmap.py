"""Dense raw voxel grid for VGICP (port of the main-path part of
`fast_gicp_tpu.ops.voxelmap`).

The target's voxels live in a compact (N + 1, 16) table of raw additive
sums [count, sum mu (3), sum cov (9 row-major), pad (3)] keyed by the
lowest point index in each voxel, plus a dense (ncells + 1,) index grid
from cell to that representative.  Row N of the table is an all-zero
sentinel: misses (out of grid, empty cell, masked point) resolve there and
read back count 0.  The JAX package's (ncells/8, 8)
`grid8` reshape and lane pick are a TPU gather workaround; here the grid is
a plain 1-D lookup.  The build is plain PyTorch ops (a scatter-min claim
and an `index_add_`), as it was plain XLA ops in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import soa

_COORD_SENTINEL = 2**30


def voxel_coord(points, resolution):
    """floor(p / resolution - 0.5) as int32 (fast_vgicp_voxel.hpp:158-160).

    A true division: multiplying by a reciprocal flips voxels at cell
    boundaries."""
    return torch.floor(points / resolution - 0.5).to(torch.int32)


class DenseRawGridMap(NamedTuple):
    """Raw accumulator map with a dense index grid."""

    rows: torch.Tensor  # (N + 1, 16) f32 raw sums; row N zeros
    grid: torch.Tensor  # (ncells + 1,) int64 cell -> representative or N;
    # the last slot is where out-of-grid points park (readers mask it)
    origin: torch.Tensor  # (3,) int32 voxel coord of cell 0
    resolution: float


def build_raw_grid(points, mask, resolution, covs, grid_dims):
    """Build a `DenseRawGridMap` from (N, 3) points and per-point
    covariances, given as (N, 3, 3), (N, 9) row-major or (6, N) sym-6
    columns."""
    n = points.shape[0]
    dtype, device = points.dtype, points.device
    gx, gy, gz = grid_dims
    ncells = gx * gy * gz

    coords = voxel_coord(points, resolution)
    origin = torch.min(
        torch.where(mask[:, None], coords, _COORD_SENTINEL), dim=0
    ).values
    rel = (coords - origin).to(torch.int64)
    inside = (
        mask & torch.all(rel >= 0, dim=-1)
        & (rel[:, 0] < gx) & (rel[:, 1] < gy) & (rel[:, 2] < gz)
    )
    flat = (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2]
    flat = torch.where(inside, flat, ncells)  # parked on the sentinel slot

    # Claim: lowest member point index per cell; unclaimed cells keep n
    # (-> the zero row).  Parked points claim the last slot, which every
    # reader masks by `inside`.
    point_idx = torch.arange(n, dtype=torch.int64, device=device)
    grid = torch.full((ncells + 1,), n, dtype=torch.int64, device=device)
    grid.scatter_reduce_(0, flat, point_idx, reduce="amin", include_self=True)
    rep = grid[flat]

    if covs.dim() == 3:
        cov9 = covs.reshape(n, 9)
    elif tuple(covs.shape) == (6, n):
        cov9 = soa.sym_cols_to_rows9(covs)
    else:
        cov9 = covs
    contrib = torch.cat(
        [
            torch.ones((n, 1), dtype=dtype, device=device),
            points,
            cov9,
            torch.zeros((n, 3), dtype=dtype, device=device),
        ],
        dim=1,
    ) * inside.to(dtype)[:, None]
    # Parked points carry vid == n and zeroed contribs -> row n stays zero.
    vid = torch.where(inside, rep, n)
    rows = torch.zeros((n + 1, 16), dtype=dtype, device=device)
    rows.index_add_(0, vid, contrib)
    return DenseRawGridMap(rows=rows, grid=grid, origin=origin,
                           resolution=float(resolution))


def lookup_raw_rows_cols(dmap: DenseRawGridMap, grid_dims, cx, cy, cz):
    """Gather raw accumulator rows (..., 16) for integer coord columns
    (...,) each; count 0 in a returned row means a miss."""
    gx, gy, gz = grid_dims
    ncells = gx * gy * gz
    rx = (cx - dmap.origin[0]).to(torch.int64)
    ry = (cy - dmap.origin[1]).to(torch.int64)
    rz = (cz - dmap.origin[2]).to(torch.int64)
    inside = (
        (rx >= 0) & (rx < gx) & (ry >= 0) & (ry < gy) & (rz >= 0) & (rz < gz)
    )
    flat = torch.where(inside, (rx * gy + ry) * gz + rz, ncells)
    n = dmap.rows.shape[0] - 1
    return dmap.rows[torch.where(inside, dmap.grid[flat], n)]


def auto_grid_dims(
    points,
    resolution: float,
    margin: int = 2,
    bucket: int = 32,
    max_cells: int = 64_000_000,
):
    """Static dense-grid dims for a host-side cloud, or None if the scene is
    too large for a dense grid.  Dims are rounded up to `bucket`
    multiples."""
    if resolution is None or resolution <= 0:
        return None
    pts = np.asarray(points)
    if pts.size == 0:
        return None
    return auto_grid_dims_from_extent(
        pts.min(axis=0), pts.max(axis=0), resolution,
        margin=margin, bucket=bucket, max_cells=max_cells,
    )


def auto_grid_dims_from_extent(
    lo_pt,
    hi_pt,
    resolution: float,
    margin: int = 2,
    bucket: int = 32,
    max_cells: int = 64_000_000,
):
    """`auto_grid_dims` from a precomputed (lo, hi) point extent."""
    if resolution is None or resolution <= 0:
        return None
    lo = np.floor(np.asarray(lo_pt) / resolution - 0.5)
    hi = np.floor(np.asarray(hi_pt) / resolution - 0.5)
    span = (hi - lo + 1 + 2 * margin).astype(np.int64)
    dims = tuple(int(d) for d in np.ceil(span / bucket) * bucket)
    # Python ints: an int64 product wraps for extents of ~2e6 cells a side
    if dims[0] * dims[1] * dims[2] > max_cells:
        return None
    return dims


def neighbor_offsets(method: str, radius: float = 1.5):
    """Static (K, 3) int32 offset list per search method
    (fast_vgicp_voxel.hpp:10-44; RADIUS = all integer offsets with
    ||o|| <= radius, fast_vgicp_cuda.cu:77-91)."""
    if method == "direct1":
        offs = [(0, 0, 0)]
    elif method == "direct7":
        offs = [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                (0, 0, 1), (0, 0, -1)]
    elif method == "direct27":
        offs = [(i - 1, j - 1, k - 1)
                for i in range(3) for j in range(3) for k in range(3)]
    elif method == "direct_radius":
        r = int(np.ceil(radius))
        offs = [
            (i, j, k)
            for i in range(-r, r + 1)
            for j in range(-r, r + 1)
            for k in range(-r, r + 1)
            if np.sqrt(i * i + j * j + k * k) <= radius
        ]
    else:
        raise ValueError(f"unknown neighbor search method: {method}")
    return np.asarray(offs, np.int32)
