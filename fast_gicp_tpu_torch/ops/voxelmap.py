"""Dense voxel grids for VGICP and NDT (port of the dense-grid part of
`fast_gicp_tpu.ops.voxelmap`).

Each map keeps its voxels in a compact (N + 1, width) table keyed by the
lowest point index in each voxel, plus a dense (ncells + 1,) index grid
from cell to that representative.  Row N of the table is an all-zero
sentinel: misses (out of grid, empty cell, masked point) resolve there and
read back count 0.  VGICP's `DenseRawGridMap` holds raw additive sums
[count, sum mu (3), sum cov (9 row-major), pad (3)]; NDT's `RawNdtGrid`
holds corner-relative moments and `NdtGridMap` finalized rows.  The JAX
package's (ncells/8, 8) `grid8` reshape and lane pick are a TPU gather
workaround; here the grid is a plain 1-D lookup.  The builds are plain
PyTorch ops (a scatter-min claim, an `index_add_`, a prefix-sum
compaction), as they were plain XLA ops in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import soa

_COORD_SENTINEL = 2**30

# NDT voxel covariances: eigenvalues clamped to >= MIN_EIG (ndt_cuda.cu:120-140).
# The finalized maps clamp here; the raw linearize kernels clamp in-kernel
# with the same value (`kMinEig`, csrc/ndt_linearize.cu), their plain
# versions with this constant.
MIN_EIG = 1e-3


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


def _claim(points, mask, resolution, grid_dims):
    """The dense grids' claim: each cell's lowest member point index.

    Returns (coords (N, 3) int32, origin (3,), inside (N,), grid
    (ncells + 1,), vid (N,)): `grid` maps a cell to its representative or N
    (unclaimed; out-of-grid and masked points park on the last slot, which
    every reader masks), `vid` each point's row, N where it is parked."""
    n = points.shape[0]
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
    flat = torch.where(inside, (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2], ncells)
    point_idx = torch.arange(n, dtype=torch.int64, device=points.device)
    grid = torch.full((ncells + 1,), n, dtype=torch.int64, device=points.device)
    grid.scatter_reduce_(0, flat, point_idx, reduce="amin", include_self=True)
    return coords, origin, inside, grid, torch.where(inside, grid[flat], n)


def build_raw_grid(points, mask, resolution, covs, grid_dims):
    """Build a `DenseRawGridMap` from (N, 3) points and per-point
    covariances, given as (N, 3, 3), (N, 9) row-major or (6, N) sym-6
    columns."""
    n = points.shape[0]
    dtype, device = points.dtype, points.device
    _coords, origin, inside, grid, vid = _claim(points, mask, resolution, grid_dims)
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
    rows = torch.zeros((n + 1, 16), dtype=dtype, device=device)
    rows.index_add_(0, vid, contrib)
    return DenseRawGridMap(rows=rows, grid=grid, origin=origin,
                           resolution=float(resolution))


def _lookup_ids(grid, origin, grid_dims, n, cx, cy, cz):
    """Representative-or-n ids of integer coord columns (...,) each;
    out-of-grid queries and empty cells give n, the zero row."""
    gx, gy, gz = grid_dims
    ncells = gx * gy * gz
    rx = (cx - origin[0]).to(torch.int64)
    ry = (cy - origin[1]).to(torch.int64)
    rz = (cz - origin[2]).to(torch.int64)
    inside = (
        (rx >= 0) & (rx < gx) & (ry >= 0) & (ry < gy) & (rz >= 0) & (rz < gz)
    )
    flat = torch.where(inside, (rx * gy + ry) * gz + rz, ncells)
    return torch.where(inside, grid[flat], n)


def lookup_raw_ids_cols(dmap: DenseRawGridMap, grid_dims, cx, cy, cz):
    """Row ids (...,) int64 into dmap.rows for integer coord columns (...,)
    each; a miss gives the zero row's (count 0)."""
    n = dmap.rows.shape[0] - 1
    return _lookup_ids(dmap.grid, dmap.origin, grid_dims, n, cx, cy, cz)


def lookup_raw_rows_cols(dmap: DenseRawGridMap, grid_dims, cx, cy, cz):
    """Gather raw accumulator rows (..., 16) for integer coord columns
    (...,) each; count 0 in a returned row means a miss."""
    return dmap.rows[lookup_raw_ids_cols(dmap, grid_dims, cx, cy, cz)]


class RawNdtGrid(NamedTuple):
    """Unfinalized NDT voxel map: per-voxel moments about each voxel's own
    corner o = (c + 1) res, so E[d d^T] - dmu dmu^T never cancels at cloud
    extents.  Consumers reconstruct the corner from the query coordinate and
    finalize (and MIN_EIG-clamp) inside the linearize kernel."""

    rows: torch.Tensor  # (N + 1, 10) [count, sum d (3), sum d d^T sym-6 (6)]; row N zeros
    grid: torch.Tensor  # (ncells + 1,) int64 cell -> representative or N; the
    # last slot is where out-of-grid points park (readers mask it)
    origin: torch.Tensor  # (3,) int32 voxel coord of cell 0
    resolution: float
    dims: tuple


class NdtGridMap(NamedTuple):
    """Finalized NDT voxel map, compacted before the finalize: rows
    [mu (3), cov (9 row-major, MIN_EIG-clamped), count, pad (3)] keyed by
    the representative point index; row N, misses and voxels dropped by the
    budget are all-zero rows (count 0)."""

    packed: torch.Tensor  # (N + 1, 16)
    grid: torch.Tensor  # (ncells + 1,) int64, as RawNdtGrid.grid
    origin: torch.Tensor  # (3,) int32
    resolution: float
    dims: tuple


def _ndt_claim_acc(points, mask, resolution, grid_dims):
    """The NDT grid build's core: the claim and a scatter-add of moments
    about each voxel's corner o = (c + 1) res.

    Returns (acc (N + 1, 10), grid (ncells + 1,), origin (3,))."""
    n = points.shape[0]
    dtype = points.dtype
    coords, origin, inside, grid, vid = _claim(points, mask, resolution, grid_dims)
    w = inside.to(dtype)
    d = points - (coords.to(dtype) + 1.0) * resolution
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    contrib = torch.stack(
        [w, dx * w, dy * w, dz * w,
         dx * dx * w, dx * dy * w, dx * dz * w,
         dy * dy * w, dy * dz * w, dz * dz * w],
        dim=1,
    )
    acc = torch.zeros((n + 1, 10), dtype=dtype, device=points.device)
    acc.index_add_(0, vid, contrib)
    return acc, grid, origin


def build_ndt_raw_grid(points, mask, resolution, grid_dims) -> RawNdtGrid:
    """The fresh-align NDT target map: claim and moment scatter, nothing
    else (see RawNdtGrid)."""
    acc, grid, origin = _ndt_claim_acc(points, mask, resolution, grid_dims)
    return RawNdtGrid(rows=acc, grid=grid, origin=origin,
                      resolution=float(resolution), dims=tuple(grid_dims))


def compact_ids(occ, budget: int):
    """The first `budget` indices i with occ[i] true, ascending, filled with
    len(occ); and the count of true entries (a tensor, no host sync).

    The static-size `jnp.nonzero(occ, size=budget, fill_value=n)` of the JAX
    package, by a prefix sum and a scatter into a budget-sized buffer."""
    n = occ.shape[0]
    pos = torch.cumsum(occ.to(torch.int64), 0) - 1
    slot = torch.where(occ & (pos < budget), pos, budget)  # slot `budget`: discarded
    buf = torch.full((budget + 1,), n, dtype=torch.int64, device=occ.device)
    buf.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=occ.device))
    return buf[:budget], occ.sum()


def build_ndt_grid_compact(points, mask, resolution, grid_dims, budget: int,
                           with_map: bool = True, with_stats: bool = False):
    """NDT grid build with a compact finalize: occupied voxels are compacted
    first (the lowest `budget` representative indices; an overflow drops the
    rest, as the reference's GPU hash drops on bucket overflow), then
    finalized, MIN_EIG-clamped and packed.

    Returns (NdtGridMap or None, stats or None) with stats = (means
    (budget, 3), valid (budget,), cov6 (6, budget)), the occupied voxels'
    statistics that D2D's source side consumes."""
    n = points.shape[0]
    dtype, device = points.dtype, points.device
    acc, grid, origin = _ndt_claim_acc(points, mask, resolution, grid_dims)

    idx, n_occ = compact_ids(acc[:n, 0] > 0, budget)
    valid = torch.arange(budget, device=device) < n_occ
    accT = acc[idx].T  # (10, budget); fill ids read the zero row n
    cnt = accT[0]
    inv_n = torch.where(cnt > 0, 1.0 / torch.clamp(cnt, min=1.0), torch.zeros_like(cnt))
    dmu = accT[1:4] * inv_n  # mean offset from the voxel corner
    # each row's voxel corner from its representative point (fill rows read
    # point n - 1 and are masked by `valid`)
    rep = points[torch.clamp(idx, max=n - 1)].T
    oc = (torch.floor(rep / resolution - 0.5) + 1.0) * resolution
    mu = (oc + dmu) * valid
    C6 = accT[4:10] * inv_n - torch.stack(
        [dmu[0] * dmu[0], dmu[0] * dmu[1], dmu[0] * dmu[2],
         dmu[1] * dmu[1], dmu[1] * dmu[2], dmu[2] * dmu[2]])
    C6c = soa.clamp_eigs_cols(C6, MIN_EIG)

    stats = (mu.T, valid, C6c * valid) if with_stats else None
    if not with_map:
        return None, stats
    rows16 = torch.cat(
        [mu.T, soa.sym_cols_to_rows9(C6c), cnt[:, None],
         torch.zeros((budget, 3), dtype=dtype, device=device)],
        dim=1,
    ) * valid[:, None].to(dtype)
    # fill rows (id n) are all zeros, so row n stays the zero sentinel
    packed = torch.zeros((n + 1, 16), dtype=dtype, device=device)
    packed.index_copy_(0, idx, rows16)
    nmap = NdtGridMap(packed=packed, grid=grid, origin=origin,
                      resolution=float(resolution), dims=tuple(grid_dims))
    return nmap, stats


def lookup_ndt_cols(nmap, cx, cy, cz):
    """Representative-or-N ids of integer coord columns (...,) each on a
    `RawNdtGrid` or an `NdtGridMap`; out-of-grid queries and empty cells
    give N, the zero row of its `rows` or `packed`."""
    n = nmap[0].shape[0] - 1
    return _lookup_ids(nmap.grid, nmap.origin, nmap.dims, n, cx, cy, cz)


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
