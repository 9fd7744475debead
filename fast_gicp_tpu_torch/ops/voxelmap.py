"""Voxel maps for VGICP and NDT (port of `fast_gicp_tpu.ops.voxelmap`).

Dense grids: each map keeps its voxels in a compact (N + 1, width) table
keyed by the lowest point index in each voxel, plus a dense (ncells + 1,)
index grid from cell to that representative.  Row N of the table is an
all-zero sentinel: misses (out of grid, empty cell, masked point) resolve
there and read back count 0.  VGICP's `DenseRawGridMap` holds raw additive
sums [count, sum mu (3), sum cov (9 row-major), pad (3)]; NDT's `RawNdtGrid`
holds corner-relative moments and `NdtGridMap` finalized rows.  The JAX
package's (ncells/8, 8) `grid8` reshape and lane pick are a TPU gather
workaround; here the grid is a plain 1-D lookup.

Gaussian voxel maps (`build_voxelmap`, any of the four accumulation
modes): the hash-table `VoxelMap` (a lexicographic sort of the voxel
coordinates, dense segment ids, a scatter-add of [1, mean, cov]
contributions, then an open-addressing table filled by `MAX_PROBE`
scatter-min claiming rounds) and the sparse dense-grid `GridVoxelMap`
(the scatter-min claim of the dense grids).  Both keep finalized rows
`packed` (C, 16) [mean (3), cov (9 row-major), count, pad (3)], the layout
of GICP's target rows, which the `linearize` kernel reads by voxel id.

The builds are plain PyTorch ops, as they were plain XLA ops in JAX.  No
build or lookup reads a value to the host: the probe rounds all run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from . import linalg3, soa

# Sentinel coordinate for masked points: sorts after all real coords.
_COORD_SENTINEL = 2**30
_EMPTY = 2**30  # empty hash slot marker (the scatter-min identity)

# Linear-probe bound shared by the table's insert and its lookups: an
# insert never moves a voxel further than a lookup probes.
MAX_PROBE = 8

ACCUMULATION_MODES = ("additive", "additive_weighted", "multiplicative", "raw")

# Spatial hash primes (Teschner et al.); lookups verify the coordinates, so
# any well-mixing hash works.
_HP1, _HP2, _HP3 = 73856093, 19349669, 83492791

# NDT voxel covariances: eigenvalues clamped to >= MIN_EIG (ndt_cuda.cu:120-140).
# The finalized maps clamp here; the raw linearize kernels clamp in-kernel
# with the same value (`kMinEig`, csrc/ndt_linearize.cu), their plain
# versions with this constant.
MIN_EIG = 1e-3


def _resolution_on(points, resolution):
    """The resolution as a 0-dim tensor on the points' own device, made by
    a fill (a host-to-device copy would synchronise).  Dividing by it is a
    true division on every device; ATen divides a CUDA tensor by a Python
    float (or by a 0-dim CPU tensor) as the product with f32(1 / res),
    which bins points on a voxel face into the next cell."""
    return torch.full((), resolution, dtype=points.dtype, device=points.device)


def voxel_coord(points, resolution):
    """floor(p / resolution - 0.5) as int32 (fast_vgicp_voxel.hpp:158-160),
    by a true division (`_resolution_on`)."""
    return torch.floor(points / _resolution_on(points, resolution) - 0.5).to(torch.int32)


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
    """The entries of a flat grid (ncells or more,) at integer coord
    columns (...,) each; out-of-grid queries give n (an empty cell holds
    its own miss marker)."""
    gx, gy, gz = grid_dims
    rx = (cx - origin[0]).to(torch.int64)
    ry = (cy - origin[1]).to(torch.int64)
    rz = (cz - origin[2]).to(torch.int64)
    inside = (
        (rx >= 0) & (rx < gx) & (ry >= 0) & (ry < gy) & (rz >= 0) & (rz < gz)
    )
    flat = torch.where(inside, (rx * gy + ry) * gz + rz, 0)
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


def compact_ids(occ, budget: int, fill: int | None = None):
    """The first `budget` indices i with occ[i] true, ascending, filled with
    `fill` (len(occ) by default); and the count of true entries (a tensor,
    no host sync).

    The static-size `jnp.nonzero(occ, size=budget, fill_value=fill)` of the
    JAX package, by a prefix sum and a scatter into a budget-sized buffer."""
    n = occ.shape[0]
    pos = torch.cumsum(occ.to(torch.int64), 0) - 1
    slot = torch.where(occ & (pos < budget), pos, budget)  # slot `budget`: discarded
    buf = torch.full((budget + 1,), n if fill is None else fill, dtype=torch.int64,
                     device=occ.device)
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
    oc = (torch.floor(rep / _resolution_on(rep, resolution) - 0.5) + 1.0) * resolution
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


# -- Gaussian voxel maps: the hash table and the sparse dense grid ---------


def _hash_coords(cx, cy, cz):
    """The JAX package's uint32 hash (c_x * P1) ^ (c_y * P2) ^ (c_z * P3),
    each coordinate taken as its uint32 two's complement, mod 2^32, of
    integer coordinate columns (...,) each.  Torch has no uint32 multiply
    on CUDA: the products run in int64 on c & 0xFFFFFFFF (at most 2^59) and
    keep the same low 32 bits.  Returns int64 in [0, 2^32)."""
    h = None
    for c, prime in ((cx, _HP1), (cy, _HP2), (cz, _HP3)):
        term = (c.to(torch.int64) & 0xFFFFFFFF) * prime
        h = term if h is None else h ^ term
    return h & 0xFFFFFFFF


class VoxelMap(NamedTuple):
    """Fixed-capacity Gaussian voxel map with an open-addressing table.

    `packed` and `lut` duplicate the statistics and the table's coordinates
    in the layouts their readers take: the linearize kernel reads a voxel's
    16-float row by id, and a probe reads one [id, cx, cy, cz] row."""

    means: torch.Tensor  # (C, 3) finalized voxel means
    covs: torch.Tensor  # (C, 3, 3) finalized voxel covariances
    counts: torch.Tensor  # (C,) int32 points per voxel
    coords: torch.Tensor  # (C, 3) int32 voxel integer coords
    table: torch.Tensor  # (T,) int32 open-addressing table -> voxel id or _EMPTY
    num_voxels: torch.Tensor  # () int64
    resolution: float
    packed: torch.Tensor  # (C, 16) f32 [mean (3), cov (9), count, pad (3)]
    lut: torch.Tensor  # (T, 4) int32 [voxel id, cx, cy, cz]


class GridVoxelMap(NamedTuple):
    """Gaussian voxel map with a dense index grid instead of a hash table:
    a lookup is one index into `grid`, the build one scatter-min claim.
    Voxel ids are the representative (lowest) point index of each voxel,
    sparse in [0, N); voxels outside the grid, which starts at the cloud's
    least voxel coordinate `origin`, are dropped at the build and miss at a
    lookup.  For unbounded scenes use the hash-table `VoxelMap`."""

    means: torch.Tensor  # (N, 3) finalized voxel means
    covs: torch.Tensor  # (N, 3, 3) finalized voxel covariances
    counts: torch.Tensor  # (N,) int32 points per voxel (0: no voxel)
    coords: torch.Tensor  # (N, 3) int32 each point's voxel coord
    num_voxels: torch.Tensor  # () int64
    resolution: float
    packed: torch.Tensor  # (N, 16) f32 [mean (3), cov (9), count, pad (3)]
    grid: torch.Tensor  # (Dx, Dy, Dz) int32 -> voxel id or -1
    origin: torch.Tensor  # (3,) int32 voxel coord of grid[0, 0, 0]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def segment_by_voxel(points, mask, resolution, capacity):
    """Group (N, 3) points by voxel: a lexicographic sort of the integer
    coordinates, boundary detection, dense segment ids.

    Returns (vid (N,) each point's segment id in the original order --
    `capacity` for masked and overflow points --, new_voxel (N,) the sorted
    order's boundary flags, vid_sorted (N,), sorted_coords (N, 3),
    num_voxels ()).  `jax.lax.sort(..., num_keys=3)` is stable, so ties
    keep the point order; three stable sorts (z, then y, then x) give the
    same permutation, and so voxel ids in the same lexicographic rank."""
    n = points.shape[0]
    coords = torch.where(mask[:, None], voxel_coord(points, resolution), _COORD_SENTINEL)
    order = torch.arange(n, dtype=torch.int64, device=points.device)
    for axis in (2, 1, 0):
        order = order[torch.sort(coords[order, axis], stable=True).indices]
    sc = coords[order]
    valid_sorted = sc[:, 0] < _COORD_SENTINEL
    changed = torch.ones(n, dtype=torch.bool, device=points.device)
    changed[1:] = torch.any(sc[1:] != sc[:-1], dim=1)
    new_voxel = changed & valid_sorted
    vid_sorted = torch.cumsum(new_voxel.to(torch.int64), 0) - 1
    num_voxels = new_voxel.sum()
    # invalid points -> the overflow bucket `capacity` (sliced off later)
    vid_sorted = torch.where(valid_sorted & (vid_sorted < capacity), vid_sorted, capacity)
    vid = torch.empty_like(vid_sorted).scatter_(0, order, vid_sorted)
    return vid, new_voxel, vid_sorted, sc, num_voxels


def _mode_contrib(points, mask, covs, mode):
    """(N, 13) accumulation rows [1 | mean contribution (3) | cov
    contribution (9)], zero on masked points.  covs may be (N, 3, 3) or
    (6, N) sym-6 columns."""
    n = points.shape[0]
    dtype = points.dtype
    if covs is not None and covs.shape[-2:] != (3, 3):
        covs = soa.sym_cols_to_rows9(covs).reshape(n, 3, 3)
    if mode == "raw":
        m_contrib = points
        c_contrib = points[:, :, None] * points[:, None, :]
    elif mode == "multiplicative":
        if covs is None:
            raise ValueError("multiplicative mode needs per-point covariances")
        c_contrib = linalg3.inv3(covs, eps=1e-30)
        m_contrib = torch.sum(c_contrib * points[:, None, :], dim=-1)
    else:
        if covs is None:
            raise ValueError("additive mode needs per-point covariances")
        m_contrib = points
        c_contrib = covs
    return torch.cat(
        [torch.ones((n, 1), dtype=dtype, device=points.device), m_contrib,
         c_contrib.reshape(n, 9)], dim=1,
    ) * mask.to(dtype)[:, None]


def _finalize(acc, mode):
    """(C, 13) accumulated rows -> (means (C, 3), covs (C, 3, 3), counts
    (C,) int32); empty rows finalize to zeros."""
    c = acc.shape[0]
    counts = acc[:, 0].to(torch.int32)
    sum_means = acc[:, 1:4]
    sum_covs = acc[:, 4:13].reshape(c, 3, 3)
    n_f = torch.clamp(acc[:, 0:1], min=1.0)
    if mode == "multiplicative":
        covs = linalg3.inv3(sum_covs, eps=1e-30)
        means = torch.sum(covs * sum_means[:, None, :], dim=-1)
    elif mode == "raw":
        means = sum_means / n_f
        covs = sum_covs / n_f[..., None] - means[:, :, None] * means[:, None, :]
    else:
        means = sum_means / n_f
        covs = sum_covs / n_f[..., None]
    return means, covs, counts


def _pack(means, covs, counts):
    """(C, 16) rows [mean (3), cov (9), count, pad (3)], a fresh contiguous
    (so 16-byte aligned) tensor, as the linearize kernel reads it."""
    c = means.shape[0]
    return torch.cat(
        [means, covs.reshape(c, 9), counts.to(means.dtype)[:, None],
         torch.zeros((c, 3), dtype=means.dtype, device=means.device)], dim=1,
    ).contiguous()


def _build_table(vcoords, num_voxels, capacity, table_size, max_probe):
    """Open-addressing insert by `max_probe` scatter-min claiming rounds:
    each round every still-pending voxel tries to claim its current slot
    (only an empty slot can be claimed), the lowest id wins, the losers
    move one slot on (linear probing).  Voxels still pending after the
    last round are dropped.  Returns the (T,) int32 table of ids or
    _EMPTY."""
    device = vcoords.device
    mask_t = table_size - 1
    vids = torch.arange(capacity, dtype=torch.int64, device=device)
    pending = vids < num_voxels
    slot = _hash_coords(vcoords[:, 0], vcoords[:, 1], vcoords[:, 2]) & mask_t
    table = torch.full((table_size + 1,), _EMPTY, dtype=torch.int64, device=device)
    for _ in range(max_probe):
        attempt = pending & (table[slot] == _EMPTY)
        # non-attempts park on the extra slot, which no probe reads
        table.scatter_reduce_(0, torch.where(attempt, slot, table_size), vids,
                              reduce="amin", include_self=True)
        pending = pending & ~(attempt & (table[slot] == vids))
        slot = torch.where(pending, (slot + 1) & mask_t, slot)
    return table[:table_size].to(torch.int32)


def build_voxelmap(points, mask, resolution, covs=None, mode: str = "additive",
                   capacity: int | None = None, table_factor: int = 8,
                   grid_dims: tuple | None = None, device="cuda"):
    """A Gaussian voxel map of (N, 3) points and per-point covariances
    ((N, 3, 3) or (6, N) sym-6 columns; not needed for "raw").

    mode: "additive" / "additive_weighted" (aliases, as in the reference:
    the arithmetic mean of the member means and covariances), or
    "multiplicative" (information form: sum C^-1 and C^-1 mu, inverted at
    the finalize), or "raw" (mean E[x], covariance E[x x^T] - mu mu^T of
    the points).  grid_dims (Dx, Dy, Dz) -> a `GridVoxelMap`; None -> the
    hash-table `VoxelMap` with `capacity` voxels (default N) and a
    power-of-two table of >= table_factor x capacity slots.  Runs on
    `device` (CUDA unless the caller asks for the CPU)."""
    if mode not in ACCUMULATION_MODES:
        raise ValueError(f"unknown accumulation mode: {mode}")
    dev = _device.resolve(device)
    points, mask = _device.as_f32(points, dev), _device.as_bool(mask, dev)
    if covs is not None:
        covs = _device.as_f32(covs, dev)
    if grid_dims is not None:
        return _build_grid_voxelmap(points, mask, resolution, covs, mode, grid_dims)
    n = points.shape[0]
    dtype, device = points.dtype, points.device
    capacity = capacity or n
    table_size = next_pow2(table_factor * capacity)

    vid, new_voxel, vid_sorted, sorted_coords, num_voxels = segment_by_voxel(
        points, mask, resolution, capacity)
    contrib = _mode_contrib(points, mask, covs, mode)
    acc = torch.zeros((capacity + 1, 13), dtype=dtype, device=device)
    acc.index_add_(0, vid, contrib)
    means, covs_out, counts = _finalize(acc[:capacity], mode)

    # each voxel's coords from its first sorted point (the rest park on the
    # dropped row `capacity`)
    vcoords = torch.zeros((capacity + 1, 3), dtype=torch.int32, device=device)
    vcoords[torch.where(new_voxel, vid_sorted, capacity)] = sorted_coords
    vcoords = vcoords[:capacity]

    table = _build_table(vcoords, num_voxels, capacity, table_size, MAX_PROBE)
    occupied = table != _EMPTY
    lut_coords = torch.where(occupied[:, None], vcoords[torch.where(occupied, table, 0)],
                             _COORD_SENTINEL)
    lut = torch.cat([table[:, None], lut_coords], dim=1)
    return VoxelMap(means=means, covs=covs_out, counts=counts, coords=vcoords, table=table,
                    num_voxels=num_voxels, resolution=float(resolution),
                    packed=_pack(means, covs_out, counts), lut=lut)


def _build_grid_voxelmap(points, mask, resolution, covs, mode, grid_dims):
    """The sparse dense-grid build: the dense grids' claim (each occupied
    cell's lowest member point is its voxel id), then the mode's
    scatter-add of contributions into rows keyed by that id."""
    n = points.shape[0]
    dtype, device = points.dtype, points.device
    gx, gy, gz = grid_dims
    coords, origin, inside, claim, vid = _claim(points, mask, resolution, grid_dims)
    contrib = _mode_contrib(points, inside, covs, mode)
    acc = torch.zeros((n + 1, 13), dtype=dtype, device=device)
    acc.index_add_(0, vid, contrib)
    means, covs_out, counts = _finalize(acc[:n], mode)
    cells = claim[: gx * gy * gz]
    grid = torch.where(cells < n, cells, -1).to(torch.int32).reshape(gx, gy, gz)
    return GridVoxelMap(means=means, covs=covs_out, counts=counts, coords=coords,
                        num_voxels=(counts > 0).sum(), resolution=float(resolution),
                        packed=_pack(means, covs_out, counts), grid=grid, origin=origin)


def _probe(lut, slot0, cx, cy, cz):
    """Voxel ids (...,) int32, or -1, of coordinate columns (...,) each
    whose probe chains start at slot0 (...,): the id of the first of the
    `MAX_PROBE` slots that matches the coordinates, unless an empty slot
    comes first (an insert leaves no hole inside a chain, so an empty slot
    proves absence).  All rounds are gathered at once, so nothing is read
    to the host; a resolved query ignores the later rounds, as JAX's early
    exit skips them."""
    table_size = lut.shape[0]
    steps = torch.arange(MAX_PROBE, dtype=torch.int64, device=lut.device)
    rows = lut[(slot0[..., None] + steps) & (table_size - 1)]  # (..., P, 4)
    match = ((rows[..., 1] == cx[..., None]) & (rows[..., 2] == cy[..., None])
             & (rows[..., 3] == cz[..., None]))
    first = torch.argmax((match | (rows[..., 0] == _EMPTY)).to(torch.int32), dim=-1,
                         keepdim=True)
    hit = torch.gather(match, -1, first)[..., 0]
    return torch.where(hit, torch.gather(rows[..., 0], -1, first)[..., 0], -1)


def lookup_lut(lut, coords):
    """Probe an open-addressing lut (T, 4) [vid, cx, cy, cz] for integer
    coords (..., 3) -> voxel id (int32) or -1."""
    cx, cy, cz = coords[..., 0], coords[..., 1], coords[..., 2]
    slot0 = _hash_coords(cx, cy, cz) & (lut.shape[0] - 1)
    return _probe(lut, slot0, cx, cy, cz)


def _grid_lookup(vmap: GridVoxelMap, cx, cy, cz):
    """One index into the dense grid; out-of-grid queries give -1."""
    return _lookup_ids(vmap.grid.reshape(-1), vmap.origin, vmap.grid.shape, -1, cx, cy, cz)


def lookup_voxels(vmap, query_coords):
    """Integer coords (..., 3) -> voxel id (int32) or -1, on a `VoxelMap`
    (verified hash probes, fast_vgicp_voxel.hpp:167-174) or a
    `GridVoxelMap` (one bounds-checked index into the grid)."""
    if isinstance(vmap, GridVoxelMap):
        return _grid_lookup(vmap, query_coords[..., 0], query_coords[..., 1],
                            query_coords[..., 2])
    return lookup_lut(vmap.lut, query_coords)


def lookup_voxels_cols(vmap, cx, cy, cz):
    """`lookup_voxels` on integer coordinate columns (...,) each."""
    if isinstance(vmap, GridVoxelMap):
        return _grid_lookup(vmap, cx, cy, cz)
    slot0 = _hash_coords(cx, cy, cz) & (vmap.lut.shape[0] - 1)
    return _probe(vmap.lut, slot0, cx, cy, cz)


def gather_voxel_stats(vmap, vids):
    """(means (..., 3), covs (..., 3, 3), counts (...,) f32) of voxel ids
    (...,) in one row gather of `packed`."""
    rows = vmap.packed[vids]
    return rows[..., 0:3], rows[..., 3:12].reshape(rows.shape[:-1] + (3, 3)), rows[..., 12]
