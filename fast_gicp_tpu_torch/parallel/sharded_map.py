"""Multi-device persistent scan-to-map odometry: the voxel map sharded across
the ranks of a mesh by a hash of the voxel coordinates (port of
`fast_gicp_tpu.parallel.sharded_map`).

  * OWNERSHIP: the voxel of integer coordinates c lives on rank
    remix(hash(c)) % size, the remix drawing on other bits than the lut's
    slot (hash & (T - 1)), or on a power-of-two mesh every rank's voxels
    would share slot residues.  `_owner_hash_np` and `_owner_of` give the
    JAX package's uint32 arithmetic bit for bit (int64 products kept below
    2^63 and masked to 32 bits, as `ops.voxelmap._hash_coords` does).
  * STATE: each rank holds its own shard as a port `MapState`, with the
    mesh (`ShardedMapState`); a checkpoint is one single-device map in the
    `.npz` format of `models.scan_to_map.save_map`, whatever the mesh size,
    and reads in either package.
  * UPDATE: `update_sharded_map` gives every rank the whole scan and each
    keeps the points whose voxel it owns; `update_sharded_map_routed` splits
    the scan and routes [point | cov9 | valid] packets to their owners with
    one all-to-all, bucketed by a stable sort of the owner (so `update_map`
    sees the rows in the JAX package's order); packets beyond the route
    capacity are dropped for the frame, as there.
  * ALIGN: `align_to_sharded_map` gives every rank the whole scan and sums
    [err, H, b] and the trial error across the shards (a voxel misses on
    every shard but its owner); `align_to_sharded_map_partitioned` splits
    the scan and routes each (point, offset) query to its voxel's owner
    with one all-to-all a linearization, and only the scalar error is
    summed in a trial.  The kernels are the single-device map align's: the
    `linearize` kernel on the owner's `packed` rows by voxel id (VGICP) or
    the NDT pack form, the trial's error kernel and the standalone trial.

`ShardedScanToMapOdometry` is the multi-rank `ScanToMapOdometry`: the
base class's frame, gate and capacity policy with the sharded hooks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from ..models.scan_to_map import (
    _NEW_PER_FRAME_CAP,
    MapState,
    ScanToMapConfig,
    ScanToMapOdometry,
    _align,
    _frame_covs,
    _rebuilt,
    _to_world,
    _update_map,
    compact_map,
    empty_map,
    grow_map,
    load_map,
    map_as_voxelmap,
    map_from_voxels,
    save_map,
)
from ..ops import cuda_kernels, cuda_linearize, cuda_ndt, cuda_solver, soa
from ..ops.covariance import _finalize_rows16, masked_mean, regularize_cov_cols
from ..ops.voxelmap import (
    _COORD_SENTINEL,
    _hash_coords,
    compact_ids,
    lookup_lut,
    lookup_voxels_cols,
    neighbor_offsets,
    next_pow2,
    segment_by_voxel,
    voxel_coord,
)
from ..precision import f32_matmuls
from ..solver import LsqResult, lsq_solve
from .mesh import Mesh
from .sharded import DATA_AXIS, _rows, make_mesh  # noqa: F401  (DATA_AXIS: the JAX module's name)

_MIX = 0x9E3779B9  # the ownership remix's multiplier


class ShardedMapState(NamedTuple):
    """This rank's shard of the hash-sharded map (a `MapState` of its own
    capacity) and the mesh the shards lie on."""

    shard: MapState
    mesh: Mesh

    @property
    def resolution(self) -> float:
        return self.shard.resolution


def empty_sharded_map(mesh: Mesh, capacity_per_device: int, resolution: float
                      ) -> ShardedMapState:
    """An empty shard of `capacity_per_device` voxels on the rank's device."""
    return ShardedMapState(empty_map(capacity_per_device, resolution, device=mesh.device),
                           mesh)


def _owner_hash_np(coords, d: int):
    """NumPy mirror of the ownership hash: voxel coords (..., 3) -> owning
    rank (int64), in the JAX package's uint32 modular arithmetic."""
    c = np.asarray(coords).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = ((c[..., 0] * np.uint32(73856093)) ^ (c[..., 1] * np.uint32(19349669))
             ^ (c[..., 2] * np.uint32(83492791)))
        h = (h ^ (h >> np.uint32(16))) * np.uint32(_MIX)
    return ((h >> np.uint32(8)) % np.uint32(d)).astype(np.int64)


def _owner_of(h, d: int):
    """Voxel hash (int64 in [0, 2^32), `_hash_coords`) -> owning rank
    (int64): the re-mixed high bits.  The uint32 product h * _MIX is taken
    in two halves of the multiplier, so no int64 product passes 2^48."""
    h = h ^ (h >> 16)
    h = (h * (_MIX & 0xFFFF) + (((h * (_MIX >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return torch.remainder(h >> 8, d)


def _owner_coords(c, d: int):
    """(M, 3) integer voxel coords -> owning rank (M,) int64."""
    return _owner_of(_hash_coords(c[:, 0], c[:, 1], c[:, 2]), d)


def _route_capacity(n_queries_per_device: int, d: int) -> int:
    """Static per-(source, destination) packet capacity: mean n/d with 2x
    slack for hash-placement variance, rounded up to 128."""
    mean = max(1, n_queries_per_device // d)
    return max(128, -(-2 * mean // 128) * 128)


def _route(mesh: Mesh, key, rows, cap: int):
    """Send each row to rank key[i] (key == size: keep it home, dropped) with
    one all-to-all: rows bucketed by a stable sort of the key, each bucket's
    first `cap` rows sent, the rest dropped.  Returns the (size * cap, W)
    rows received, block r from rank r, zero rows past each block's end."""
    d, m = mesh.size, key.shape[0]
    dev = rows.device
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(d, dtype=key.dtype, device=dev))
    rank = torch.arange(m, device=dev) - starts[torch.clamp(sorted_key, 0, d - 1)]
    ok = (sorted_key < d) & (rank < cap)
    slot = torch.where(ok, sorted_key * cap + rank, d * cap)
    buf = torch.zeros((d * cap + 1, rows.shape[1]), dtype=rows.dtype, device=dev)
    buf[slot] = rows[order]  # rows past the capacity land on the trash row d * cap
    return mesh.all_to_all(buf[:d * cap])


def merge_sharded_map(state: ShardedMapState, capacity: int = None) -> MapState:
    """Merge every rank's shard into ONE single-device `MapState` (a cold
    path, called by every rank): ownership is disjoint, so the merged map is
    the shards' live rows in rank order with a rebuilt lut.  With
    `distribute_map` a checkpoint resumes on a mesh of any size."""
    sh, mesh = state.shard, state.mesh
    dev = mesh.device
    counts = mesh.all_gather(sh.num_voxels.to(torch.int64).reshape(1)).cpu()
    top = int(counts.max())
    n = int(counts[mesh.rank])
    sums = torch.zeros((top, 13), dtype=torch.float32, device=dev)
    coords = torch.zeros((top, 3), dtype=torch.int32, device=dev)
    sums[:n], coords[:n] = sh.sums[:n], sh.coords[:n]
    all_sums, all_coords = mesh.all_gather(sums), mesh.all_gather(coords)
    keep = [slice(r * top, r * top + int(c)) for r, c in enumerate(counts)]
    return map_from_voxels(torch.cat([all_sums[k] for k in keep]),
                           torch.cat([all_coords[k] for k in keep]), sh.resolution,
                           capacity, device=dev)


def distribute_map(mesh: Mesh, state: MapState, capacity_per_device: int = None
                   ) -> ShardedMapState:
    """This rank's shard of a single-device `MapState` (every rank passes
    the whole map): its voxels by the ownership hash, on the host as in the
    JAX package.  `capacity_per_device` defaults to 2x the fullest shard's
    row count, rounded to a power of two (at least 256)."""
    d = mesh.size
    n = int(state.num_voxels)
    coords = state.coords[:n].cpu().numpy()
    sums = state.sums[:n].cpu().numpy()
    owner = _owner_hash_np(coords, d)
    counts = np.bincount(owner, minlength=d)
    if capacity_per_device is None:
        capacity_per_device = max(256, next_pow2(2 * max(1, int(counts.max()))))
    if counts.max() > capacity_per_device:
        raise ValueError(f"fullest shard needs {int(counts.max())} rows > "
                         f"capacity_per_device {capacity_per_device}")
    mine = owner == mesh.rank
    return ShardedMapState(map_from_voxels(sums[mine], coords[mine], state.resolution,
                                           capacity_per_device, device=mesh.device), mesh)


def save_sharded_map(path: str, state: ShardedMapState) -> None:
    """Checkpoint the sharded map as one single-device map (every rank calls
    it: the merge is collective; rank 0 writes the `save_map` file, and the
    call returns once it is written)."""
    merged = merge_sharded_map(state)
    if state.mesh.rank == 0:
        save_map(path, merged)
    state.mesh.barrier()


def load_sharded_map(mesh: Mesh, path: str, capacity_per_device: int = None
                     ) -> ShardedMapState:
    """Restore a `save_sharded_map` (or `save_map`, of either package)
    checkpoint onto `mesh`."""
    return distribute_map(mesh, load_map(path, device=mesh.device), capacity_per_device)


def _scan_on(mesh, points_world, covs_world, mask):
    dev = mesh.device
    pts = _device.as_f32(points_world, dev)
    return (pts, _device.as_f32(covs_world, dev).reshape(pts.shape[0], 9),
            _device.as_bool(mask, dev))


@f32_matmuls
def update_sharded_map(mesh: Mesh, state: ShardedMapState, points_world, covs_world, mask
                       ) -> ShardedMapState:
    """Fuse a registered (world-frame) scan into the sharded map: every rank
    gets the whole scan and fuses the points whose voxel it owns, with no
    collective."""
    pts, cov9, msk = _scan_on(mesh, points_world, covs_world, mask)
    own = _owner_coords(voxel_coord(pts, state.resolution), mesh.size) == mesh.rank
    return state._replace(shard=_update_map(state.shard, pts, cov9, msk & own,
                                            _NEW_PER_FRAME_CAP))


def _lex_sorted(c):
    """(M, 3) integer coords in lexicographic order (x, then y, then z), by
    three stable sorts as `segment_by_voxel` orders the voxels."""
    order = torch.arange(c.shape[0], device=c.device)
    for axis in (2, 1, 0):
        order = order[torch.sort(c[order, axis], stable=True).indices]
    return c[order]


def _map_cap(mesh, shard: MapState, pts, msk, cap: int):
    """`msk` without the points of the new voxels past the first `cap` of
    the whole map's, in `update_map`'s order (the lexicographic order of
    the coords): the shards admit together what one map would.

    Each shard lists its first `cap` new voxels (at most; sentinel rows
    after them), one all-gather of (cap, 3) int32 collects every shard's,
    and the cap-th of them all in that order is the last one admitted.
    Ownership is disjoint, so no voxel is listed twice."""
    n = pts.shape[0]
    k = min(cap, n)
    vc = voxel_coord(pts, shard.resolution)
    fresh = msk & (lookup_lut(shard.lut, vc) < 0)
    _seg, first_of_voxel, _sorted_ids, sorted_coords, _nv = segment_by_voxel(
        pts, fresh, shard.resolution, n)
    first, count = compact_ids(first_of_voxel, k, fill=n - 1)
    listed = torch.arange(k, device=pts.device)[:, None] < count
    everyone = mesh.all_gather(torch.where(listed, sorted_coords[first], _COORD_SENTINEL))
    if everyone.shape[0] < cap:
        return msk
    last = _lex_sorted(everyone)[cap - 1]  # a sentinel row: fewer new voxels than cap
    x, y, z = vc.unbind(1)
    upto = (x < last[0]) | ((x == last[0]) & ((y < last[1]) | ((y == last[1]) & (z <= last[2]))))
    return msk & (~fresh | upto)


def _fuse_routed(mesh, shard: MapState, pts, cov9, msk, new_cap=_NEW_PER_FRAME_CAP,
                 map_cap: bool = False) -> MapState:
    """The routed update of this rank's block of the scan (pts (n, 3), cov9
    (n, 9), msk (n,)); each shard admits at most `new_cap` new voxels, or,
    with `map_cap`, all the shards together (`_map_cap`)."""
    n = pts.shape[0]
    owner = _owner_coords(voxel_coord(pts, shard.resolution), mesh.size)
    rows = torch.cat([pts, cov9, msk.to(torch.float32)[:, None]], dim=1)
    recv = _route(mesh, torch.where(msk, owner, mesh.size), rows,
                  _route_capacity(n, mesh.size))
    p, m = recv[:, :3].contiguous(), recv[:, 12] > 0.0
    if map_cap:
        m = _map_cap(mesh, shard, p, m, new_cap)
    return _update_map(shard, p, recv[:, 3:12].contiguous(), m, new_cap)


@f32_matmuls
def update_sharded_map_routed(mesh: Mesh, state: ShardedMapState, points_world, covs_world,
                              mask) -> ShardedMapState:
    """Fuse a SPLIT registered scan: each rank takes its block of the N rows
    (N divisible by the mesh size), routes [point | cov9 | valid] packets to
    the voxels' owners with one all-to-all and fuses the ~N / size rows it
    receives.  Packets beyond the 2x-slack route capacity are dropped for
    the frame, as the map drops inserts it cannot place."""
    pts, cov9, msk = _scan_on(mesh, points_world, covs_world, mask)
    sl = _rows(mesh)(pts.shape[0])
    return state._replace(shard=_fuse_routed(mesh, state.shard, pts[sl], cov9[sl], msk[sl]))


def re_anchor_sharded_map(mesh: Mesh, state: ShardedMapState, shift_cells) -> ShardedMapState:
    """In-mesh re-anchoring: shift every voxel by -shift_cells and
    redistribute the shards with ONE all-to-all.

    Ownership is a hash of the coords, so the shift moves voxels between
    ranks.  Each shard shifts its live rows as `re_anchor_map` does (coords
    - k; mean sums - count t; covariance sums unchanged), routes 16-float
    packets [sums (13) | coords (3)] to their new owners (coords as exact
    float values, below 2^24 cells) and rebuilds its lut from the rows it
    receives.  A rank sends at most its whole shard to one rank, so the
    route drops nothing; rows beyond the destination's capacity drop as
    `update_map`'s over-capacity inserts do."""
    sh = state.shard
    dev = sh.sums.device
    cap_local, table_size = sh.sums.shape[0], sh.lut.shape[0]
    vid = torch.arange(cap_local, device=dev)
    live = vid < sh.num_voxels
    k = (shift_cells.to(device=dev, dtype=torch.int32) if isinstance(shift_cells, torch.Tensor)
         else _device.upload(np.asarray(shift_cells, np.int32), dev))
    t = k.to(torch.float32) * sh.resolution
    coords = torch.where(live[:, None], sh.coords - k[None], 0)
    sums = torch.cat([sh.sums[:, 0:1], sh.sums[:, 1:4] - sh.sums[:, 0:1] * t[None],
                      sh.sums[:, 4:13]], dim=1) * live.to(torch.float32)[:, None]
    rows = torch.cat([sums, coords.to(torch.float32)], dim=1)
    recv = _route(mesh, torch.where(live, _owner_coords(coords, mesh.size), mesh.size), rows,
                  cap_local)
    # live received rows carry count >= 1: front-pack them into the capacity
    rvalid = recv[:, 0] > 0.0
    order = torch.argsort((~rvalid).to(torch.int32), stable=True)[:cap_local]
    count = torch.clamp(rvalid.sum(), max=cap_local).to(torch.int32)
    front = (vid < count)[:, None]
    got = recv[order]
    new_sums = torch.where(front, got[:, :13], 0.0)
    new_coords = torch.where(front, torch.round(got[:, 13:16]).to(torch.int32), 0)
    return state._replace(shard=_rebuilt(new_sums, new_coords, count, sh.resolution,
                                         table_size))


def grow_sharded_map(mesh: Mesh, state: ShardedMapState, new_capacity_per_device: int
                     ) -> ShardedMapState:
    """Every shard migrated into a larger allocation (its own lut rebuilt);
    ownership is unchanged, so no collective."""
    return state._replace(shard=grow_map(state.shard, new_capacity_per_device))


def compact_sharded_map(mesh: Mesh, state: ShardedMapState, center, radius
                        ) -> ShardedMapState:
    """Evict the voxels beyond `radius` of `center` on every shard
    (`compact_map` a shard; no collective, no host read)."""
    return state._replace(shard=compact_map(state.shard, center, radius))


def _source_on(mesh, source, source_mask, source_covs, guess):
    dev = mesh.device
    return (_device.as_f32(source, dev), _device.as_bool(source_mask, dev),
            _device.as_f32(source_covs, dev), _device.as_f32(guess, dev))


@f32_matmuls
def align_to_sharded_map(mesh: Mesh, state: ShardedMapState, source, source_mask,
                         source_covs, guess, config: ScanToMapConfig) -> LsqResult:
    """Register a scan (every rank passes the whole scan; covariances (6, N)
    columns or (N, 3, 3)) against the sharded map: each rank solves the
    single-device objective (`config.objective`: "vgicp", "ndt_d2d" or
    "ndt_p2d") on its own shard, a query missing on every shard but its
    voxel's owner, with [err, H, b] and the trial error summed across the
    ranks, so every rank walks the same LM trajectory."""
    source, source_mask, source_covs, guess = _source_on(mesh, source, source_mask,
                                                         source_covs, guess)
    return _align(state.shard, source, source_mask, source_covs, guess, config,
                  reduce=mesh.reduce)


def _rbf_local(mesh, p_loc, m_loc, kernel_width=0.5, max_dist=3.0):
    """RBF covariance columns (6, n) of this rank's block of queries against
    the whole cloud, gathered from every rank's block in one all-gather."""
    full = mesh.all_gather(torch.cat([p_loc, m_loc.to(p_loc.dtype)[:, None]], dim=1))
    full_p, full_m = full[:, :3].contiguous(), full[:, 3] > 0.0
    m = cuda_kernels.rbf_moments(p_loc.contiguous(), m_loc, full_p, full_m,
                                 masked_mean(full_p, full_m), kernel_width, max_dist)
    return regularize_cov_cols(_finalize_rows16(m, 1e-12), "plane")


@f32_matmuls
def sharded_rbf_covariances(mesh: Mesh, points, mask, kernel_width=0.5, max_dist=3.0):
    """Query-split RBF covariances: each rank takes its block of the N
    points, gathers the whole cloud from the ranks' blocks (one all-gather of
    N x 16 bytes) and estimates its block's covariances against it with the
    `rbf_moments` kernel (query and target clouds apart), O(N^2 / size) a
    rank.  Returns this rank's block (N / size, 3, 3), the rows of the JAX
    package's globally sharded (N, 3, 3) array."""
    dev = mesh.device
    points, mask = _device.as_f32(points, dev), _device.as_bool(mask, dev)
    sl = _rows(mesh)(points.shape[0])
    cols = _rbf_local(mesh, points[sl], mask[sl], kernel_width, max_dist)
    return soa.sym_cols_to_rows9(cols).reshape(-1, 3, 3)


def _query_rows(x, P, offs, resolution):
    """The (point, offset) queries of source columns P (3, n) at pose x,
    offset-major (lane k n + i): coords (K n, 3) int32."""
    q = voxel_coord(soa.transform_cols(x, P), resolution)
    return torch.stack([(q[a][None, :] + offs[:, a:a + 1]).reshape(-1) for a in range(3)],
                       dim=1)


def _partitioned_local(mesh, shard: MapState, src, smask, scovs, guess,
                       config: ScanToMapConfig) -> LsqResult:
    """`align_to_sharded_map_partitioned` on this rank's block of the scan."""
    vm = map_as_voxelmap(shard)
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    k, n, d = len(offsets), src.shape[0], mesh.size
    cap = _route_capacity(k * n, d)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=src.device)
    P = soa.cols_from_points(src)
    CA = soa.sym_cols_from_covs(scovs)
    validq = smask.repeat(k)
    ndt = config.objective in ("ndt_d2d", "ndt_p2d")
    if not ndt and config.objective != "vgicp":
        raise ValueError(f"unknown scan-to-map objective: {config.objective}")
    mode = config.objective[4:] if ndt else None

    def route(x):
        q = _query_rows(x, P, offs, vm.resolution)
        rows = torch.cat([q.to(torch.float32), P.T.repeat(k, 1), CA.T.repeat(k, 1),
                          validq.to(torch.float32)[:, None]], dim=1)  # (K n, 13)
        return _route(mesh, torch.where(validq, _owner_coords(q, d), d), rows, cap)

    def linearize(x):
        recv = route(x)
        q = torch.round(recv[:, 0:3]).to(torch.int32)
        p, ca = recv[:, 3:6].T.contiguous(), recv[:, 6:12].T.contiguous()
        vids = lookup_voxels_cols(vm, q[:, 0], q[:, 1], q[:, 2])
        hit = (recv[:, 12] > 0.0) & (vids >= 0)
        ids = torch.clamp(vids, min=0)
        if ndt:
            mu, cov6, count = soa.sym_cols_from_packed(vm.packed[ids])
            valid = (hit & (count > cuda_ndt.MIN_VOXEL_POINTS)).to(torch.float32)
            out = cuda_ndt.ndt_linearize(p, ca if mode == "d2d" else None, x,
                                         cuda_ndt._finalized_pack(mu, cov6, valid, mode),
                                         vm.resolution, mode)
        else:
            out = cuda_linearize.linearize(p, ca, x, vm.packed, hit.to(torch.float32), ids)
        err, H, b, aux = cuda_solver.reduce_normal_eq(out, mesh.reduce)
        return err, H, b, (aux, p)  # the owner re-transforms p at each trial pose

    def cost(x, frozen):
        aux, p = frozen
        return cuda_solver.TrialCost(p, resolution=vm.resolution if ndt else None)(x, aux)

    return lsq_solve(linearize, cuda_solver.ReducedCost(cost, mesh.reduce), guess, config.lsq)


@f32_matmuls
def align_to_sharded_map_partitioned(mesh: Mesh, state: ShardedMapState, source, source_mask,
                                     source_covs, guess, config: ScanToMapConfig
                                     ) -> LsqResult:
    """Compute-partitioned align: the SCAN is split over the ranks too.

    Each rank takes its block of the N source points (N divisible by the
    mesh size) and, each linearization: transforms it, derives each (point,
    offset) query's voxel and the voxel's owner, routes [coords | source
    point | source covariance | valid] packets to the owners with one
    all-to-all, linearizes the queries it received against its shard with
    the single-device kernels (the owner re-transforms the untransformed
    point, so the frozen aux serves every trial pose) and sums the 43-float
    normal equations.  A trial sums only the scalar error.  Per-rank work is
    O(N K / size); the result equals the single-device solve's up to the
    order of the sums.  Packets beyond the 2x-slack route capacity are
    dropped (see `sharded_routing_load` for the balance).
    `config.objective` selects "vgicp" or "ndt_d2d" / "ndt_p2d"."""
    source, source_mask, source_covs, guess = _source_on(mesh, source, source_mask,
                                                         source_covs, guess)
    sl = _rows(mesh)(source.shape[0])
    covs = source_covs[:, sl] if source_covs.dim() == 2 else source_covs[sl]
    return _partitioned_local(mesh, state.shard, source[sl], source_mask[sl], covs, guess,
                              config)


def sharded_routing_load(mesh: Mesh, state: ShardedMapState, source, source_mask, guess,
                         config: ScanToMapConfig):
    """Diagnostic: the (point, offset) queries routed TO each rank at
    `guess` (size,) int64, the same on every rank: each rank's linearize
    workload; balanced means ~N K / size each."""
    dev = mesh.device
    source, guess = _device.as_f32(source, dev), _device.as_f32(guess, dev)
    source_mask = _device.as_bool(source_mask, dev)
    sl = _rows(mesh)(source.shape[0])
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
    q = _query_rows(guess, soa.cols_from_points(source[sl]), offs, state.resolution)
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=dev).index_add_(
        0, _owner_coords(q, mesh.size), source_mask[sl].repeat(len(offsets)).to(torch.int64))
    return mesh.reduce(counts)


class ShardedScanToMapOdometry(ScanToMapOdometry):
    """The multi-rank `ScanToMapOdometry`: a persistent hash-sharded world
    map, the constant-velocity warm start, the tracking gate and the fusion
    at the gated pose.  Every rank feeds the same scans and gets the same
    poses.

    The frame, gate and growth and eviction policy are the base class's;
    the hooks differ: each rank estimates the
    covariances of its block of the scan (`sharded_rbf_covariances`, or the
    kNN estimate of the whole scan), aligns with
    `align_to_sharded_map_partitioned`, fuses with the routed update and
    re-anchors in the mesh.  The capacity policy's numbers are per shard;
    the new voxels admitted a frame are the whole map's."""

    _capacity_scope = " on the fullest shard"
    # the hooks run collectives: the frame stays eager (the JAX package's
    # sharded driver sets _fused_frames = False)
    _graph_frames = False

    def __init__(self, config: ScanToMapConfig = ScanToMapConfig(), mesh: Mesh = None,
                 covariance: str = "rbf", initial_map=None, initial_pose=None,
                 initial_velocity=None, bucket: int = None):
        mesh = mesh if mesh is not None else make_mesh()
        super().__init__(config, covariance=covariance, bucket=bucket,
                         initial_pose=initial_pose, initial_velocity=initial_velocity,
                         device=mesh.device)
        self.mesh = mesh
        # initial_map: a sharded state of a mesh of this size, or a
        # single-device MapState (a `save_map` checkpoint), distributed by
        # the ownership hash onto a mesh of any size
        if initial_map is None:
            self.state = empty_sharded_map(mesh, max(1, config.capacity // mesh.size),
                                           config.resolution)
        elif isinstance(initial_map, ShardedMapState):
            if initial_map.mesh.size != mesh.size:
                raise ValueError(f"checkpoint has {initial_map.mesh.size} shards, mesh has "
                                 f"{mesh.size}: merge and redistribute "
                                 "(save_sharded_map / load_sharded_map)")
            self.state = initial_map
        else:
            self.state = distribute_map(mesh, initial_map)
        # resumed mapping on a non-empty checkpoint aligns frame 0 first
        self._align_first_frame = initial_map is not None and int(mesh.reduce(
            self.state.shard.num_voxels.to(torch.int64).reshape(1))) > 0

    def save(self, path: str) -> None:
        """Checkpoint the map as one single-device `.npz` (every rank calls
        it; `save_sharded_map`): it resumes on a mesh of any size through
        `initial_map=load_map(path)`, and in `ScanToMapOdometry`."""
        save_sharded_map(path, self.state)

    def _block(self, *tensors):
        sl = _rows(self.mesh)(tensors[0].shape[0])
        return [t[sl] for t in tensors]

    def _covs(self, pts, mask):
        """This rank's block of the scan's covariances, (6, n) columns."""
        if self.covariance == "rbf":
            return _rbf_local(self.mesh, *self._block(pts, mask))
        return _frame_covs(pts, mask, self.covariance)[:, _rows(self.mesh)(pts.shape[0])]

    def _align(self, pts, mask, covs, guess) -> LsqResult:
        return _partitioned_local(self.mesh, self.state.shard, *self._block(pts, mask), covs,
                                  guess, self.config)

    def _fuse(self, pose, pts, covs, fuse_mask) -> None:
        """The routed update of this rank's block.  The config's
        `new_per_frame_capacity` is the whole map's, as `ScanToMapOdometry`'s
        (`_map_cap`): on any mesh the shards admit the single map's new
        voxels.  The JAX package's sharded odometry admits `update_map`'s
        default, 16,384, on each shard, whatever the config says."""
        p, m = self._block(pts, fuse_mask)
        world_pts, world_cov9 = _to_world(pose, p, covs)
        self.state = self.state._replace(
            shard=_fuse_routed(self.mesh, self.state.shard, world_pts, world_cov9, m,
                               self.config.new_per_frame_capacity, map_cap=True))

    def _re_anchor_state(self, k) -> None:
        """The in-mesh shift: one all-to-all redistribution
        (`re_anchor_sharded_map`)."""
        self.state = re_anchor_sharded_map(self.mesh, self.state, k)

    # --- the capacity policy's primitives, per shard --------------------------

    def _shards(self) -> int:
        return self.mesh.size

    def _capacity(self) -> int:
        return self.state.shard.sums.shape[0]

    def _max_capacity(self) -> int:
        return max(1, self.config.max_capacity // self._shards())

    def _fill(self) -> int:
        """The fullest shard's voxel count (one all-gather; synchronizes)."""
        return self.mesh.max_int(int(self.state.shard.num_voxels))

    def _grow(self, new_capacity: int) -> None:
        self.state = grow_sharded_map(self.mesh, self.state, new_capacity)

    def _compact(self, center, radius) -> None:
        self.state = compact_sharded_map(self.mesh, self.state, center, radius)
