"""Scan-to-map odometry over a persistent world voxel map (port of
`fast_gicp_tpu.models.scan_to_map`).

The reference is scan-to-scan only: its target voxel map is rebuilt from
the latest scan every align (fast_vgicp_impl.hpp:66-70).  Here a
fixed-capacity world-frame Gaussian voxel map persists across frames,
accumulates additive voxel statistics from every registered scan and is the
registration target of each new scan:
  * `MapState`: raw additive sums [n | sum mu | sum C] a voxel (finalized
    at lookup), integer coordinates and the open-addressing lut;
  * `update_map`: segment the scan by voxel, add into the existing voxels,
    claim lut slots for new ones with `MAX_PROBE` scatter-min rounds on
    tickets (all rounds run: no host read);
  * `align_to_map`: VGICP against the live map (weight sqrt(min(n, 25)),
    Mahalanobis frozen a linearization: the `linearize` kernel reads the
    map's `packed` rows by voxel id), or NDT D2D / P2D (the eager freeze of
    the hash map and the pack-form launch); an LM trial is one trial launch.

The align linearizes in the WORLD frame, as the JAX package's does (the
voxel keys are world-anchored, so the persistent map cannot re-centre a
call); past ~5-10 km from the map origin the normal equations' lever arms
erode f32, and `re_anchor_map` / `ScanToMapOdometry.re_anchor()` shift map
and pose chain to the vehicle by a whole number of cells.

Every entry point runs on `device` (CUDA unless the caller asks for the
CPU); the state-only calls (`grow_map`, `compact_map`, `re_anchor_map`,
`map_as_voxelmap`) run where the state lies.  Each functional call returns
a new state and leaves its input unchanged.  `ScanToMapOdometry` runs a
frame's covariances, align, gate and fusion as eager ops on one stream;
its only host reads are the solve's flag read a trial, the map's fill every
`grow_check_every` frames, and `poses`, `velocity` and `re_anchor`.
`process_chunk` runs its frames one after another with no read between
them; its one-program form (a CUDA graph of the frame body) waits for the
device-resident LM loop.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from .. import device as _device
from .. import se3
from ..ops import soa
from ..ops.covariance import knn_covariance_cols, rbf_covariance_cols
from ..ops.voxelmap import (
    _COORD_SENTINEL,
    _EMPTY,
    MAX_PROBE,
    VoxelMap,
    _build_table,
    _hash_coords,
    compact_ids,
    lookup_lut,
    neighbor_offsets,
    next_pow2,
    segment_by_voxel,
)
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from ..utils.padding import bucket_size, pad_points


class MapState(NamedTuple):
    sums: torch.Tensor  # (C, 13) f32: [count, sum mean (3), sum cov (9)]
    coords: torch.Tensor  # (C, 3) int32 voxel coords (world frame)
    lut: torch.Tensor  # (T, 4) int32 [vid, cx, cy, cz]
    num_voxels: torch.Tensor  # () int32
    resolution: float  # a float32 value


# Static per-frame bound on NEW voxels admitted to the map (the compaction
# size of the claim and commit scatters); a frame discovering more admits
# the first ones and the rest on later frames.
_NEW_PER_FRAME_CAP = 16384


def _f32(v) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


def _state_on(state: MapState, dev: torch.device) -> MapState:
    """The state's tensors on `dev` (the same tensors if they lie there)."""
    return state._replace(**{f: getattr(state, f).to(dev)
                             for f in ("sums", "coords", "lut", "num_voxels")})


def _lut_from_table(table, coords):
    """(T, 4) int32 lut [vid, coords of vid] from a (T,) table of ids or
    _EMPTY; empty slots carry _COORD_SENTINEL coords."""
    occupied = table != _EMPTY
    lut_coords = torch.where(occupied[:, None],
                             coords[torch.where(occupied, table, 0).long()], _COORD_SENTINEL)
    return torch.cat([table[:, None], lut_coords], dim=1)


def _scalar_i32(v, dev):
    return torch.full((), v, dtype=torch.int32, device=dev)


def _on(v, dev):
    """A float32 value on `dev` with no host sync: a tensor moved, a Python
    number filled in, a host array uploaded asynchronously."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    if np.ndim(v) == 0:
        return torch.full((), float(v), dtype=torch.float32, device=dev)
    return _device.upload(np.asarray(v, np.float32), dev)


def empty_map(capacity: int, resolution: float, table_factor: int = 8,
              device="cuda") -> MapState:
    """An empty map of `capacity` voxels and a lut of next_pow2(table_factor
    x capacity) slots (MAX_PROBE is sized for a 1/8 load factor; the
    persistent map reaches full load over time), on `device`."""
    dev = _device.resolve(device)
    table_size = next_pow2(table_factor * capacity)
    lut = torch.full((table_size, 4), _COORD_SENTINEL, dtype=torch.int32, device=dev)
    lut[:, 0].fill_(_EMPTY)
    return MapState(sums=torch.zeros((capacity, 13), dtype=torch.float32, device=dev),
                    coords=torch.zeros((capacity, 3), dtype=torch.int32, device=dev),
                    lut=lut, num_voxels=_scalar_i32(0, dev), resolution=_f32(resolution))


def save_map(path: str, state: MapState) -> None:
    """Checkpoint the map to an .npz with the JAX package's keys and dtypes
    (sums f32, coords and lut int32, num_voxels int32 (), resolution f32
    ()): a checkpoint of either package loads in the other."""
    np.savez_compressed(
        path,
        sums=state.sums.cpu().numpy(),
        coords=state.coords.cpu().numpy(),
        lut=state.lut.cpu().numpy(),
        num_voxels=np.asarray(state.num_voxels.cpu().numpy(), np.int32),
        resolution=np.asarray(state.resolution, np.float32),
    )


def load_map(path: str, device="cuda") -> MapState:
    """Restore a `save_map` checkpoint onto `device`."""
    dev = _device.resolve(device)
    z = np.load(path)
    return MapState(
        sums=torch.as_tensor(z["sums"], dtype=torch.float32, device=dev),
        coords=torch.as_tensor(z["coords"], dtype=torch.int32, device=dev),
        lut=torch.as_tensor(z["lut"], dtype=torch.int32, device=dev),
        num_voxels=torch.as_tensor(z["num_voxels"], dtype=torch.int32, device=dev).reshape(()),
        resolution=_f32(z["resolution"]),
    )


def _rebuilt(sums, coords, num_voxels, resolution, table_size) -> MapState:
    """A state whose lut is rebuilt from its coords by `_build_table`."""
    table = _build_table(coords, num_voxels, coords.shape[0], table_size, MAX_PROBE)
    return MapState(sums=sums, coords=coords, lut=_lut_from_table(table, coords),
                    num_voxels=num_voxels, resolution=resolution)


def map_from_voxels(sums, coords, resolution: float, capacity: int = None,
                    device="cuda") -> MapState:
    """A MapState from bare live-voxel rows: `sums` (n, 13), `coords` (n,
    3); `capacity` defaults to 2x the row count (growth headroom), rounded
    to a power of two.  Built on `device`."""
    dev = _device.resolve(device)
    sums = _device.as_f32(sums, dev)
    coords = torch.as_tensor(coords, device=dev).to(torch.int32)
    n = sums.shape[0]
    if capacity is None:
        capacity = max(256, next_pow2(2 * max(1, n)))
    if n > capacity:
        raise ValueError(f"{n} voxels exceed capacity {capacity}")
    sums_full = torch.zeros((capacity, 13), dtype=torch.float32, device=dev)
    sums_full[:n] = sums
    coords_full = torch.zeros((capacity, 3), dtype=torch.int32, device=dev)
    coords_full[:n] = coords
    return _rebuilt(sums_full, coords_full, _scalar_i32(n, dev), _f32(resolution),
                    next_pow2(8 * capacity))


def merge_maps(a: MapState, b: MapState, transform_b=None, capacity: int = None,
               device="cuda") -> MapState:
    """Merge two persistent maps into one (stitching maps of several runs).

    Both maps must share a resolution.  `transform_b` (4x4, b's frame to
    a's) first moves map b rigidly: count unchanged, sum p -> R sum p +
    count t, sum C -> R sum C R^T, and each voxel re-bins at its moved mean
    (exact for lattice translations; otherwise a boundary voxel may land one
    cell off).  Rows landing in one cell add their sums.  Host-side numpy,
    as in the JAX package (an offline operation); the merged map is built
    on `device`."""
    res_a, res_b = float(a.resolution), float(b.resolution)
    if abs(res_a - res_b) > 1e-6 * max(res_a, res_b):
        raise ValueError(f"cannot merge maps with different resolutions ({res_a} vs {res_b})")
    na, nb = int(a.num_voxels), int(b.num_voxels)
    rows_a = a.sums[:na].cpu().numpy()
    coords_a = a.coords[:na].cpu().numpy()
    rows_b = b.sums[:nb].cpu().numpy().astype(np.float64)
    coords_b = b.coords[:nb].cpu().numpy()
    if transform_b is not None and nb:
        T = np.asarray(transform_b, np.float64)
        R, t = T[:3, :3], T[:3, 3]
        cnt = rows_b[:, :1]
        sp = rows_b[:, 1:4] @ R.T + cnt * t
        sc = np.einsum("ij,njk,lk->nil", R, rows_b[:, 4:13].reshape(-1, 3, 3), R).reshape(-1, 9)
        rows_b = np.concatenate([cnt, sp, sc], axis=1)
        coords_b = np.floor(sp / np.maximum(cnt, 1e-9) / res_a - 0.5).astype(np.int32)
    coords = np.concatenate([coords_a, coords_b.astype(np.int32)])
    rows = np.concatenate([rows_a.astype(np.float64), rows_b])
    uniq, inv = np.unique(coords, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    merged = np.zeros((len(uniq), 13), np.float64)
    np.add.at(merged, inv, rows)
    return map_from_voxels(merged.astype(np.float32), uniq.astype(np.int32), res_a,
                           capacity=capacity, device=device)


def grow_map(state: MapState, new_capacity: int) -> MapState:
    """The map migrated into a larger allocation, made once (sums and coords
    copied, the lut rebuilt at next_pow2(8 x new_capacity) slots).  The
    update's cost grows with the capacity, so `ScanToMapOdometry` starts
    small and doubles; a `new_capacity` no larger returns the state."""
    old = state.sums.shape[0]
    if new_capacity <= old:
        return state
    dev = state.sums.device
    sums = torch.zeros((new_capacity, 13), dtype=torch.float32, device=dev)
    sums[:old] = state.sums
    coords = torch.zeros((new_capacity, 3), dtype=torch.int32, device=dev)
    coords[:old] = state.coords
    return _rebuilt(sums, coords, state.num_voxels, state.resolution,
                    next_pow2(8 * new_capacity))


def compact_map(state: MapState, center, radius) -> MapState:
    """Evict the voxels whose centres lie farther than `radius` from
    `center` (bounded memory on long drives): a stable argsort of the
    inverted keep mask slides the survivors to the front in their order, and
    the lut is rebuilt.  Capacity is unchanged; `center` (3,) and `radius`
    may be device values, so a caller compacts without a host read."""
    capacity, table_size = state.sums.shape[0], state.lut.shape[0]
    dev = state.sums.device
    vid = torch.arange(capacity, device=dev)
    live = vid < state.num_voxels
    # voxel coord c spans x / res in [c + 0.5, c + 1.5): its centre (c + 1) res
    centers = (state.coords.to(torch.float32) + 1.0) * state.resolution
    center = _on(center, dev)
    radius = _on(radius, dev)
    d2 = torch.sum((centers - center[None]) ** 2, dim=1)
    keep = live & (d2 <= radius * radius)
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    count = keep.sum().to(torch.int32)
    front = (vid < count)[:, None]
    sums = torch.where(front, state.sums[order], 0.0)
    coords = torch.where(front, state.coords[order], 0)
    return _rebuilt(sums, coords, count, state.resolution, table_size)


def re_anchor_map(state: MapState, shift_cells) -> MapState:
    """The map's frame shifted by -shift_cells x resolution (long-drive
    re-anchoring): voxel coords shift by the whole cell count (exact:
    floor(x / res - 0.5) commutes with whole-cell translations), the mean
    sums by -count t, the covariance sums not at all, and the lut is rebuilt.
    `shift_cells` (3,) int32, a host array or a device value."""
    dev = state.sums.device
    capacity, table_size = state.sums.shape[0], state.lut.shape[0]
    live = (torch.arange(capacity, device=dev) < state.num_voxels)[:, None]
    k = (shift_cells.to(device=dev, dtype=torch.int32) if isinstance(shift_cells, torch.Tensor)
         else _device.upload(np.asarray(shift_cells, np.int32), dev))
    t = k.to(torch.float32) * state.resolution
    coords = torch.where(live, state.coords - k[None], state.coords)
    shifted = torch.cat([state.sums[:, 0:1], state.sums[:, 1:4] - state.sums[:, 0:1] * t[None],
                         state.sums[:, 4:13]], dim=1)
    sums = torch.where(live, shifted, state.sums)
    return _rebuilt(sums, coords, state.num_voxels, state.resolution, table_size)


def _update_map(state: MapState, points_world, cov9, mask, new_cap: int) -> MapState:
    """`update_map` on tensors on the state's device; cov9 (N, 9) rows."""
    capacity, table_size = state.sums.shape[0], state.lut.shape[0]
    n = points_world.shape[0]
    dev = points_world.device
    i64 = torch.int64

    # segment the scan by voxel (as the hash map's build does)
    seg, new_seg, seg_sorted, sorted_coords, n_segs = segment_by_voxel(
        points_world, mask, state.resolution, n)
    contrib = torch.cat([torch.ones((n, 1), dtype=torch.float32, device=dev), points_world,
                         cov9], dim=1) * mask.to(torch.float32)[:, None]
    seg_sums = torch.zeros((n + 1, 13), dtype=torch.float32, device=dev)
    seg_sums.index_add_(0, seg, contrib)
    seg_sums = seg_sums[:n]
    seg_coords = torch.full((n + 1, 3), _COORD_SENTINEL, dtype=torch.int32, device=dev)
    seg_coords[torch.where(new_seg, seg_sorted, n)] = sorted_coords
    seg_coords = seg_coords[:n]
    seg_valid = torch.arange(n, device=dev) < n_segs

    # match the scan's voxels against the map
    vids = lookup_lut(state.lut, seg_coords)
    exists = seg_valid & (vids >= 0)
    is_new = seg_valid & (vids < 0)

    # phase 1: compact the new-voxel candidates (ascending, filled with n - 1)
    new_cap = min(new_cap, n)
    cand, n_new = compact_ids(is_new, new_cap, fill=n - 1)
    lanes = torch.arange(new_cap, device=dev)
    cand_valid = lanes < torch.clamp(n_new, max=new_cap)  # the rest retry next frame
    # Pre-filter to guaranteed capacity BEFORE claiming: a candidate that won
    # a slot and then failed the capacity check would leave a hole in its
    # probe chain that orphans same-frame voxels under the stop-at-empty
    # lookup.  The pre-claim rank bounds the post-claim rank, so every claim
    # winner is admissible.
    pre_rank = torch.cumsum(cand_valid.to(i64), 0) - 1
    cand_valid = cand_valid & (state.num_voxels + pre_rank < capacity)
    cand_coords = seg_coords[cand]

    # phase 2: claim lut slots with tickets on a copy of the table whose
    # occupied slots are blocked (-1); slot table_size parks non-attempts
    mask_t = table_size - 1
    slot = _hash_coords(cand_coords[:, 0], cand_coords[:, 1], cand_coords[:, 2]) & mask_t
    table = torch.full((table_size + 1,), _EMPTY, dtype=i64, device=dev)
    table[:table_size] = torch.where(state.lut[:, 0] != _EMPTY, -1, _EMPTY)
    tickets = lanes
    pending = cand_valid
    for _ in range(MAX_PROBE):
        attempt = pending & (table[slot] == _EMPTY)
        table.scatter_reduce_(0, torch.where(attempt, slot, table_size), tickets,
                              reduce="amin", include_self=True)
        won = attempt & (table[slot] == tickets)
        pending = pending & ~won
        slot = torch.where(pending, (slot + 1) & mask_t, slot)
    # a claim succeeded iff its ticket sits in the slot where it stopped
    claimed = cand_valid & ~pending & (table[slot] == tickets)

    # phase 3: voxel ids for the claimed candidates, in candidate order
    new_vid = state.num_voxels + torch.cumsum(claimed.to(i64), 0) - 1
    in_cap = claimed & (new_vid < capacity)
    assigned = torch.full((n + 1,), -1, dtype=i64, device=dev)
    assigned[torch.where(in_cap, cand, n)] = new_vid
    assigned = assigned[:n]

    # phase 4: commit the sums (one scatter over the segments), the new
    # voxels' coords and their lut rows
    target_vid = torch.where(exists, vids.to(i64), torch.where(assigned >= 0, assigned, capacity))
    sums = torch.cat([state.sums, torch.zeros((1, 13), dtype=torch.float32, device=dev)])
    sums.index_add_(0, target_vid, seg_sums * (exists | (assigned >= 0)).to(torch.float32)[:, None])
    coords = torch.cat([state.coords, torch.zeros((1, 3), dtype=torch.int32, device=dev)])
    coords[torch.where(in_cap, new_vid, capacity)] = cand_coords
    num_voxels = torch.clamp(state.num_voxels + in_cap.sum(), max=capacity).to(torch.int32)
    lut = torch.cat([state.lut, torch.full((1, 4), _EMPTY, dtype=torch.int32, device=dev)])
    lut[torch.where(in_cap, slot, table_size)] = torch.cat(
        [new_vid[:, None].to(torch.int32), cand_coords], dim=1)
    return MapState(sums=sums[:capacity], coords=coords[:capacity], lut=lut[:table_size],
                    num_voxels=num_voxels, resolution=state.resolution)


@f32_matmuls
def update_map(state: MapState, points_world, covs_world, mask,
               new_cap: int = _NEW_PER_FRAME_CAP, device="cuda") -> MapState:
    """Fuse a registered scan (world frame; covariances (N, 3, 3) or (N, 9)
    rows) into the map.

    Additive accumulation like AdditiveGaussianVoxel (fast_vgicp_voxel.hpp:
    105-122), but persistent: existing voxels keep their history.  Insertion
    is claim-first: a new voxel's row and id are committed only after its lut
    claim succeeds, so a voxel whose probe window is full is dropped for this
    frame (and retried the next) instead of leaking an unreachable row; new
    voxels beyond capacity are dropped.  Runs on `device`."""
    dev = _device.resolve(device)
    state = _state_on(state, dev)
    pts = _device.as_f32(points_world, dev)
    cov9 = _device.as_f32(covs_world, dev).reshape(pts.shape[0], 9)
    return _update_map(state, pts, cov9, _device.as_bool(mask, dev), new_cap)


def map_as_voxelmap(state: MapState, max_weight_points: float = 25.0) -> VoxelMap:
    """The additive sums finalized into a `VoxelMap` view for registration.

    The residual weight downstream is sqrt(count) (fast_vgicp_impl.hpp:149),
    made for single-scan maps; in a persistent map counts grow with every
    fused frame and would skew the objective toward long-observed (ground)
    voxels, so the count the objective sees (`packed[:, 12]`) is clamped to
    a scan-like scale."""
    capacity = state.sums.shape[0]
    counts_f = state.sums[:, 0]
    n_f = torch.clamp(counts_f, min=1.0)[:, None]
    means = state.sums[:, 1:4] / n_f
    covs = state.sums[:, 4:13] / n_f
    packed = torch.cat([means, covs, torch.clamp(counts_f, max=max_weight_points)[:, None],
                        torch.zeros((capacity, 3), dtype=torch.float32,
                                    device=counts_f.device)], dim=1).contiguous()
    return VoxelMap(means=means, covs=covs.reshape(capacity, 3, 3),
                    counts=counts_f.to(torch.int32), coords=state.coords,
                    table=state.lut[:, 0], num_voxels=state.num_voxels,
                    resolution=state.resolution, packed=packed, lut=state.lut)


class ScanToMapConfig(NamedTuple):
    """The JAX package's ScanToMapConfig: its fields and defaults."""

    resolution: float = 1.0
    # the INITIAL map allocation; the odometry doubles it whenever the map
    # passes 70% full (the update's cost grows with the capacity)
    capacity: int = 1 << 15
    max_capacity: int = 1 << 21
    grow_check_every: int = 32  # frames between (synchronizing) fill checks
    # static bound on NEW voxels admitted a frame (the claim and commit
    # scatters' size); the first scans of a sequence take 2-3 frames to be
    # admitted whole, steady frames discover a few hundred
    new_per_frame_capacity: int = 4096
    # direct1, the reference's own VGICP default (the 7-offset objective
    # reject-storms the LM against the persistent map)
    neighbor_search_method: str = "direct1"
    neighbor_search_radius: float = 1.5
    # tracking gate: an align whose pose deviates from the constant-velocity
    # prediction by more than this is rejected (the prediction is used and
    # the scan is not fused); evaluated on the device.  None disables a gate.
    gate_translation: float = 1.0  # metres
    gate_rotation: float = 0.5  # radians
    # after this many consecutive rejections a live align is accepted anyway
    gate_relock_after: int = 5
    # bounded memory: every `evict_every` frames drop the voxels farther than
    # `eviction_radius` metres from the current pose; None keeps everything
    eviction_radius: float = None
    evict_every: int = 64
    # False: localization on a frozen map (no fusion, growth or eviction;
    # every frame, the first too, aligns against `initial_map=`)
    fuse_scans: bool = True
    # "vgicp" (sqrt(n)-weighted frozen-Mahalanobis GICP), or "ndt_d2d" /
    # "ndt_p2d" (Cauchy-robust NDT weights, ndt_compute_derivatives.cu:15-18)
    objective: str = "vgicp"
    lsq: LsqConfig = LsqConfig()


def map_objective(state: MapState, source, source_mask, source_covs,
                  config: ScanToMapConfig):
    """The objective `align_to_map` solves, on tensors on the state's
    device: VGICP -> `make_vgicp_objective`'s (linearize, error, freeze,
    linearize_frozen) on the map's `VoxelMap` view (the freeze probes the
    lut, the `linearize` kernel reads `packed` by voxel id); NDT -> the
    `NdtObjective` on the same view (an eager freeze into a pack and the
    pack-form launch a linearization)."""
    from .ndt import make_ndt_objective
    from .vgicp import VGICPConfig, make_vgicp_objective

    vm = map_as_voxelmap(state)
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    if config.objective in ("ndt_d2d", "ndt_p2d"):
        return make_ndt_objective(source, source_mask,
                                  None if config.objective == "ndt_p2d" else source_covs,
                                  vm, offsets)
    if config.objective != "vgicp":
        raise ValueError(f"unknown scan-to-map objective: {config.objective}")
    vcfg = VGICPConfig(resolution=config.resolution,
                       neighbor_search_method=config.neighbor_search_method,
                       neighbor_search_radius=config.neighbor_search_radius, lsq=config.lsq)
    return make_vgicp_objective(source, source_mask, source_covs, vm, offsets, vcfg)


def _align(state, source, source_mask, source_covs, guess, config) -> LsqResult:
    obj = map_objective(state, source, source_mask, source_covs, config)
    linearize, error = obj[0], obj[1]
    return lsq_solve(linearize, error, guess, config.lsq)


@f32_matmuls
def align_to_map(state: MapState, source, source_mask, source_covs, guess,
                 config: ScanToMapConfig = ScanToMapConfig(), device="cuda") -> LsqResult:
    """Register a scan (sensor frame; covariances (6, N) sym-6 columns or
    (N, 3, 3)) against the persistent map, in the world frame, from `guess`.
    Runs on `device`."""
    dev = _device.resolve(device)
    state = _state_on(state, dev)
    source = _device.as_f32(source, dev)
    return _align(state, source, _device.as_bool(source_mask, dev),
                  _device.as_f32(source_covs, dev), _device.as_f32(guess, dev), config)


def _to_world(pose, points, covs6):
    """A scan and its (6, N) covariance columns in the world frame: (points
    (N, 3), covariances as (N, 9) rows)."""
    return (se3.transform_points(pose, points),
            soa.sym_cols_to_rows9(soa.rotate_sym_cols(pose[:3, :3], covs6)))


def _compose(a, b):
    return se3.orthonormalize(a @ b)


def _relative(prev, pose):
    # orthonormalized: the inverse-and-compose loop otherwise doubles the
    # rotation's defect every frame (se3.orthonormalize)
    return se3.orthonormalize(se3.invert_transform(prev) @ pose)


def _gate_pose(aligned, guess, converged, error, hessian, gate_t, gate_r,
               streak=None, relock_after=None):
    """Tracking gate: accept the aligned pose only if it converged with a
    live objective and lies within (gate_t, gate_r) of the constant-velocity
    prediction; otherwise fall back to the prediction and tell the caller
    not to fuse.  All on the device.

    trace(H) > 0 iff at least one correspondence contributed: with none the
    normal equations are zero, the LM step is the identity and the solve
    returns the guess "converged", which the deviation gates alone cannot
    tell from success (`error > 0` would also reject a legitimate zero
    residual).  The accept form rejects a NaN deviation, which compares
    False.  With `streak` (an int32 count of consecutive rejections), a live
    align is accepted anyway after `relock_after` of them (the prediction is
    then the likelier culprit), and the new streak is returned too."""
    d = se3.invert_transform(guess) @ aligned
    t_dev = torch.linalg.vector_norm(d[:3, 3])
    r_dev = se3.rotation_angle(d[:3, :3])
    alive = torch.trace(hessian) > 0.0
    live = converged & alive & torch.isfinite(error)
    good = live
    if gate_t is not None:
        good = good & (t_dev <= gate_t)
    if gate_r is not None:
        good = good & (r_dev <= gate_r)
    if streak is None:
        return torch.where(good, aligned, guess), ~good
    accept = good | (live & (streak >= relock_after))
    new_streak = torch.where(accept, torch.zeros_like(streak), streak + 1)
    return torch.where(accept, aligned, guess), ~accept, new_streak


def _frame_covs(pts, mask, covariance: str):
    """A scan's (6, N) covariance columns: RBF or kNN (k 20, plane)."""
    if covariance == "rbf":
        return rbf_covariance_cols(pts, mask)
    if covariance == "knn":
        return knn_covariance_cols(pts, mask)
    raise ValueError(f"unknown covariance estimator: {covariance}")


def _fused_frame_body(state: MapState, prev_pose, last_delta, reject_streak, pts, mask,
                      config: ScanToMapConfig, covariance: str, gate_t, gate_r):
    """One odometry frame on (bucket, 3) points and their mask on the
    state's device: covariances -> constant-velocity align -> tracking gate
    -> world transform -> fusion.  Returns (state, pose, delta, streak); on
    a reject the old delta stays verbatim (recomputing it as inv(prev)
    (prev delta) would amplify prev's defects) and the scan is not fused."""
    covs6 = _frame_covs(pts, mask, covariance)
    guess = _compose(prev_pose, last_delta)
    result = _align(state, pts, mask, covs6, guess, config)
    pose, rejected, streak = _gate_pose(
        result.transformation, guess, result.converged, result.error, result.hessian,
        gate_t, gate_r, streak=reject_streak, relock_after=config.gate_relock_after)
    delta = torch.where(rejected, last_delta, _relative(prev_pose, pose))
    if config.fuse_scans:
        state = _update_map(state, *_to_world(pose, pts, covs6), mask & ~rejected,
                            config.new_per_frame_capacity)
    return state, pose, delta, streak


def _fused_first_frame(state: MapState, pts, mask, pose, config: ScanToMapConfig,
                       covariance: str) -> MapState:
    """A fresh map's first frame: the scan anchored at `pose` (identity,
    or the resume pose of a mapping run) and fused."""
    covs6 = _frame_covs(pts, mask, covariance)
    return _update_map(state, *_to_world(pose, pts, covs6), mask,
                       config.new_per_frame_capacity)


class ScanToMapOdometry:
    """Odometry over the persistent map.

    Per frame: covariances -> constant-velocity guess -> `align_to_map` ->
    tracking gate -> fuse the scan into the map at the gated pose; the first
    frame of a fresh map is anchored at `initial_pose` (identity).  Every
    step stays on the device: read `poses` (or use `process`, which returns
    a host array) to synchronize.  `initial_map=` resumes from a `save_map`
    checkpoint (its resolution holds); with `initial_pose=` and
    `initial_velocity=` (a previous run's `poses[-1]` and `velocity`) a
    mapping run continues in a new process.  Runs on `device`."""

    def __init__(self, config: ScanToMapConfig = ScanToMapConfig(),
                 covariance: str = "rbf", initial_map: MapState = None,
                 bucket: int = None, initial_pose=None, initial_velocity=None,
                 device="cuda"):
        self.device = _device.resolve(device)
        self.config = config
        self.covariance = covariance
        self.state = (_state_on(initial_map, self.device) if initial_map is not None
                      else empty_map(config.capacity, config.resolution, device=self.device))
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self._anchor = eye if initial_pose is None else _device.as_f32(initial_pose,
                                                                        self.device)
        # resuming MAPPING on a non-empty checkpoint aligns frame 0 before
        # fusing it (stamping it in unaligned would corrupt the map); only an
        # empty map anchors frame 0 at `initial_pose`
        self._align_first_frame = (initial_map is not None
                                   and int(initial_map.num_voxels) > 0)
        self._poses_dev = []  # (4, 4) device poses, one a frame
        self._last_pose = None
        self._n_frames = 0
        self._last_delta = eye if initial_velocity is None else _device.as_f32(
            initial_velocity, self.device)
        self._resumed_velocity = initial_velocity is not None
        self._reject_streak = torch.zeros((), dtype=torch.int32, device=self.device)
        self._frames_since_check = 0
        self._frames_since_evict = 0
        # sticky padding bucket (pass `bucket`, the largest expected scan, to
        # pin it); every padded size is another set of shapes
        self._bucket = None if bucket is None else bucket_size(bucket)

    # --- the growth and eviction policy ------------------------------------

    def _maybe_grow(self) -> None:
        """Grow the map 2x when it is over 70% full, checked every
        grow_check_every frames (the fill read synchronizes).  One policy
        for every odometry class: a sharded one overrides only the primitives
        below."""
        if not self.config.fuse_scans:
            return  # a frozen map (localization): no growth, no eviction
        self._maybe_evict()
        self._frames_since_check += 1
        if self._frames_since_check < self.config.grow_check_every:
            return
        self._frames_since_check = 0
        capacity, max_capacity = self._capacity(), self._max_capacity()
        fill = self._fill()
        if capacity >= max_capacity:
            if fill > 0.95 * capacity and not getattr(self, "_warned_full", False):
                self._warned_full = True
                warnings.warn(f"map at max capacity ({fill}/{capacity} voxels"
                              f"{self._capacity_scope}); new voxels will be dropped")
            return
        if fill > 0.7 * capacity:
            self._grow(min(capacity * 2, max_capacity))

    def _maybe_evict(self) -> None:
        """Every evict_every frames, drop the voxels beyond eviction_radius
        of the current pose (enqueued on the device; no read)."""
        if self.config.eviction_radius is None or self._last_pose is None:
            return
        self._frames_since_evict += 1
        if self._frames_since_evict < self.config.evict_every:
            return
        self._frames_since_evict = 0
        self._compact(self._last_pose[:3, 3], self.config.eviction_radius)

    _capacity_scope = ""  # a sharded map: " on the fullest shard"

    def _capacity(self) -> int:
        return self.state.sums.shape[0]

    def _max_capacity(self) -> int:
        return self.config.max_capacity

    def _fill(self) -> int:
        """The voxel count; synchronizes."""
        return int(self.state.num_voxels)

    def _grow(self, new_capacity: int) -> None:
        self.state = grow_map(self.state, new_capacity)

    def _compact(self, center, radius) -> None:
        self.state = compact_map(self.state, center, radius)

    def re_anchor(self):
        """Move the map frame to the current pose (long-drive numerics).

        The map, the stored poses and the current pose shift together by a
        whole number of cells, so the trajectory stays self-consistent in the
        new frame; returns the applied world shift (float64 (3,)) for callers
        that keep a global offset.  Reads the current pose once."""
        if self._last_pose is None:
            return np.zeros(3)
        res = self.state.resolution
        t = self._last_pose[:3, 3].cpu().numpy()
        k = np.round(t / res).astype(np.int32)
        if not k.any():
            return np.zeros(3)
        shift = k.astype(np.float64) * res
        self._re_anchor_state(k)
        sh = _device.upload(shift.astype(np.float32), self.device)

        def moved(p):
            p = p.clone()
            p[:3, 3] -= sh
            return p

        self._poses_dev = [moved(p) for p in self._poses_dev]
        self._last_pose = moved(self._last_pose)
        return shift

    def _re_anchor_state(self, k) -> None:
        """Shift the map state by -k cells (a sharded map re-routes the
        voxels instead: ownership is a hash of the coords)."""
        self.state = re_anchor_map(self.state, k)

    @property
    def poses(self):
        """The pose chain as float64 (4, 4) arrays; one read."""
        if not self._poses_dev:
            return []
        return list(torch.stack(self._poses_dev).cpu().numpy().astype(np.float64))

    @property
    def velocity(self):
        """The latest frame-to-frame delta (4x4 float64): with `poses[-1]`
        and `save()` the state a mapping run resumes from."""
        return self._last_delta.cpu().numpy().astype(np.float64)

    # --- the frame ---------------------------------------------------------

    @f32_matmuls
    def _frame(self, pts, mask, have_velocity: bool):
        """One frame on (bucket, 3) points and their mask on the device:
        `_fused_first_frame` for a fresh map's anchor frame, else
        `_fused_frame_body`."""
        cfg = self.config
        if not self._poses_dev and cfg.fuse_scans and not self._align_first_frame:
            pose = self._anchor
            self.state = _fused_first_frame(self.state, pts, mask, pose, cfg, self.covariance)
        else:
            # localization and checkpoint-resumed mapping align from frame 0
            # (guess: the resume pose), a fresh map from frame 1; until a
            # velocity exists the prediction is a standstill and only the
            # liveness checks apply
            prev = self._last_pose if self._last_pose is not None else self._anchor
            self.state, pose, self._last_delta, self._reject_streak = _fused_frame_body(
                self.state, prev, self._last_delta, self._reject_streak, pts, mask, cfg,
                self.covariance, cfg.gate_translation if have_velocity else None,
                cfg.gate_rotation if have_velocity else None)
        self._poses_dev.append(pose)
        self._last_pose = pose
        self._n_frames += 1
        return pose

    def _padded(self, scans):
        """Scans padded to the sticky bucket (grown with 10% headroom to fit
        the largest), uploaded in one copy: ((F, bucket, 3), (F, bucket))."""
        biggest = max(len(s) for s in scans)
        if self._bucket is None or biggest > self._bucket:
            self._bucket = bucket_size(int(biggest * 1.1))
        padded = [pad_points(s, self._bucket) for s in scans]
        return (_device.upload(np.stack([p for p, _ in padded]), self.device),
                _device.upload(np.stack([m for _, m in padded]), self.device))

    def process_async(self, scan):
        """Feed one (N, 3) scan; returns the pose as a device tensor without
        synchronizing."""
        pts, mask = self._padded([np.asarray(scan)])
        have_velocity = len(self._poses_dev) >= 2 or self._resumed_velocity
        pose = self._frame(pts[0], mask[0], have_velocity)
        self._maybe_grow()
        return pose

    def process(self, scan) -> np.ndarray:
        """Feed one (N, 3) scan; returns the estimated world pose (4x4
        float64), synchronized."""
        return self.process_async(scan).cpu().numpy().astype(np.float64)

    def process_chunk(self, scans) -> None:
        """Feed a list of (N, 3) scans: the frames run one after another
        with the map state carried between them and no host read (the JAX
        package runs them as one `lax.scan` program; the port's one-program
        form, a CUDA graph of the frame body, waits for the device-resident
        LM loop).  The poses equal those of feeding the frames one by one;
        what differs is the cadence: the growth headroom is checked before
        the chunk instead of every `grow_check_every` frames, and eviction
        runs between chunks (keep chunks at most grow_check_every long).
        Warm-up frames (a fresh map's anchor frame and the frames before a
        velocity exists) take the per-frame path."""
        scans = [np.asarray(s) for s in scans]
        need = 1 if self._resumed_velocity else 2
        while scans and self._n_frames < need:
            self.process_async(scans.pop(0))
        if not scans:
            return
        if self.config.fuse_scans and self._n_frames:
            # the whole chunk's growth headroom now: the next fill check
            # comes after the chunk
            self._frames_since_check = self.config.grow_check_every
            self._maybe_grow()
        pts, mask = self._padded(scans)
        for i in range(len(scans)):
            self._frame(pts[i], mask[i], True)
        # the chunk's frames count toward the growth and eviction cadences
        self._frames_since_evict += len(scans) - 1
        self._frames_since_check += len(scans) - 1
        self._maybe_grow()

    def save(self, path: str) -> None:
        """Checkpoint the map (the poses are the caller's: persist them with
        utils.kitti.save_poses_kitti)."""
        save_map(path, self.state)
