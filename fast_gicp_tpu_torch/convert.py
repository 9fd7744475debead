"""State carried between the JAX package and the port.

Registration has no weights: its state is the configuration and the voxel
map.  These helpers read the JAX package's objects as plain fields and
numpy arrays (this module imports no JAX), so both packages can compute
from the same state and their results can be compared.  Like the port's
entry points, the helpers put their tensors on the card unless the caller
passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .models.experimental import MultiPointConfig
from .models.gicp import GICPConfig
from .models.loop_closure import LoopClosureConfig
from .models.ndt import NDTConfig
from .models.pose_graph import PoseGraphConfig, PoseGraphResult
from .models.pose_graph_sparse import SlidingWindowBA, SparsePGConfig
from .models.scan_to_map import MapState
from .models.vgicp import VGICPConfig
from .ops import soa
from .ops.voxelmap import DenseRawGridMap, GridVoxelMap, NdtGridMap, RawNdtGrid, VoxelMap
from .solver import LsqConfig, LsqResult


def config_from_jax(cfg):
    """A JAX `VGICPConfig`, `GICPConfig`, `NDTConfig`, `MultiPointConfig`,
    `LsqConfig`, `PoseGraphConfig`, `SparsePGConfig` or `LoopClosureConfig`
    (any object with the same field names) -> the port's config of the same
    kind."""
    for kind, field in ((SparsePGConfig, "cg_iterations"), (LoopClosureConfig, "min_gap"),
                        (PoseGraphConfig, "gauge_weight")):
        if hasattr(cfg, field):
            return kind(**{f: getattr(cfg, f) for f in kind._fields})
    if hasattr(cfg, "lsq"):
        kind = (NDTConfig if hasattr(cfg, "distance_mode")
                else MultiPointConfig if hasattr(cfg, "search_radius")
                else VGICPConfig if hasattr(cfg, "grid_dims") else GICPConfig)
        fields = {f: getattr(cfg, f) for f in kind._fields if f != "lsq"}
        if fields.get("grid_dims") is not None:
            fields["grid_dims"] = tuple(int(d) for d in fields["grid_dims"])
        return kind(**fields, lsq=config_from_jax(cfg.lsq))
    return LsqConfig(**{f: getattr(cfg, f) for f in LsqConfig._fields})


def covs_from_numpy(covs, device="cuda"):
    """Covariances of the JAX package as numpy, (N, 3, 3) or (6, N) sym-6
    columns -> the port's (6, N) float32 sym-6 columns on `device`."""
    device = _device.resolve(device)
    t = torch.tensor(np.asarray(covs, np.float32), device=device)
    return soa.sym_cols_from_covs(t).contiguous()


def raw_grid_from_numpy(rows, grid8, origin, resolution, device="cuda"):
    """A JAX `DenseRawGridMap`'s arrays, as numpy, -> the port's map."""
    device = _device.resolve(device)
    return DenseRawGridMap(
        rows=torch.tensor(np.asarray(rows, np.float32), device=device),
        grid=_grid_from_grid8(grid8, device),
        origin=torch.tensor(np.asarray(origin, np.int32), device=device),
        resolution=float(resolution),
    )


def _grid_from_grid8(grid8, device):
    """A JAX dense grid's (ncells/8 + 1, 8) `grid8` -> the port's 1-D grid of
    ncells + 1 slots; the last slot is where out-of-grid points park in
    both layouts and is masked by every reader."""
    flat = np.asarray(grid8).reshape(-1)
    return torch.as_tensor(flat[: flat.shape[0] - 7].astype(np.int64), device=device)


def _map_fields(vmap, kind, device):
    """The fields of `kind` read from `vmap` by name: arrays as tensors of
    their own dtype (int32, float32, bool), `resolution` as a float."""
    fields = {}
    for f in kind._fields:
        a = np.asarray(getattr(vmap, f))
        fields[f] = float(a) if f == "resolution" else torch.tensor(a, device=device)
    return kind(**fields)


def voxel_map_from_numpy(vmap, device="cuda"):
    """A JAX hash-table `VoxelMap` (any object with its field names, its
    arrays as numpy or array-likes) -> the port's `VoxelMap`: the same
    statistics, table and lut."""
    return _map_fields(vmap, VoxelMap, _device.resolve(device))


def grid_voxel_map_from_numpy(gmap, device="cuda"):
    """A JAX `GridVoxelMap` (any object with its field names) -> the port's
    `GridVoxelMap`; its TPU lookup copy `grid8` is not carried (the port
    indexes `grid`)."""
    return _map_fields(gmap, GridVoxelMap, _device.resolve(device))


def raw_ndt_grid_from_numpy(rows, grid8, origin, resolution, dims, device="cuda"):
    """A JAX `RawNdtGrid`'s arrays, as numpy (dims: its `grid.shape`) -> the
    port's `RawNdtGrid`."""
    device = _device.resolve(device)
    return RawNdtGrid(
        rows=torch.tensor(np.asarray(rows, np.float32), device=device),
        grid=_grid_from_grid8(grid8, device),
        origin=torch.tensor(np.asarray(origin, np.int32), device=device),
        resolution=float(resolution),
        dims=tuple(int(d) for d in dims),
    )


def ndt_grid_map_from_numpy(packed, grid8, origin, resolution, dims, device="cuda"):
    """A JAX `NdtGridMap`'s arrays, as numpy (dims: its `grid.shape`) -> the
    port's `NdtGridMap`."""
    device = _device.resolve(device)
    return NdtGridMap(
        packed=torch.tensor(np.asarray(packed, np.float32), device=device),
        grid=_grid_from_grid8(grid8, device),
        origin=torch.tensor(np.asarray(origin, np.int32), device=device),
        resolution=float(resolution),
        dims=tuple(int(d) for d in dims),
    )


def ndt_stats_from_numpy(means, valid, cov6, device="cuda"):
    """The JAX package's compact NDT source statistics (means (B, 3),
    valid (B,), cov6 (6, B)), as numpy -> the port's tensors."""
    device = _device.resolve(device)
    return (torch.tensor(np.asarray(means, np.float32), device=device),
            torch.tensor(np.asarray(valid, bool), device=device),
            torch.tensor(np.asarray(cov6, np.float32), device=device))


def _to_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lsq_result_to_numpy(res) -> LsqResult:
    """An `LsqResult` of either package -> one with numpy fields (pose and
    Hessian arrays, error float, converged bool, iterations int)."""
    return LsqResult(
        transformation=_to_numpy(res.transformation),
        hessian=_to_numpy(res.hessian),
        error=float(_to_numpy(res.error)),
        converged=bool(_to_numpy(res.converged)),
        iterations=int(_to_numpy(res.iterations)),
    )


def pose_graph_result_to_numpy(res) -> PoseGraphResult:
    """A `PoseGraphResult` of either package -> one with numpy fields (poses
    array, error float, iterations int, converged bool)."""
    return PoseGraphResult(
        poses=_to_numpy(res.poses),
        error=float(_to_numpy(res.error)),
        iterations=int(_to_numpy(res.iterations)),
        converged=bool(_to_numpy(res.converged)),
    )


def sliding_window_from_numpy(ba, device="cuda") -> SlidingWindowBA:
    """A JAX `SlidingWindowBA` (any object with its fields) -> the port's,
    solving on `device`, with the same window, config, poses, edges (global
    indices), base, prior pose and prior information, so both can go on
    from the same state."""
    out = SlidingWindowBA(window=ba.window, config=config_from_jax(ba.config), device=device)
    out.poses = [np.array(p, np.float32) for p in ba.poses]
    out.edges = [(int(i), int(j), np.array(rel, np.float32), np.array(info, np.float32))
                 for (i, j, rel, info) in ba.edges]
    out.base = int(ba.base)
    out.prior_pose = None if ba.prior_pose is None else np.array(ba.prior_pose, np.float32)
    out.prior_info = None if ba.prior_info is None else np.array(ba.prior_info, np.float32)
    return out


def sharded_map_shards_from_numpy(state, device="cuda") -> list:
    """A JAX `ShardedMapState` (its fields as numpy arrays: the leading rows
    of sums, coords and lut global, D shards of equal size one after
    another, num_voxels (D,)) -> the D shards as port `MapState`s on
    `device`; rank r of a mesh of D ranks holds shard r
    (`parallel.sharded_map.ShardedMapState(shards[r], mesh)`)."""
    device = _device.resolve(device)
    nv = np.asarray(state.num_voxels)
    d = nv.shape[0]
    sums, coords, lut = (np.asarray(getattr(state, f)) for f in ("sums", "coords", "lut"))
    c, t = sums.shape[0] // d, lut.shape[0] // d
    res = float(np.float32(np.asarray(state.resolution)))
    return [MapState(sums=torch.tensor(sums[r * c:(r + 1) * c], dtype=torch.float32,
                                       device=device),
                     coords=torch.tensor(coords[r * c:(r + 1) * c], dtype=torch.int32,
                                         device=device),
                     lut=torch.tensor(lut[r * t:(r + 1) * t], dtype=torch.int32, device=device),
                     num_voxels=torch.tensor(int(nv[r]), dtype=torch.int32, device=device),
                     resolution=res)
            for r in range(d)]
