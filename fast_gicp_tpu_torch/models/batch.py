"""Batched multi-pair alignment (port of `fast_gicp_tpu.models.batch`).

Every argument carries a leading batch dimension B (all clouds of a batch
padded to one size, masks marking the rest); each pair runs through its own
target-centroid frame, objective and LM solve, as under the JAX package's
`vmap`, and the results stack into one `LsqResult` with a leading B
(transformation (B, 4, 4), hessian (B, 6, 6), error, converged and
iterations (B,)).  The JAX package fuses the B registrations into one
program; here the pairs run in turn on the caller's stream, each with the
kernels of its single-pair path, so each pair's result is the single-pair
call's bit for bit.  One launch for B pairs is later work.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..ops.voxelmap import build_voxelmap, neighbor_offsets
from ..precision import f32_matmuls
from ..solver import LsqResult, lsq_solve
from .base import centered_frame_align
from .gicp import GICPConfig, make_gicp_objective
from .ndt import NDTConfig, _check_mode, _compact_source_voxels, _ndt_voxelmap, make_ndt_objective
from .vgicp import VGICPConfig, make_vgicp_objective


def _stack(results) -> LsqResult:
    """B single-pair results -> one with a leading B on every field."""
    return LsqResult(*(torch.stack(field) for field in zip(*results)))


def _batch(dev, clouds, guesses):
    """(points, mask[, covs]) groups of batched arrays and the guesses ->
    lists of per-pair tensors on `dev` (masks bool, the rest float32)."""
    out = []
    for group in clouds:
        out.append([_device.as_f32(group[0], dev), _device.as_bool(group[1], dev)]
                   + [_device.as_f32(a, dev) for a in group[2:]])
    return out, _device.as_f32(guesses, dev)


@f32_matmuls
def gicp_align_batch(sources, source_masks, source_covs, targets, target_masks, target_covs,
                     guesses, config: GICPConfig = GICPConfig(), device="cuda") -> LsqResult:
    """Batched GICP (1-NN re-searched every iteration; `refresh_iterations`
    is not read, as in the JAX package).  Runs on `device` (CUDA unless
    the caller asks for the CPU)."""
    dev = _device.resolve(device)
    ((sp, sm, sc), (tp, tm, tc)), g = _batch(
        dev, ((sources, source_masks, source_covs), (targets, target_masks, target_covs)),
        guesses)
    results = []
    for i in range(sp.shape[0]):
        def run(sp_c, tp_c, g_c, i=i):
            lin, err = make_gicp_objective(sp_c, sm[i], sc[i], tp_c, tm[i], tc[i], config)
            return lsq_solve(lin, err, g_c, config.lsq)

        results.append(centered_frame_align(run, sp[i], tp[i], tm[i], g[i]))
    return _stack(results)


@f32_matmuls
def vgicp_align_batch(sources, source_masks, source_covs, targets, target_masks, target_covs,
                      guesses, config: VGICPConfig = VGICPConfig(),
                      device="cuda") -> LsqResult:
    """Batched VGICP: each pair's Gaussian voxel map (`build_voxelmap` of
    the configured mode; `GridVoxelMap` with grid_dims, the hash map
    without), re-searched every iteration.  Runs on `device`."""
    dev = _device.resolve(device)
    ((sp, sm, sc), (tp, tm, tc)), g = _batch(
        dev, ((sources, source_masks, source_covs), (targets, target_masks, target_covs)),
        guesses)
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    results = []
    for i in range(sp.shape[0]):
        def run(sp_c, tp_c, g_c, i=i):
            vmap = build_voxelmap(tp_c, tm[i], config.resolution, covs=tc[i],
                                  mode=config.voxel_accumulation, grid_dims=config.grid_dims,
                                  device=dev)
            lin, err, _freeze, _lf = make_vgicp_objective(sp_c, sm[i], sc[i], vmap, offsets,
                                                          config)
            return lsq_solve(lin, err, g_c, config.lsq)

        results.append(centered_frame_align(run, sp[i], tp[i], tm[i], g[i]))
    return _stack(results)


@f32_matmuls
def ndt_align_batch(sources, source_masks, targets, target_masks, guesses,
                    config: NDTConfig = NDTConfig(), device="cuda") -> LsqResult:
    """Batched NDT (P2D or D2D) on `_ndt_voxelmap`'s maps (the hash map, or
    a `GridVoxelMap` with grid_dims; not the dense NDT grids), re-searched
    every iteration.  Runs on `device`."""
    _check_mode(config)
    dev = _device.resolve(device)
    ((sp, sm), (tp, tm)), g = _batch(dev, ((sources, source_masks), (targets, target_masks)),
                                     guesses)
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    results = []
    for i in range(sp.shape[0]):
        def run(sp_c, tp_c, g_c, i=i):
            target_vm = _ndt_voxelmap(tp_c, tm[i], config.resolution, config.grid_dims)
            if config.distance_mode == "p2d":
                obj = make_ndt_objective(sp_c, sm[i], None, target_vm, offsets)
            else:
                means, mask, covs = _compact_source_voxels(
                    _ndt_voxelmap(sp_c, sm[i], config.resolution, config.grid_dims),
                    config.max_source_voxels)
                obj = make_ndt_objective(means, mask, covs, target_vm, offsets)
            return lsq_solve(obj.linearize, obj.error, g_c, config.lsq)

        results.append(centered_frame_align(run, sp[i], tp[i], tm[i], g[i]))
    return _stack(results)
