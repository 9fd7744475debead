"""Batched multi-pair alignment (port of `fast_gicp_tpu.models.batch`).

Every argument carries a leading batch dimension B (all clouds of a batch
padded to one size, masks marking the rest); each pair runs through its own
target-centroid frame, objective and LM solve, as under the JAX package's
`vmap`, and the results stack into one `LsqResult` with a leading B
(transformation (B, 4, 4), hessian (B, 6, 6), error, converged and
iterations (B,)).  Each pair runs with the kernels of its single-pair path,
so each pair's result is the single-pair call's bit for bit.

As the JAX package fuses the B registrations into one program, a batch is
one device program with `device_loop` (the default): on CUDA one replay of
a CUDA graph captured once a signature (`graphs.replay_cached`: the
function, B, the padded sizes, the config, the device and whether
deterministic algorithms are on) that runs the B pairs in turn, each LM
loop a conditional WHILE node, nothing read to the host; on the CPU its
plain version.  `device_loop=False` runs the pairs eagerly, each LM trial's
flags read to the host.
"""

from __future__ import annotations

import functools

import torch

from .. import device as _device
from .. import graphs
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


def _run(body, config, inputs: dict, dev, device_loop: bool) -> LsqResult:
    """`body(config, **inputs)`: one program a signature with `device_loop`
    (`graphs.run`), else eagerly."""
    return graphs.run((body, config), inputs, functools.partial(body, config), dev,
                      device_loop)


def _gicp_pairs(config: GICPConfig, sp, sm, sc, tp, tm, tc, g) -> LsqResult:
    results = []
    for i in range(sp.shape[0]):
        def run(sp_c, tp_c, g_c, i=i):
            lin, err = make_gicp_objective(sp_c, sm[i], sc[i], tp_c, tm[i], tc[i], config)
            return lsq_solve(lin, err, g_c, config.lsq)

        results.append(centered_frame_align(run, sp[i], tp[i], tm[i], g[i]))
    return _stack(results)


@f32_matmuls
def gicp_align_batch(sources, source_masks, source_covs, targets, target_masks, target_covs,
                     guesses, config: GICPConfig = GICPConfig(), device="cuda",
                     device_loop: bool = True) -> LsqResult:
    """Batched GICP (1-NN re-searched every iteration; `refresh_iterations`
    is not read, as in the JAX package).  Runs on `device` (CUDA unless
    the caller asks for the CPU), as one program with `device_loop`."""
    dev = _device.resolve(device)
    ((sp, sm, sc), (tp, tm, tc)), g = _batch(
        dev, ((sources, source_masks, source_covs), (targets, target_masks, target_covs)),
        guesses)
    return _run(_gicp_pairs, config, dict(sp=sp, sm=sm, sc=sc, tp=tp, tm=tm, tc=tc, g=g), dev,
                device_loop)


def _vgicp_pairs(config: VGICPConfig, sp, sm, sc, tp, tm, tc, g) -> LsqResult:
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)
    results = []
    for i in range(sp.shape[0]):
        def run(sp_c, tp_c, g_c, i=i):
            vmap = build_voxelmap(tp_c, tm[i], config.resolution, covs=tc[i],
                                  mode=config.voxel_accumulation, grid_dims=config.grid_dims,
                                  device=sp.device)
            lin, err, _freeze, _lf = make_vgicp_objective(sp_c, sm[i], sc[i], vmap, offsets,
                                                          config)
            return lsq_solve(lin, err, g_c, config.lsq)

        results.append(centered_frame_align(run, sp[i], tp[i], tm[i], g[i]))
    return _stack(results)


@f32_matmuls
def vgicp_align_batch(sources, source_masks, source_covs, targets, target_masks, target_covs,
                      guesses, config: VGICPConfig = VGICPConfig(), device="cuda",
                      device_loop: bool = True) -> LsqResult:
    """Batched VGICP: each pair's Gaussian voxel map (`build_voxelmap` of
    the configured mode; `GridVoxelMap` with grid_dims, the hash map
    without), re-searched every iteration.  Runs on `device`, as one
    program with `device_loop`."""
    dev = _device.resolve(device)
    ((sp, sm, sc), (tp, tm, tc)), g = _batch(
        dev, ((sources, source_masks, source_covs), (targets, target_masks, target_covs)),
        guesses)
    return _run(_vgicp_pairs, config, dict(sp=sp, sm=sm, sc=sc, tp=tp, tm=tm, tc=tc, g=g), dev,
                device_loop)


def _ndt_pairs(config: NDTConfig, sp, sm, tp, tm, g) -> LsqResult:
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


@f32_matmuls
def ndt_align_batch(sources, source_masks, targets, target_masks, guesses,
                    config: NDTConfig = NDTConfig(), device="cuda",
                    device_loop: bool = True) -> LsqResult:
    """Batched NDT (P2D or D2D) on `_ndt_voxelmap`'s maps (the hash map, or
    a `GridVoxelMap` with grid_dims; not the dense NDT grids), re-searched
    every iteration.  Runs on `device`, as one program with
    `device_loop`."""
    _check_mode(config)
    dev = _device.resolve(device)
    ((sp, sm), (tp, tm)), g = _batch(dev, ((sources, source_masks), (targets, target_masks)),
                                     guesses)
    return _run(_ndt_pairs, config, dict(sp=sp, sm=sm, tp=tp, tm=tm, g=g), dev, device_loop)
