"""Voxelized GICP on a dense raw voxel grid (port of the main path of
`fast_gicp_tpu.models.vgicp`).

A raw voxel grid is built from the target on every align; correspondences
are (source point x neighbor voxel) over the configured offsets; each
linearization freezes the per-pair Mahalanobis (cov_voxel + R C_src R^T)^-1
and the weight w = sqrt(voxel count) (fast_vgicp_impl.hpp:149) for the LM
trials that follow.  The per-correspondence math runs in the
`cuda_linearize` kernel and, each LM trial, in one launch of the trial
kernel (`cuda_solver.lm_step`); their plain versions for CPU tensors.

Ported here: the raw-grid objective and the two-phase `vgicp_align` /
`vgicp_register`.  The hash map (grid_dims=None), the non-additive
accumulation modes and the class API are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import device as _device
from ..ops import cuda_linearize, cuda_solver, soa
from ..ops.covariance import rbf_covariance_cols
from ..ops.voxelmap import (
    DenseRawGridMap,
    build_raw_grid,
    lookup_raw_ids_cols,
    neighbor_offsets,
    voxel_coord,
)
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from .base import centered_frame_align


class VGICPConfig(NamedTuple):
    """Defaults match fast_vgicp_impl.hpp:22-24; the fields and defaults of
    the JAX package's VGICPConfig.

    grid_dims: static (Dx, Dy, Dz) of the dense grid (`auto_grid_dims`).
    refresh_iterations: R -> re-search correspondences for the first R LM
    iterations, then freeze them for the rest; None re-searches every
    iteration like FastVGICP.
    """

    resolution: float = 1.0
    neighbor_search_method: str = "direct1"
    neighbor_search_radius: float = 1.5
    voxel_accumulation: str = "additive"
    k_correspondences: int = 20
    regularization: str = "plane"
    grid_dims: tuple | None = None
    refresh_iterations: int | None = None
    lsq: LsqConfig = LsqConfig()


def make_vgicp_objective(source, source_mask, source_covs, vmap, offsets,
                         config: VGICPConfig):
    """(linearize, error, freeze, linearize_frozen) for the VGICP objective
    against a `DenseRawGridMap`.

    Correspondences are flattened offset-major to L = K * N columns, the
    layout of the kernels; the source columns and covariance columns are
    loop-invariant and the pose is applied inside the kernels.
    `freeze(x)` looks up the voxel row ids (K * N,) int64 at pose x and
    `linearize_frozen(x, ids)` linearizes against them without a
    re-search, the kernel reading each row of the map by its id.
    """
    if not isinstance(vmap, DenseRawGridMap):
        raise NotImplementedError("only the dense raw grid map is ported")
    k = len(offsets)
    P = soa.cols_from_points(source)  # (3, N)
    C_A = soa.sym_cols_from_covs(source_covs)  # (6, N) passes through
    P_flat = P.repeat(1, k).contiguous()  # (3, K*N), column k*N + i = P[:, i]
    CA_flat = C_A.repeat(1, k).contiguous()
    valid = source_mask.to(source.dtype).repeat(k).contiguous()

    def freeze(x):
        coords = voxel_coord(soa.transform_cols(x, P), vmap.resolution)
        q = [
            torch.stack([coords[a] + int(o[a]) for o in offsets])  # (K, N)
            for a in range(3)
        ]
        return lookup_raw_ids_cols(vmap, config.grid_dims, *q).reshape(-1)

    def linearize_frozen(x, ids):
        return cuda_linearize.linearize_raw(P_flat, CA_flat, x, vmap.rows, valid, ids)

    def linearize(x):
        return linearize_frozen(x, freeze(x))

    # the trial cost the LM steps launch: the weight is aux row 6
    error = cuda_solver.TrialCost(P_flat)

    return linearize, error, freeze, linearize_frozen


def _build_target_map(target, target_mask, target_covs, config: VGICPConfig):
    if config.grid_dims is None or config.voxel_accumulation not in (
        "additive", "additive_weighted",
    ):
        raise NotImplementedError(
            "only the dense raw grid (grid_dims set, additive accumulation) "
            "is ported"
        )
    return build_raw_grid(target, target_mask, config.resolution, target_covs,
                          config.grid_dims)


@f32_matmuls
def vgicp_align(source, source_mask, source_covs, target, target_mask,
                target_covs, guess, config: VGICPConfig = VGICPConfig(),
                device="cuda") -> LsqResult:
    """Voxelized-GICP align of (N, 3) source onto (M, 3) target, with
    per-point covariances as (N, 3, 3) or (6, N) sym-6 columns.

    With config.refresh_iterations = R the solve is two-phase: R iterations
    with a voxel re-search each, then the correspondences are frozen at the
    phase-1 pose for the remaining iterations.  Runs in the target-centroid
    frame; the returned pose and Hessian are world-frame.  Runs on `device`
    (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    source = _device.as_f32(source, dev)
    target = _device.as_f32(target, dev)
    source_covs = _device.as_f32(source_covs, dev)
    target_covs = _device.as_f32(target_covs, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    guess = _device.as_f32(guess, dev)
    offsets = neighbor_offsets(config.neighbor_search_method,
                               config.neighbor_search_radius)

    def run(src_c, tgt_c, x0):
        vmap = _build_target_map(tgt_c, target_mask, target_covs, config)
        linearize, error, freeze, linearize_frozen = make_vgicp_objective(
            src_c, source_mask, source_covs, vmap, offsets, config
        )
        R = config.refresh_iterations
        if not R or R >= config.lsq.max_iterations:
            return lsq_solve(linearize, error, x0, config.lsq)
        p1 = lsq_solve(linearize, error, x0,
                       config.lsq._replace(max_iterations=R))
        frozen = freeze(p1.transformation)
        p2 = lsq_solve(
            lambda x: linearize_frozen(x, frozen),
            error,
            p1.transformation,
            config.lsq._replace(max_iterations=config.lsq.max_iterations - R),
        )
        return p2._replace(iterations=p1.iterations + p2.iterations)

    return centered_frame_align(run, source, target, target_mask, guess)


@f32_matmuls
def vgicp_register(source, source_mask, target, target_mask, guess,
                   config: VGICPConfig = VGICPConfig(),
                   kernel_width: float = 0.5, kernel_max_dist: float = 3.0,
                   device="cuda") -> LsqResult:
    """Full registration: RBF covariances for both clouds, then the align
    (the reference's per-align covariance re-estimation protocol,
    align.cpp:56-76).  Runs on `device` (CUDA unless the caller asks for
    the CPU)."""
    dev = _device.resolve(device)
    source = _device.as_f32(source, dev)
    target = _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    scovs = rbf_covariance_cols(source, source_mask, kernel_width,
                                kernel_max_dist)
    tcovs = rbf_covariance_cols(target, target_mask, kernel_width,
                                kernel_max_dist)
    return vgicp_align(source, source_mask, scovs, target, target_mask, tcovs,
                       guess, config, device=dev)
