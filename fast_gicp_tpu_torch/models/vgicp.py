"""Voxelized GICP (port of `fast_gicp_tpu.models.vgicp`: the reference's
`FastVGICP` and the objective of `FastVGICPCuda`).

A voxel map is built from the target on every align; correspondences are
(source point x neighbor voxel) over the configured offsets (DIRECT1, 7,
27 or RADIUS); each linearization freezes the per-pair Mahalanobis
(cov_voxel + R C_src R^T)^-1 and the weight w = sqrt(voxel count)
(fast_vgicp_impl.hpp:149) for the LM trials that follow.  The maps:
  * the dense raw grid (`grid_dims` set, additive accumulation): raw sums
    that the `linearize_raw` kernel reads by row id;
  * the Gaussian voxel maps of `voxelmap.build_voxelmap` (any accumulation
    mode): the hash-table `VoxelMap` (`grid_dims` None, unbounded scenes)
    and the sparse dense-grid `GridVoxelMap`, whose finalized rows the
    `linearize` kernel reads by voxel id.
Each LM trial is one launch of the trial kernel (`cuda_solver.lm_step`);
each kernel has a plain version for CPU tensors.

`FastVGICP` is the class API (`models/base.Registration`); its default
`grid_dims="auto"` sizes the dense raw grid from the target's extent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import device as _device
from ..ops import cuda_linearize, cuda_solver, soa
from ..ops.covariance import estimate_covariance_cols, rbf_covariance_cols
from ..ops.voxelmap import (
    DenseRawGridMap,
    auto_grid_dims_from_extent,
    build_raw_grid,
    build_voxelmap,
    lookup_raw_ids_cols,
    lookup_voxels_cols,
    neighbor_offsets,
    voxel_coord,
)
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from .base import (Cloud, CovarianceRegistration, centered_frame_align,
                   centered_frame_evaluate)


class VGICPConfig(NamedTuple):
    """Defaults match fast_vgicp_impl.hpp:22-24; the fields and defaults of
    the JAX package's VGICPConfig.

    grid_dims: static (Dx, Dy, Dz) of a dense grid (`auto_grid_dims`): the
    raw grid for additive accumulation, a `GridVoxelMap` otherwise; None:
    the hash-table `VoxelMap` (unbounded scenes).
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


def _offsets(config: VGICPConfig):
    return neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)


def _query_cols(P, x, resolution, offsets):
    """Query voxel coordinates of the source columns P (3, N) at pose x
    plus each offset: three (K, N) int32 columns, offset-major."""
    coords = voxel_coord(soa.transform_cols(x, P), resolution)
    return [torch.stack([coords[a] + int(o[a]) for o in offsets]) for a in range(3)]


def make_vgicp_objective(source, source_mask, source_covs, vmap, offsets,
                         config: VGICPConfig, reduce=None):
    """(linearize, error, freeze, linearize_frozen) for the VGICP objective
    against a `DenseRawGridMap`, a `VoxelMap` or a `GridVoxelMap`.

    Correspondences are flattened offset-major to L = K * N columns, the
    layout of the kernels; the source columns and covariance columns are
    loop-invariant and the pose is applied inside the kernels.
    `freeze(x)` looks the correspondences up at pose x: on the raw grid the
    row ids (K * N,) int64 (a miss reads the zero row, count 0); on the
    other maps (max(vids, 0), valid), vids (K * N,) int32 and valid =
    (vids >= 0) & source_mask.  `linearize_frozen(x, frozen)` linearizes
    against them without a re-search, the kernel reading each row of the
    map by its id: no gather comes before it.

    `reduce` (the JAX package's `axis_name`): a sum all-reduce over the
    ranks of a mesh, each holding its own block of the source and the whole
    map; [err, H, b] and the trial error are summed across them.  None: one
    device.
    """
    k = len(offsets)
    P = soa.cols_from_points(source)  # (3, N)
    C_A = soa.sym_cols_from_covs(source_covs)  # (6, N) passes through
    P_flat = P.repeat(1, k).contiguous()  # (3, K*N), column k*N + i = P[:, i]
    CA_flat = C_A.repeat(1, k).contiguous()

    if isinstance(vmap, DenseRawGridMap):
        valid = source_mask.to(source.dtype).repeat(k).contiguous()

        def freeze(x):
            q = _query_cols(P, x, vmap.resolution, offsets)
            return lookup_raw_ids_cols(vmap, config.grid_dims, *q).reshape(-1)

        def linearize_frozen(x, ids):
            return cuda_solver.reduce_normal_eq(
                cuda_linearize.linearize_raw(P_flat, CA_flat, x, vmap.rows, valid, ids), reduce)
    else:
        mask_flat = source_mask.repeat(k)

        def freeze(x):
            vids = lookup_voxels_cols(vmap, *_query_cols(P, x, vmap.resolution,
                                                          offsets)).reshape(-1)
            return torch.clamp(vids, min=0), ((vids >= 0) & mask_flat).to(source.dtype)

        def linearize_frozen(x, frozen):
            ids, valid = frozen
            return cuda_solver.reduce_normal_eq(
                cuda_linearize.linearize(P_flat, CA_flat, x, vmap.packed, valid, ids), reduce)

    def linearize(x):
        return linearize_frozen(x, freeze(x))

    # the trial cost the LM steps launch: the weight is aux row 6
    error = cuda_solver.trial_cost(cuda_solver.TrialCost(P_flat), reduce)

    return linearize, error, freeze, linearize_frozen


def _build_target_map(target, target_mask, target_covs, config: VGICPConfig):
    """The raw grid for `grid_dims` with additive accumulation; otherwise
    the Gaussian voxel map of the configured mode (`GridVoxelMap` with
    `grid_dims`, the hash `VoxelMap` without)."""
    if config.grid_dims is not None and config.voxel_accumulation in (
        "additive", "additive_weighted",
    ):
        return build_raw_grid(target, target_mask, config.resolution, target_covs,
                              config.grid_dims)
    return build_voxelmap(target, target_mask, config.resolution, covs=target_covs,
                          mode=config.voxel_accumulation, grid_dims=config.grid_dims,
                          device=target.device)


def _tensors(dev, *arrays):
    """(points, mask, covs, ...) triples and trailing poses -> tensors on
    `dev`: float32, masks bool."""
    return [_device.as_bool(a, dev) if i % 3 == 1 else _device.as_f32(a, dev)
            for i, a in enumerate(arrays)]


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
    source, source_mask, source_covs, target, target_mask, target_covs, guess = _tensors(
        dev, source, source_mask, source_covs, target, target_mask, target_covs, guess)

    def run(src_c, tgt_c, x0):
        return _vgicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask,
                            target_covs, x0, config)

    return centered_frame_align(run, source, target, target_mask, guess)


def _vgicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask, target_covs, x0,
                 config: VGICPConfig, reduce=None) -> LsqResult:
    """`vgicp_align`'s solve in the target-centroid frame: the target map,
    then one or two phases; with `reduce`, of this rank's block of the
    source against the whole map."""
    vmap = _build_target_map(tgt_c, target_mask, target_covs, config)
    linearize, error, freeze, linearize_frozen = make_vgicp_objective(
        src_c, source_mask, source_covs, vmap, _offsets(config), config, reduce=reduce
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


@f32_matmuls
def vgicp_evaluate(source, source_mask, source_covs, target, target_mask,
                   target_covs, pose, config: VGICPConfig = VGICPConfig(),
                   device="cuda"):
    """(error, H, b) of the VGICP objective at an arbitrary pose (the
    reference's evaluateCost, lsq_registration_impl.hpp:48-50), evaluated
    in the target-centroid frame and reported world-frame, consistent with
    `vgicp_align`'s Hessian.  Runs on `device`."""
    dev = _device.resolve(device)
    source, source_mask, source_covs, target, target_mask, target_covs, pose = _tensors(
        dev, source, source_mask, source_covs, target, target_mask, target_covs, pose)
    offsets = _offsets(config)

    def run(src_c, tgt_c, p):
        vmap = _build_target_map(tgt_c, target_mask, target_covs, config)
        linearize, _error, _freeze, _lf = make_vgicp_objective(
            src_c, source_mask, source_covs, vmap, offsets, config)
        err, H, b, _aux = linearize(p)
        return err, H, b

    return centered_frame_evaluate(run, source, target, target_mask, pose)


@f32_matmuls
def vgicp_mahalanobis(source, source_mask, source_covs, target, target_mask,
                      target_covs, pose, config: VGICPConfig = VGICPConfig(),
                      device="cuda"):
    """Per-correspondence Mahalanobis matrices at `pose`, the debug surface
    of the reference's compute_mahalanobis (compute_mahalanobis.cu:10-72):
    (M (K, 6, N) sym-6 columns, zero where invalid; valid (K, N)), against
    the Gaussian voxel map of the configured mode (`build_voxelmap`, in the
    input frame).  Runs on `device`."""
    dev = _device.resolve(device)
    source, source_mask, source_covs, target, target_mask, target_covs, x = _tensors(
        dev, source, source_mask, source_covs, target, target_mask, target_covs, pose)
    vmap = build_voxelmap(target, target_mask, config.resolution, covs=target_covs,
                          mode=config.voxel_accumulation, grid_dims=config.grid_dims,
                          device=dev)
    P = soa.cols_from_points(source)
    vids = lookup_voxels_cols(vmap, *_query_cols(P, x, vmap.resolution, _offsets(config)))
    valid = (vids >= 0) & source_mask[None, :]
    _mu, cov_B, _n = soa.sym_cols_from_packed(vmap.packed[torch.clamp(vids, min=0)])
    cov_rot = soa.rotate_sym_cols(x[:3, :3], soa.sym_cols_from_covs(source_covs))
    M = soa.inv_sym_cols(cov_B + cov_rot[None]) * valid[:, None, :]
    return M, valid


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


@f32_matmuls
def vgicp_register_fresh(source, source_mask, target, target_mask, guess,
                         config: VGICPConfig = VGICPConfig(), method: str = "knn",
                         k: int = 20, regularization: str = "plane",
                         kernel_width: float = 0.5, kernel_max_dist: float = 3.0,
                         device="cuda"):
    """Fresh registration, the class API's first align: covariances for
    both clouds by `method` ("knn", "rbf" or "adaptive") under
    `regularization`, then the align.  Returns (LsqResult, source_cov6,
    target_cov6), the sym-6 covariance columns (6, N) for the caller's
    cache.  Runs on `device` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    source, source_mask, target, target_mask = (
        _device.as_f32(source, dev), _device.as_bool(source_mask, dev),
        _device.as_f32(target, dev), _device.as_bool(target_mask, dev))
    kwargs = dict(k=k, regularization=regularization, kernel_width=kernel_width,
                  kernel_max_dist=kernel_max_dist)
    scovs = estimate_covariance_cols(source, source_mask, method, **kwargs)
    tcovs = estimate_covariance_cols(target, target_mask, method, **kwargs)
    res = vgicp_align(source, source_mask, scovs, target, target_mask, tcovs,
                      guess, config, device=dev)
    return res, scovs, tcovs


def vgicp_align_multires(source, source_mask, source_covs, target, target_mask,
                         target_covs, guess, resolutions=(4.0, 1.0),
                         config: VGICPConfig = VGICPConfig(), device="cuda") -> LsqResult:
    """Coarse-to-fine VGICP: `vgicp_align` at each resolution in turn, each
    level starting from the pose of the one before.  A single level
    converges from guesses within about one voxel; a coarse level first
    widens the basin to the coarsest resolution."""
    result = None
    x = guess
    for r in resolutions:
        result = vgicp_align(source, source_mask, source_covs, target, target_mask,
                             target_covs, x, config._replace(resolution=float(r)),
                             device=device)
        x = result.transformation
    return result


@dataclass
class FastVGICP(CovarianceRegistration):
    """Class-API VGICP, for both `FastVGICP` and `FastVGICPCuda`; the
    covariance estimator, its setters and cache are the base's.

    grid_dims: "auto" (the dense grid sized from the target's extent, the
    raw grid for additive accumulation; the hash map where the scene is
    too large for a dense grid), None (the hash map) or an explicit
    (Dx, Dy, Dz)."""

    resolution: float = 1.0
    neighbor_search_method: str = "direct1"
    neighbor_search_radius: float = 1.5
    voxel_accumulation: str = "additive"
    grid_dims: object = "auto"

    _align_cached = staticmethod(vgicp_align)
    _evaluate_at = staticmethod(vgicp_evaluate)

    def set_resolution(self, r: float) -> None:
        self.resolution = float(r)

    def set_neighbor_search_method(self, method: str, radius: float = None) -> None:
        """DIRECT1, DIRECT7, DIRECT27 or DIRECT_RADIUS (any case)."""
        self.neighbor_search_method = method.lower()
        if radius is not None:
            self.neighbor_search_radius = float(radius)

    def set_voxel_accumulation_mode(self, mode: str) -> None:
        self.voxel_accumulation = mode

    def set_grid_dims(self, dims) -> None:
        self.grid_dims = tuple(dims) if dims not in (None, "auto") else dims

    def _grid_dims(self, target: Cloud):
        if self.grid_dims == "auto":
            lo, hi = target.extent()  # host-side, cached per cloud
            return auto_grid_dims_from_extent(lo, hi, self.resolution)
        return self.grid_dims

    def _config(self, target: Cloud) -> VGICPConfig:
        return VGICPConfig(
            resolution=self.resolution,
            neighbor_search_method=self.neighbor_search_method,
            neighbor_search_radius=self.neighbor_search_radius,
            voxel_accumulation=self.voxel_accumulation,
            k_correspondences=self.k_correspondences,
            regularization=self.regularization,
            grid_dims=self._grid_dims(target),
            lsq=self._lsq_config(),
        )


# The reference's CUDA class name: the same objective, on the card.
FastVGICPCuda = FastVGICP
