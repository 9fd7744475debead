"""NDT, point-to-distribution (P2D) and distribution-to-distribution (D2D)
(port of the functional dense-grid path of `fast_gicp_tpu.models.ndt`, the
reference's `NDTCuda`, ndt_cuda.cu and ndt_compute_derivatives.cu).

The target is a voxel map of raw points with NDT statistics (mean, and
covariance E[x x^T] - mu mu^T with its eigenvalues clamped to >= 1e-3);
voxels with 6 points or fewer are skipped.  P2D scores raw source points
against target voxels with M = cov_B^-1; D2D scores the source's own voxel
Gaussians with M = (cov_B + R C_A R^T)^-1.  Both use the Cauchy weight
w = c^2 / (c^2 + |e|^2), c = the voxel resolution.  M is frozen at each
linearization; the LM trials recompute w at the trial pose (the `ndt_error`
body).

Correspondences are (neighbor offset x source) lanes flattened offset-major
to L = K * N.  On the dense grids (`grid_dims` set) each linearization is one
launch of the linearize kernel, which looks each lane's voxel up in the map
itself (`cuda_ndt.ndt_linearize_lookup`; a frozen phase looks up at the pose
it froze at).  On the hash `VoxelMap` (`grid_dims` None) and the
`GridVoxelMap` (`_ndt_voxelmap`, the batch aligns' maps) each linearization
is an eager freeze (`cuda_ndt.ndt_freeze_pack`) followed by one launch of
the kernel's pack form, as the JAX package's fused objective runs it.  Each
LM trial is one launch of the trial kernel with the `ndt_error` body
(`cuda_solver.lm_step`); every kernel has its plain version for CPU tensors.

Ported here: `NDTConfig`, the objective (the JAX package's fused form,
`_make_ndt_objective_fused`), `ndt_align`, `ndt_prepare_cloud`,
`ndt_align_prebuilt`, `ndt_register_fresh`, `ndt_evaluate` and the class
API's `NDTCuda` (alias `NDT`), on the dense grids and the hash map.  The
JAX package's `axis_name` is the objective's `reduce` (`parallel.sharded`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import device as _device
from .. import se3
from ..ops import cuda_ndt, cuda_solver, soa
from ..ops.covariance import masked_mean
from ..ops.voxelmap import (
    MIN_EIG,
    GridVoxelMap,
    NdtGridMap,
    RawNdtGrid,
    VoxelMap,
    auto_grid_dims_from_extent,
    build_ndt_grid_compact,
    build_ndt_raw_grid,
    build_voxelmap,
    compact_ids,
    neighbor_offsets,
)
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from .base import Cloud, Registration, centered_frame_align, centered_frame_evaluate


class NDTConfig(NamedTuple):
    """Defaults match ndt_cuda.cu:21-22 (D2D, DIRECT7, resolution 1.0); the
    fields and defaults of the JAX package's NDTConfig.

    grid_dims: static (Dx, Dy, Dz) of the dense grids (`auto_grid_dims`);
    None: the hash `VoxelMap` (unbounded scenes).
    max_source_voxels / max_target_voxels: row budgets of the compacted
    D2D source statistics and of the prepared dense target map; occupied
    voxels beyond a budget are dropped for the align.
    refresh_iterations: R -> re-search voxel correspondences for the first
    R LM iterations, then freeze the gathered rows for the rest; None
    re-searches every iteration.
    """

    resolution: float = 1.0
    distance_mode: str = "d2d"  # "p2d" | "d2d"
    neighbor_search_method: str = "direct7"
    neighbor_search_radius: float = 1.5
    grid_dims: tuple | None = None
    max_source_voxels: int = 4096
    max_target_voxels: int = 8192
    refresh_iterations: int | None = None
    lsq: LsqConfig = LsqConfig()


class _FinPack(NamedTuple):
    """A finalized frozen pack [mu, M, valid] rebuilt from a linearize aux
    (P2D's frozen phase): its type tells `linearize_frozen` to run the
    M-direct "p2d" kernel even on a raw map."""

    pack: torch.Tensor


def _check_mode(config: NDTConfig):
    if config.distance_mode not in ("p2d", "d2d"):
        raise ValueError(f"unknown NDT distance mode: {config.distance_mode}")


def _ndt_voxelmap(points, mask, resolution, grid_dims=None):
    """The NDT voxel map of (N, 3) points on the hash table (grid_dims None)
    or a `GridVoxelMap`: `build_voxelmap(mode="raw")` (mean E[x], covariance
    E[x x^T] - mu mu^T), the eigenvalues clamped to >= MIN_EIG
    (ndt_cuda.cu:120-140) and the clamped rows written into `packed`."""
    vm = build_voxelmap(points, mask, resolution, mode="raw", grid_dims=grid_dims,
                        device=points.device)
    rows9 = soa.sym_cols_to_rows9(soa.clamp_eigs_cols(soa.sym_cols_from_covs(vm.covs),
                                                      MIN_EIG))
    packed = torch.cat([vm.packed[:, :3], rows9, vm.packed[:, 12:]], dim=1).contiguous()
    return vm._replace(covs=rows9.reshape(-1, 3, 3), packed=packed)


def _compact_source_voxels(vm, max_voxels: int):
    """(means (cap, 3), valid (cap,), covs (cap, 3, 3)) of the occupied
    voxels of a `VoxelMap` or `GridVoxelMap` in ascending voxel id, cap =
    min(max_voxels, capacity); rows beyond the occupied count read voxel 0
    and are invalid (`jnp.nonzero(size=cap, fill_value=0)`), and occupied
    voxels beyond cap are dropped for the align.  No host sync."""
    cap = min(max_voxels, vm.means.shape[0])
    idx, n_occ = compact_ids(vm.counts > 0, cap, fill=0)
    valid = torch.arange(cap, device=idx.device) < n_occ
    return vm.means[idx], valid, vm.covs[idx]


class NdtObjective(NamedTuple):
    """The NDT objective over L = K * N lanes (offset-major), as
    `make_ndt_objective` builds it.

    On a dense map, `linearize(x)` looks each lane's voxel up at pose x
    inside the linearize kernel (`cuda_ndt.ndt_linearize_lookup`: one
    launch from the pose and the map to [err, H, b] and aux).  `freeze(x)`
    returns the pose x itself (no device op); `linearize_frozen(x, frozen)`
    re-linearizes against the voxels looked up at that pose, in the same
    launch (D2D still re-freezes M from the current rotation, and the
    Cauchy weight follows the pose).  On the hash `VoxelMap` and the
    `GridVoxelMap`, `freeze(x)` is the eager freeze into a pack
    (`cuda_ndt.ndt_freeze_pack`), `linearize_frozen(x, pack)` one pack-form
    launch (D2D's M again at the current rotation) and `linearize(x)` the
    two in turn.  `pack_from_aux` (P2D only, else None) rebuilds a frozen
    state from a linearize's aux: P2D's M does not depend on the pose, so
    the two-phase solve seeds its frozen phase from the last refresh
    iteration instead of re-searching; `linearize_frozen` takes it as a
    `_FinPack` (the pack form).  `p`, `ca`, `mask`, `vmap`, `offsets` and
    `mode` are what the kernels read besides the pose."""

    linearize: Callable  # x -> (err, H, b, aux)
    # (x, aux) -> err, and the trial launch's form (a ReducedCost across ranks)
    error: cuda_solver.TrialCost | cuda_solver.ReducedCost
    freeze: Callable  # x -> the lookup pose of the frozen phase
    linearize_frozen: Callable  # (x, pose or _FinPack) -> (err, H, b, aux)
    pack_from_aux: Callable | None  # aux -> _FinPack (P2D only)
    p: torch.Tensor  # (3, N) source columns
    ca: torch.Tensor | None  # (6, N) source covariance columns (D2D only)
    mask: torch.Tensor  # (N,) bool source validity
    vmap: RawNdtGrid | NdtGridMap | VoxelMap | GridVoxelMap  # the target map
    offsets: np.ndarray  # (K, 3) int32 neighbour offsets
    mode: str  # the `ndt_linearize` mode of `linearize`


def make_ndt_objective(src_means, src_mask, src_covs, vmap, offsets,
                       reduce=None) -> NdtObjective:
    """The NDT objective against a `RawNdtGrid`, an `NdtGridMap` or, from
    `_ndt_voxelmap`, a `VoxelMap` or `GridVoxelMap`; src_covs is None for
    P2D, else the source voxel covariances as (6, N) sym-6 columns or
    (N, 3, 3).  `reduce` (the JAX package's `axis_name`): a sum all-reduce
    over the ranks of a mesh, each holding its own block of the source
    points (P2D) or voxels (D2D) and the whole map; the fields `linearize`,
    `linearize_frozen` and `error` then sum [err, H, b] and the trial error
    across them.  None: one device."""
    n = src_means.shape[0]
    offsets = np.ascontiguousarray(np.asarray(offsets, np.int32))
    k = len(offsets)
    L = n * k
    raw = isinstance(vmap, RawNdtGrid)
    d2d = src_covs is not None
    mode = ("d2d" if d2d else "p2d") + ("_raw" if raw else "")
    res = vmap.resolution
    P = soa.cols_from_points(src_means).contiguous()  # (3, N), read untiled
    CA = soa.sym_cols_from_covs(src_covs).contiguous() if d2d else None
    mask = src_mask.contiguous()

    # the kernel cannot look a hash map (or a GridVoxelMap) up: there every
    # linearization is an eager freeze into a pack, then the pack form
    eager = isinstance(vmap, (VoxelMap, GridVoxelMap))

    def freeze(x):
        if eager:
            return cuda_ndt.ndt_freeze_pack(P, mask, x, vmap, offsets, mode)
        # the frozen phase looks its voxels up at x, read at every launch:
        # x itself, not a copy (phase 1's pose, which nothing writes again)
        return x

    def local_frozen(x, frozen):
        if isinstance(frozen, _FinPack):
            return cuda_ndt.ndt_linearize(P, CA, x, frozen.pack, res, "p2d")
        if eager:
            return cuda_ndt.ndt_linearize(P, CA, x, frozen, res, mode)
        return cuda_ndt.ndt_linearize_lookup(P, CA, mask, x, vmap, offsets, mode,
                                             x_lookup=frozen)

    def linearize_frozen(x, frozen):
        return cuda_solver.reduce_normal_eq(local_frozen(x, frozen), reduce)

    def linearize(x):
        if eager:
            return linearize_frozen(x, freeze(x))
        return cuda_solver.reduce_normal_eq(
            cuda_ndt.ndt_linearize_lookup(P, CA, mask, x, vmap, offsets, mode), reduce)

    # the trial cost the LM steps launch (the Cauchy weight at the trial pose)
    error = cuda_solver.trial_cost(cuda_solver.TrialCost(P, offsets=k, resolution=res),
                                   reduce)

    def pack_from_aux(aux):
        # aux [M (6), valid, mu (3)] -> the M-direct pack [mu, M, valid, pad]
        return _FinPack(torch.cat(
            [aux[7:10].T, aux[0:6].T, aux[6:7].T,
             torch.zeros((L, 6), dtype=aux.dtype, device=aux.device)], dim=1
        ).contiguous())

    # P2D only: D2D's frozen phase re-freezes M from cov_B at each
    # linearization, and the aux carries only M (the JAX package measured
    # 8 mm off the full re-search solve with an aux-seeded D2D freeze).
    return NdtObjective(linearize, error, freeze, linearize_frozen,
                        None if d2d else pack_from_aux, P, CA, mask, vmap, offsets, mode)


def _two_phase_solve(obj: NdtObjective, x0, config: NDTConfig) -> LsqResult:
    """R re-searching LM iterations, then the frozen phase: seeded from the
    last refresh iteration's aux for P2D (the pack form), frozen at the
    phase-1 pose for D2D (on a dense map the lookup form with that pose)."""
    R = config.refresh_iterations
    cfg1 = config.lsq._replace(max_iterations=R)
    cfg2 = config.lsq._replace(max_iterations=config.lsq.max_iterations - R)
    if obj.pack_from_aux is not None:
        p1, aux1 = lsq_solve(obj.linearize, obj.error, x0, cfg1, with_aux=True)
        frozen = obj.pack_from_aux(aux1)
    else:
        p1 = lsq_solve(obj.linearize, obj.error, x0, cfg1)
        frozen = obj.freeze(p1.transformation)
    p2 = lsq_solve(lambda x: obj.linearize_frozen(x, frozen), obj.error,
                   p1.transformation, cfg2)
    return p2._replace(iterations=p1.iterations + p2.iterations)


def _solve(obj: NdtObjective, x0, config) -> LsqResult:
    """The LM solve of an objective (one or two phases)."""
    R = config.refresh_iterations
    if not R or R >= config.lsq.max_iterations:
        return lsq_solve(obj.linearize, obj.error, x0, config.lsq)
    return _two_phase_solve(obj, x0, config)


def _objective(source, source_mask, source_compact, target_vm, config, rows=None,
               reduce=None) -> NdtObjective:
    """The objective from prebuilt state in one frame: the target voxel map
    and, for D2D, the compact source voxel statistics (means, valid, cov6);
    P2D reads the raw source points.  `rows(n)` (the sharded aligns) gives
    this rank's slice of the n source rows (P2D) or voxels (D2D), whose
    sums `reduce` adds across the ranks."""
    offsets = neighbor_offsets(config.neighbor_search_method,
                               config.neighbor_search_radius)
    if source_compact is None:
        src = (source, source_mask, None)
    else:
        src = source_compact
    if rows is not None:
        means, mask, covs = src
        sl = rows(means.shape[0])
        # covariances: (N, 3, 3), or (6, N) sym-6 columns
        src = (means[sl], mask[sl],
               None if covs is None else covs[:, sl] if covs.dim() == 2 else covs[sl])
    return make_ndt_objective(*src, target_vm, offsets, reduce=reduce)


def _align_objective(src_c, source_mask, tgt_c, target_mask, config, rows=None,
                     reduce=None) -> NdtObjective:
    """`ndt_align`'s (and `ndt_evaluate`'s) objective on target-centred
    points: a raw target grid (the hash map without grid_dims) and, for D2D,
    the source's compact statistics, both built in the target's frame.
    `rows` and `reduce`: `_objective`'s."""
    d2d = config.distance_mode == "d2d"
    stats = None
    if config.grid_dims is None:
        target_vm = _ndt_voxelmap(tgt_c, target_mask, config.resolution)
        if d2d:
            stats = _compact_source_voxels(
                _ndt_voxelmap(src_c, source_mask, config.resolution),
                config.max_source_voxels)
        return _objective(src_c, source_mask, stats, target_vm, config, rows, reduce)
    if d2d:
        _, stats = build_ndt_grid_compact(
            src_c, source_mask, config.resolution, config.grid_dims,
            budget=config.max_source_voxels, with_map=False, with_stats=True)
    target_vm = build_ndt_raw_grid(tgt_c, target_mask, config.resolution,
                                   config.grid_dims)
    return _objective(src_c, source_mask, stats, target_vm, config, rows, reduce)


def _prebuilt_objective(source, source_mask, source_compact, src_center,
                        target_vm, tgt_center, config) -> NdtObjective:
    """`ndt_align_prebuilt`'s objective in the target-centroid frame: D2D
    source means shift by (src_center - tgt_center), raw source points by
    -tgt_center."""
    compact = None
    if config.distance_mode == "d2d":
        means, mask_c, covs = source_compact
        compact = (means + (src_center - tgt_center), mask_c, covs)
    return _objective(source - tgt_center, source_mask, compact, target_vm, config)


def _prepare_fresh(source, source_mask, target, target_mask, config, dev):
    """`ndt_register_fresh`'s per-cloud state, each cloud in its own centroid
    frame (P2D prepares no source state): (target_state, source_state or
    None, the state arguments of `ndt_align_prebuilt`: source_compact,
    src_center, target_vm, tgt_center)."""
    tstate = ndt_prepare_cloud(target, target_mask, config, device=dev)
    sstate, compact, src_center = None, None, tstate[2]  # P2D: raw source points
    if config.distance_mode == "d2d":
        sstate = ndt_prepare_cloud(source, source_mask, config, device=dev)
        _, compact, src_center = sstate
    return tstate, sstate, (compact, src_center, tstate[0], tstate[2])


@f32_matmuls
def ndt_path_objective(source, source_mask, target, target_mask,
                       config: NDTConfig, fresh: bool, device="cuda"):
    """The objective a registration solves, with the state prepared as its
    entry point prepares it: `ndt_register_fresh`'s (fresh=True) or
    `ndt_align`'s (fresh=False), both in the target-centroid frame.  Returns
    (NdtObjective, target centroid).  For measuring the path's parts (its
    map builds, its kernels' inputs) without running the solve."""
    _check_mode(config)
    dev = _device.resolve(device)
    source, target = _device.as_f32(source, dev), _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    if fresh:
        _, _, prebuilt = _prepare_fresh(source, source_mask, target, target_mask,
                                        config, dev)
        return _prebuilt_objective(source, source_mask, *prebuilt, config), prebuilt[3]
    c = masked_mean(target, target_mask)
    return _align_objective(source - c, source_mask, target - c, target_mask, config), c


@f32_matmuls
def ndt_align(source, source_mask, target, target_mask, guess,
              config: NDTConfig = NDTConfig(), device="cuda") -> LsqResult:
    """NDT align of (N, 3) source onto (M, 3) target; the voxel maps are
    built from the points (a raw target grid; for D2D the source's compact
    statistics).

    With config.refresh_iterations = R the solve is two-phase.  Runs in the
    target-centroid frame; the returned pose and Hessian are world-frame.
    Runs on `device` (CUDA unless the caller asks for the CPU)."""
    _check_mode(config)
    dev = _device.resolve(device)
    source, target = _device.as_f32(source, dev), _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    guess = _device.as_f32(guess, dev)

    def run(src_c, tgt_c, x0):
        return _solve(_align_objective(src_c, source_mask, tgt_c, target_mask, config),
                      x0, config)

    return centered_frame_align(run, source, target, target_mask, guess)


def ndt_prepare_cloud(points, mask, config: NDTConfig, device="cuda"):
    """Per-cloud NDT state (voxel map, compact stats, centroid), built in the
    cloud's own centroid frame: an `NdtGridMap` at the target budget (the
    hash `VoxelMap` of `_ndt_voxelmap` without grid_dims) and, for D2D, the
    compact statistics at the source budget (None for P2D).  Runs on
    `device`.

    Voxelizing in the cloud's own frame can bin a point into another voxel
    than `ndt_align`, which voxelizes the source in the target's frame
    (floor(x / res - 0.5) depends on the shift), so the two give slightly
    different, equally valid poses."""
    _check_mode(config)
    dev = _device.resolve(device)
    points = _device.as_f32(points, dev)
    mask = _device.as_bool(mask, dev)
    c = masked_mean(points, mask)
    want_stats = config.distance_mode == "d2d"
    if config.grid_dims is None:
        vm = _ndt_voxelmap(points - c, mask, config.resolution)
        compact = (_compact_source_voxels(vm, config.max_source_voxels) if want_stats
                   else None)
        return vm, compact, c
    vm, compact = build_ndt_grid_compact(
        points - c, mask, config.resolution, config.grid_dims,
        budget=config.max_target_voxels, with_stats=want_stats)
    if want_stats and config.max_source_voxels < config.max_target_voxels:
        # one state serves both roles; trim the stats to the source budget
        b = config.max_source_voxels
        m, v, c6 = compact
        compact = (m[:b], v[:b], c6[:, :b])
    return vm, compact, c


@f32_matmuls
def ndt_align_prebuilt(source, source_mask, source_compact, src_center,
                       target_vm, tgt_center, guess,
                       config: NDTConfig = NDTConfig(), device="cuda") -> LsqResult:
    """NDT align against prebuilt per-cloud state (`ndt_prepare_cloud`), with
    `ndt_align`'s two-phase semantics.  The solve runs in the target-centroid
    frame: D2D source means shift by (src_center - tgt_center), raw source
    points by -tgt_center; the pose and Hessian return to world."""
    _check_mode(config)
    dev = _device.resolve(device)
    source = _device.as_f32(source, dev)
    source_mask = _device.as_bool(source_mask, dev)
    guess = _device.as_f32(guess, dev)
    x0 = se3.conjugate_to_centered(guess, tgt_center)
    obj = _prebuilt_objective(source, source_mask, source_compact, src_center,
                              target_vm, tgt_center, config)
    res = _solve(obj, x0, config)
    A = se3.adjoint_translation(tgt_center)
    return res._replace(
        transformation=se3.conjugate_from_centered(res.transformation, tgt_center),
        hessian=A.T @ res.hessian @ A,
    )


@f32_matmuls
def ndt_register_fresh(source, source_mask, target, target_mask, guess,
                       config: NDTConfig = NDTConfig(), device="cuda"):
    """Fresh NDT registration as the class API runs it: each cloud's state
    prepared in its own centroid frame (`ndt_prepare_cloud`; P2D prepares no
    source state), then `ndt_align_prebuilt`.  Returns (LsqResult,
    target_state, source_state or None).  Runs on `device`."""
    dev = _device.resolve(device)
    tstate, sstate, prebuilt = _prepare_fresh(source, source_mask, target, target_mask,
                                              config, dev)
    res = ndt_align_prebuilt(source, source_mask, *prebuilt, guess, config, device=dev)
    return res, tstate, sstate


@f32_matmuls
def ndt_evaluate(source, source_mask, target, target_mask, pose,
                 config: NDTConfig = NDTConfig(), device="cuda"):
    """(error, H, b) of the NDT objective at an arbitrary pose, evaluated in
    the target-centroid frame and reported world-frame.  Runs on `device`."""
    _check_mode(config)
    dev = _device.resolve(device)
    source, target = _device.as_f32(source, dev), _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    pose = _device.as_f32(pose, dev)

    def run(src_c, tgt_c, p):
        obj = _align_objective(src_c, source_mask, tgt_c, target_mask, config)
        err, H, b, _aux = obj.linearize(p)
        return err, H, b

    return centered_frame_evaluate(run, source, target, target_mask, pose)


@dataclass
class NDTCuda(Registration):
    """Class-API NDT, the reference's `NDTCuda` (ndt_cuda.hpp:22-71): each
    cloud's voxel map (and, for D2D, its compact voxel statistics) is built
    once and cached on the cloud (`Cloud.ndt_cache`), so the swap moves it
    with the cloud (ndt_cuda.cu:70-93).

    grid_dims: "auto" (a dense grid sized from both clouds' extents), None
    (the hash map) or an explicit (Dx, Dy, Dz)."""

    resolution: float = 1.0
    distance_mode: str = "d2d"
    neighbor_search_method: str = "direct7"
    neighbor_search_radius: float = 1.5
    grid_dims: object = "auto"

    def set_resolution(self, r: float) -> None:
        self.resolution = float(r)

    def set_grid_dims(self, dims) -> None:
        self.grid_dims = tuple(dims) if dims not in (None, "auto") else dims

    def set_distance_mode(self, mode: str) -> None:
        """Sets P2D or D2D, in either case ("P2D" is the reference's spelling)."""
        mode = mode.lower()
        if mode not in ("p2d", "d2d"):
            raise ValueError("distance mode must be 'p2d' or 'd2d'")
        self.distance_mode = mode

    def set_neighbor_search_method(self, method: str, radius: float = None) -> None:
        """DIRECT1, DIRECT7, DIRECT27 or DIRECT_RADIUS (any case)."""
        self.neighbor_search_method = method.lower()
        if radius is not None:
            self.neighbor_search_radius = float(radius)

    def _config(self, grid_dims=None) -> NDTConfig:
        return NDTConfig(
            resolution=self.resolution,
            distance_mode=self.distance_mode,
            neighbor_search_method=self.neighbor_search_method,
            neighbor_search_radius=self.neighbor_search_radius,
            grid_dims=grid_dims,
            lsq=self._lsq_config(),
        )

    def _grid_dims(self, source: Cloud, target: Cloud):
        """With "auto", dense-grid dims over the union of both clouds'
        cached extents (D2D builds a source map too, and a grid build drops
        the voxels outside it)."""
        if self.grid_dims != "auto":
            return self.grid_dims
        slo, shi = source.extent()
        tlo, thi = target.extent()
        return auto_grid_dims_from_extent(np.minimum(slo, tlo), np.maximum(shi, thi),
                                          self.resolution)

    @staticmethod
    def _key(config: NDTConfig):
        # P2D caches no compact stats, so a later D2D align must not reuse
        # its entry
        return (config.resolution, config.grid_dims, config.max_source_voxels,
                config.distance_mode)

    def _ensure_prepared(self, cloud: Cloud, config: NDTConfig):
        """The cloud's (voxel map, compact stats, centroid), built on a
        cache miss."""
        key = self._key(config)
        if cloud.ndt_cache is None or cloud.ndt_cache[0] != key:
            cloud.ndt_cache = (key,) + tuple(ndt_prepare_cloud(cloud.points, cloud.mask, config,
                                                               device=self.device))
        return cloud.ndt_cache[1:]

    def _compute(self, source: Cloud, target: Cloud, guess):
        config = self._config(grid_dims=self._grid_dims(source, target))
        key = self._key(config)
        if all(c.ndt_cache is None or c.ndt_cache[0] != key for c in (source, target)):
            # the fresh align; its per-cloud states fill both caches (P2D
            # prepares the source lazily)
            res, tstate, sstate = ndt_register_fresh(
                source.points, source.mask, target.points, target.mask, guess, config,
                device=self.device)
            target.ndt_cache = (key,) + tuple(tstate)
            if sstate is not None:
                source.ndt_cache = (key,) + tuple(sstate)
            return res
        target_vm, _, tgt_center = self._ensure_prepared(target, config)
        source_compact, src_center = None, tgt_center  # P2D reads the raw points
        if self.distance_mode == "d2d":
            _, source_compact, src_center = self._ensure_prepared(source, config)
        return ndt_align_prebuilt(source.points, source.mask, source_compact, src_center,
                                  target_vm, tgt_center, guess, config, device=self.device)

    def _evaluate(self, source: Cloud, target: Cloud, pose):
        return ndt_evaluate(source.points, source.mask, target.points, target.mask, pose,
                            self._config(grid_dims=self._grid_dims(source, target)),
                            device=self.device)


NDT = NDTCuda
