"""Generalized ICP (port of the functional path of
`fast_gicp_tpu.models.gicp`, the reference's `FastGICP`,
fast_gicp_impl.hpp).

Covariances for both clouds (kNN by default, or RBF or adaptive-radius
windows, with any of the five regularizations), then an LM solve whose every
linearization re-searches exact 1-NN correspondences of the transformed
source (the `nn_search` kernel), reads the matched target rows
[mu, cov9, count = 1, pad] by their index, and freezes the Mahalanobis
M = (C_B + R C_A R^T)^-1 for the trials that follow (the `linearize`
kernel); every LM trial is one launch of the trial kernel (the trial
step, the `error` body at the trial pose and the LM schedule,
`cuda_solver.lm_step`).
Correspondences farther than max_correspondence_distance are dropped.

Ported here: `GICPConfig`, the objective, `gicp_align` (with the two-phase
refresh_iterations form), `gicp_evaluate`, `gicp_register_fresh` and the
class API's `FastGICP` / `FastGICPSingleThread`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import device as _device
from ..ops import cuda_linearize, cuda_solver, soa
from ..ops.covariance import estimate_covariance_cols
from ..ops.neighbors import nn_search
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from .base import (Cloud, CovarianceRegistration, centered_frame_align,
                   centered_frame_evaluate)


class GICPConfig(NamedTuple):
    """Defaults match fast_gicp_impl.hpp:16-20 and the lsq defaults; the
    fields and defaults of the JAX package's GICPConfig.

    refresh_iterations: R -> re-search 1-NN correspondences for the first
    R LM iterations, then freeze the matched target rows for the rest
    (M is still re-frozen from each linearization's rotation); None
    re-searches every iteration like FastGICP.
    """

    k_correspondences: int = 20
    regularization: str = "plane"
    max_correspondence_distance: float = math.inf
    refresh_iterations: int | None = None
    lsq: LsqConfig = LsqConfig()


def _covs_rows9(covs):
    """(N, 3, 3) or (6, N) sym-6 covariances -> (N, 9) row-major rows."""
    if covs.shape[-2:] == (3, 3):
        return covs.reshape(covs.shape[0], 9)
    return soa.sym_cols_to_rows9(covs)


def target_rows16(target, target_covs):
    """The GICP target's row table (M, 16) [mu (3) | cov 3x3 row-major (9) |
    count = 1 | pad (3)], read by index in the linearize kernel; count 1
    makes the kernel's sqrt(count) weight the GICP unit weight."""
    nt = target.shape[0]
    return torch.cat(
        [target, _covs_rows9(target_covs),
         torch.ones((nt, 1), dtype=target.dtype, device=target.device),
         torch.zeros((nt, 3), dtype=target.dtype, device=target.device)],
        dim=1,
    ).contiguous()


def make_gicp_objective(source, source_mask, source_covs, target, target_mask,
                        target_covs, config: GICPConfig, with_freeze: bool = False,
                        reduce=None):
    """(linearize, error) closures of the GICP objective; with
    `with_freeze=True` also (freeze, linearize_frozen).

    `freeze(x)` runs the 1-NN search at pose x and returns the matched
    target indices (N,) int32 and the correspondence validity (N,);
    `linearize_frozen(x, frozen)` linearizes against them without a
    re-search, the kernel reading each matched row of the target table
    by index.  The source columns and covariance columns are
    loop-invariant and the pose is applied inside the kernels.

    `reduce` (the JAX package's `axis_name`): a sum all-reduce over the
    ranks of a mesh, each holding its own block of the source; [err, H, b]
    and the trial error are summed across them.  None: one device."""
    thr_sq = config.max_correspondence_distance ** 2
    P = soa.cols_from_points(source).contiguous()  # (3, N)
    C_A = soa.sym_cols_from_covs(source_covs).contiguous()  # (6, N)
    table = target_rows16(target, target_covs)

    def freeze(x):
        p_t = soa.transform_cols(x, P)
        idx, sq_dist = nn_search(p_t.T.contiguous(), target, target_mask, source_mask)
        valid = (source_mask & (sq_dist < thr_sq)).to(source.dtype)
        return idx, valid

    def linearize_frozen(x, frozen):
        idx, valid = frozen
        return cuda_solver.reduce_normal_eq(
            cuda_linearize.linearize(P, C_A, x, table, valid, idx), reduce)

    def linearize(x):
        return linearize_frozen(x, freeze(x))

    # the trial cost the LM steps launch: the weight is aux row 6
    error = cuda_solver.trial_cost(cuda_solver.TrialCost(P), reduce)

    if with_freeze:
        return linearize, error, freeze, linearize_frozen
    return linearize, error


def _inputs(dev, *clouds):
    """(points, mask, covs) triples -> tensors on `dev`."""
    out = []
    for points, mask, covs in clouds:
        out += [_device.as_f32(points, dev), _device.as_bool(mask, dev),
                _device.as_f32(covs, dev)]
    return out


@f32_matmuls
def gicp_align(source, source_mask, source_covs, target, target_mask,
               target_covs, guess, config: GICPConfig = GICPConfig(),
               device="cuda") -> LsqResult:
    """GICP align of (N, 3) source onto (M, 3) target, with per-point
    covariances as (N, 3, 3) or (6, N) sym-6 columns.

    With config.refresh_iterations = R the solve is two-phase: R
    re-searching LM iterations, then the matched target rows are frozen
    at the phase-1 pose for the rest.  Runs in the target-centroid frame;
    the returned pose and Hessian are world-frame.  Runs on `device` (CUDA
    unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    source, source_mask, source_covs, target, target_mask, target_covs = _inputs(
        dev, (source, source_mask, source_covs), (target, target_mask, target_covs))
    guess = _device.as_f32(guess, dev)

    def run(src_c, tgt_c, x0):
        return _gicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask,
                           target_covs, x0, config)

    return centered_frame_align(run, source, target, target_mask, guess)


def _gicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask, target_covs, x0,
                config: GICPConfig, reduce=None) -> LsqResult:
    """`gicp_align`'s solve in the target-centroid frame (one or two
    phases); with `reduce`, of this rank's block of the source."""
    linearize, error, freeze, linearize_frozen = make_gicp_objective(
        src_c, source_mask, source_covs, tgt_c, target_mask, target_covs,
        config, with_freeze=True, reduce=reduce,
    )
    R = config.refresh_iterations
    if not R or R >= config.lsq.max_iterations:
        return lsq_solve(linearize, error, x0, config.lsq)
    p1 = lsq_solve(linearize, error, x0, config.lsq._replace(max_iterations=R))
    frozen = freeze(p1.transformation)
    p2 = lsq_solve(
        lambda x: linearize_frozen(x, frozen),
        error,
        p1.transformation,
        config.lsq._replace(max_iterations=config.lsq.max_iterations - R),
    )
    return p2._replace(iterations=p1.iterations + p2.iterations)


@f32_matmuls
def gicp_evaluate(source, source_mask, source_covs, target, target_mask,
                  target_covs, pose, config: GICPConfig = GICPConfig(),
                  device="cuda"):
    """(error, H, b) of the GICP objective at an arbitrary pose (the
    reference's evaluateCost, lsq_registration_impl.hpp:48-50), evaluated
    in the target-centroid frame and reported world-frame, consistent with
    `gicp_align`'s Hessian.  Runs on `device`."""
    dev = _device.resolve(device)
    source, source_mask, source_covs, target, target_mask, target_covs = _inputs(
        dev, (source, source_mask, source_covs), (target, target_mask, target_covs))
    pose = _device.as_f32(pose, dev)

    def run(src_c, tgt_c, p):
        linearize, _error = make_gicp_objective(
            src_c, source_mask, source_covs, tgt_c, target_mask, target_covs, config)
        err, H, b, _aux = linearize(p)
        return err, H, b

    return centered_frame_evaluate(run, source, target, target_mask, pose)


@f32_matmuls
def gicp_register_fresh(source, source_mask, target, target_mask, guess,
                        config: GICPConfig = GICPConfig(), method: str = "knn",
                        k: int = 20, regularization: str = "plane",
                        kernel_width: float = 0.5, kernel_max_dist: float = 3.0,
                        device="cuda"):
    """Fresh registration: covariances for both clouds, then the GICP
    align.  `method` is "knn" (k nearest neighbours: the fused
    `knn_moments` kernel for `plane` and `none`, the `knn_slab` search for
    the other regularizations), "rbf" (RBF kernel density) or "adaptive"
    (adaptive-radius windows: the `radius_count` and `radius_window`
    kernels); `regularization` is any of the reference's five modes.
    Returns (LsqResult, source_cov6, target_cov6) so a caller can cache the
    sym-6 covariance columns (6, N).  Runs on `device` (CUDA unless the
    caller asks for the CPU)."""
    dev = _device.resolve(device)
    source = _device.as_f32(source, dev)
    target = _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    kwargs = dict(k=k, regularization=regularization, kernel_width=kernel_width,
                  kernel_max_dist=kernel_max_dist)
    scovs = estimate_covariance_cols(source, source_mask, method, **kwargs)
    tcovs = estimate_covariance_cols(target, target_mask, method, **kwargs)
    res = gicp_align(source, source_mask, scovs, target, target_mask, tcovs,
                     guess, config, device=dev)
    return res, scovs, tcovs


@dataclass
class FastGICP(CovarianceRegistration):
    """Class-API GICP, for both `FastGICP` and `FastGICPSingleThread`: the
    thread count means nothing on the card; `set_num_threads` is accepted
    and ignored.  Covariances are estimated lazily per cloud and cached on
    the `Cloud`, so loops that `swap_source_and_target()` reuse them as the
    reference does (fast_gicp_impl.hpp:50-57, :107-112)."""

    _align_cached = staticmethod(gicp_align)
    _evaluate_at = staticmethod(gicp_evaluate)

    def _config(self, target: Cloud = None) -> GICPConfig:
        del target
        return GICPConfig(
            k_correspondences=self.k_correspondences,
            regularization=self.regularization,
            max_correspondence_distance=self.max_correspondence_distance,
            lsq=self._lsq_config(),
        )


class FastGICPSingleThread(FastGICP):
    """Name-parity alias of the reference's `FastGICPSingleThread`
    (fast_gicp_st.hpp:20-65): the same objective and results; its anchor
    re-search skip (fast_gicp_st_impl.hpp:46-54) is a CPU latency trick with
    no counterpart here."""
