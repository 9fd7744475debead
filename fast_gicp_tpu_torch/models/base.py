"""The PCL-shaped class API and the target-centroid frame every align and
evaluation runs in (port of `fast_gicp_tpu.models.base`).

`Registration` mirrors the surface the reference inherits from PCL plus its
additions (lsq_registration.hpp:16-85, fast_gicp.hpp:42-73):
set_input_source/target, align(guess), the getters, get_fitness_score,
swap_source_and_target / clear_source / clear_target with covariance reuse
for odometry loops.  Clouds are padded to bucket sizes on ingestion and
kept on the instance's device with their covariances; the swap exchanges
the two `Cloud` objects, so their cached covariances go with them
(fast_gicp_impl.hpp:50-57).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from .. import se3
from ..ops.covariance import masked_mean
from ..solver import LsqConfig
from ..utils.padding import DEFAULT_BUCKET, pad_points
from .metrics import fitness_score


def centered_frame_align(run, source, target, target_mask, guess):
    """Run an align in the TARGET-CENTROID frame, report world results.

    The Jacobian J = [skew(T p) | -I] puts |p|^2-scale entries into the
    f32-accumulated normal equations; about the target centroid the lever
    arms are bounded by the cloud extent.  The pose conjugates back exactly
    (X = T(c) X' T(-c)) and the reported 6x6 returns to world twists
    through the translation adjoint (H = A^T H' A).

    `run(source_c, target_c, guess_c) -> LsqResult` is the uncentered align
    body; covariances are translation-invariant and pass through outside.
    """
    c = masked_mean(target, target_mask)
    res = run(
        source - c,
        target - c,
        se3.conjugate_to_centered(guess.to(target.dtype), c),
    )
    A = se3.adjoint_translation(c)
    return res._replace(
        transformation=se3.conjugate_from_centered(res.transformation, c),
        hessian=A.T @ res.hessian @ A,
    )


def centered_frame_evaluate(run, source, target, target_mask, pose):
    """`centered_frame_align`'s twin for evaluating the objective:
    `run(source_c, target_c, pose_c) -> (err, H', b')` evaluates it in the
    target-centroid frame; the returned (err, H, b) are world-frame (err
    is frame-invariant; H and b return through the translation adjoint),
    consistent with the aligns' reported Hessian."""
    c = masked_mean(target, target_mask)
    err, H, b = run(
        source - c,
        target - c,
        se3.conjugate_to_centered(pose.to(target.dtype), c),
    )
    A = se3.adjoint_translation(c)
    return err, A.T @ H @ A, A.T @ b


@dataclass
class Cloud:
    """A padded cloud on the device, its lazily estimated covariances and
    its host copy.

    `channels` carries an optional (M, C) per-point payload (intensity,
    RGB, normals: the reference's PointXYZI / PointXYZRGB / PointNormal
    instantiations); registration uses xyz only, and the payload comes
    back out through `Registration.aligned_source()`."""

    points: torch.Tensor  # (M, 3) f32
    mask: torch.Tensor  # (M,) bool
    size: int  # true point count
    covs: Optional[torch.Tensor] = None  # (6, M) sym-6 columns or (M, 3, 3)
    host_points: Optional[np.ndarray] = None  # (M, 3) f32
    channels: Optional[np.ndarray] = None  # (M, C) payload (host)
    # NDT per-cloud state: (key, voxel map, compact source stats, centroid);
    # the swap exchanges the Cloud objects, so it moves with the cloud as
    # the covariances do (ndt_cuda.cu:70-93)
    ndt_cache: Optional[tuple] = None
    _extent: Optional[tuple] = None  # cached host (lo, hi) of the real points

    def extent(self):
        """Cached (lo, hi) numpy extent over the real (unpadded) points."""
        if self._extent is None:
            pts = self.host_points[: self.size]
            self._extent = (pts.min(axis=0), pts.max(axis=0))
        return self._extent


@functools.cache
def _identity_guess(device: torch.device) -> torch.Tensor:
    """The identity guess on `device`, made once (a fill, no host copy);
    the solve never writes its x0."""
    return torch.eye(4, dtype=torch.float32, device=device)


def estimate_covariances(cloud: Cloud, method: str, k: int, regularization: str,
                         kernel_width: float = 0.5, kernel_max_dist: float = 3.0) -> None:
    """Fill cloud.covs with the selected estimator, unless it is set.

    The selector mirrors the CUDA variant's NearestNeighborMethod
    (fast_vgicp_cuda.hpp:21): "knn" (brute-force kNN on the device, the
    fused `knn_moments` kernel), "rbf" (GPU_RBF_KERNEL), "kdtree"
    (CPU_PARALLEL_KDTREE: the native host kd-tree feeds the device), and
    "adaptive" (adaptive-radius windows)."""
    if cloud.covs is not None:
        return
    from ..ops import covariance

    if method == "kdtree":
        from .. import native

        # the tree holds the real points only (the padding sits at the
        # origin); padded queries get covariances the masks drop
        idx, _ = native.knn_search(cloud.host_points[: cloud.size], cloud.host_points, k)
        cloud.covs = covariance.covariances_from_neighbors(cloud.points, idx,
                                                           method=regularization)
    elif method == "rbf":
        cloud.covs = covariance.rbf_covariance_cols(
            cloud.points, cloud.mask, kernel_width, kernel_max_dist, method=regularization)
    elif method == "knn":
        cloud.covs = covariance.knn_covariance_cols(cloud.points, cloud.mask, k=k,
                                                    method=regularization)
    elif method == "adaptive":
        cloud.covs = covariance.adaptive_radius_covariance_cols(
            cloud.points, cloud.mask, k=k, method=regularization)
    else:
        raise ValueError("covariance estimation must be 'knn', 'rbf', 'adaptive', "
                         "or 'kdtree'")


@dataclass
class Registration:
    """Base registration class; subclasses implement `_compute` and
    `_evaluate`.  Defaults follow lsq_registration_impl.hpp:11-19.  Runs on
    `device` (CUDA unless the caller asks for the CPU)."""

    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    optimizer: str = "lm"
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    max_correspondence_distance: float = math.inf
    lm_debug_print: bool = False
    bucket: int = DEFAULT_BUCKET
    device: object = "cuda"

    _source: Optional[Cloud] = field(default=None, repr=False)
    _target: Optional[Cloud] = field(default=None, repr=False)
    _pending: Optional[object] = field(default=None, repr=False)
    _final_T: Optional[np.ndarray] = field(default=None, repr=False)
    _final_H: Optional[np.ndarray] = field(default=None, repr=False)
    _converged: bool = field(default=False, repr=False)
    _iterations: int = field(default=0, repr=False)

    def __post_init__(self):
        self.device = _device.resolve(self.device)

    # -- cloud management -------------------------------------------------
    def _ingest(self, points: np.ndarray, channels=None) -> Cloud:
        points = np.asarray(points)
        if channels is None and points.shape[1] > 3:
            # (N, 3 + C): the trailing columns are the payload
            channels = points[:, 3:]
        padded, mask = pad_points(points[:, :3], self.bucket)
        ch = None
        if channels is not None:
            ch = np.zeros((padded.shape[0], channels.shape[1]), np.float32)
            ch[: len(channels)] = channels
        return Cloud(points=_device.as_f32(padded, self.device),
                     mask=_device.as_bool(mask, self.device), size=int(mask.sum()),
                     host_points=padded, channels=ch)

    def set_input_source(self, points: np.ndarray, channels=None) -> None:
        self._source = self._ingest(points, channels)

    def set_input_target(self, points: np.ndarray, channels=None) -> None:
        self._target = self._ingest(points, channels)

    def swap_source_and_target(self) -> None:
        self._source, self._target = self._target, self._source

    def clear_source(self) -> None:
        self._source = None

    def clear_target(self) -> None:
        self._target = None

    def set_source_covariances(self, covs) -> None:
        """(N, 3, 3) or (6, N) sym-6 covariances of the padded source."""
        self._require_source().covs = _device.as_f32(covs, self.device)

    def set_target_covariances(self, covs) -> None:
        """(N, 3, 3) or (6, N) sym-6 covariances of the padded target."""
        self._require_target().covs = _device.as_f32(covs, self.device)

    def clear_covariances(self) -> None:
        """Drop the cached covariances and NDT maps so that the next align
        estimates them again: the class-API form of the reference
        benchmark's fresh instance per align (align.cpp:56-76), without
        uploading the clouds again."""
        for cloud in (self._source, self._target):
            if cloud is not None:
                cloud.covs = None
                cloud.ndt_cache = None

    def _require_source(self) -> Cloud:
        if self._source is None:
            raise RuntimeError("set_input_source has not been called")
        return self._source

    def _require_target(self) -> Cloud:
        if self._target is None:
            raise RuntimeError("set_input_target has not been called")
        return self._target

    # -- settings ---------------------------------------------------------
    def set_max_correspondence_distance(self, d: float) -> None:
        self.max_correspondence_distance = float(d)

    def set_max_iterations(self, n: int) -> None:
        self.max_iterations = int(n)

    def set_rotation_epsilon(self, eps: float) -> None:
        self.rotation_epsilon = float(eps)

    def set_transformation_epsilon(self, eps: float) -> None:
        self.transformation_epsilon = float(eps)

    def set_initial_lambda_factor(self, f: float) -> None:
        self.lm_init_lambda_factor = float(f)

    def set_optimizer_type(self, kind: str) -> None:
        if kind not in ("lm", "gn"):
            raise ValueError("optimizer must be 'lm' or 'gn'")
        self.optimizer = kind

    def set_debug_print(self, enabled: bool) -> None:
        """Print a line a LM trial, the reference's setDebugPrint
        (lsq_registration.hpp:41, impl:143-149)."""
        self.lm_debug_print = bool(enabled)

    def _lsq_config(self) -> LsqConfig:
        return LsqConfig(
            max_iterations=self.max_iterations,
            rotation_epsilon=self.rotation_epsilon,
            transformation_epsilon=self.transformation_epsilon,
            optimizer=self.optimizer,
            lm_max_iterations=self.lm_max_iterations,
            lm_init_lambda_factor=self.lm_init_lambda_factor,
            debug_print=self.lm_debug_print,
        )

    # -- alignment --------------------------------------------------------
    def align_async(self, initial_guess=None):
        """Run the registration and return its `LsqResult` as tensors on
        the device, without reading them to the host; the getters read
        them, once, when first called.  A caller can chain the returned
        pose as the next align's guess.

        The overlap this allows is bounded: the port's LM solve reads each
        trial's two flags to the host (one sync a trial), so this returns
        only after the solve's last trial; what it saves is the final read
        of the pose, the Hessian and the flags."""
        src, tgt = self._require_source(), self._require_target()
        guess = (_identity_guess(self.device) if initial_guess is None
                 else _device.as_f32(initial_guess, self.device))
        result = self._compute(src, tgt, guess)
        self._pending = result
        self._final_T = None
        self._final_H = None
        return result

    def _sync_pending(self) -> None:
        result = self._pending
        if result is None:
            return
        self._pending = None
        # one device-to-host read for the pose, the Hessian and the flags
        flat = torch.cat([result.transformation.reshape(-1), result.hessian.reshape(-1),
                          result.converged.to(torch.float32).reshape(1),
                          result.iterations.to(torch.float32).reshape(1)]).cpu().numpy()
        self._final_T = flat[:16].reshape(4, 4).astype(np.float64)
        self._final_H = flat[16:52].reshape(6, 6).astype(np.float64)
        self._converged = bool(flat[52])
        self._iterations = int(flat[53])

    def align(self, initial_guess=None) -> np.ndarray:
        """Run the registration; returns the final 4x4 transformation."""
        self.align_async(initial_guess)
        self._sync_pending()
        return self._final_T

    def _compute(self, source: Cloud, target: Cloud, guess: torch.Tensor):
        raise NotImplementedError

    def evaluate_cost(self, pose, return_terms: bool = False):
        """The objective (and with return_terms its H and b) at an arbitrary
        pose, the reference's evaluateCost (lsq_registration.hpp:53,
        lsq_registration_impl.hpp:48-50)."""
        src, tgt = self._require_source(), self._require_target()
        err, H, b = self._evaluate(src, tgt, _device.as_f32(pose, self.device))
        flat = torch.cat([err.reshape(1), H.reshape(-1), b.reshape(-1)]).cpu().numpy()
        if return_terms:
            return (float(flat[0]), flat[1:37].reshape(6, 6).astype(np.float64),
                    flat[37:43].astype(np.float64))
        return float(flat[0])

    def _evaluate(self, source: Cloud, target: Cloud, pose: torch.Tensor):
        raise NotImplementedError

    # -- results ----------------------------------------------------------
    def aligned_source(self) -> np.ndarray:
        """The source cloud transformed by the final pose, payload columns
        appended: the reference's `align(output)` cloud, where extra point
        fields ride along untouched."""
        self._sync_pending()
        if self._final_T is None:
            raise RuntimeError("align() has not been run")
        src = self._require_source()
        pts = np.asarray(src.host_points[: src.size], np.float64)
        T = self._final_T
        out = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        if src.channels is not None:
            out = np.concatenate([out, src.channels[: src.size]], axis=1)
        return out

    def get_final_transformation(self) -> np.ndarray:
        self._sync_pending()
        if self._final_T is None:
            raise RuntimeError("align has not been called")
        return self._final_T

    def get_final_hessian(self) -> np.ndarray:
        self._sync_pending()
        if self._final_H is None:
            raise RuntimeError("align has not been called")
        return self._final_H

    def has_converged(self) -> bool:
        self._sync_pending()
        return self._converged

    def get_num_iterations(self) -> int:
        self._sync_pending()
        return self._iterations

    def get_fitness_score(self, max_range: float = math.inf) -> float:
        """PCL's fitness: the mean squared 1-NN distance of the source at
        the final pose, within max_range."""
        src, tgt = self._require_source(), self._require_target()
        T = self.get_final_transformation()
        return float(fitness_score(T, src.points, src.mask, tgt.points, tgt.mask,
                                   max_range=max_range, device=self.device))


@dataclass
class CovarianceRegistration(Registration):
    """A registration whose objective reads per-point covariances
    (FastGICP, FastVGICP): the estimator's settings and setters, the
    per-cloud cache, and the choice between the fresh align (both clouds'
    covariances and the align in one call, whose covariances fill the
    cache for the swap) and the align on cached covariances.  A subclass
    sets `_register_fresh`, `_align_cached` and `_evaluate_at` to its
    module's functions and builds its config in `_config(target)`."""

    k_correspondences: int = 20
    regularization: str = "plane"
    covariance_estimation: str = "knn"  # "knn" | "rbf" | "kdtree" | "adaptive"
    kernel_width: float = 0.5
    kernel_max_dist: float = 3.0

    def set_num_threads(self, n: int) -> None:  # API parity no-op
        del n

    def set_correspondence_randomness(self, k: int) -> None:
        self.k_correspondences = int(k)

    def set_regularization_method(self, method: str) -> None:
        self.regularization = method

    def set_nearest_neighbor_method(self, method: str) -> None:
        """The CUDA variant's covariance selector (fast_vgicp_cuda.hpp:21):
        "knn" (GPU_BRUTEFORCE), "rbf" (GPU_RBF_KERNEL) or "kdtree"
        (CPU_PARALLEL_KDTREE: the native host kd-tree feeds the device)."""
        if method not in ("knn", "rbf", "kdtree"):
            raise ValueError("covariance estimation must be 'knn', 'rbf', or 'kdtree'")
        self.covariance_estimation = method

    def set_kernel_params(self, width: float, max_dist: float = None) -> None:
        """RBF kernel width and cut-off; max_dist defaults to 5 x width
        (fast_vgicp_cuda_impl.hpp:46-50)."""
        self.kernel_width = float(width)
        self.kernel_max_dist = float(max_dist) if max_dist is not None else 5.0 * float(width)

    def _ensure_covariances(self, cloud: Cloud) -> None:
        estimate_covariances(cloud, self.covariance_estimation, self.k_correspondences,
                             self.regularization, kernel_width=self.kernel_width,
                             kernel_max_dist=self.kernel_max_dist)

    def _config(self, target: Cloud):
        raise NotImplementedError

    def _compute(self, source: Cloud, target: Cloud, guess: torch.Tensor):
        if (source.covs is None and target.covs is None
                and self.covariance_estimation in ("knn", "rbf", "adaptive")):
            res, source.covs, target.covs = self._register_fresh(
                source.points, source.mask, target.points, target.mask, guess,
                self._config(target), method=self.covariance_estimation,
                k=self.k_correspondences, regularization=self.regularization,
                kernel_width=self.kernel_width, kernel_max_dist=self.kernel_max_dist,
                device=self.device)
            return res
        self._ensure_covariances(source)
        self._ensure_covariances(target)
        return self._align_cached(source.points, source.mask, source.covs, target.points,
                                  target.mask, target.covs, guess, self._config(target),
                                  device=self.device)

    def _evaluate(self, source: Cloud, target: Cloud, pose: torch.Tensor):
        self._ensure_covariances(source)
        self._ensure_covariances(target)
        return self._evaluate_at(source.points, source.mask, source.covs, target.points,
                                 target.mask, target.covs, pose, self._config(target),
                                 device=self.device)
