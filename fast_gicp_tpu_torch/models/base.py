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

An align is a host part and a device body (the JAX package's one jitted
program a registration): the host part reads what lives on the host (a
cloud's extent for "auto" grid dims, the native kd-tree's covariances,
which clouds already cache their state) and names the program; the body
estimates what a cloud lacks, builds the maps and solves.  With
`device_loop` (the default) the body is one CUDA graph replay a call
(`graphs.replay_cached`, captured once a signature, its LM loops
conditional WHILE nodes); otherwise it runs eagerly.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, fields
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import device as _device
from .. import graphs, se3
from ..ops.covariance import estimate_covariance_cols, masked_mean
from ..precision import f32_matmuls
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
    elif method in DEVICE_ESTIMATORS:
        cloud.covs = estimate_covariance_cols(cloud.points, cloud.mask, method, k=k,
                                              regularization=regularization,
                                              kernel_width=kernel_width,
                                              kernel_max_dist=kernel_max_dist)
    else:
        raise ValueError("covariance estimation must be 'knn', 'rbf', 'adaptive', "
                         "or 'kdtree'")


DEVICE_ESTIMATORS = ("knn", "rbf", "adaptive")
"""The covariance estimators that run on the device, inside an align's
program; "kdtree" runs the native host tree before it."""


class Program(NamedTuple):
    """An align's device body and what it bakes in: `body(static,
    **inputs)` -> (LsqResult, the source's new cached state or None, the
    target's or None); `static` a hashable value the body reads (the
    config, and for the covariance classes the align and the estimator's
    settings); `inputs` the tensors (nested in tuples and NamedTuples, None
    where a cloud has no cached state: the path) it reads."""

    body: Callable
    static: tuple
    inputs: dict


@dataclass
class Registration:
    """Base registration class; subclasses implement `_program` (the host
    part of an align: its `Program`) and `_evaluate`; `_store` puts the
    states the program returns onto the clouds (covariances here, NDTCuda's
    maps in its own).  Defaults follow
    lsq_registration_impl.hpp:11-19.  Runs on `device` (CUDA unless the
    caller asks for the CPU); `device_loop` (the default) runs each align
    as one device program (`align_async`)."""

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
    device_loop: bool = True

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
        # uploaded from pinned memory: no host sync (the odometry loop
        # ingests a scan a frame)
        return Cloud(points=_device.upload(padded, self.device),
                     mask=_device.upload(mask, self.device), size=int(mask.sum()),
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
        (lsq_registration.hpp:41, impl:143-149).  A printed trial is read
        to the host, so while it is on the aligns take the eager form."""
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

        The align is one device program (`device_loop`, the default): on
        CUDA one replay of a CUDA graph captured once a signature
        (`signature()`: the class, every setting, the path, the padded
        sizes, the device and whether deterministic algorithms are on),
        its LM loops conditional WHILE nodes; nothing
        is read to the host, so this returns once the replay is enqueued.
        A signature's first call also pays an eager warm-up and the
        capture.  The result and the cached covariances or maps are the
        instance's own tensors, which no later replay overwrites.  On the
        CPU the program is the device form's plain version.

        The eager form (every LM trial's flags read to the host, so this
        returns after the last trial) runs with `device_loop=False`, and
        while `set_debug_print(True)` is on, since a printed trial is read
        to the host.  Both forms give the same bits."""
        src, tgt = self._require_source(), self._require_target()
        guess = (_identity_guess(self.device) if initial_guess is None
                 else _device.as_f32(initial_guess, self.device))
        prog = self._program(src, tgt)
        inputs = dict(prog.inputs, guess=guess)
        run = functools.partial(prog.body, prog.static)
        result, new_source, new_target = graphs.run(
            self._program_key(prog), inputs, run, self.device,
            device_loop=self.device_loop and not self.lm_debug_print)
        self._store(prog, src, tgt, new_source, new_target)
        self._pending = result
        self._final_T = None
        self._final_H = None
        return result

    def _program_key(self, prog: Program):
        # every setting of the instance, used by the body or not (so no
        # setter can be missed), beside what the host part derived
        settings = tuple((f.name, getattr(self, f.name)) for f in fields(self)
                         if not f.name.startswith("_"))
        return type(self), settings, prog.static

    def signature(self):
        """The key under which the next align's program is captured and
        replayed (`graphs.program_key`): the class, every setting of the
        instance (the device among them), what the host part derived (the
        config with its grid dims, the path), whether deterministic
        algorithms are on, and the inputs' structure (which clouds hold a
        state), padded sizes and layouts."""
        prog = self._program(self._require_source(), self._require_target())
        inputs = dict(prog.inputs, guess=_identity_guess(self.device))
        return graphs.program_key(self._program_key(prog), inputs)

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

    def _program(self, source: Cloud, target: Cloud) -> Program:
        raise NotImplementedError

    def _store(self, prog: Program, source: Cloud, target: Cloud, new_source,
               new_target) -> None:
        """The cached states the program returned onto the clouds: the new
        covariances (NDTCuda stores its maps)."""
        if new_source is not None:
            source.covs = new_source
        if new_target is not None:
            target.covs = new_target

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
    (FastGICP, FastVGICP): the estimator's settings and setters and the
    per-cloud cache.  An align's program estimates the covariances of the
    clouds that have none (both on the fresh align: the JAX package's one
    dispatch) and aligns on them; the swap then reuses them.  The "kdtree"
    estimator runs on the host before the program.  A subclass sets
    `_align_cached` and `_evaluate_at` to its module's functions and builds
    its config in `_config(target)`."""

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

    def _program(self, source: Cloud, target: Cloud) -> Program:
        if self.covariance_estimation not in DEVICE_ESTIMATORS:
            self._ensure_covariances(source)  # the native host tree
            self._ensure_covariances(target)
        static = _CovarianceStatic(self._align_cached, self._config(target),
                                   self.covariance_estimation, self.k_correspondences,
                                   self.regularization, self.kernel_width,
                                   self.kernel_max_dist)
        return Program(_covariance_body, static, dict(
            source=source.points, source_mask=source.mask, source_covs=source.covs,
            target=target.points, target_mask=target.mask, target_covs=target.covs))

    def _evaluate(self, source: Cloud, target: Cloud, pose: torch.Tensor):
        self._ensure_covariances(source)
        self._ensure_covariances(target)
        return self._evaluate_at(source.points, source.mask, source.covs, target.points,
                                 target.mask, target.covs, pose, self._config(target),
                                 device=self.device)


class _CovarianceStatic(NamedTuple):
    """What a `CovarianceRegistration` align's program bakes in."""

    align: Callable  # the module's align on covariances
    config: tuple  # the module's config NamedTuple
    method: str
    k: int
    regularization: str
    kernel_width: float
    kernel_max_dist: float


@f32_matmuls
def _estimate_missing(points, mask, covs, static: _CovarianceStatic):
    """The covariances a cloud caches, estimated by `static`'s estimator
    when `covs` is None: (covs, the new estimate or None)."""
    if covs is not None:
        return covs, None
    covs = estimate_covariance_cols(points, mask, static.method, k=static.k,
                                    regularization=static.regularization,
                                    kernel_width=static.kernel_width,
                                    kernel_max_dist=static.kernel_max_dist)
    return covs, covs


def _covariance_body(static: _CovarianceStatic, source, source_mask, source_covs, target,
                     target_mask, target_covs, guess):
    """A `CovarianceRegistration` align: the covariances the clouds lack
    (the source's first, as the reference's fresh align), then the align on
    them.  Returns (LsqResult, new source covariances or None, new target
    covariances or None)."""
    source_covs, new_source = _estimate_missing(source, source_mask, source_covs, static)
    target_covs, new_target = _estimate_missing(target, target_mask, target_covs, static)
    res = static.align(source, source_mask, source_covs, target, target_mask, target_covs,
                       guess, static.config, device=source.device)
    return res, new_source, new_target
