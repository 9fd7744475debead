"""Experimental multi-correspondence radius GICP, `FastGICPMultiPoints`
(port of `fast_gicp_tpu.models.experimental`; the reference's
experimental/fast_gicp_mp.hpp:16-85, impl :130-219, which its own build
does not compile).

Every target point within `search_radius` of the transformed source point
contributes with the weight w = max(0, 1 - d / r); the correspondence is
the weighted average of those points' means and covariances
(fast_gicp_mp_impl.hpp:146-176).  As in the JAX package the radius list is
a fixed-k nearest-neighbour set (k = 32) with the radius as the weight's
cut-off, so for any k at least the radius set's size the result is the
reference's, and the solve is the shared LM driver.

Each linearization runs the exact k-NN search on the transformed source
(`ops.neighbors.knn_search`, the `knn_slab` kernel), the weights and the
weighted average as eager ops, then one `linearize` launch on the averaged
rows [q, cov_B, count 1, pad] in the gathered form: the kernel's weight
sqrt(count) * valid is the unit weight.  Each LM trial is one launch of the
trial kernel with GICP's error body (`cuda_solver.lm_step`).  The align runs
in the input frame, as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import device as _device
from ..ops import cuda_linearize, cuda_solver, soa
from ..ops.neighbors import knn_search
from ..precision import f32_matmuls
from ..solver import LsqConfig, LsqResult, lsq_solve
from .base import Cloud, Registration, estimate_covariances


class MultiPointConfig(NamedTuple):
    """Defaults follow fast_gicp_mp.hpp:24-33 (k = 20 covariances, radius
    search; the reference leaves the radius to the caller: 1.0 here); the
    fields and defaults of the JAX package's MultiPointConfig."""

    search_radius: float = 1.0
    k_neighbors: int = 32
    k_correspondences: int = 20
    regularization: str = "plane"
    lsq: LsqConfig = LsqConfig()


def averaged_rows(idx, sq_d, source_mask, target_pack, radius):
    """(rows (N, 16), valid (N,)): each source point's correspondence, the
    average of its neighbours idx (N, k) at squared distances sq_d weighted
    by w = max(0, 1 - d / r) (fast_gicp_mp_impl.hpp:158-161), as the
    `linearize` kernel reads it: [q (3), cov_B (9 row-major), count 1, pad
    (3)]; target_pack (M, 9) holds each target point's [mean, sym-6 cov]."""
    n = idx.shape[0]
    w_nb = torch.clamp(1.0 - torch.sqrt(sq_d) / radius, min=0.0)
    sum_w = w_nb.sum(dim=1)
    valid = (source_mask & (sum_w > 1e-6)).to(sq_d.dtype)
    inv_w = 1.0 / torch.clamp(sum_w, min=1e-6)
    agg = (w_nb[:, :, None] * target_pack[idx.long()]).sum(dim=1) * inv_w[:, None]
    rows = torch.cat([agg[:, :3], soa.sym_cols_to_rows9(agg[:, 3:].T),
                      torch.ones((n, 1), dtype=agg.dtype, device=agg.device),
                      torch.zeros((n, 3), dtype=agg.dtype, device=agg.device)], dim=1)
    return rows.contiguous(), valid


def make_multipoint_objective(source, source_mask, source_covs, target, target_mask,
                              target_covs, config: MultiPointConfig):
    """(linearize, error) of the weighted-average multi-correspondence GICP
    objective; covariances as (N, 3, 3) or (6, N) sym-6 columns."""
    P = soa.cols_from_points(source).contiguous()  # (3, N)
    C_A = soa.sym_cols_from_covs(source_covs).contiguous()  # (6, N)
    target_pack = torch.cat([target, soa.sym_cols_from_covs(target_covs).T], dim=1)

    def linearize(x):
        idx, sq_d = knn_search(soa.transform_cols(x, P).T, target, target_mask,
                               k=config.k_neighbors, device=source.device)
        rows, valid = averaged_rows(idx, sq_d, source_mask, target_pack, config.search_radius)
        return cuda_linearize.linearize(P, C_A, x, rows, valid)

    # the trial cost the LM steps launch: the weight is aux row 6 (valid)
    return linearize, cuda_solver.TrialCost(P)


@f32_matmuls
def multipoint_align(source, source_mask, source_covs, target, target_mask, target_covs,
                     guess, config: MultiPointConfig = MultiPointConfig(),
                     device="cuda") -> LsqResult:
    """Multi-correspondence GICP align of (N, 3) source onto (M, 3) target,
    in the input frame.  Runs on `device` (CUDA unless the caller asks for
    the CPU)."""
    dev = _device.resolve(device)
    source, target, guess = (_device.as_f32(a, dev) for a in (source, target, guess))
    source_mask, target_mask = (_device.as_bool(a, dev) for a in (source_mask, target_mask))
    source_covs, target_covs = (_device.as_f32(a, dev) for a in (source_covs, target_covs))
    linearize, error = make_multipoint_objective(source, source_mask, source_covs, target,
                                                 target_mask, target_covs, config)
    return lsq_solve(linearize, error, guess, config.lsq)


@dataclass
class FastGICPMultiPoints(Registration):
    """Class-API multi-correspondence radius GICP (experimental, as in the
    reference); kNN covariances of both clouds, cached on the clouds."""

    search_radius: float = 1.0
    k_neighbors: int = 32
    k_correspondences: int = 20
    regularization: str = "plane"

    def set_search_radius(self, r: float) -> None:
        self.search_radius = float(r)

    def set_correspondence_randomness(self, k: int) -> None:
        self.k_correspondences = int(k)

    def set_regularization_method(self, method: str) -> None:
        self.regularization = method

    def set_num_threads(self, n: int) -> None:  # API parity no-op
        del n

    def _ensure_covariances(self, cloud: Cloud) -> None:
        estimate_covariances(cloud, "knn", self.k_correspondences, self.regularization)

    def _config(self) -> MultiPointConfig:
        return MultiPointConfig(search_radius=self.search_radius, k_neighbors=self.k_neighbors,
                                k_correspondences=self.k_correspondences,
                                regularization=self.regularization, lsq=self._lsq_config())

    def _compute(self, source: Cloud, target: Cloud, guess):
        self._ensure_covariances(source)
        self._ensure_covariances(target)
        return multipoint_align(source.points, source.mask, source.covs, target.points,
                                target.mask, target.covs, guess, self._config(),
                                device=self.device)
