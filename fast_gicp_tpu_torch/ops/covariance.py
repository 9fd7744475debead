"""RBF kernel-density covariances (port of the RBF path of
`fast_gicp_tpu.ops.covariance`).

For each query q: w_j = exp(-kernel_width |q - x_j|^2) if
|q - x_j| <= max_dist else 0; mean = sum w x / sum w;
cov = sum w x x^T / sum w - mean mean^T (covariance_estimation_rbf.cu:40-84),
then PLANE regularization.  The moments come from the RBF kernel
(`cuda_kernels.rbf_moments`) about the cloud's masked mean: covariances
are translation-invariant, and centering keeps the E[x x^T] - mu mu^T
finalize from cancelling at large coordinates.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..precision import f32_matmuls
from . import cuda_kernels, soa


def masked_mean(points, mask):
    """Mean of the valid rows of (N, 3) points (zeros if none)."""
    valid = mask.to(points.dtype)
    return torch.sum(points * valid[:, None], dim=0) / torch.clamp(
        torch.sum(valid), min=1.0
    )


def rbf_covariance_cols(points, mask, kernel_width: float = 0.5,
                        max_dist: float = 3.0, method: str = "plane"):
    """RBF covariances as sym-6 columns (6, N) on the points' device.
    `method` is "plane" or "none"."""
    if method not in ("plane", "none"):
        raise NotImplementedError(
            f"regularization {method!r}: only 'plane' and 'none' are ported"
        )
    m = cuda_kernels.rbf_moments(points, mask, points, mask,
                                 masked_mean(points, mask), kernel_width,
                                 max_dist)
    inv_w = 1.0 / torch.clamp(m[0], min=1e-12)
    mean = [m[1] * inv_w, m[2] * inv_w, m[3] * inv_w]
    cov6 = torch.stack(
        [
            m[4] * inv_w - mean[0] * mean[0],
            0.5 * (m[5] + m[7]) * inv_w - mean[0] * mean[1],
            0.5 * (m[6] + m[10]) * inv_w - mean[0] * mean[2],
            m[8] * inv_w - mean[1] * mean[1],
            0.5 * (m[9] + m[11]) * inv_w - mean[1] * mean[2],
            m[12] * inv_w - mean[2] * mean[2],
        ]
    )
    return soa.plane_covs_cols(cov6) if method == "plane" else cov6


@f32_matmuls
def rbf_covariances(points, mask, kernel_width: float = 0.5,
                    max_dist: float = 3.0, method: str = "plane",
                    device="cuda"):
    """(N, 3, 3) RBF kernel-density covariances of an (N, 3) cloud with an
    (N,) bool mask.  Defaults match fast_vgicp_cuda_impl.hpp:24-31.  Runs on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    points = _device.as_f32(points, dev)
    mask = _device.as_bool(mask, dev)
    cols = rbf_covariance_cols(points, mask, kernel_width, max_dist, method)
    return soa.sym_cols_to_rows9(cols).reshape(points.shape[0], 3, 3)
