"""SE(3) pose-graph optimization, dense (port of
`fast_gicp_tpu.models.pose_graph`).

Residual (right-perturbation pose-graph form):
    r_e(delta) = log( Z_e^-1 (T_i exp(d_i))^-1 (T_j exp(d_j)) )
with Z_e the measured relative pose.  The whole-graph Jacobian at delta = 0
comes from `torch.func.jacfwd`, the normal equations are assembled densely
((6K)^2: windows of tens of keyframes), pose 0 is pinned by a strong gauge
prior and the damped system is solved by `torch.linalg.solve`.  The
Gauss-Newton loop reads its convergence flag to the host once an iteration
(the JAX package's `lax.while_loop` keeps it on the device).  Runs on the
card unless the caller passes device="cpu".
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from .. import device as _device
from .. import se3
from ..precision import f32_matmuls


class PoseGraphConfig(NamedTuple):
    max_iterations: int = 10
    damping: float = 1e-9
    gauge_weight: float = 1e8  # prior information pinning pose 0
    convergence_delta: float = 1e-6  # max |delta| to declare convergence


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) optimized poses
    error: torch.Tensor  # () final weighted squared error
    iterations: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool


def _edge_residuals(poses, deltas, idx_i, idx_j, z_inv):
    """Stacked (E, 6) residuals at perturbation `deltas` (K, 6)."""
    T = poses @ se3.se3_exp(deltas)
    rel = se3.invert_transform(T[idx_i]) @ T[idx_j]
    return se3.se3_log(z_inv @ rel)


def _with_aux(fn):
    """fn(x) -> (fn(x), fn(x)): jacfwd's has_aux form, so that one pass gives
    the Jacobian and the value."""
    def both(x):
        out = fn(x)
        return out, out
    return both


_NUMPY = {torch.float32: np.float32, torch.int64: np.int64}


def _on(a, dtype, dev):
    """A tensor or array as a contiguous `dtype` tensor on `dev`; arrays go
    up through pinned memory, so the upload makes no host sync."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype).contiguous()
    return _device.upload(np.asarray(a, dtype=_NUMPY[dtype]), dev)


def graph_inputs(poses, edge_i, edge_j, edge_rel, edge_info, dev):
    """The solvers' inputs as tensors on `dev`: poses float32, the endpoints
    int64, the information matrices (identity if None) and Z_e^-1."""
    poses = _on(poses, torch.float32, dev)
    edge_i = _on(edge_i, torch.int64, dev)
    edge_j = _on(edge_j, torch.int64, dev)
    if edge_info is None:
        edge_info = torch.eye(6, dtype=torch.float32, device=dev).expand(edge_i.shape[0], 6, 6)
    else:
        edge_info = _on(edge_info, torch.float32, dev)
    z_inv = se3.invert_transform(_on(edge_rel, torch.float32, dev))
    return poses, edge_i, edge_j, edge_info, z_inv


@f32_matmuls
def optimize_pose_graph(poses, edge_i, edge_j, edge_rel, edge_info=None,
                        config: PoseGraphConfig = PoseGraphConfig(),
                        device="cuda") -> PoseGraphResult:
    """Gauss-Newton pose-graph solve.

    Args:
      poses: (K, 4, 4) initial absolute poses.
      edge_i, edge_j: (E,) endpoint indices.
      edge_rel: (E, 4, 4) measured relative poses Z_e (i -> j).
      edge_info: optional (E, 6, 6) information matrices (e.g. registration
        Hessians); identity if None.
      device: where it runs (CUDA unless the caller asks for the CPU).
    """
    dev = _device.resolve(device)
    poses, edge_i, edge_j, edge_info, z_inv = graph_inputs(
        poses, edge_i, edge_j, edge_rel, edge_info, dev)
    k = poses.shape[0]
    diag = torch.cat([
        torch.full((6,), config.gauge_weight, dtype=torch.float32, device=dev),
        torch.full((6 * k - 6,), config.damping, dtype=torch.float32, device=dev),
    ])
    zero = torch.zeros(6 * k, dtype=torch.float32, device=dev)
    T, it, conv = poses, 0, False
    conv_t = torch.zeros((), dtype=torch.bool, device=dev)
    while it < config.max_iterations and not conv:
        def res_flat(deltas, T=T):
            return _edge_residuals(T, deltas.reshape(k, 6), edge_i, edge_j, z_inv)

        J, r = jacfwd(_with_aux(res_flat), has_aux=True)(zero)  # (E, 6, 6K), (E, 6)
        WJ = torch.einsum("eij,ejd->eid", edge_info, J)
        H = torch.einsum("eid,eim->dm", J, WJ)
        b = torch.einsum("eid,ei->d", WJ, r)
        delta = -torch.linalg.solve(H + torch.diag(diag), b)
        T = T @ se3.se3_exp(delta.reshape(k, 6))
        conv_t = torch.max(torch.abs(delta)) < config.convergence_delta
        it += 1
        conv = bool(conv_t)  # the one host read a Gauss-Newton iteration
    r = _edge_residuals(T, torch.zeros((k, 6), dtype=torch.float32, device=dev),
                        edge_i, edge_j, z_inv)
    err = torch.einsum("ei,eij,ej->", r, edge_info, r)
    return PoseGraphResult(poses=T, error=err,
                           iterations=torch.full((), it, dtype=torch.int32, device=dev),
                           converged=conv_t)


def edges_from_odometry(poses):
    """Sequential odometry edges (i, i+1) with measured relatives taken from
    the given pose chain (numpy)."""
    k = len(poses)
    idx_i = np.arange(k - 1, dtype=np.int32)
    idx_j = idx_i + 1
    rel = np.stack(
        [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(k - 1)]
    ).astype(np.float32)
    return idx_i, idx_j, rel
