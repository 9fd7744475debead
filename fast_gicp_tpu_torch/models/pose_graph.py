"""SE(3) pose-graph optimization, dense (port of
`fast_gicp_tpu.models.pose_graph`).

Residual (right-perturbation pose-graph form):
    r_e(delta) = log( Z_e^-1 (T_i exp(d_i))^-1 (T_j exp(d_j)) )
with Z_e the measured relative pose.  The whole-graph Jacobian at delta = 0
comes from `torch.func.jacfwd`, the normal equations are assembled densely
((6K)^2: windows of tens of keyframes), pose 0 is pinned by a strong gauge
prior and the damped system is solved by `torch.linalg.solve_ex` (an LU
whose info is not read, as `jnp.linalg.solve` checks nothing).  Runs on the
card unless the caller passes device="cpu", in the device form by default:
the JAX package's `lax.while_loop` as a conditional WHILE node of a CUDA
graph captured once per signature, its condition set by
`cuda_pose_graph.pg_cond` (on the CPU the host loop over the same
condition); with `device_loop=False` the eager loop, which reads its
convergence flag to the host once an iteration.  Both give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from .. import device as _device
from .. import graphs, se3
from ..ops import cuda_pose_graph as cpg
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


def _gn_delta(T, edge_i, edge_j, edge_info, z_inv, diag, zero):
    """The Gauss-Newton step (K * 6,) at poses T: the whole-graph Jacobian
    by jacfwd, the dense normal equations, the damped solve."""
    k = T.shape[0]

    def res_flat(deltas):
        return _edge_residuals(T, deltas.reshape(k, 6), edge_i, edge_j, z_inv)

    J, r = jacfwd(_with_aux(res_flat), has_aux=True)(zero)  # (E, 6, 6K), (E, 6)
    WJ = torch.einsum("eij,ejd->eid", edge_info, J)
    H = torch.einsum("eid,eim->dm", J, WJ)
    b = torch.einsum("eid,ei->d", WJ, r)
    return -torch.linalg.solve_ex(H + torch.diag(diag), b, check_errors=False)[0]


def _final_error(T, edge_i, edge_j, edge_info, z_inv):
    r = _edge_residuals(T, torch.zeros((T.shape[0], 6), dtype=torch.float32, device=T.device),
                        edge_i, edge_j, z_inv)
    return torch.einsum("ei,eij,ej->", r, edge_info, r)


def _dense_device(poses, edge_i, edge_j, edge_info, z_inv, diag, zero, config):
    """The solve's device form: JAX's while_loop through `graphs.while_loop`,
    the state (poses, iterations, converged) in device buffers."""
    k, dev = poses.shape[0], poses.device
    T = poses.clone()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def step():
        delta = _gn_delta(T, edge_i, edge_j, edge_info, z_inv, diag, zero)
        T.copy_(T @ se3.se3_exp(delta.reshape(k, 6)))
        conv.copy_(torch.max(torch.abs(delta)) < config.convergence_delta)
        cpg.pg_cond(cpg.PG_GN_STEP, config.max_iterations, it, flag, stop=conv,
                    handle=gn.handle)

    gn = graphs.Condition(flag)
    cpg.pg_cond(cpg.PG_GN_ENTER, config.max_iterations, it, flag, stop=conv, handle=gn.handle)
    graphs.while_loop(gn, step)
    return PoseGraphResult(poses=T, error=_final_error(T, edge_i, edge_j, edge_info, z_inv),
                           iterations=it, converged=conv)


@f32_matmuls
def optimize_pose_graph(poses, edge_i, edge_j, edge_rel, edge_info=None,
                        config: PoseGraphConfig = PoseGraphConfig(),
                        device="cuda", device_loop: bool = True) -> PoseGraphResult:
    """Gauss-Newton pose-graph solve.

    Args:
      poses: (K, 4, 4) initial absolute poses.
      edge_i, edge_j: (E,) endpoint indices.
      edge_rel: (E, 4, 4) measured relative poses Z_e (i -> j).
      edge_info: optional (E, 6, 6) information matrices (e.g. registration
        Hessians); identity if None.
      device: where it runs (CUDA unless the caller asks for the CPU).
      device_loop: the device form (the default): on CUDA one replay of a
        graph captured once per signature (K, E, the config, the device,
        deterministic algorithms on or off), nothing read to the host; on the
        CPU its plain version.  A signature's first call also pays a warm-up
        and the capture, so it pays off where signatures repeat.  False: the
        eager loop.
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
    if device_loop:
        inputs = dict(poses=poses, edge_i=edge_i, edge_j=edge_j, edge_info=edge_info,
                      z_inv=z_inv)
        key = ("dense", k, edge_i.shape[0], config)
        return graphs.replay_cached(key, inputs, lambda **kw: _dense_device(
            **kw, diag=diag, zero=zero, config=config), dev)
    T, it, conv = poses, 0, False
    conv_t = torch.zeros((), dtype=torch.bool, device=dev)
    while it < config.max_iterations and not conv:
        delta = _gn_delta(T, edge_i, edge_j, edge_info, z_inv, diag, zero)
        T = T @ se3.se3_exp(delta.reshape(k, 6))
        conv_t = torch.max(torch.abs(delta)) < config.convergence_delta
        it += 1
        conv = bool(conv_t)  # the one host read a Gauss-Newton iteration
    return PoseGraphResult(poses=T, error=_final_error(T, edge_i, edge_j, edge_info, z_inv),
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
