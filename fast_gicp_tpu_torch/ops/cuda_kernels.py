"""RBF kernel-density moments: the CUDA kernel `csrc/rbf_moments.cu` and
its plain PyTorch version (port of `fast_gicp_tpu.ops.pallas_kernels`'
RBF part).

`rbf_moments` is the counterpart of `rbf_cross_moments_centered_T`
(`pallas_kernels.py:461`, kernel `_rbf_kernel`): for every query, 16 rows
of weighted moments of the target cloud about `center`,
[sum w, sum w y (3), sum w y y^T (9 row-major), 0 (3)], with
w = exp(-kernel_width d^2) for d^2 = |q - y|^2 <= max_dist^2 and y the
target point minus `center`.  Rows of masked queries carry no meaning.

The TPU kernel's bf16 hi/lo feature split and (8, N) padding are layout
workarounds and are gone: the CUDA kernel accumulates in f32 registers
(see the note in the source for its design and bound).  The (q - t)^2
distance form and the centering are numerics and are kept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RBF_ARGS = (_P, _P, _I, _I, _F, _F, _P, _P)


def _pack(points, mask, center):
    """(N, 3) points and (N,) mask -> contiguous (N, 4) [p - center, valid]."""
    return torch.cat(
        [points - center, mask.to(points.dtype)[:, None]], dim=1
    ).contiguous()


def _check_cloud(name, points, mask):
    if points.dtype != torch.float32 or points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"{name}: expected (N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if mask.dtype != torch.bool or mask.shape != points.shape[:1]:
        raise ValueError(f"{name} mask: expected ({points.shape[0]},) bool")


def _constants(kernel_width, max_dist):
    """Both versions see the same f32 constants kw and max_dist^2."""
    return float(np.float32(kernel_width)), float(np.float32(max_dist * max_dist))


def rbf_moments(query, qmask, target, tmask, center, kernel_width, max_dist):
    """(16, Nq) RBF moment rows of `target` about `center` for each query.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    devices = {t.device for t in (query, qmask, target, tmask, center)}
    if len(devices) != 1:
        raise ValueError(f"rbf_moments: tensors on several devices {devices}")
    if query.device.type == "cpu":
        return rbf_moments_plain(query, qmask, target, tmask, center,
                                 kernel_width, max_dist)
    if query.device.type != "cuda":
        raise ValueError(f"rbf_moments: unsupported device {query.device}")
    kw, md2 = _constants(kernel_width, max_dist)
    q4 = _pack(query, qmask, center)
    t4 = _pack(target, tmask, center)
    nq, nt = q4.shape[0], t4.shape[0]
    out = torch.empty((16, nq), dtype=torch.float32, device=q4.device)
    fn = _build.function("fgt_rbf_moments", _RBF_ARGS)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    _build.check("fgt_rbf_moments", fn(
        q4.data_ptr(), t4.data_ptr(), nq, nt, kw, md2, out.data_ptr(), stream))
    rbf_moments.launches += 1
    return out


rbf_moments.launches = 0


def rbf_moments_plain(query, qmask, target, tmask, center, kernel_width,
                      max_dist, chunk: int = 1024):
    """Plain PyTorch version of `rbf_moments`: dense (chunk, Nt) weight
    tiles times an (Nt, 10) moment feature matrix.  d^2 is summed in the
    kernel's order, so both versions take the same range decisions."""
    kw, md2 = _constants(kernel_width, max_dist)
    y = target - center
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    feats = torch.stack(
        [torch.ones_like(y0), y0, y1, y2,
         y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2, y2 * y2],
        dim=1,
    )
    qc = query - center
    parts = []
    for start in range(0, qc.shape[0], chunk):
        q = qc[start:start + chunk]
        dx = q[:, 0:1] - y0[None, :]
        dy = q[:, 1:2] - y1[None, :]
        dz = q[:, 2:3] - y2[None, :]
        d2 = (dx * dx + dy * dy) + dz * dz
        w = torch.where(tmask[None, :] & (d2 <= md2), torch.exp(d2 * -kw),
                        torch.zeros_like(d2))
        parts.append(w @ feats)
    m = torch.cat(parts).T  # (10, Nq)
    zero = torch.zeros_like(m[0])
    return torch.stack(
        [m[0], m[1], m[2], m[3],
         m[4], m[5], m[6], m[5], m[7], m[8], m[6], m[8], m[9],
         zero, zero, zero]
    )
