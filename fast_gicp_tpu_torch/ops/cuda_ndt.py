"""NDT linearize and trial error: the CUDA kernels of `csrc/ndt_linearize.cu`
and their plain PyTorch versions (port of `fast_gicp_tpu.ops.pallas_linearize`'s
NDT part).

`ndt_linearize` is the counterpart of `ndt_linearize_pallas`
(`pallas_linearize.py:518`): mode "d2d" replaces `_ndt_d2d_lin_kernel`
(`:330`), "p2d" `_ndt_p2d_lin_kernel` (`:347`), "d2d_raw"
`_ndt_d2d_raw_lin_kernel` (`:492`) and "p2d_raw" `_ndt_p2d_raw_lin_kernel`
(`:507`); `ndt_error` replaces `_ndt_error_kernel` (`:580`) behind
`ndt_error_pallas`.  Each mode has a wrapper of its own with its own launch
count.

Layouts (L = K * N correspondences, offset-major, without the JAX package's
(8, L) sublane padding and (8, 128) pose tile):
  * p (3, L): untransformed source columns, tiled over the offsets (the
    error reads only its first N = L / offsets columns, or takes them as
    (3, N)); ca (6, L): unrotated source sym-6 covariance columns (D2D
    only) -- both loop-invariant over a solve;
  * x (4, 4): the pose, applied inside the kernel;
  * pack (L, 16), rows-major: finalized modes [mu (3), cov_B (D2D) or
    M = cov_B^-1 (P2D) sym-6 (6), valid, pad (6)]; raw modes [voxel corner
    o (3), count, sum d (3), sum d d^T sym-6 (6), valid, pad (2)];
  * aux (10, L) = [M (6), valid, mu (3)], written by `ndt_linearize` and
    read by `ndt_error`.  GICP's aux (`cuda_linearize`) has the same shape
    with the weight in row 6: the two must not be mixed.
The Cauchy weight w = c^2 / (c^2 + |mu - p|^2) * valid uses c = the voxel
resolution; `ndt_error` recomputes it at the trial pose.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, soa
from .cuda_linearize import (
    AUX_ROWS, _check, _check_cuda, _reduce_scratch, normal_equations,
)
from .voxelmap import MIN_EIG

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIN_ARGS = (_P, _P, _P, _P, _F, _I, _P, _P, _P, _P, _P)
_ERR_ARGS = (_P, _I, _I, _P, _P, _F, _I, _P, _P, _P, _P)

MODES = ("d2d", "p2d", "d2d_raw", "p2d_raw")


def _c_sq(resolution) -> float:
    """resolution^2 rounded to float32, as the JAX package squares it."""
    r = np.float32(resolution)
    return float(r * r)


def _linearize(wrapper, mode, p, ca, x, pack, resolution):
    L = p.shape[-1]
    _check("p", p, (3, L))
    if mode.startswith("d2d"):
        if ca is None:
            raise ValueError("ca: D2D needs the source covariance columns")
        _check("ca", ca, (6, L))
    _check("x", x, (4, 4))
    _check("pack", pack, (L, 16))
    c_sq = _c_sq(resolution)
    if p.device.type == "cpu":
        return ndt_linearize_plain(p, ca, x, pack, c_sq, mode)
    _check_cuda([p, x, pack] + ([ca] if mode.startswith("d2d") else []))
    if pack.data_ptr() % 16:
        raise ValueError("pack must be 16-byte aligned (read as float4)")
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(43, dtype=torch.float32, device=p.device)
    aux = torch.empty((AUX_ROWS, L), dtype=torch.float32, device=p.device)
    entry = f"fgt_ndt_linearize_{mode}"
    fn = _build.function(entry, _LIN_ARGS)
    _build.check(entry, fn(
        p.data_ptr(), ca.data_ptr() if mode.startswith("d2d") else None,
        x.data_ptr(), pack.data_ptr(), c_sq, L, partials.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), aux.data_ptr(), stream))
    wrapper.launches += 1
    return normal_equations(out) + (aux,)


def ndt_linearize_d2d(p, ca, x, pack, resolution):
    """D2D against a finalized pack [mu, cov_B, valid]: M = (cov_B +
    R C_A R^T)^-1 at pose x.  Returns (err, H (6, 6), b (6,), aux (10, L)).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return _linearize(ndt_linearize_d2d, "d2d", p, ca, x, pack, resolution)


def ndt_linearize_p2d(p, ca, x, pack, resolution):
    """P2D against a finalized pack [mu, M = cov_B^-1, valid] (ca unused)."""
    return _linearize(ndt_linearize_p2d, "p2d", p, ca, x, pack, resolution)


def ndt_linearize_d2d_raw(p, ca, x, pack, resolution):
    """D2D against a raw pack: finalize and MIN_EIG clamp, then as "d2d"."""
    return _linearize(ndt_linearize_d2d_raw, "d2d_raw", p, ca, x, pack, resolution)


def ndt_linearize_p2d_raw(p, ca, x, pack, resolution):
    """P2D against a raw pack: finalize, MIN_EIG clamp and invert, then as
    "p2d" (ca unused)."""
    return _linearize(ndt_linearize_p2d_raw, "p2d_raw", p, ca, x, pack, resolution)


_BY_MODE = {
    "d2d": ndt_linearize_d2d,
    "p2d": ndt_linearize_p2d,
    "d2d_raw": ndt_linearize_d2d_raw,
    "p2d_raw": ndt_linearize_p2d_raw,
}
for _fn in _BY_MODE.values():
    _fn.launches = 0


def ndt_linearize(p, ca, x, pack, resolution, mode):
    """(err (), H (6, 6), b (6,), aux (10, L)) of the NDT objective at pose x
    against a frozen pack; `mode` is one of MODES (ca may be None for the
    P2D modes).  CPU tensors take the plain version; CUDA tensors launch the
    mode's kernel."""
    if mode not in _BY_MODE:
        raise ValueError(f"unknown NDT linearize mode {mode!r}")
    return _BY_MODE[mode](p, ca, x, pack, resolution)


def ndt_error(p, aux, x, resolution, offsets=1):
    """Sum of w e^T M e at trial pose x against the frozen NDT aux (10, L),
    the Cauchy weight taken at x (scalar).  Lanes are `offsets` blocks of
    N = L / offsets, lane k * N + i reading source column i: p is (3, N), or
    (3, L) tiled over the offsets, of which only the first N columns are
    read.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    L = aux.shape[-1]
    _check("aux", aux, (AUX_ROWS, L))
    _check("x", x, (4, 4))
    if offsets < 1 or L % offsets:
        raise ValueError(f"offsets={offsets} does not divide L={L}")
    N = L // offsets
    if p.dim() == 2 and p.shape[-1] == L:
        p = p[:, :N]
    _check("p", p, (3, N))
    c_sq = _c_sq(resolution)
    if p.device.type == "cpu":
        return ndt_error_plain(p.repeat(1, offsets), aux, x, c_sq)
    _check_cuda([aux, x])
    if p.device != aux.device or (N > 1 and p.stride(1) != 1):
        raise ValueError("p must lie on the device of aux, its columns contiguous")
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(1, dtype=torch.float32, device=p.device)
    fn = _build.function("fgt_ndt_error", _ERR_ARGS)
    _build.check("fgt_ndt_error", fn(
        p.data_ptr(), p.stride(0), N, x.data_ptr(), aux.data_ptr(), c_sq, L,
        partials.data_ptr(), ticket.data_ptr(), out.data_ptr(), stream))
    ndt_error.launches += 1
    return out[0]


ndt_error.launches = 0


def _cauchy(c_sq, p, q, valid):
    e0, e1, e2 = q[0] - p[0], q[1] - p[1], q[2] - p[2]
    return c_sq / (c_sq + e0 * e0 + e1 * e1 + e2 * e2) * valid


def _unpack_raw(pack):
    """Raw pack rows (L, 16) -> (mu (3, L), clamped cov_B (6, L), valid (L,)):
    the finalize of the raw modes (corner-relative moments divided out,
    E[d d^T] - dmu dmu^T, the MIN_EIG clamp, valid cleared on empty voxels)."""
    cnt = pack[:, 3]
    alive = (cnt > 0).to(pack.dtype)
    inv_n = alive / torch.clamp(cnt, min=1.0)
    d = pack[:, 4:7].T * inv_n
    mu = pack[:, 0:3].T + d
    C = pack[:, 7:13].T * inv_n - torch.stack(
        [d[0] * d[0], d[0] * d[1], d[0] * d[2], d[1] * d[1], d[1] * d[2], d[2] * d[2]])
    return mu, soa.clamp_eigs_cols(C, MIN_EIG), pack[:, 13] * alive


def ndt_linearize_plain(p, ca, x, pack, c_sq, mode):
    """Plain PyTorch version of `ndt_linearize` (`c_sq` = resolution^2)."""
    if mode.endswith("_raw"):
        mu, C, valid = _unpack_raw(pack)
    else:
        mu, C, valid = pack[:, 0:3].T, pack[:, 3:9].T, pack[:, 9]
    if mode.startswith("d2d"):
        M = soa.inv_sym_cols(C + soa.rotate_sym_cols(x[:3, :3], ca))
    elif mode == "p2d_raw":
        M = soa.inv_sym_cols(C)
    else:
        M = C
    M = M * valid
    p_t = soa.transform_cols(x, p)
    err, H, b = soa.linearize_cols(p_t, mu, M, _cauchy(c_sq, p_t, mu, valid))
    return err, H, b, torch.cat([M, valid[None], mu])


def ndt_error_plain(p, aux, x, c_sq):
    """Plain PyTorch version of `ndt_error` (`c_sq` = resolution^2)."""
    p_t = soa.transform_cols(x, p)
    mu, valid = aux[7:10], aux[6]
    return soa.error_cols(p_t, mu, aux[:6], _cauchy(c_sq, p_t, mu, valid))
