"""GICP/VGICP linearize and trial error: the CUDA kernels of
`csrc/linearize.cu` and their plain PyTorch versions (port of
`fast_gicp_tpu.ops.pallas_linearize`'s GICP part).

`linearize_raw` is the counterpart of `linearize_raw_pallas` (kernel
`_linearize_raw_kernel`, `pallas_linearize.py:193`), `linearize` of
`linearize_pallas` (kernel `_linearize_kernel`, `pallas_linearize.py:180`)
and `error` of `error_pallas` (kernel `_error_kernel`,
`pallas_linearize.py:633`).  The two linearizes share one device body and
differ only in how they unpack the target rows.

Layouts (L correspondences, column-major like the JAX package's SoA math,
without its (8, N) sublane padding):
  * p (3, L): untransformed source columns; ca (6, L): unrotated source
    sym-6 covariance columns -- both loop-invariant over a solve;
  * x (4, 4): the pose, applied inside the kernel;
  * rows (T, 16), a row table, and idx (L,) int32 or int64: correspondence
    n reads row idx[n] (the kernel reads it by index; the JAX package
    gathers the rows first, as a TPU kernel cannot).  Without idx, rows is
    (L, 16), already gathered.  For `linearize_raw`, raw voxel rows
    [count, sum mu (3), sum cov (9 row-major), pad (3)], count 0 marking a
    miss; for `linearize`, finalized rows [mu (3), cov (9 row-major),
    count, pad (3)] (GICP's matched target points carry count 1);
  * valid (L,): 0/1 source (correspondence) validity;
  * aux (10, L) = [M (6), w, mu_B (3)]: written by both linearizes, read
    by `error`.  w = sqrt(count) * valid.
The kernels write err, H and b into one 43-float buffer
[err, H (6 x 6), b (6)]; the wrappers return views of it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, soa

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIN_ARGS = (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P)
_ERR_ARGS = (_P, _P, _P, _I, _P, _P, _P, _P)

AUX_ROWS = 10


def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def _same_device(tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on several devices: {t.device} vs {dev}")
    return dev


def _check_cuda(tensors):
    dev = _same_device(tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


_scratches: dict = {}


def _reduce_scratch(device):
    """(partials, ticket, stream handle) of the kernels' cross-block sums
    on the current stream of `device`, made once a device and stream:
    partials for the most blocks any linearize or error kernel launches
    (`fgt_max_reduce_blocks()` x 28 floats) and a ticket zeroed once, which
    every kernel leaves at 0 again.  Kernels on one stream run in turn, so
    they share both, and a launch needs no allocation and no fill.

    They are made eagerly at a stream's first launch: a stream first seen
    while it captures a CUDA graph raises (its scratch would come from the
    graph's pool), so a capture prepares its streams first
    (`graphs.prepare`)."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    if key not in _scratches:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the reduction scratch of a stream is made before it captures: "
                "call graphs.prepare(device) on the capture's streams first")
        rows = _build.function("fgt_max_reduce_blocks", ())()
        if rows < 1:
            raise RuntimeError("fgt_max_reduce_blocks: the CUDA runtime refused")
        dev = torch.device("cuda", stream.device_index)
        _scratches[key] = (torch.empty(rows * 28, dtype=torch.float32, device=dev),
                           torch.zeros(1, dtype=torch.int32, device=dev))
    return _scratches[key] + (stream.cuda_stream,)


def normal_equations(out):
    """(err (), H (6, 6), b (6,)) as views of a kernel's 43-float
    [err, H (6 x 6), b (6)] buffer: no device op."""
    return out[0], out[1:37].view(6, 6), out[37:43]


def _linearize(wrapper, entry, plain, p, ca, x, rows, valid, idx):
    """The shared body of the two linearize wrappers: checks, the plain
    version for CPU tensors (rows[idx] first when idx is given), else one
    launch of C entry `entry`, counted on `wrapper` (and in
    `wrapper.idx_launches` when it read rows by index)."""
    L = p.shape[-1]
    _check("p", p, (3, L))
    _check("ca", ca, (6, L))
    _check("x", x, (4, 4))
    _check("valid", valid, (L,))
    tensors = [p, ca, x, rows, valid]
    if idx is None:
        _check("rows", rows, (L, 16))
    else:
        if rows.dim() != 2 or rows.shape[1] != 16 or rows.dtype != torch.float32:
            raise ValueError(f"rows: expected (T, 16) {torch.float32}, got "
                             f"{tuple(rows.shape)} {rows.dtype}")
        if idx.dtype not in (torch.int32, torch.int64) or tuple(idx.shape) != (L,):
            raise ValueError(f"idx: expected ({L},) int32 or int64, got "
                             f"{tuple(idx.shape)} {idx.dtype}")
        tensors.append(idx)
    if _same_device(tensors).type == "cpu":
        return plain(p, ca, x, rows if idx is None else rows[idx], valid)
    _check_cuda(tensors)
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (read as float4)")
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(43, dtype=torch.float32, device=p.device)
    aux = torch.empty((AUX_ROWS, L), dtype=torch.float32, device=p.device)
    fn = _build.function(entry, _LIN_ARGS)
    _build.check(entry, fn(
        p.data_ptr(), ca.data_ptr(), x.data_ptr(), rows.data_ptr(),
        None if idx is None else idx.data_ptr(), 0 if idx is None else idx.element_size(),
        valid.data_ptr(), L, partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        aux.data_ptr(), stream))
    wrapper.launches += 1
    if idx is not None:
        wrapper.idx_launches += 1
    return normal_equations(out) + (aux,)


def linearize_raw(p, ca, x, rows, valid, idx=None):
    """(err (), H (6, 6), b (6,), aux (10, L)) of the VGICP objective at
    pose x against raw voxel rows: row idx[n] of the table rows (T, 16)
    for correspondence n, or row n of gathered rows (L, 16) without idx.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return _linearize(linearize_raw, "fgt_linearize_raw", linearize_raw_plain,
                      p, ca, x, rows, valid, idx)


linearize_raw.launches = 0
linearize_raw.idx_launches = 0


def linearize(p, ca, x, rows, valid, idx=None):
    """(err (), H (6, 6), b (6,), aux (10, L)) of the GICP objective at pose
    x against finalized target rows [mu, cov9, count, pad]: row idx[n] of
    the table rows (T, 16) for correspondence n, or row n of gathered rows
    (L, 16) without idx.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    return _linearize(linearize, "fgt_linearize", linearize_plain,
                      p, ca, x, rows, valid, idx)


linearize.launches = 0
linearize.idx_launches = 0


def error(p, x, aux):
    """Sum of w e^T M e at trial pose x against the frozen aux (scalar).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    L = p.shape[-1]
    _check("p", p, (3, L))
    _check("x", x, (4, 4))
    _check("aux", aux, (AUX_ROWS, L))
    if p.device.type == "cpu":
        return error_plain(p, x, aux)
    _check_cuda([p, x, aux])
    partials, ticket, stream = _reduce_scratch(p.device)
    out = torch.empty(1, dtype=torch.float32, device=p.device)
    fn = _build.function("fgt_error", _ERR_ARGS)
    _build.check("fgt_error", fn(
        p.data_ptr(), x.data_ptr(), aux.data_ptr(), L, partials.data_ptr(),
        ticket.data_ptr(), out.data_ptr(), stream))
    error.launches += 1
    return out[0]


error.launches = 0


def linearize_raw_plain(p, ca, x, rows, valid):
    """Plain PyTorch version of `linearize_raw` (the raw-grid branch of the
    JAX objective, `vgicp.py:219-237`, with the kernel's aux layout)."""
    mu_B, cov_B, count = soa.sym_cols_from_raw(rows)
    valid = valid * (count > 0).to(valid.dtype)
    p_t = soa.transform_cols(x, p)
    cov_rot = soa.rotate_sym_cols(x[:3, :3], ca)
    M = soa.inv_sym_cols(cov_B + cov_rot) * valid
    w = torch.sqrt(torch.clamp(count, min=0.0)) * valid
    err, H, b = soa.linearize_cols(p_t, mu_B, M, w)
    return err, H, b, torch.cat([M, w[None], mu_B])


def linearize_plain(p, ca, x, rows, valid):
    """Plain PyTorch version of `linearize` (the GICP objective,
    `gicp.py:112-133`, with the kernel's aux layout)."""
    mu_B = rows[:, 0:3].T
    cov_B = torch.stack([rows[:, 3], rows[:, 4], rows[:, 5],
                         rows[:, 7], rows[:, 8], rows[:, 11]])
    count = rows[:, 12]
    p_t = soa.transform_cols(x, p)
    cov_rot = soa.rotate_sym_cols(x[:3, :3], ca)
    M = soa.inv_sym_cols(cov_B + cov_rot) * valid
    w = torch.sqrt(torch.clamp(count, min=0.0)) * valid
    err, H, b = soa.linearize_cols(p_t, mu_B, M, w)
    return err, H, b, torch.cat([M, w[None], mu_B])


def error_plain(p, x, aux):
    """Plain PyTorch version of `error`."""
    return soa.error_cols(soa.transform_cols(x, p), aux[7:10], aux[:6], aux[6])
