"""The point-pair kernels -- RBF moments, exact 1-NN search, fused kNN
moments, the kNN slab search and the adaptive-radius count and window --
(`csrc/rbf_moments.cu`, `csrc/nn_search.cu`, `csrc/knn_moments.cu`,
`csrc/knn_slab.cu`, `csrc/radius_window.cu`) and their plain PyTorch
versions (port of `fast_gicp_tpu.ops.pallas_kernels`).

`rbf_moments` is the counterpart of `rbf_cross_moments_centered_T`
(`pallas_kernels.py:461`, kernel `_rbf_kernel`): for every query, 16 rows
of weighted moments of the target cloud about `center`,
[sum w, sum w y (3), sum w y y^T (9 row-major), 0 (3)], with
w = exp(-kernel_width d^2) for d^2 = |q - y|^2 <= max_dist^2 and y the
target point minus `center`.  Rows of masked queries carry no meaning.

`nn_search` is the counterpart of `nn_search_pallas` (`pallas_kernels.py:173`,
kernel `_nn_kernel`): the exact nearest target of every query.

`knn_moments` is the counterpart of `knn_moments_pallas`
(`pallas_kernels.py:372`, kernel `_make_knn_moments_kernel`): the packed-key
k-NN selection over each query tile's candidate slab, and the moments of
the selected neighbours about the tile's first query point.

`knn_slab` is the counterpart of `knn_slab_pallas` (`pallas_kernels.py:252`,
kernel `_make_knn_slab_kernel`): the k nearest candidates of each query
over its tile's candidate slab, exact f32 d^2 ascending, ties to the lower
slab position.  With every target tile as a candidate it is the exact k-NN.

`radius_count` and `radius_window` are the two passes of
`radius_window_moments_T` (`pallas_kernels.py:663`, kernels `_count_kernel`
and `_window_kernel`): counts within each rung of a squared-radius ladder,
then hard-window moments at a per-query squared radius.

The TPU kernels' bf16 hi/lo feature split and (8, N) padding are layout
workarounds and are gone: the CUDA kernels keep their sums in f32
registers (see the note in each source for its design and bound).  The
(q - t)^2 distance form, the centering and the per-tile moment origin are
numerics and are kept; every d^2 is rounded in the order the plain versions
use, so both take the same range, nearest and selection decisions.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build, tally

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RBF_ARGS = (_P, _P, _I, _I, _F, _F, _P, _P, _P, _P)
_NN_ARGS = (_P, _P, _I, _I, _P, _P, _P, _P, _P)
_KNN_ARGS = (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P)
_BOXES_ARGS = (_P, _I, _P, _P, _P)
_COUNT_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P)
_WINDOW_ARGS = (_P, _P, _P, _P, _I, _I, _P, _P, _P)

# Large finite coordinate for masked points: distances ~3.6e18, far below
# f32 overflow (3.4e38) even after squaring differences of 1e9.
MASK_COORD = 1.0e9
KNN_TILE = 256  # queries sharing one candidate slab in `knn_moments`
KNN_MAX_SLAB = 4096  # candidate positions a query tile may search
KNN_SLAB_MAX_K = 32  # neighbours a query may keep in `knn_slab`
RADIUS_MAX_RUNGS = 32  # ladder rungs `radius_count` counts at once
_RADIUS_TILE = 128  # targets per bounding box in `radius_count`
_CHUNK = 32  # targets per bounding box in `nn_search`, `rbf_moments`, `radius_window`


def _pack(points, mask, center):
    """(N, 3) points and (N,) mask -> contiguous (N, 4) [p - center, valid]."""
    return torch.cat(
        [points - center, mask.to(points.dtype)[:, None]], dim=1
    ).contiguous()


def _pack_masked(points, mask):
    """(N, 3) points and (N,) mask -> contiguous (N, 4) [p, valid] with the
    masked points parked at MASK_COORD."""
    parked = torch.where(mask[:, None], points, torch.full_like(points, MASK_COORD))
    return torch.cat([parked, mask.to(points.dtype)[:, None]], dim=1).contiguous()


def _check_points(name, points):
    if points.dtype != torch.float32 or points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"{name}: expected (N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")


def _check_cloud(name, points, mask):
    _check_points(name, points)
    if mask.dtype != torch.bool or mask.shape != points.shape[:1]:
        raise ValueError(f"{name} mask: expected ({points.shape[0]},) bool")


def _one_device(name, tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _sq_dist(q, t):
    """Squared distances of (..., 3) q against (..., 3) t broadcast, summed
    in the kernels' order ((dx^2 + dy^2) + dz^2)."""
    dx = q[..., 0] - t[..., 0]
    dy = q[..., 1] - t[..., 1]
    dz = q[..., 2] - t[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def _constants(kernel_width, max_dist):
    """Both versions see the same f32 constants kw and max_dist^2."""
    return float(np.float32(kernel_width)), float(np.float32(max_dist * max_dist))


def rbf_moments(query, qmask, target, tmask, center, kernel_width, max_dist):
    """(16, Nq) RBF moment rows of `target` about `center` for each query.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    dev = _one_device("rbf_moments", (query, qmask, target, tmask, center))
    if dev.type == "cpu":
        tally.add(dev, "rbf_moments")
        return rbf_moments_plain(query, qmask, target, tmask, center,
                                 kernel_width, max_dist)
    kw, md2 = _constants(kernel_width, max_dist)
    q4 = _pack(query, qmask, center)
    t4 = _pack(target, tmask, center)
    nq, nt = q4.shape[0], t4.shape[0]
    boxes = torch.empty(6 * -(-nt // _CHUNK), dtype=torch.float32, device=q4.device)
    out = torch.empty((16, nq), dtype=torch.float32, device=q4.device)
    fn = _build.function("fgt_rbf_moments", _RBF_ARGS)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    _build.check("fgt_rbf_moments", fn(
        q4.data_ptr(), t4.data_ptr(), nq, nt, kw, md2, boxes.data_ptr(), out.data_ptr(),
        tally.slot(dev, "rbf_moments"), stream))
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
        d2 = _sq_dist(qc[start:start + chunk, None, :], y[None, :, :])
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


def nn_search(query, target, tmask, qmask=None):
    """Exact 1-NN of each (Nq, 3) query in the (Nt, 3) target with (Nt,)
    mask: (idx int32 (Nq,), d^2 f32 (Nq,)), ties to the lowest index.
    Rows of queries masked out by the optional (Nq,) `qmask` are finite and
    carry no meaning (the kernel leaves them out of its culling bounds).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if qmask is None:
        qmask = torch.ones(query.shape[0], dtype=torch.bool, device=query.device)
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    if target.shape[0] == 0:
        raise ValueError("nn_search: empty target")
    dev = _one_device("nn_search", (query, qmask, target, tmask))
    if dev.type == "cpu":
        tally.add(dev, "nn_search")
        return nn_search_plain(query, target, tmask)
    q4 = torch.cat([query, qmask.to(query.dtype)[:, None]], dim=1).contiguous()
    t4 = _pack_masked(target, tmask)
    nq, nt = q4.shape[0], t4.shape[0]
    boxes = torch.empty(6 * -(-nt // _CHUNK), dtype=torch.float32, device=dev)
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    d2 = torch.empty(nq, dtype=torch.float32, device=dev)
    fn = _build.function("fgt_nn_search", _NN_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("fgt_nn_search", fn(
        q4.data_ptr(), t4.data_ptr(), nq, nt, boxes.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), tally.slot(dev, "nn_search"), stream))
    nn_search.launches += 1
    return idx, d2


nn_search.launches = 0


def nn_search_plain(query, target, tmask, chunk: int = 2048):
    """Plain PyTorch version of `nn_search` (every query row searched):
    dense (chunk, Nt) distance tiles and a first-index argmin."""
    t = torch.where(tmask[:, None], target, torch.full_like(target, MASK_COORD))
    idx, d2 = [], []
    for start in range(0, query.shape[0], chunk):
        d = _sq_dist(query[start:start + chunk, None, :], t[None, :, :])
        i = torch.argmin(d, dim=1)
        idx.append(i.to(torch.int32))
        d2.append(torch.gather(d, 1, i[:, None])[:, 0])
    return torch.cat(idx), torch.clamp(torch.cat(d2), min=0.0)


def _check_knn(query, target, cidx, k, cand_tile):
    Q, C = cidx.shape
    nq, nt = query.shape[0], target.shape[0]
    if cidx.dtype != torch.int32:
        raise ValueError(f"cidx: expected int32, got {cidx.dtype}")
    if nq != Q * KNN_TILE or nt % cand_tile or C * cand_tile > nt:
        raise ValueError(f"knn_moments: sizes ({nq}, {nt}) not tiled for "
                         f"Q={Q}, C={C}, cand_tile={cand_tile}")
    if C * cand_tile > KNN_MAX_SLAB:
        raise ValueError(f"knn_moments: slab {C} x {cand_tile} is wider than "
                         f"{KNN_MAX_SLAB} positions")
    if not 1 <= k <= C * cand_tile:
        raise ValueError(f"knn_moments: k={k} outside [1, {C * cand_tile}]")


def knn_moments(query, qmask, target, tmask, cidx, k: int, cand_tile: int = 128):
    """Fused k-NN moments: (mom (10, Nq), kth_sq (Nq,)).

    Query tile i (KNN_TILE queries) searches the `cand_tile`-point target
    tiles `cidx[i]` (a tile index outside [0, Nt / cand_tile) reads as
    masked points); mom rows are [count, sum y (3), sym-6 sum y y^T] over
    each query's k selected neighbours, y = x - (the tile's first query
    point), for the center-invariant covariance finalize only.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    _check_knn(query, target, cidx, k, cand_tile)
    dev = _one_device("knn_moments", (query, qmask, target, tmask, cidx))
    if dev.type == "cpu":
        tally.add(dev, "knn_moments")
        return knn_moments_plain(query, qmask, target, tmask, cidx, k, cand_tile)
    q4 = _pack_masked(query, qmask)
    t4 = _pack_masked(target, tmask)
    cidx = cidx.contiguous()
    nq, nt = q4.shape[0], t4.shape[0]
    mom = torch.empty((10, nq), dtype=torch.float32, device=dev)
    kth = torch.empty(nq, dtype=torch.float32, device=dev)
    fn = _build.function("fgt_knn_moments", _KNN_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("fgt_knn_moments", fn(
        q4.data_ptr(), t4.data_ptr(), cidx.data_ptr(), nq, nt, cidx.shape[1],
        cand_tile, int(k), mom.data_ptr(), kth.data_ptr(), tally.slot(dev, "knn_moments"),
        stream))
    knn_moments.launches += 1
    return mom, kth


knn_moments.launches = 0


def knn_moments_plain(query, qmask, target, tmask, cidx, k: int,
                      cand_tile: int = 128, chunk: int = 8):
    """Plain PyTorch version of `knn_moments`: the packed keys of whole
    (KNN_TILE, C * cand_tile) slabs, the k smallest by `torch.topk` (keys
    are unique, so the set is unambiguous), and the moments of the
    gathered neighbours; `chunk` query tiles at a time."""
    Q, C = cidx.shape
    S = C * cand_tile
    q = _pack_masked(query, qmask)[:, :3].reshape(Q, KNN_TILE, 3)
    t4 = _pack_masked(target, tmask).reshape(-1, cand_tile, 4)
    T = t4.shape[0]
    parked = torch.tensor([MASK_COORD, MASK_COORD, MASK_COORD, 0.0], device=query.device)
    lane = torch.arange(S, dtype=torch.int32, device=query.device)
    moms, kths = [], []
    for start in range(0, Q, chunk):
        qq = q[start:start + chunk]  # (n, KNN_TILE, 3)
        n = qq.shape[0]
        ids = cidx[start:start + chunk]
        inside = (ids >= 0) & (ids < T)
        cand = torch.where(inside[..., None, None], t4[ids.clamp(0, T - 1).long()],
                           parked).reshape(n, S, 4)
        d = _sq_dist(qq[:, :, None, :], cand[:, None, :, :])  # (n, KNN_TILE, S)
        keys = (d.view(torch.int32) & -4096) | lane
        top = torch.topk(keys, k, dim=2, largest=False, sorted=True)
        kths.append(torch.clamp((top.values[..., k - 1] & -4096).view(torch.float32),
                                min=0.0))
        picked = torch.gather(
            cand[:, None].expand(n, KNN_TILE, S, 4), 2,
            top.indices[..., None].expand(n, KNN_TILE, k, 4))  # (n, KNN_TILE, k, 4)
        v = picked[..., 3]
        y = (picked[..., :3] - qq[:, :1, None, :]) * v[..., None]
        y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
        feats = torch.stack([v, y0, y1, y2, y0 * y0, y0 * y1, y0 * y2,
                             y1 * y1, y1 * y2, y2 * y2], dim=0)  # (10, n, KNN_TILE, k)
        moms.append(feats.sum(dim=3).reshape(10, n * KNN_TILE))
    return torch.cat(moms, dim=1), torch.cat(kths).reshape(-1)


def _check_slab(query, target, cidx, k, cand_tile):
    Q, C = cidx.shape
    nq, nt = query.shape[0], target.shape[0]
    if cidx.dtype != torch.int32:
        raise ValueError(f"cidx: expected int32, got {cidx.dtype}")
    if cand_tile not in (128, 256):
        raise ValueError(f"knn_slab: cand_tile {cand_tile} is not 128 or 256")
    if nq != Q * KNN_TILE or nt % cand_tile:
        raise ValueError(f"knn_slab: sizes ({nq}, {nt}) not tiled for Q={Q}, "
                         f"cand_tile={cand_tile}")
    if not 1 <= k <= min(KNN_SLAB_MAX_K, C * cand_tile):
        raise ValueError(f"knn_slab: k={k} outside [1, min({KNN_SLAB_MAX_K}, "
                         f"{C * cand_tile})]")


def knn_slab(query, qmask, target, tmask, cidx, k: int, cand_tile: int = 256):
    """k-NN over candidate slabs: (idx (Nq, k) int32 global target ids,
    sq (Nq, k) f32 squared distances ascending, clamped at 0).

    Query tile i (KNN_TILE queries) searches the `cand_tile`-point target
    tiles `cidx[i]` (a tile index outside [0, Nt / cand_tile) reads as
    masked points); ties go to the lower slab position c * cand_tile + lane.
    Masked points are parked at MASK_COORD, so a masked target is chosen
    only when the slab holds fewer than k valid ones.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    _check_slab(query, target, cidx, k, cand_tile)
    dev = _one_device("knn_slab", (query, qmask, target, tmask, cidx))
    if dev.type == "cpu":
        tally.add(dev, "knn_slab")
        return knn_slab_plain(query, qmask, target, tmask, cidx, k, cand_tile)
    q4 = _pack_masked(query, qmask)
    t4 = _pack_masked(target, tmask)
    cidx = cidx.contiguous()
    nq, nt = q4.shape[0], t4.shape[0]
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    sq = torch.empty((nq, k), dtype=torch.float32, device=dev)
    fn = _build.function("fgt_knn_slab", _KNN_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check("fgt_knn_slab", fn(
        q4.data_ptr(), t4.data_ptr(), cidx.data_ptr(), nq, nt, cidx.shape[1], cand_tile,
        int(k), idx.data_ptr(), sq.data_ptr(), tally.slot(dev, "knn_slab"), stream))
    knn_slab.launches += 1
    return idx, sq


knn_slab.launches = 0


def knn_slab_plain(query, qmask, target, tmask, cidx, k: int, cand_tile: int = 256,
                   max_elems: int = 1 << 24):
    """Plain PyTorch version of `knn_slab`: the (KNN_TILE, C * cand_tile)
    d^2 slab of each query tile and a stable sort along it (equal d^2 keep
    their slab order; `torch.topk` promises no order among equal keys),
    the first k taken; query tiles in chunks of about `max_elems` d^2."""
    Q, C = cidx.shape
    S = C * cand_tile
    q = _pack_masked(query, qmask)[:, :3].reshape(Q, KNN_TILE, 3)
    t = _pack_masked(target, tmask)[:, :3].reshape(-1, cand_tile, 3)
    T = t.shape[0]
    inside = (cidx >= 0) & (cidx < T)
    cand = torch.where(inside[..., None, None], t[cidx.clamp(0, T - 1).long()],
                       torch.full((), MASK_COORD, dtype=t.dtype, device=t.device))
    cand = cand.reshape(Q, S, 3)
    lane = torch.arange(cand_tile, dtype=torch.int32, device=cidx.device)
    gid = (cidx[..., None] * cand_tile + lane).reshape(Q, 1, S)
    chunk = max(1, max_elems // (KNN_TILE * S))
    idx, sq = [], []
    for start in range(0, Q, chunk):
        qq, cc = q[start:start + chunk], cand[start:start + chunk]
        d = _sq_dist(qq[:, :, None, :], cc[:, None, :, :])  # (n, KNN_TILE, S)
        vals, order = torch.sort(d, dim=2, stable=True)
        order = order[..., :k]
        sq.append(torch.clamp(vals[..., :k], min=0.0))
        idx.append(torch.gather(gid[start:start + chunk].expand(-1, KNN_TILE, S), 2, order))
    return torch.cat(idx).reshape(-1, k), torch.cat(sq).reshape(-1, k)


def _check_radius(name, query, qmask, target, tmask, center, r2, lo, hi):
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    if center.shape != (3,) or center.dtype != torch.float32:
        raise ValueError(f"{name} center: expected (3,) float32")
    if r2.dtype != torch.float32 or r2.ndim != 1 or not lo <= r2.shape[0] <= hi:
        raise ValueError(f"{name}: expected a float32 vector of {lo} to {hi} squared "
                         f"radii, got {tuple(r2.shape)} {r2.dtype}")
    return _one_device(name, (query, qmask, target, tmask, center, r2))


def _pack_centered(query, qmask, target, tmask, center):
    """Both clouds minus `center`, packed [p, valid] with masked points
    parked at MASK_COORD: the plain versions' inputs (`radius_inputs`
    packs the kernels' the same way)."""
    return _pack_masked(query - center, qmask), _pack_masked(target - center, tmask)


class RadiusInputs(NamedTuple):
    """The radius kernels' inputs on the card: both clouds packed about the
    center ([p - center, valid], masked points parked at MASK_COORD; one
    tensor when the query cloud is the target cloud), the box of the valid
    targets of each 128-point tile (`radius_count`'s cull) and of each
    32-point chunk (`radius_window`'s)."""

    q4: torch.Tensor
    t4: torch.Tensor
    boxes: torch.Tensor
    chunk_boxes: torch.Tensor


def radius_inputs(query, qmask, target, tmask, center):
    """`RadiusInputs` of a pair of clouds for `radius_count` and
    `radius_window`, so that the two passes over them pack the clouds and
    build the target's tile and chunk boxes once.  None for CPU tensors (the plain
    versions pack their own and cull nothing)."""
    _check_cloud("query", query, qmask)
    _check_cloud("target", target, tmask)
    if center.shape != (3,) or center.dtype != torch.float32:
        raise ValueError("radius_inputs center: expected (3,) float32")
    dev = _one_device("radius_inputs", (query, qmask, target, tmask, center))
    if dev.type == "cpu":
        return None
    t4 = _pack_masked(target - center, tmask)
    q4 = t4 if query is target and qmask is tmask else _pack_masked(query - center, qmask)
    nt = t4.shape[0]
    boxes = torch.empty(6 * -(-nt // _RADIUS_TILE), dtype=torch.float32, device=dev)
    chunk_boxes = torch.empty(6 * -(-nt // _CHUNK), dtype=torch.float32, device=dev)
    fn = _build.function("fgt_radius_boxes", _BOXES_ARGS)
    _build.check("fgt_radius_boxes", fn(
        t4.data_ptr(), nt, boxes.data_ptr(), chunk_boxes.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream))
    return RadiusInputs(q4, t4, boxes, chunk_boxes)


def _radius_launch_inputs(name, query, qmask, target, tmask, center, inputs, dev):
    """`inputs`, checked against the clouds, or built here when None."""
    if inputs is None:
        return radius_inputs(query, qmask, target, tmask, center)
    if (inputs.q4.shape != (query.shape[0], 4) or inputs.t4.shape != (target.shape[0], 4)
            or inputs.boxes.device != dev or inputs.chunk_boxes.device != dev):
        raise ValueError(f"{name}: inputs are not radius_inputs of these clouds")
    return inputs


def radius_count(query, qmask, target, tmask, center, r2, inputs=None):
    """(L, Nq) f32: for each query, the number of targets with
    d^2 <= r2[l] for each of the L (<= 32) squared radii, both clouds
    taken about `center`.  Rows of masked queries carry no meaning.
    `inputs`: `radius_inputs` of these arguments, built here if None.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check_radius("radius_count", query, qmask, target, tmask, center, r2,
                        1, RADIUS_MAX_RUNGS)
    if dev.type == "cpu":
        tally.add(dev, "radius_count")
        return radius_count_plain(query, qmask, target, tmask, center, r2)
    q4, t4, boxes, _chunk_boxes = _radius_launch_inputs(
        "radius_count", query, qmask, target, tmask, center, inputs, dev)
    r2 = r2.contiguous()
    nq, nt, L = q4.shape[0], t4.shape[0], r2.shape[0]
    cnt = torch.empty((L, nq), dtype=torch.float32, device=dev)
    fn = _build.function("fgt_radius_count", _COUNT_ARGS)
    _build.check("fgt_radius_count", fn(
        q4.data_ptr(), t4.data_ptr(), boxes.data_ptr(), r2.data_ptr(), L, nq, nt,
        cnt.data_ptr(), tally.slot(dev, "radius_count"),
        torch.cuda.current_stream(dev).cuda_stream))
    radius_count.launches += 1
    return cnt


radius_count.launches = 0


def radius_count_plain(query, qmask, target, tmask, center, r2, chunk: int = 1024):
    """Plain PyTorch version of `radius_count`: dense (chunk, Nt) d^2
    tiles, one comparison per rung."""
    q4, t4 = _pack_centered(query, qmask, target, tmask, center)
    t = t4[None, :, :3]
    parts = []
    for start in range(0, q4.shape[0], chunk):
        d = _sq_dist(q4[start:start + chunk, None, :3], t)
        parts.append(torch.stack([(d <= r).sum(1) for r in r2]).to(torch.float32))
    return torch.cat(parts, dim=1)


def radius_window(query, qmask, target, tmask, center, r2q, inputs=None):
    """(16, Nq) f32 hard-window moment rows [n, sum y (3), sum y y^T (9,
    row-major), 0 (3)] over the targets with d^2 <= r2q[query], with
    y = target - center and both clouds taken about `center`; summed in
    f32.  Rows of masked queries carry no meaning.  `inputs` as for
    `radius_count`.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check_radius("radius_window", query, qmask, target, tmask, center, r2q,
                        query.shape[0], query.shape[0])
    if dev.type == "cpu":
        tally.add(dev, "radius_window")
        return radius_window_plain(query, qmask, target, tmask, center, r2q)
    q4, t4, _boxes, chunk_boxes = _radius_launch_inputs(
        "radius_window", query, qmask, target, tmask, center, inputs, dev)
    r2q = r2q.contiguous()
    nq, nt = q4.shape[0], t4.shape[0]
    out = torch.empty((16, nq), dtype=torch.float32, device=dev)
    fn = _build.function("fgt_radius_window", _WINDOW_ARGS)
    _build.check("fgt_radius_window", fn(
        q4.data_ptr(), t4.data_ptr(), chunk_boxes.data_ptr(), r2q.data_ptr(), nq, nt,
        out.data_ptr(), tally.slot(dev, "radius_window"),
        torch.cuda.current_stream(dev).cuda_stream))
    radius_window.launches += 1
    return out


radius_window.launches = 0


def radius_window_plain(query, qmask, target, tmask, center, r2q, chunk: int = 1024):
    """Plain PyTorch version of `radius_window`: dense (chunk, Nt) 0/1
    window weights times an (Nt, 10) moment feature matrix, in f32."""
    q4, t4 = _pack_centered(query, qmask, target, tmask, center)
    y = t4[:, :3] * t4[:, 3:]  # masked targets add nothing
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    feats = torch.stack([t4[:, 3], y0, y1, y2, y0 * y0, y0 * y1, y0 * y2,
                         y1 * y1, y1 * y2, y2 * y2], dim=1)
    t = t4[None, :, :3]
    parts = []
    for start in range(0, q4.shape[0], chunk):
        d = _sq_dist(q4[start:start + chunk, None, :3], t)
        w = (d <= r2q[start:start + chunk, None]).to(torch.float32)
        parts.append(w @ feats)
    m = torch.cat(parts).T  # (10, Nq)
    zero = torch.zeros_like(m[0])
    return torch.stack([m[0], m[1], m[2], m[3],
                        m[4], m[5], m[6], m[5], m[7], m[8], m[6], m[8], m[9],
                        zero, zero, zero])
