"""Nearest-neighbour search (port of `fast_gicp_tpu.ops.neighbors`).

`nn_search` is the exact 1-NN of every query in a target cloud, the
reference's per-iteration `nearestKSearch(pt, 1, ...)` correspondence query
(fast_gicp_impl.hpp:136-139); it runs the `nn_search` kernel
(`ops/cuda_kernels.py`).  `select_candidate_tiles` ranks target tiles by
their bounding-box gap to each query tile, for the fused kNN moments and
the culled k-NN search.  `knn_search_culled` (each 256-query tile searches
its 16 nearest 256-point target tiles, with a per-query exactness
certificate) and `knn_search` (exact: every target tile a candidate) run
the `knn_slab` kernel, the covariance-estimation kNN of the reference
(fast_gicp_impl.hpp:257).

Distances are always the squared-difference form ((q - t)^2 summed over
the axes), never |q|^2 - 2 q.t + |t|^2: the dot form loses its digits to
cancellation at metre-scale coordinates.  Masked target points are parked
at MASK_COORD, so they are never nearer than a valid point.
"""

from __future__ import annotations

import torch

from .. import device as _device
from . import cuda_kernels

# Large finite coordinate for masked points: distances ~3.6e18, far below
# f32 overflow (3.4e38) even after squaring differences of 1e9.
MASK_COORD = cuda_kernels.MASK_COORD


def _masked_target(target, target_mask):
    return torch.where(target_mask[:, None], target,
                       torch.full_like(target, MASK_COORD))


def masked_mean(points, mask):
    """Mean of the valid rows of (N, 3) points (zeros if none)."""
    valid = mask.to(points.dtype)
    return torch.sum(points * valid[:, None], dim=0) / torch.clamp(
        torch.sum(valid), min=1.0
    )


def _center_clouds(query, target, target_mask):
    """Both clouds minus the target's valid mean.  Distances are
    translation-invariant; masked target points are parked at MASK_COORD
    after the shift (1e9 dwarfs any real offset)."""
    c = masked_mean(target, target_mask)
    return query - c, target - c


def nn_search(query, target, target_mask, query_mask=None):
    """1-NN of each (Nq, 3) query point in the (Nt, 3) target: returns
    (idx int32 (Nq,), sq_dist f32 (Nq,)); ties go to the lowest target
    index.  Query rows may be padding: their results are finite and carry
    no meaning; naming them in the optional `query_mask` keeps them out of
    the kernel's culling bounds."""
    return cuda_kernels.nn_search(query, target, target_mask, query_mask)


def select_candidate_tiles(qt, tt, C: int):
    """Per query tile, the C target tiles with the smallest bbox gap.

    qt (Q, tile, 3) raw query tiles; tt (T, tile, 3) masked target tiles
    (masked points parked at MASK_COORD).  Returns (cidx (Q, C) int32,
    excluded_sq (Q,) f32: the squared bbox gap of the nearest EXCLUDED
    tile, inf when C >= T).

    Many tile pairs have a gap of exactly 0.  `jax.lax.top_k` breaks ties
    toward the lower tile index; a stable sort does the same on every
    device, so both packages and both devices choose the same tiles."""
    Q, T = qt.shape[0], tt.shape[0]
    gap_sq = torch.zeros((Q, T), dtype=qt.dtype, device=qt.device)
    for a in range(3):
        q_a, t_a = qt[..., a], tt[..., a]
        gap = torch.clamp(
            torch.maximum(q_a.amin(1)[:, None] - t_a.amax(1)[None, :],
                          t_a.amin(1)[None, :] - q_a.amax(1)[:, None]),
            min=0.0,
        )
        gap_sq = gap_sq + gap * gap
    if C < T:
        vals, order = torch.sort(gap_sq, dim=1, stable=True)
        return order[:, :C].to(torch.int32).contiguous(), vals[:, C].contiguous()
    cidx = torch.arange(T, dtype=torch.int32, device=qt.device).expand(Q, T)
    return cidx.contiguous(), torch.full((Q,), float("inf"), dtype=qt.dtype,
                                         device=qt.device)


_SLAB_TILE = cuda_kernels.KNN_TILE  # query and candidate tile of the culled search
_SLAB_CANDIDATES = 16  # candidate tiles per query tile


def knn_search_culled(query, target, target_mask, k: int = 20, device="cuda"):
    """Tile-culled k-NN: each 256-query tile searches only the 16 256-point
    target tiles with the smallest bounding-box gap (all of them when the
    target has fewer), both clouds shifted by the target's valid mean.

    Returns (idx (Nq, k) int32 global target ids, sq (Nq, k) f32 squared
    distances ascending, certified (Nq,) bool).  certified[i] means the
    k-th distance of query i is <= the squared bbox gap of its tile's
    nearest excluded target tile, so no excluded tile can hold a nearer
    point and the list is the exact k-NN (ties to the lower slab position,
    slabs ordered by gap rank).  Needs Nq and Nt multiples of 256 and
    k <= 32.  Runs on `device` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    query, target = _device.as_f32(query, dev), _device.as_f32(target, dev)
    target_mask = _device.as_bool(target_mask, dev)
    nq, nt = query.shape[0], target.shape[0]
    if nq % _SLAB_TILE or nt % _SLAB_TILE:
        raise ValueError(f"cloud sizes ({nq}, {nt}) not {_SLAB_TILE}-multiples")
    Q, T = nq // _SLAB_TILE, nt // _SLAB_TILE
    query, target = _center_clouds(query, target, target_mask)
    cidx, excluded_sq = select_candidate_tiles(
        query.reshape(Q, _SLAB_TILE, 3),
        _masked_target(target, target_mask).reshape(T, _SLAB_TILE, 3),
        min(_SLAB_CANDIDATES, T),
    )
    ones = torch.ones(nq, dtype=torch.bool, device=dev)
    idx, sq = cuda_kernels.knn_slab(query, ones, target, target_mask, cidx, k,
                                    cand_tile=_SLAB_TILE)
    certified = sq[:, k - 1].reshape(Q, _SLAB_TILE) <= excluded_sq[:, None]
    return idx, sq, certified.reshape(nq)


_EXACT_TILE = 128  # candidate tile of the exact search (padding granularity)


def knn_search(query, target, target_mask, k: int = 20, approx: bool = False,
               device="cuda"):
    """Exact k-NN of each (Nq, 3) query in the (Nt, 3) target, both shifted
    by the target's valid mean: (idx (Nq, k) int32, sq (Nq, k) f32
    ascending), ties to the lower target index (as `lax.top_k` breaks
    them).  Masked targets are parked at MASK_COORD and fill a list only
    when fewer than k targets are valid.

    The `knn_slab` kernel with every target tile a candidate; queries are
    padded to a multiple of 256 and targets to a multiple of 128 inside.
    `approx` is accepted for the JAX signature and changes nothing: the
    JAX package's `approx_max_k` is exact off the TPU too.  Needs
    k <= min(32, Nt).  Runs on `device` (CUDA unless the caller asks for
    the CPU)."""
    del approx
    dev = _device.resolve(device)
    query, target = _device.as_f32(query, dev), _device.as_f32(target, dev)
    target_mask = _device.as_bool(target_mask, dev)
    nq, nt = query.shape[0], target.shape[0]
    if not 1 <= k <= nt:
        raise ValueError(f"knn_search: k={k} outside [1, {nt}]")
    query, target = _center_clouds(query, target, target_mask)
    qpad, tpad = -nq % _SLAB_TILE, -nt % _EXACT_TILE
    query = torch.cat([query, query.new_zeros((qpad, 3))])
    qmask = torch.arange(nq + qpad, device=dev) < nq
    target = torch.cat([target, target.new_zeros((tpad, 3))])
    target_mask = torch.cat([target_mask, target_mask.new_zeros(tpad)])
    Q, T = (nq + qpad) // _SLAB_TILE, (nt + tpad) // _EXACT_TILE
    cidx = torch.arange(T, dtype=torch.int32, device=dev).expand(Q, T).contiguous()
    idx, sq = cuda_kernels.knn_slab(query, qmask, target, target_mask, cidx, k,
                                    cand_tile=_EXACT_TILE)
    return idx[:nq], sq[:nq]
