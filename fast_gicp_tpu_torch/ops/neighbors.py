"""Nearest-neighbour search (port of `fast_gicp_tpu.ops.neighbors`).

`nn_search` is the exact 1-NN of every query in a target cloud, the
reference's per-iteration `nearestKSearch(pt, 1, ...)` correspondence query
(fast_gicp_impl.hpp:136-139); it runs the `nn_search` kernel
(`ops/cuda_kernels.py`).  `select_candidate_tiles` ranks target tiles by
their bounding-box gap to each query tile, for the fused kNN moments.

Distances are always the squared-difference form ((q - t)^2 summed over
the axes), never |q|^2 - 2 q.t + |t|^2: the dot form loses its digits to
cancellation at metre-scale coordinates.  Masked target points are parked
at MASK_COORD, so they are never nearer than a valid point.
"""

from __future__ import annotations

import torch

from . import cuda_kernels

# Large finite coordinate for masked points: distances ~3.6e18, far below
# f32 overflow (3.4e38) even after squaring differences of 1e9.
MASK_COORD = cuda_kernels.MASK_COORD


def _masked_target(target, target_mask):
    return torch.where(target_mask[:, None], target,
                       torch.full_like(target, MASK_COORD))


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
