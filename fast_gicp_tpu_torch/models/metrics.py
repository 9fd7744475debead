"""Registration quality metrics (port of `fast_gicp_tpu.models.metrics`)."""

from __future__ import annotations

import math

import torch

from .. import device as _device
from .. import se3
from ..ops.neighbors import nn_search
from ..precision import f32_matmuls


@f32_matmuls
def fitness_score(T, source, source_mask, target, target_mask,
                  max_range: float = math.inf, device="cuda"):
    """PCL-style fitness: the mean squared 1-NN distance of the transformed
    source points within max_range (pcl::Registration::getFitnessScore, as
    the reference benchmarks use it, align.cpp:45, :101).  A 0-d tensor on
    `device` (CUDA unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    T = _device.as_f32(T, dev)
    source = _device.as_f32(source, dev)
    target = _device.as_f32(target, dev)
    source_mask = _device.as_bool(source_mask, dev)
    target_mask = _device.as_bool(target_mask, dev)
    p_t = se3.transform_points(T, source).contiguous()
    _, sq_dist = nn_search(p_t, target, target_mask, source_mask)
    ok = source_mask & (sq_dist <= max_range * max_range)
    n = torch.clamp(torch.sum(ok), min=1)
    return torch.sum(torch.where(ok, sq_dist, torch.zeros_like(sq_dist))) / n


def pose_error(gt, est):
    """(translation error, rotation error in rad) of `est` against `gt`:
    the reference test's metric delta = gt^-1 est (gicp_test.cpp:73-78)."""
    gt = torch.as_tensor(gt)
    est = torch.as_tensor(est, dtype=gt.dtype, device=gt.device)
    delta = torch.linalg.inv(gt) @ est
    return torch.linalg.vector_norm(delta[:3, 3]), se3.rotation_angle(delta[:3, :3])
