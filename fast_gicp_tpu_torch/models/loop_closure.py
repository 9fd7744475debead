"""Loop-closure detection for the SLAM back-end (port of
`fast_gicp_tpu.models.loop_closure`).

Candidates come from the odometry trajectory (revisit proximity with a
temporal guard, host numpy); each is verified by coarse-to-fine
registration on the card (NDT D2D at 4 m for the drifted guess, on the
hash voxel map that `ndt_align` builds without `grid_dims`: an eager freeze
and the pack-form linearize; then a VGICP refine at 1 m) and a fitness
gate.  Accepted closures carry the
refine solve's world-frame Hessian as the edge information, ready for
`optimize_pose_graph[_sparse]`.  The host reads what the JAX package reads:
the fitness and the refine's converged flag.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import device as _device


class LoopClosureConfig(NamedTuple):
    # candidate generation
    min_gap: int = 10          # frames between i and j (skip odometry edges)
    radius: float = 3.0        # m between poses to call it a revisit
    max_candidates: int = 8    # verify at most this many (nearest first)
    # geometric verification
    downsample: float = 0.25
    coarse_resolution: float = 4.0   # NDT D2D basin for drifted guesses
    refine_resolution: float = 1.0   # VGICP refine
    fitness_max: float = 0.5         # m^2 mean-NN-sq gate on the refined pose


class LoopClosure(NamedTuple):
    i: int
    j: int
    relative: np.ndarray     # 4x4, T_i^-1 T_j as measured by registration
    information: np.ndarray  # 6x6 (the refine solve's final Hessian)
    fitness: float


def find_loop_candidates(poses, config: LoopClosureConfig = LoopClosureConfig()):
    """Revisit candidates (i, j), i < j, from pose proximity: for each j its
    nearest admissible i (j - i > min_gap), within `radius`, nearest first,
    at most `max_candidates`.  Host O(K^2) over keyframe translations."""
    t = np.stack([np.asarray(p)[:3, 3] for p in poses])
    cands = []
    for j in range(len(t)):
        lo = j - config.min_gap
        if lo <= 0:
            continue
        d = np.linalg.norm(t[:lo] - t[j], axis=1)
        i = int(np.argmin(d))
        if d[i] < config.radius:
            cands.append((float(d[i]), i, j))
    cands.sort()
    return [(i, j) for _, i, j in cands[: config.max_candidates]]


def verify_closure(scan_i, scan_j, guess, config: LoopClosureConfig = LoopClosureConfig(),
                   device="cuda"):
    """Geometric verification: register scan_j against scan_i coarse to
    fine from the (drifted) odometry guess, on `device` (CUDA unless the
    caller asks for the CPU).  Returns (relative (4, 4), information
    (6, 6), fitness, ok)."""
    from ..models.metrics import fitness_score
    from ..models.ndt import NDTConfig, ndt_align
    from ..models.vgicp import VGICPConfig, vgicp_register
    from ..ops.voxelmap import auto_grid_dims
    from ..utils.downsample import voxel_downsample
    from ..utils.padding import pad_points

    dev = _device.resolve(device)
    ci = voxel_downsample(scan_i, config.downsample)
    cj = voxel_downsample(scan_j, config.downsample)
    sp, sm = (_device.upload(a, dev) for a in pad_points(cj))
    tp, tm = (_device.upload(a, dev) for a in pad_points(ci))
    g = _device.upload(np.asarray(guess, np.float32), dev)
    coarse = ndt_align(sp, sm, tp, tm, g, NDTConfig(resolution=config.coarse_resolution),
                       device=dev)
    refined = vgicp_register(
        sp, sm, tp, tm, coarse.transformation,
        VGICPConfig(resolution=config.refine_resolution,
                    grid_dims=auto_grid_dims(ci, config.refine_resolution)),
        device=dev,
    )
    fit = float(fitness_score(refined.transformation, sp, sm, tp, tm, device=dev))
    ok = bool(refined.converged) and fit <= config.fitness_max
    return (
        refined.transformation.cpu().numpy().astype(np.float32),
        refined.hessian.cpu().numpy().astype(np.float32),
        fit,
        ok,
    )


def detect_loop_closures(scans, poses, config: LoopClosureConfig = LoopClosureConfig(),
                         device="cuda"):
    """Find and verify: candidates from the trajectory, verification by
    registration on `device`.  Returns the accepted `LoopClosure`s (possibly
    none)."""
    dev = _device.resolve(device)
    closures = []
    for i, j in find_loop_candidates(poses, config):
        guess = np.linalg.inv(np.asarray(poses[i])) @ np.asarray(poses[j])
        rel, info, fit, ok = verify_closure(scans[i], scans[j], guess.astype(np.float32),
                                            config, device=dev)
        if ok:
            closures.append(LoopClosure(i=i, j=j, relative=rel, information=info,
                                        fitness=fit))
    return closures
