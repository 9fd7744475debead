"""Synthetic LiDAR drive generation for benchmarks and tests.

No KITTI data ships in this environment (and none exists in the reference
repo either — its KITTI runner expects a user-supplied velodyne directory,
kitti.cpp:71-79), so odometry throughput/accuracy claims are pinned on
synthetic drives with REALISTIC inter-frame motion: a 10 Hz sensor moving
at ~10 m/s around a closed circuit turns ~0.7 deg/frame — far gentler
than toy loops with tens of degrees per frame, and representative of the
KITTI sequences the reference demos (README.md:139-155).

The world is a structured scene (ground plane, building walls, pillars)
sampled densely enough that a 55 m-range scan sees 20-60k points before
downsampling, like a 64-beam LiDAR.
"""

from __future__ import annotations

import numpy as np


def drive_world(rng, half_extent: float = 140.0, n: int = 1_400_000):
    """Structured world covering a [-e, e]^2 area: ground + ring road
    walls + pillar clusters (the geometry VGICP needs to constrain all six
    degrees of freedom).  The default extent EXCEEDS the default drive's
    sensing reach (radius 80 + range 55 = 135): a sensor seeing past the
    world edge gets a void sector whose degenerate geometry is a
    generator artifact, not a property of real scenes."""
    e = half_extent
    ground = np.stack(
        [
            rng.uniform(-e, e, n // 2),
            rng.uniform(-e, e, n // 2),
            0.05 * rng.standard_normal(n // 2),
        ],
        axis=1,
    )
    # four building walls at varying radii/orientations
    walls = []
    for (wx, wy, along_x) in [(-70, 40, True), (55, -35, False),
                              (20, 75, True), (-45, -60, False)]:
        m = n // 12
        u = rng.uniform(-35, 35, m)
        if along_x:
            w = np.stack([wx + u, np.full(m, float(wy))
                          + 0.05 * rng.standard_normal(m),
                          rng.uniform(0, 6, m)], axis=1)
        else:
            w = np.stack([np.full(m, float(wx))
                          + 0.05 * rng.standard_normal(m),
                          wy + u, rng.uniform(0, 6, m)], axis=1)
        walls.append(w)
    n_pil = 100
    pillars = np.stack(
        [
            np.repeat(rng.uniform(-e, e, n_pil), n // (12 * n_pil)),
            np.repeat(rng.uniform(-e, e, n_pil), n // (12 * n_pil)),
            rng.uniform(0, 4, (n // (12 * n_pil)) * n_pil),
        ],
        axis=1,
    )
    # ring-road building fronts: arc wall segments flanking the default
    # drive circle (radius 80), so the sensor always has vertical structure
    # nearby — like buildings lining a street
    arcs = []
    for (r_arc, th0, th1) in [(62, 0.2, 1.3), (98, 1.0, 2.2), (60, 2.4, 3.6),
                              (100, 3.2, 4.4), (63, 4.6, 5.8), (97, 5.4, 6.2)]:
        m = n // 48
        th = rng.uniform(th0, th1, m)
        rr = r_arc + 0.05 * rng.standard_normal(m)
        arcs.append(np.stack(
            [rr * np.cos(th), rr * np.sin(th), rng.uniform(0, 5, m)], axis=1
        ))
    return np.concatenate([ground, *walls, pillars, *arcs]).astype(np.float32)


def drive_scans(
    rng,
    n_frames: int = 512,
    radius: float = 80.0,
    speed: float = 1.0,
    accel_frames: int = 8,
    sensor_range: float = 55.0,
    view_fraction: float = 0.35,
    noise: float = 0.01,
    world: np.ndarray | None = None,
):
    """Circuit drive: scans along a circle of `radius`, cruising at
    `speed` meters/frame after accelerating from REST over the first
    `accel_frames` frames (drives start stationary — this also gives the
    odometry a trackable bootstrap, like any real sequence).

    At the defaults the cruise motion is ~1 m and ~0.7 deg of yaw per
    frame (a 10 Hz sensor at ~10 m/s); 512 frames cover a bit over one
    full revolution, so the end revisits the start — scan-to-scan drift
    shows up as end-point error while scan-to-map re-anchors.

    Returns (scans, gt_poses); scans are sensor-frame (N, 3) float32 with
    per-frame dropout and Gaussian noise, gt_poses world-frame 4x4.
    Motion per frame is INDEPENDENT of n_frames (fewer frames = shorter
    drive, not faster motion).
    """
    if world is None:
        world = drive_world(rng)
    scans, poses = [], []
    arc = 0.0
    for i in range(n_frames):
        th = arc / radius
        # pose on the circle, heading along the tangent
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:3, :3] = np.asarray(
            [[-s, -c, 0.0], [c, -s, 0.0], [0.0, 0.0, 1.0]]
        )
        T[:3, 3] = [radius * c, radius * s, 1.8]
        poses.append(T)
        local = (world - T[:3, 3]) @ T[:3, :3]
        r = np.linalg.norm(local, axis=1)
        # Range-dependent density like a real spinning LiDAR (~1/r^2 point
        # density on surfaces): a HARD range sphere would truncate boundary
        # voxels and bias their means toward the sensor — measured as a
        # systematic ~4 cm/frame forward bias in scan-to-scan VGICP on
        # hard-clipped synthetic scans, an artifact real scans don't have.
        p_keep = view_fraction * np.minimum(
            1.0, (20.0 / np.maximum(r, 20.0)) ** 2
        )
        sel = (r < sensor_range) & (rng.random(len(local)) < p_keep)
        scans.append(
            (local[sel] + noise * rng.standard_normal((int(sel.sum()), 3))
             ).astype(np.float32)
        )
        arc += speed * min(1.0, (i + 1) / max(accel_frames, 1))
    # Normalize so gt[0] == I, matching odometry conventions (pose chains
    # start at identity; ate_rmse compares absolute trajectories).
    inv0 = np.linalg.inv(poses[0])
    poses = [inv0 @ T for T in poses]
    return scans, poses
