"""KITTI-style odometry loops and trajectory metrics (port of
`fast_gicp_tpu.utils.kitti`).

Scan-to-scan odometry, each function returning the absolute 4x4 poses (pose[0] = I):
  * `run_odometry`: the reference's loop (src/kitti.cpp:71-156): per frame
    downsample -> set_input_source -> align -> swap_source_and_target (the
    source's covariances become the next target's), over any of the port's
    `Registration` classes; one host read a frame (the class API's result);
  * `run_odometry_batched`: every scan's covariances once, then B pairs at a
    time through `models.batch.vgicp_align_batch`, the unconverged pairs
    re-solved alone;
  * `run_odometry_stream`: every frame's align enqueued with the previous
    delta on the device as its guess (constant-velocity warm start), one
    read at the end; optionally the downsample on the device too;
  * `run_odometry_scan`: the whole sequence from one ragged upload (int16 by
    default), each frame's covariances, target map and LM solve on the
    device in turn; the JAX package rolls this into one `lax.scan`
    program, and its one-program form here (a CUDA graph) waits for the
    device-resident LM loop.
Besides each solve's one flag read a trial, the device-chained ones read
nothing until their end.  Each runs on `device` (CUDA unless the
caller asks for the CPU).  The metrics are the JAX package's numpy code,
kept here as the port's own copy.
"""

from __future__ import annotations

import glob
import os
import time
import warnings
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from .. import device as _device
from .. import graphs
from ..precision import f32_matmuls
from .downsample import voxel_downsample
from .io import load_kitti_bin
from .padding import bucket_size, pad_points


def run_odometry(
    scans: Iterable[np.ndarray],
    reg,
    downsample_resolution: float = 0.25,
    progress: Optional[Callable[[int, np.ndarray, float], None]] = None,
) -> List[np.ndarray]:
    """Scan-to-scan odometry over (N, 3) scans with a `Registration`
    instance (its own device).  `progress(i, pose, fps)` is called a frame
    with a 30-frame sliding-window FPS (kitti.cpp:112-132)."""
    poses: List[np.ndarray] = []
    stamps: List[float] = []
    for i, raw in enumerate(scans):
        pts = voxel_downsample(raw, downsample_resolution)
        if i == 0:
            reg.set_input_target(pts)
            poses.append(np.eye(4))
            continue
        reg.set_input_source(pts)
        delta = reg.align()
        reg.swap_source_and_target()
        poses.append(poses[-1] @ delta)
        stamps.append(time.perf_counter())
        if progress is not None:
            window = stamps[-30:]
            fps = (len(window) - 1) / max(window[-1] - window[0], 1e-9)
            progress(i, poses[-1], fps)
    return poses


def _cov_fn(covariance: str):
    from ..ops.covariance import knn_covariance_cols, rbf_covariance_cols

    if covariance == "rbf":
        return rbf_covariance_cols
    if covariance == "knn":
        return knn_covariance_cols
    raise ValueError(f"unknown covariance estimator: {covariance}")


def _chain(deltas) -> List[np.ndarray]:
    poses = [np.eye(4)]
    for d in deltas:
        poses.append(poses[-1] @ np.asarray(d, np.float64))
    return poses


def run_odometry_batched(
    scans: Iterable[np.ndarray],
    downsample_resolution: float = 0.25,
    batch_size: int = 16,
    covariance: str = "rbf",
    config=None,
    rescue: bool = True,
    device="cuda",
) -> List[np.ndarray]:
    """Throughput-mode scan-to-scan odometry: batched VGICP over pairs.

    Each scan's covariances are estimated once (it is the source of pair i
    and the target of pair i + 1), then windows of `batch_size` pairs go
    through `vgicp_align_batch` from identity, the deltas staying on the
    device; poses are chained on the host at the end.  The default config
    caps the solve at 24 iterations (no warm start); a pair still
    unconverged there is re-solved alone with 4x the budget, warm-started
    from its capped pose (`rescue=False` disables), its flag read with the
    transforms.  Runs on `device`."""
    from ..models.batch import vgicp_align_batch
    from ..models.vgicp import VGICPConfig, vgicp_align
    from ..solver import LsqConfig

    dev = _device.resolve(device)
    config = config or VGICPConfig(lsq=LsqConfig(max_iterations=24))
    cov_fn = _cov_fn(covariance)
    clouds = [voxel_downsample(s, downsample_resolution) for s in scans]
    if len(clouds) < 2:
        return [np.eye(4)] * len(clouds)
    bucket = max(bucket_size(len(c)) for c in clouds)

    def frame(i):
        p, m = pad_points(clouds[i], bucket)
        p, m = _device.upload(p, dev), _device.upload(m, dev)
        return p, m, cov_fn(p, m)

    n_pairs = len(clouds) - 1
    eye = torch.eye(4, dtype=torch.float32, device=dev).expand(batch_size, 4, 4)
    pending = []  # (transforms, converged) a window
    for s in range(0, n_pairs, batch_size):
        # frames s .. s + b: b pairs (no padding to a compiled batch shape)
        b = min(s + batch_size, n_pairs) - s
        pts, msk, cw = (torch.stack(f) for f in zip(*(frame(i) for i in range(s, s + b + 1))))
        res = vgicp_align_batch(pts[1:], msk[1:], cw[1:], pts[:-1], msk[:-1], cw[:-1],
                                eye[:b], config, device=dev)
        pending.append((res.transformation, res.converged))
    deltas = torch.cat([t for t, _c in pending]).cpu().numpy()
    conv = torch.cat([c for _t, c in pending]).cpu().numpy()
    if rescue and not conv.all():
        rescue_cfg = config._replace(
            lsq=config.lsq._replace(max_iterations=4 * config.lsq.max_iterations))
        for i in np.flatnonzero(~conv):
            sp, sm, sc = frame(i + 1)
            tp, tm, tc = frame(i)
            r = vgicp_align(sp, sm, sc, tp, tm, tc, deltas[i], rescue_cfg, device=dev)
            deltas[i] = r.transformation.cpu().numpy()
    return _chain(deltas)


def run_odometry_stream(
    scans: Iterable[np.ndarray],
    downsample_resolution: float = 0.25,
    covariance: str = "rbf",
    config=None,
    warm_start: bool = True,
    on_device_downsample: bool | None = None,
    device="cuda",
) -> List[np.ndarray]:
    """Device-chained scan-to-scan odometry: every frame's `vgicp_align` is
    enqueued with the previous frame's delta (on the device) as its guess;
    the deltas are read once at the end.

    on_device_downsample=True runs the voxel downsample on the device
    (`voxelmap.device_downsample` on a dense grid over the union of every
    raw scan's extent; raises if the scene does not fit one); False / None
    downsamples on the host.  Runs on `device`."""
    from ..models.vgicp import VGICPConfig, vgicp_align
    from ..ops.voxelmap import auto_grid_dims_multi, device_downsample

    dev = _device.resolve(device)
    config = config or VGICPConfig()
    cov_fn = _cov_fn(covariance)
    live_counts, out_counts, out_cap = [], [], None
    if on_device_downsample:
        scans = list(scans)  # the grid and buckets are sized over every raw scan
        if len(scans) < 2:
            return [np.eye(4)] * len(scans)
        ds_dims = auto_grid_dims_multi(scans, downsample_resolution)
        if ds_dims is None:
            raise ValueError("on_device_downsample=True but the scene extent / resolution "
                             "does not fit a dense grid; use the host downsample")
        raw_bucket = max(bucket_size(len(s)) for s in scans)
        # the compacted cloud's bucket from three sampled frames, +15%
        out_cap = bucket_size(max(len(voxel_downsample(s, downsample_resolution))
                                  for s in (scans[0], scans[len(scans) // 2], scans[-1]))
                              * 115 // 100)

        def frames():
            for scan in scans:
                p, m = pad_points(scan, raw_bucket)
                pts, msk, n_live, n_out = device_downsample(
                    _device.upload(p, dev), _device.upload(m, dev), downsample_resolution,
                    out_cap, ds_dims)
                live_counts.append(n_live)
                out_counts.append(n_out)
                yield pts, msk
    else:
        clouds = [voxel_downsample(s, downsample_resolution) for s in scans]
        if len(clouds) < 2:
            return [np.eye(4)] * len(clouds)
        bucket = max(bucket_size(len(c)) for c in clouds)

        def frames():
            for cloud in clouds:
                p, m = pad_points(cloud, bucket)
                yield _device.upload(p, dev), _device.upload(m, dev)

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    delta, prev, deltas = eye, None, []
    for p, m in frames():
        c = cov_fn(p, m)
        if prev is not None:
            delta = vgicp_align(p, m, c, *prev, delta if warm_start else eye, config,
                                device=dev).transformation
            deltas.append(delta)
        prev = (p, m, c)
    poses = _chain(torch.stack(deltas).cpu().numpy())  # the one read
    if live_counts:
        overflow = int(torch.stack(live_counts).max())
        if overflow > out_cap:
            warnings.warn(f"device downsample overflowed its {out_cap}-voxel bucket (max "
                          f"{overflow} occupied voxels); tail voxels were dropped")
        dropped = int(torch.stack(out_counts).max())
        if dropped:
            warnings.warn(f"device downsample dropped up to {dropped} points/frame outside "
                          f"the static grid; size the grid over more frames or use the host "
                          f"downsample")
    return poses


def quantize_frames(clouds, upload_dtype: str = "int16"):
    """The ragged upload of `run_odometry_scan`: one (S_pad, 3) concatenation
    of the frames' real points (no pad rows, no mask), their (F,) int32
    starts and counts, the dequantizing scale and the shared bucket.

    "int16": coordinates quantized to one sequence-wide scale, absmax /
    32000 (rint, ties to even, `native.quantize_i16`), about 2 mm on a
    +-60 m LiDAR sequence; "float32": raw.  S_pad leaves the last frame's
    (bucket, 3) slice in bounds, rounded up to a bucket multiple.  Returns
    (flat, starts, counts, scale or None, bucket), numpy."""
    from .. import native

    if upload_dtype not in ("int16", "float32"):
        raise ValueError("upload_dtype must be 'int16' or 'float32'")
    bucket = max(bucket_size(len(c)) for c in clouds)
    counts = np.asarray([len(c) for c in clouds], np.int32)
    starts = np.concatenate([np.zeros(1, np.int64),
                             np.cumsum(counts.astype(np.int64))[:-1]]).astype(np.int32)
    s_pad = bucket_size(int(counts.astype(np.int64).sum()) + bucket)
    if upload_dtype == "float32":
        flat = np.zeros((s_pad, 3), np.float32)
        for c, s in zip(clouds, starts):
            flat[s: s + len(c)] = c[:, :3]
        return flat, starts, counts, None, bucket
    c32 = [np.ascontiguousarray(c[:, :3], np.float32) for c in clouds]
    amax = max((native.absmax(c) for c in c32), default=0.0) or 1.0
    scale = amax / 32000.0
    flat = np.zeros((s_pad, 3), np.int16)
    for c, s in zip(c32, starts):
        native.quantize_i16(c, 1.0 / scale, flat[s: s + len(c)])
    return flat, starts, counts, scale, bucket


@f32_matmuls
def _scan_deltas(flat, starts, counts, scale, bucket, config, warm_start, device_loop=True):
    """The frames of a ragged upload on the device, each (bucket, 3) slice
    dequantized and masked by its count, its RBF covariances, the previous
    frame's target map, the objective and the LM solve in turn (the JAX
    package's `lax.scan` body, world frame, no re-centring).  Returns the
    (F - 1, 4, 4) deltas on the device.

    With `device_loop` the frame body is one program: captured once as a
    CUDA graph (`graphs.DeviceGraph`) on static buffers -- the frame's raw
    slice and count, the previous frame's points, mask and covariances and
    the warm start -- and replayed for each frame, the slice copied in on
    the device; on the CPU the same body in the device form's plain
    version.  Without it, the eager loop (one flag read a trial)."""
    from ..models.vgicp import _build_target_map, make_vgicp_objective
    from ..ops.covariance import rbf_covariance_cols
    from ..ops.voxelmap import neighbor_offsets
    from ..solver import lsq_solve

    dev = flat.device
    lane = torch.arange(bucket, device=dev)
    offsets = neighbor_offsets(config.neighbor_search_method, config.neighbor_search_radius)

    def dequantized(raw, count):
        p = raw.to(torch.float32)
        if scale is not None:
            p = p * scale
        m = lane < count
        # the slice reads into the next frame: zero the rows past the count
        return p * m[:, None].to(p.dtype), m

    def get_frame(start, count):
        return dequantized(flat[start: start + bucket], count)

    def step(p, m, c, prev_p, prev_m, prev_c, delta):
        vm = _build_target_map(prev_p, prev_m, prev_c, config)
        linearize, error, _freeze, _lf = make_vgicp_objective(p, m, c, vm, offsets, config)
        return lsq_solve(linearize, error, delta if warm_start else eye,
                         config.lsq).transformation

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    delta = eye
    prev_p, prev_m = get_frame(int(starts[0]), int(counts[0]))
    prev_c = rbf_covariance_cols(prev_p, prev_m)
    if not device_loop:
        deltas = []
        for start, count in zip(starts[1:], counts[1:]):
            p, m = get_frame(int(start), int(count))
            c = rbf_covariance_cols(p, m)
            delta = step(p, m, c, prev_p, prev_m, prev_c, delta)
            deltas.append(delta)
            prev_p, prev_m, prev_c = p, m, c
        return torch.stack(deltas)

    raw = flat[:bucket].clone()
    count = torch.zeros((), dtype=torch.int32, device=dev)
    warm = eye.clone()

    def frame():
        p, m = dequantized(raw, count)
        c = rbf_covariance_cols(p, m)
        warm.copy_(step(p, m, c, prev_p, prev_m, prev_c, warm))
        prev_p.copy_(p)
        prev_m.copy_(m)
        prev_c.copy_(c)
        return warm

    deltas = torch.empty((len(starts) - 1, 4, 4), dtype=torch.float32, device=dev)
    graph = None
    for k, (start, n) in enumerate(zip(starts[1:], counts[1:])):
        if graph is None:
            # the warm-up writes the carried buffers: build it on copies of
            # frame 0's and put them back before the first replay
            saved = [t.clone() for t in (prev_p, prev_m, prev_c)]
            raw.copy_(flat[int(start): int(start) + bucket])
            count.fill_(int(n))
            graph = graphs.DeviceGraph(frame, dev)
            for t, s in zip((prev_p, prev_m, prev_c), saved):
                t.copy_(s)
            warm.copy_(eye)
        raw.copy_(flat[int(start): int(start) + bucket])
        count.fill_(int(n))
        deltas[k].copy_(graph.replay())
    return deltas


def run_odometry_scan(
    scans: Iterable[np.ndarray],
    downsample_resolution: float = 0.25,
    config=None,
    warm_start: bool = True,
    upload_dtype: str = "int16",
    device="cuda",
    device_loop: bool = True,
) -> List[np.ndarray]:
    """Whole-sequence odometry from one ragged upload (`quantize_frames`):
    the host uploads the frames once and reads every delta back at once;
    on the device each frame's RBF covariances, the previous frame's target
    map and the LM solve run in turn, the constant-velocity warm start
    carried on the device.  With `device_loop` (the default) the frame body
    is one captured CUDA graph replayed a frame, its LM loop on the device
    (the JAX package's one `lax.scan` program; `_scan_deltas`); False runs
    it as eager ops.  With config.grid_dims None the dense grid is
    sized over the union of every frame's extent (`auto_grid_dims_multi`;
    the hash map where it does not fit).  Runs on `device`."""
    from ..models.vgicp import VGICPConfig
    from ..ops.voxelmap import auto_grid_dims_multi

    dev = _device.resolve(device)
    config = config or VGICPConfig()
    clouds = [voxel_downsample(s, downsample_resolution) for s in scans]
    if len(clouds) < 2:
        return [np.eye(4)] * len(clouds)
    if config.grid_dims is None:
        config = config._replace(grid_dims=auto_grid_dims_multi(clouds, config.resolution))
    flat, starts, counts, scale, bucket = quantize_frames(clouds, upload_dtype)
    scale_dev = (None if scale is None
                 else torch.full((), scale, dtype=torch.float32, device=dev))
    deltas = _scan_deltas(_device.upload(flat, dev), starts, counts, scale_dev, bucket, config,
                          warm_start, device_loop)
    return _chain(deltas.cpu().numpy())


def kitti_scan_paths(directory: str, limit: Optional[int] = None):
    """Sorted %06d.bin scan paths under a KITTI velodyne directory."""
    return sorted(glob.glob(os.path.join(directory, "*.bin")))[:limit]


def run_kitti_odometry(
    directory: str,
    reg,
    downsample_resolution: float = 0.25,
    limit: Optional[int] = None,
    progress=None,
) -> List[np.ndarray]:
    """`run_odometry` over the .bin scans of a KITTI velodyne directory."""
    scans = (load_kitti_bin(p) for p in kitti_scan_paths(directory, limit))
    return run_odometry(scans, reg, downsample_resolution, progress)


def save_poses_kitti(path: str, poses: List[np.ndarray]) -> None:
    """Write poses as 3x4 row-major lines (kitti.cpp:141-153 format)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9g}" for v in np.asarray(T)[:3].ravel()))
            f.write("\n")


def ate_rmse(gt_poses: List[np.ndarray], est_poses: List[np.ndarray]) -> float:
    """Absolute trajectory error (RMSE of translation), compared directly
    (both trajectories start at I)."""
    gt = np.asarray([T[:3, 3] for T in gt_poses])
    est = np.asarray([T[:3, 3] for T in est_poses])
    n = min(len(gt), len(est))
    return float(np.sqrt(np.mean(np.sum((gt[:n] - est[:n]) ** 2, axis=1))))


def load_poses_kitti(path: str) -> List[np.ndarray]:
    """Read KITTI 3x4 row-major pose lines as 4x4 matrices."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return [np.vstack([r, [0.0, 0.0, 0.0, 1.0]]).astype(np.float64) for r in rows]


def align_trajectories(gt_poses, est_poses):
    """Best rigid SE(3) alignment (Umeyama without scale) of the estimated
    translations onto ground truth: (R, t) with gt_i ~= R est_i + t."""
    gt = np.asarray([T[:3, 3] for T in gt_poses], np.float64)
    est = np.asarray([T[:3, 3] for T in est_poses], np.float64)
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    mu_g, mu_e = gt.mean(0), est.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _s, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return R, mu_g - R @ mu_e


def ate_rmse_aligned(gt_poses, est_poses) -> float:
    """ATE RMSE after the best rigid alignment (drift independent of a global
    frame offset between the trajectories)."""
    R, t = align_trajectories(gt_poses, est_poses)
    gt = np.asarray([T[:3, 3] for T in gt_poses], np.float64)
    est = np.asarray([T[:3, 3] for T in est_poses], np.float64)
    n = min(len(gt), len(est))
    d = gt[:n] - (est[:n] @ R.T + t)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def rpe(gt_poses, est_poses, delta: int = 1):
    """Relative pose error over a `delta`-frame step: RMSE translation (m)
    and RMSE rotation (rad) of (gt_i^-1 gt_{i+d})^-1 (est_i^-1 est_{i+d})
    (the TUM RPE convention)."""
    n = min(len(gt_poses), len(est_poses))
    ts, rs = [], []
    for i in range(n - delta):
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        ts.append(float(np.linalg.norm(e[:3, 3])))
        c = (np.trace(e[:3, :3]) - 1.0) / 2.0
        rs.append(float(np.arccos(np.clip(c, -1.0, 1.0))))
    if not ts:
        return float("nan"), float("nan")
    return float(np.sqrt(np.mean(np.square(ts)))), float(np.sqrt(np.mean(np.square(rs))))


def trajectory_report(gt_poses, est_poses) -> dict:
    """Every trajectory metric in one dict."""
    n = min(len(gt_poses), len(est_poses))
    gt_t = np.asarray([T[:3, 3] for T in gt_poses[:n]])
    seg = np.linalg.norm(np.diff(gt_t, axis=0), axis=1)
    rpe1_t, rpe1_r = rpe(gt_poses, est_poses, 1)
    # a short trajectory cannot form a 10-frame step: the delta used is
    # reported, so runs of different lengths are not read as one metric
    delta10 = min(10, max(1, n - 1))
    rpe10_t, rpe10_r = rpe(gt_poses, est_poses, delta10)
    end = float(np.linalg.norm(gt_poses[n - 1][:3, 3] - est_poses[n - 1][:3, 3]))
    return {
        "frames": int(n),
        "path_length_m": float(seg.sum()),
        "ate_rmse_m": ate_rmse(gt_poses, est_poses),
        "ate_rmse_aligned_m": ate_rmse_aligned(gt_poses, est_poses),
        "rpe1_trans_m": rpe1_t,
        "rpe1_rot_deg": float(np.rad2deg(rpe1_r)),
        "rpe10_delta_frames": int(delta10),
        "rpe10_trans_m": rpe10_t,
        "rpe10_rot_deg": float(np.rad2deg(rpe10_r)),
        "end_error_m": end,
    }
