"""Drive the PyTorch/CUDA port (`fast_gicp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Eight registration paths run (`PATHS`): `vgicp_register` (RBF covariances,
dense raw voxel grid, two-phase LM solve), `gicp_register_fresh` in three
forms (kNN covariances with PLANE, adaptive-radius covariances, kNN
covariances with MIN_EIG; exact 1-NN correspondences re-searched at every
linearization, LM solve), and NDT in four forms: `ndt_register_fresh` D2D
and P2D (NDTCuda's fresh align: finalized maps prepared per cloud) and
`ndt_align` D2D and P2D (raw target grid, two-phase solve).  Three class
paths (`CLASS_PATHS`) drive the class API's swap workflow (set_input_*,
align, swap_source_and_target, align, evaluate_cost, get_fitness_score):
FastVGICP on the hash map (class defaults, grid_dims=None), FastVGICP on
the sparse dense grid (multiplicative, DIRECT7) and FastGICP; phase 3
holds the map builds on the card to the CPU and the `linearize` kernel to
its plain and gathered forms on those maps' inputs.  Five more class paths
run NDTCuda (D2D and P2D) on the dense "auto" grid (the lookup form) and
on the hash map (set_grid_dims(None): an eager freeze and the pack form a
linearization) and FastGICPMultiPoints (the exact k = 32 search a
linearization, `linearize` on the averaged rows in the gathered form);
`ndt_align_batch` and `vgicp_align_batch` run B = 4 consecutive pairs of
the drive, each pair bit for bit against its single-pair call; and
`pygicp.align_points` runs each of its four methods.  Phase 3 checks the
pack form on the hash path's first freeze, `knn_slab` at k = 32 and the
gathered `linearize` at FastGICPMultiPoints' first linearization, and the
trial launch at every new path's first linearization.
Slice F's odometry runs five paths over a 128-frame synthetic drive (seed
11, the 1.4M-point world, 0.25 m host downsample; `ODOMETRY_PATHS`):
`run_odometry` with FastVGICP (the KITTI app's serial mode),
`run_odometry_stream` and `run_odometry_scan` (RBF covariances, the dense
grid over the drive), `ScanToMapOdometry` in chunks of 32 frames (its map
saved with `save_map` and loaded back equal) and a localization pass
(NDT D2D, fuse_scans=False) over the first 32 frames on that map: launches,
the trajectory against the ground truth (ATE under 1% of the distance
scan to scan, 0.05 m scan to map, localization within 0.05 m of the
mapping pass), frames/s, host syncs a frame (torch's sync debug mode;
besides each trial's flag read only the JAX package's reads) and an
8-frame profile; the kernels at scan_to_map's frame 16 and at
localization's first freeze, `update_map` card against CPU,
`process_chunk` against `process` and the first 8 frames of a small
drive card against CPU.  `python3 chip_smoke.py --odometry` runs only
those phases.
Slice G's back-end runs after them on the 512-frame drive of the same
seed (`drive_scans`' defaults: a bit over one revolution, so the end
revisits the start; 0.25 m host downsample): `run_odometry_stream` over
the 512 frames (the front end, timed apart), then, with every launch
counter set to 0 just before and read just after, `detect_loop_closures`
(at least one closure, each within 0.1 m of the ground truth's relative
pose), `optimize_pose_graph_sparse` over the 512 poses (odometry edges at
1e2 I, the closures at their Hessians; the end error must fall), on the
JAX test's 1k graph (the end drift under 0.3x), dense against sparse on a
10-pose graph (within 2e-3), and `SlidingWindowBA` (window 20) over the
drive's first 96 relatives, a solve every 32 keyframes, and on the 30-keyframe
chain (the loop edge halves the tail error), each solve in its device form
(the default: one CUDA graph a signature, its loops conditional nodes, the
counts read from the device tally `pg_counts`).  The 512-pose solve runs
again in the eager form under torch's sync debug mode: its host syncs must
be its flag reads (one an LM trial, one a Gauss-Newton iteration; none
inside a PCG), and every preconditioner application one
`block_tridiag_apply` launch.  Then every solve in both forms
(`backend_forms`): bit for bit with deterministic scatter-adds, the eager
form's counts equal to the tally, 0 host syncs in a replay, the applies one
a PCG and one a CG iteration, the warm-up and capture, replay, eager and
device-span times and a traced replay; and `pg_cond` bit for bit its plain
version on a seeded sweep of every mode.  The kernels
at the back-end's own inputs: `block_tridiag` (factor and apply) at the
first PCG of the 512-pose and the 1k solve, on a seeded sweep of lambda
with a near-singular C_k and at the kernels' edge chain lengths, bit for bit
its plain version (x also within 1e-5 of max |x|), timed beside its serial
chain and the dense (6K)^2 Cholesky calls of torch; at
the first `verify_closure`, `rbf_moments` on both clouds, `ndt_d2d` in the
pack form (the coarse align is on the hash map), `linearize_raw`,
`nn_search` and both trial launches.  Card against CPU: `verify_closure`
(2e-3 m, 1e-3 rad), a 64-pose sparse solve (1e-4) and the 30-keyframe
window (both in the device form; 1e-4 after its first solve; after the loop edge the objective,
within 1e-3, as the poses lie in a flat valley there).  A traced run of each stage gives its wall, device busy time and
idle share; the sparse solves' are their replays', timed by CUDA events and counted by the
tally.  The back-end run's launches of `block_tridiag_factor`, `block_tridiag_apply` and
`pg_cond` are what those kernels counted on the device (`pg_counts`: a replay launches them
without their wrappers).  A growing graph (the 512-pose graph cut after its 1st, 3rd, 5th and
7th closure) gives the device form's first call at each new signature, its warm-up and capture,
the memory the cached graphs hold and the eager form's wall beside it.  `python3 chip_smoke.py --backend` runs only those phases.
Slice H's multi-device phase runs after the back-end (`phase_parallel`;
`python3 chip_smoke.py --parallel` runs it alone).  The world of one: this
process alone in an NCCL group; the five sharded aligns on the full-size
pair (GICP, VGICP on the raw grid and on the hash map, NDT D2D and P2D on
the hash map), each bit for bit its single-device call with deterministic
scatter-adds; the edge-sharded 1k solve at 3 Gauss-Newton iterations, bit
for bit the single solve likewise, its end drift under 0.3x; `ShardedScanToMapOdometry` over the
128-frame drive against `ScanToMapOdometry` (the first 8 frames within
1e-3 m, the ATE under 0.05 m); every path counted with the launch counters
set to 0 just before it (each trial the standalone `lm_trial` and the
trial-off error launch, never the fused one), its collectives, bytes, host
syncs and a traced run.  The world of two: two spawned processes on the
one card over gloo (`parallel_rank`, output prefixed by rank), the same
paths, each align within 1e-4 of the single call (deterministic
scatter-adds on both sides), the 10-pose graph's objective within 1e-4,
the odometry's first 8 frames within 5e-3 m and its ATE, the first frame's
voxel count the single map's at its binding cap on new voxels in both
worlds, every voxel of a shard its rank's by `_owner_hash_np`, and each kernel of the slice's paths
against its plain version at rank 0's inputs.
The device-resident LM loop's phase runs after the multi-device one
(`phase_device_loop`; `python3 chip_smoke.py --align` runs it alone): the
condition kernel (`loop_cond`, `csrc/device_loop.cu`) bit for bit against
its plain version on a 128-case sweep and timed; the `apps/align.py`
twin's class rows at --n 10 on the full-size pair written as PCD files;
its 14 `--device-loop` rows (7 bodies, fresh and reuse) at n = 20 with 2
timed runs, each trip one replay of the row's captured graph, its solve's
loops conditional WHILE nodes: ms an align beside the bodies called
eagerly, no host sync between a run's first enqueue and its read (torch's
sync debug mode), the loops' launches a trip from the device's tally
(`cuda_solver.loop_counts`: a profiler does not see every kernel of a
conditional body), a traced run, every trip's iterations and pose equal to
its eager call's with deterministic scatter-adds (the row captured again
under them; with atomic ones the gap beside the eager call's own repeat
gap); then `run_odometry_scan` and `ScanToMapOdometry.process_chunk` in
their one-program forms over the 128-frame drive against their eager
forms on the same criterion, with their ATE bounds, frames/s and host
syncs.  The other phases run the odometry eager (`device_loop=False`).
Phases, each fatal on failure (exit code != 0, no result line):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from `fast_gicp_tpu_torch/csrc` (one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs, at the shapes its path gives it on the full-size synthetic
     pair (22,528 padded points per cloud), with the stated tolerances,
     timed from a torch.profiler trace;
  4. main paths: each path on the full-size pair, with every launch
     counter set to 0 just before it and read just after; checks the pose
     against the synthetic ground truth (t < 0.05 m, r < 1 deg; P2D NDT at
     twice that) and that every kernel of the path ran; then the NDT voxel
     budgets against the pair's occupied voxels;
  5. card against CPU: each path on the card against the same call with
     device="cpu" (the plain versions): the VGICP and GICP paths on the
     CPU-test-sized pair, the NDT paths on the full-size pair (the small
     pair's 1 m voxels hold too few points for NDT's > 6 gate);
  6. bench protocol: 20 registrations of each path through a 1e-5 rigid
     jitter of both clouds (bench.py's protocol at a smaller depth), after
     a warm-up;
  7. profile: stage wall times, each registration's device span from CUDA
     events on the stream, and a torch.profiler trace of a few
     registrations of each path (device time by kernel, device busy share,
     device ops).
Phase 3 also holds the LM trial launch (`lm_step`: the trial step, the
error and the LM schedule in one kernel) bit for bit to the unfused trial
on a seeded sweep at the first linearization of four paths and of the
FastVGICP class paths' hash and grid maps (`phase_trial`), and
phase 4 checks that every LM trial of every path is one such launch and one
flag read.  The GICP and VGICP linearizes read their target rows by index
(the idx form): phase 3 holds it bit for bit to the gathered form and to a
repeat launch, at the paths' inputs and on `linearize_edge_cases`, and
times it at 7 x the path's lanes (a grid-stride loop); phase 4 checks that every
linearize launch of those paths is the idx form.  The NDT linearizes look
each lane's voxel up in the kernel (the lookup form; a frozen phase looks
up at the pose it froze at): phase 3 holds it bit for bit, at one pose and
with another lookup pose, to the eager freeze into a pack and the pack
form, at the paths' inputs and on `ndt_lookup_edge_cases`, and D2D
align's two-phase solve to the pack form's; phase 4 checks that every NDT
linearize launch is the lookup form (P2D align's frozen phase, seeded from
an aux, takes a pack), and phase 7 prints each path's device ops against
PREDICTED_DEVICE_OPS.

The last lines are the `nvidia-smi` name/power-limit line, one
{"kernels": [...]} JSON line and the {"ok": true, ...} JSON line.

    python3 chip_smoke.py --ndt-timing DIR
    python3 chip_smoke.py --trial-timing DIR
    python3 chip_smoke.py --lin-timing DIR [REF]

time the NDT linearizes (the pack form's launch, and `obj.linearize(x)`
from the pose to [err, H, b], which every package has: the eager freeze and
the pack launch, or the lookup-form launch) and ndt_error, an LM trial's kernels
(the trial launch, or the lm_trial and error launches of a package before
it), or the GICP, VGICP and NDT linearizes, of the package under DIR (an unpacked earlier checkout,
say) on phase 3's inputs and print one JSON line, so two designs can be
compared in one call on one card; `--lin-timing` also prints digests of the
linearizes' outputs, and with REF (a file holding such a line) whether each
equals REF's.

    python3 chip_smoke.py [--backend] --tridiag-previous DIR

runs the whole script (or the back-end's phases) and also builds
`block_tridiag.cu` of the package under DIR into a library of its own and
times its factor and apply beside this package's on the back-end's inputs,
in turns (previous, this, this, previous).
This script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import pathlib
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

T_START = time.perf_counter()
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
DEVICE_MS_TRACES = 5  # traces device_ms takes before it gives up
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, which brackets device_ms's traces
PROFILER_FALLBACKS = []  # device_ms's times taken where no trace counted
# FP32 operations each kernel needs, counted from its arithmetic:
RBF_OPS_PER_PAIR = 28  # distance 8, exp 1, moment products 9 and sums 10
LINEARIZE_OPS = 300  # per correspondence: transform, R C R^T, inverse, 28 terms
ERROR_OPS = 43  # per correspondence: transform, e, M e, e^T M e, sum
LM_TRIAL_OPS = 700  # two 6x6 Cholesky solves, residual, se3_exp, 4x4 product
NDT_LINEARIZE_OPS = 310  # LINEARIZE_OPS and the Cauchy weight (D2D)
NDT_P2D_LINEARIZE_OPS = 220  # no covariance rotation, no inverse
# of NDT_LINEARIZE_OPS, the rotation and the inverse, which the kernel runs on
# valid lanes only
NDT_D2D_M_OPS = NDT_LINEARIZE_OPS - NDT_P2D_LINEARIZE_OPS
NDT_RAW_OPS = 250  # raw finalize 25, eigenvalues 60 + acos and 2 cos, clamp 110
NDT_ERROR_OPS = 52  # ERROR_OPS and the Cauchy weight
NDT_OFFSETS = 7  # DIRECT7: the NDT kernels' lanes are 7 offsets x the source
NDT_LOOKUP_OPS = 24  # the voxel lookup a lane: 3 divisions, 3 floors, 3 subtractions,
# 3 offsets, 6 bounds compares, the flat index 4 and the corner 3 (raw maps)
NDT_MODES = ("d2d", "p2d", "d2d_raw", "p2d_raw")
NN_OPS_PER_PAIR = 8  # 3 differences, 3 squares, 2 adds
KNN_OPS_PER_CANDIDATE = 11  # distance 8, key 2, one compare of a k-selection
KNN_OPS_PER_NEIGHBOUR = 22  # local coordinates 6, moment products 6, sums 10
SLAB_OPS_PER_CANDIDATE = 9  # distance 8, one compare against the k-th best
WINDOW_OPS_PER_PAIR = 25  # distance 8, the window compare 1, 6 products, 10 sums
WINDOW_REL_TOL = 1e-5  # radius_window rows against each query's own scale


class PhaseError(RuntimeError):
    pass


def require(cond, what):
    if not cond:
        raise PhaseError(what)


LOG_PREFIX = []  # a rank's tag in the world of two ("[rank r]")


def log(*args):
    print(*LOG_PREFIX, *args, flush=True)


def synthetic_pair(n_world=None, voxel=0.1):
    """(source, target, ground-truth target<-source pose) from the repo's
    synthetic LiDAR drive: frames 31 and 30 of a 32-frame drive, seed 0."""
    from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
    from fast_gicp_tpu_torch.utils.synthetic import drive_scans, drive_world

    rng = np.random.default_rng(0)
    world = drive_world(rng) if n_world is None else drive_world(rng, n=n_world)
    scans, gt = drive_scans(rng, n_frames=32, world=world)
    target = voxel_downsample(scans[30], voxel)
    source = voxel_downsample(scans[31], voxel)
    return source, target, np.linalg.inv(gt[30]) @ gt[31]


def pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ T
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(cos)))


def cuda_ms(fn, reps):
    """Mean time per call of `fn` over `reps` back-to-back calls, after one
    warm-up call, from CUDA events.  Where the host enqueues slower than
    the card runs, this is the host's time per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel=None):
    """Device time from torch.profiler traces of `reps` calls of `fn`: a
    launch's self device time, summed over the kernels whose name holds
    `kernel` (a name or a tuple of names, each launched once a call), or a
    call's of every device op when `kernel` is None.  The profiler loses
    events of a trace now and then: on the H100, the first kernel of a
    trace, one launch of 200 in five traces in a row, 11 of 200, 30-70% of
    a trace, or more than 10% of a named kernel's launches in five traces
    in a row.  So the calls are bracketed by a marker kernel on each side,
    left out of the count; a named kernel's time is divided by the
    launches the trace holds, taken at once when they are at least 90% of
    `reps`; with `kernel` None a trace counts when another trace of the
    same calls holds as many device ops within 1% (the larger one is
    taken).  Up to DEVICE_MS_TRACES traces are taken.  When none counts, a
    named kernel's time is the mean launch of the trace that held the most
    of them, and where no trace held one, or with `kernel` None, the CUDA
    events' time a call (`cuda_ms`, the whole call's, host gaps included);
    each such fallback is logged and kept in PROFILER_FALLBACKS."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    seen = []  # (device ops, their time) of each all-op trace
    best = None  # (fewest launches of a name, the per-launch time) of a named trace
    for attempt in range(DEVICE_MS_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in device_events(prof) if MARKER_KERNEL not in e.key]
        if names is None:
            count = sum(e.count for e in events)
            total = sum(e.self_device_time_total for e in events)
            if count > 0 and any(abs(n - count) <= 0.01 * max(n, count) for n, _t in seen):
                return max(seen + [(count, total)])[1] / 1e3 / reps
            seen.append((count, total))
            counts = [n for n, _t in seen]
        else:
            by_name = [[e for e in events if k in e.key] for k in names]
            counts = [sum(e.count for e in es) for es in by_name]
            if all(counts):
                ms = sum(sum(e.self_device_time_total for e in es) / c
                         for es, c in zip(by_name, counts)) / 1e3
                if min(counts) >= 0.9 * reps:
                    return ms
                if best is None or min(counts) > best[0]:
                    best = (min(counts), ms)
        if names is not None or attempt:
            log(f"[profile] traces of {reps} calls held {counts} events of "
                f"{kernel or 'all ops'} (trace {attempt + 1} of {DEVICE_MS_TRACES})")
    if best is not None:
        used = f"the mean of the {best[0]} launches of {reps} that the fullest trace held"
        ms = best[1]
    else:
        used = "CUDA events, the whole call"
        ms = cuda_ms(fn, reps)
    PROFILER_FALLBACKS.append(dict(kernel=kernel or "all ops", reps=reps, used=used, ms=ms))
    log(f"[profile] {kernel or 'all ops'}: no trace of {reps} calls counted in "
        f"{DEVICE_MS_TRACES}; took {used}: {ms:.5f} ms")
    return ms


def device_ops(fn, reps):
    """Device ops (kernels, copies, fills) per call of `fn` from a
    torch.profiler trace of `reps` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / reps


def device_events(prof):
    """The device-side entries (kernels, copies, fills) of a trace's
    `key_averages()`.  The host-side ops that launched them carry the same
    device time, so summing both would count it twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def timings(kernel_fn, plain_fn, kernel_name, reps, plain_reps):
    """ms (the kernel's own device time), plain_ms (the device time of all
    the plain version's ops), and the CUDA-event time per call of each."""
    n = len(PROFILER_FALLBACKS)
    out = dict(call_ms=cuda_ms(kernel_fn, reps),
               plain_call_ms=cuda_ms(plain_fn, plain_reps),
               ms=device_ms(kernel_fn, reps, kernel_name),
               plain_ms=device_ms(plain_fn, plain_reps),
               timing="profiler device time")
    if len(PROFILER_FALLBACKS) > n:
        out["timing"] += "; where no trace counted: " + "; ".join(
            f"{f['kernel']}: {f['used']}" for f in PROFILER_FALLBACKS[n:])
    return out


def bound_ms(nbytes, nops):
    """Least time on an H100 SXM: the larger of bytes over the memory rate
    and FP32 operations over the FP32 rate; returns (ms, bound_by)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol |want|; returns max |diff|."""
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    require(not bool(bad.any()),
            f"{name}: {int(bad.sum())} entries outside rtol={rtol} "
            f"atol={atol}; max |diff| {float(diff.max())}")
    return float(diff.max())


def count_ops_per_pair(rungs):
    """FP32 operations `radius_count` needs for a pair inside the largest
    radius: d^2 (8), the rung it falls in by a binary search of the ladder
    (ceil(log2(rungs + 1)) compares) and one increment; each query then
    needs a prefix sum over the rungs, counted apart."""
    return NN_OPS_PER_PAIR + math.ceil(math.log2(rungs + 1)) + 1


def pairs_within(query, target, r2, chunk=1024):
    """Number of (query, target) pairs with d^2 <= r2 (a float, or one
    squared radius a query), from chunked distance rows."""
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=query.device).expand(query.shape[0])
    total = 0
    for s in range(0, query.shape[0], chunk):
        d2 = torch.cdist(query[s:s + chunk], target,
                         compute_mode="donot_use_mm_for_euclid_dist").square()
        total += int((d2 <= r2[s:s + chunk, None]).sum())
    return total


# the chunked kernels' shapes (csrc/nn_search.cu, csrc/rbf_moments.cu)
CHUNK = 32  # targets per chunk box
LIST_CAP = 1024  # chunks a block lists per round
NN_QUERIES, NN_GROUPS = 64, 4  # queries a block, groups splitting its chunks
RBF_QUERIES = 32


def _gap2(lo_a, hi_a, lo_b, hi_b):
    """(A, B) squared gaps between boxes, rounded as `csrc/tile_cull.cuh`
    rounds them; inf where either box is empty."""
    gap = torch.clamp(torch.maximum(lo_b[None] - hi_a[:, None], lo_a[:, None] - hi_b[None]),
                      min=0.0)
    g2 = (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]
    empty = (lo_a[:, 0] > hi_a[:, 0])[:, None] | (lo_b[:, 0] > hi_b[:, 0])[None, :]
    return torch.where(empty, torch.full_like(g2, float("inf")), g2)


def _boxes(p, valid, size):
    """(lo, hi) of the flagged points of each `size`-point run of p (the
    last run may be short)."""
    n = p.shape[0]
    pad = -n % size
    big = torch.finfo(torch.float32).max
    v = torch.cat([valid, valid.new_zeros(pad)]).reshape(-1, size, 1)
    pp = torch.cat([p, p.new_zeros((pad, 3))]).reshape(-1, size, 3)
    return (torch.where(v, pp, big).amin(1), torch.where(v, pp, -big).amax(1))


def culled_tiles(q4, boxes, r2max, tile=128):
    """(query blocks, target tiles) bool: the pairs of tile-query block and
    tile-target tile that the radius kernels' cull visits, those whose
    squared box gap, rounded as `csrc/tile_cull.cuh` rounds it, is <= r2max.
    q4: the packed queries (w = valid); boxes: the target's tile boxes
    (`radius_inputs`)."""
    qlo, qhi = _boxes(q4[:, :3], q4[:, 3] != 0, tile)
    b = boxes.reshape(-1, 6)
    return _gap2(qlo, qhi, b[:, :3], b[:, 3:]) <= r2max


def _chunk_rows(q, t, fn, rows=1024):
    """fn(d2 (rows, chunks, CHUNK) with +inf past the target's end) for row
    slices of q, concatenated."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    nt = t.shape[0]
    pad = -nt % CHUNK
    tt = torch.cat([t, t.new_zeros((pad, 3))])
    past = torch.arange(nt + pad, device=t.device) >= nt
    out = []
    for s in range(0, q.shape[0], rows):
        d2 = cuda_kernels._sq_dist(q[s:s + rows, None, :], tt[None])
        out.append(fn(torch.where(past, float("inf"), d2).reshape(d2.shape[0], -1, CHUNK)))
    return torch.cat(out)


def nn_search_emulated(q4, t4):
    """The chunked `nn_search` kernel's walk, emulated with tensor ops:
    (idx, d2, pairs visited).  q4: (nq, 4) [x, y, z, valid]; t4: (nt, 4) with
    masked targets parked.  Follows the kernel chunk by chunk: the two
    listing passes, group g's share of each round's list, each warp's
    point-to-box skip against its running bests and the merges."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    dev = q4.device
    nq, nt = q4.shape[0], t4.shape[0]
    pad = -nq % NN_QUERIES
    q = torch.cat([q4[:, :3], q4.new_zeros((pad, 3))])
    valid = torch.cat([q4[:, 3] != 0, torch.zeros(pad, dtype=torch.bool, device=dev)])
    t = t4[:, :3]
    C = -(-nt // CHUNK)
    clo, chi = _boxes(t, torch.ones(nt, dtype=torch.bool, device=dev), CHUNK)
    blo, bhi = _boxes(q, valid, NN_QUERIES)
    gap = _gap2(blo, bhi, clo, chi)  # (blocks, C)
    pgap = _gap2(q, q, clo, chi)  # (n, C): each query to each chunk box
    cmin = _chunk_rows(q, t, lambda d: d.amin(2))  # (n, C)
    carg = _chunk_rows(q, t, lambda d: d.argmin(2))  # first minimum in the chunk
    clen = torch.clamp(nt - torch.arange(C, device=dev) * CHUNK, max=CHUNK)
    best = torch.full((q.shape[0],), float("inf"), device=dev)
    best_idx = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    visited = 0

    def lex_min(d_a, i_a, d_b, i_b):
        take = (d_b < d_a) | ((d_b == d_a) & (i_b < i_a))
        return torch.where(take, d_b, d_a), torch.where(take, i_b, i_a)

    for pass_ in range(2):
        if pass_ == 0:
            listed = gap <= 0
        else:
            bound = torch.where(valid, best, 0.0).reshape(-1, NN_QUERIES).amax(1)
            listed = (gap > 0) & (gap <= bound[:, None])
        # a chunk's place in its round's list, hence its group
        rank = torch.zeros_like(listed, dtype=torch.int64)
        for c0 in range(0, C, LIST_CAP):
            part = listed[:, c0:c0 + LIST_CAP].long()
            rank[:, c0:c0 + LIST_CAP] = part.cumsum(1) - part
        parts = []
        for g in range(NN_GROUPS):
            d, i = best.clone(), best_idx.clone()
            mine = (listed & (rank % NN_GROUPS == g)).repeat_interleave(NN_QUERIES // 32, 0)
            for c in range(C):
                col = mine[:, c]
                if not bool(col.any()):
                    continue
                need = (valid & (pgap[:, c] <= d)).reshape(-1, 32).any(1) & col
                visited += int(need.sum()) * 32 * int(clen[c])
                lanes = need.repeat_interleave(32)
                nd, ni = lex_min(d, i, cmin[:, c], carg[:, c] + c * CHUNK)
                d, i = torch.where(lanes, nd, d), torch.where(lanes, ni, i)
            parts.append((d, i))
        for d, i in parts:
            best, best_idx = lex_min(best, best_idx, d, i)
    unsearched = torch.isinf(best)
    d0 = cuda_kernels._sq_dist(q, t[:1])
    best = torch.where(unsearched, d0, best)
    best_idx = torch.where(unsearched, 0, best_idx)
    return best_idx[:nq].to(torch.int32), torch.clamp(best[:nq], min=0.0), visited


def rbf_visited_pairs(q4, t4, md2):
    """The pairs the chunked `rbf_moments` kernel visits: for each block of
    32 queries, the chunks whose valid-target box lies within max_dist of
    its valid queries' box and whose box some valid query's own point
    reaches.  q4, t4: (n, 4) [x, y, z, valid]."""
    dev = q4.device
    nq, nt = q4.shape[0], t4.shape[0]
    pad = -nq % RBF_QUERIES
    q = torch.cat([q4[:, :3], q4.new_zeros((pad, 3))])
    valid = torch.cat([q4[:, 3] != 0, torch.zeros(pad, dtype=torch.bool, device=dev)])
    C = -(-nt // CHUNK)
    clo, chi = _boxes(t4[:, :3], t4[:, 3] != 0, CHUNK)
    blo, bhi = _boxes(q, valid, RBF_QUERIES)
    listed = _gap2(blo, bhi, clo, chi) <= md2
    reach = ((_gap2(q, q, clo, chi) <= md2) & valid[:, None]).reshape(-1, 32, C).any(1)
    clen = torch.clamp(nt - torch.arange(C, device=dev) * CHUNK, max=CHUNK)
    return int(((listed & reach).long() * clen[None]).sum()) * 32


def window_visited_pairs(q4, chunk_boxes, r2q, nt):
    """The pairs the warp-per-query `radius_window` kernel visits: for each
    query, the 32-target chunks whose box (of the valid targets,
    `radius_inputs`) its point reaches within its own window, gap^2 rounded
    as `csrc/tile_cull.cuh` rounds it, times the chunk's length."""
    b = chunk_boxes.reshape(-1, 6)
    clen = torch.clamp(nt - torch.arange(b.shape[0], device=q4.device) * CHUNK, max=CHUNK)
    total = 0
    for s in range(0, q4.shape[0], 4096):
        q = q4[s:s + 4096, :3]
        listed = _gap2(q, q, b[:, :3], b[:, 3:]) <= r2q[s:s + 4096, None]
        total += int((listed.long() * clen[None]).sum())
    return total


def block_window_visited_pairs(q4, boxes, r2q, tile=128):
    """The pairs the first `radius_window` design visited: a block
    of 128 queries walked every 128-target tile whose box lay within its
    valid queries' largest window of its valid queries' box."""
    valid = q4[:, 3] != 0
    pad = -q4.shape[0] % tile
    bound = torch.cat([torch.where(valid, r2q, float("-inf")),
                       r2q.new_full((pad,), float("-inf"))]).reshape(-1, tile).amax(1)
    qlo, qhi = _boxes(q4[:, :3], valid, tile)
    b = boxes.reshape(-1, 6)
    return int((_gap2(qlo, qhi, b[:, :3], b[:, 3:]) <= bound[:, None]).sum()) * tile * tile


def check_nn_edge_cases(dev):
    """`nn_search` bit-equal to its plain version on the valid queries of
    every adversarial case of `utils.synthetic.nn_search_edge_cases` (d^2
    ties across chunks, every target masked, ragged sizes, a block whose
    box touches no chunk, a block of padding, queries 50 m off), and finite
    on every query: the cases the CPU tests hold the plain version to
    against numpy and JAX.  Returns the number of cases."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.nn_search_edge_cases()
    for case in cases:
        q, qm, t, tm = (torch.as_tensor(case[key], device=dev)
                        for key in ("query", "qmask", "target", "tmask"))
        idx, d2 = cuda_kernels.nn_search(q, t, tm, qm)
        idx_w, d2_w = cuda_kernels.nn_search_plain(q, t, tm)
        torch.cuda.synchronize()
        require(bool(torch.equal(idx[qm], idx_w[qm]) and torch.equal(d2[qm], d2_w[qm])),
                f"nn_search edge case {case['name']}: {int((idx != idx_w)[qm].sum())} idx, "
                f"{int((d2 != d2_w)[qm].sum())} d2 differ")
        require(bool(torch.isfinite(d2).all()), f"nn_search edge case {case['name']}: non-finite")
    log(f"[kernels] edge cases: nn_search idx and d2 bit-equal on all {len(cases)} "
        f"({', '.join(c['name'] for c in cases)})")
    return len(cases)


def check_rbf_edge_cases(dev):
    """`rbf_moments` within its tolerance of the plain version on the valid
    queries of every adversarial case of `utils.synthetic.rbf_moments_edge_cases`
    (pairs exactly on the radius, masked targets in range, nq != nt,
    nt < 128, a block with nothing in range, kernel width 0), and a repeat
    launch bit-identical.  Returns the number of cases."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.rbf_moments_edge_cases()
    for case in cases:
        q, qm, t, tm, c = (torch.as_tensor(case[key], device=dev)
                           for key in ("query", "qmask", "target", "tmask", "center"))
        args = (q, qm, t, tm, c, case["kernel_width"], case["max_dist"])
        got = cuda_kernels.rbf_moments(*args)
        again = cuda_kernels.rbf_moments(*args)
        want = cuda_kernels.rbf_moments_plain(*args)
        torch.cuda.synchronize()
        name = f"rbf edge case {case['name']}"
        check_close(f"{name} sum w", got[0, qm], want[0, qm], 5e-3, 1e-4)
        check_close(f"{name} sum w y", got[1:4][:, qm], want[1:4][:, qm], 5e-3, 2e-2)
        check_close(f"{name} sum w yy", got[4:13][:, qm], want[4:13][:, qm], 5e-3, 5e-2)
        require(bool(torch.equal(got, again)), f"{name}: a repeat launch differs")
    log(f"[kernels] edge cases: rbf_moments within tolerance and repeat-identical on all "
        f"{len(cases)} ({', '.join(c['name'] for c in cases)})")
    return len(cases)


def check_knn_moments_edge_cases(dev):
    """`knn_moments` against its plain version on every adversarial case of
    `utils.synthetic.knn_moments_edge_cases` (ties within one key step at
    the k-th place, exact ties, fewer than k valid candidates, a wholly
    masked slab, tile ids -1 and T, masked queries, k in {1, 20, 32, 48},
    4,096-wide slabs): kth bit-equal on every query, mom within 1e-4 of
    each row's largest |entry|, and a repeat launch bit-identical.
    Returns the number of cases."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.knn_moments_edge_cases()
    for case in cases:
        args = [torch.as_tensor(case[key], device=dev)
                for key in ("query", "qmask", "target", "tmask", "cidx")]
        mom, kth = cuda_kernels.knn_moments(*args, case["k"], case["cand_tile"])
        mom2, kth2 = cuda_kernels.knn_moments(*args, case["k"], case["cand_tile"])
        mom_w, kth_w = cuda_kernels.knn_moments_plain(*args, case["k"], case["cand_tile"])
        torch.cuda.synchronize()
        name = f"knn_moments edge case {case['name']}"
        require(bool(torch.equal(kth, kth_w)), f"{name}: {int((kth != kth_w).sum())} kth differ")
        scale = mom_w.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        check_close(f"{name} mom", mom / scale, mom_w / scale, 0.0, 1e-4)
        require(bool(torch.equal(mom, mom2) and torch.equal(kth, kth2)),
                f"{name}: a repeat launch differs")
    log(f"[kernels] edge cases: knn_moments kth bit-equal, mom within 1e-4 and "
        f"repeat-identical on all {len(cases)} ({', '.join(c['name'] for c in cases)})")


def check_window_edge_cases(dev):
    """`radius_window` against its plain version on the valid queries of
    every adversarial case of `utils.synthetic.radius_window_edge_cases`
    (r2q = 0, windows on pairs' d^2 among duplicates, the largest rung
    beside the smallest in every warp, masked points, nq and nt not
    multiples of 32, nt < 32): row 0 equal, rows 1-12 within
    WINDOW_REL_TOL of each query's largest |entry|, and a repeat launch
    bit-identical.  Returns the number of cases."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.radius_window_edge_cases()
    for case in cases:
        args = [torch.as_tensor(case[key], device=dev)
                for key in ("query", "qmask", "target", "tmask", "center", "r2q")]
        got = cuda_kernels.radius_window(*args)
        again = cuda_kernels.radius_window(*args)
        want = cuda_kernels.radius_window_plain(*args)
        torch.cuda.synchronize()
        m = args[1]
        name = f"radius_window edge case {case['name']}"
        require(bool(torch.equal(got[0, m], want[0, m])),
                f"{name}: {int((got[0] != want[0])[m].sum())} valid windows differ in n")
        g, w = got[1:13][:, m], want[1:13][:, m]
        scale = w.abs().amax(0, keepdim=True).clamp(min=1e-30)
        check_close(f"{name} rows", g / scale, w / scale, 0.0, WINDOW_REL_TOL)
        require(bool(torch.equal(got, again)), f"{name}: a repeat launch differs")
    log(f"[kernels] edge cases: radius_window n equal, rows within {WINDOW_REL_TOL:g} and "
        f"repeat-identical on all {len(cases)} ({', '.join(c['name'] for c in cases)})")


def check_edge_cases(dev):
    """`knn_slab` and `radius_count` bit-equal to their plain versions on
    every adversarial case of `utils.synthetic` (ties across positions and
    tiles, short slabs, tile ids -1 and T, masked queries and targets, k in
    {1, 20, 32}, both tile widths; pairs exactly on rungs of ascending,
    non-ascending and repeated ladders, L in {1, 20, 32}): the cases the
    CPU tests hold the plain versions to against numpy and JAX.  Returns
    the number of cases."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.utils import synthetic

    slab = synthetic.knn_slab_edge_cases()
    for case in slab:
        args = [torch.as_tensor(case[key], device=dev)
                for key in ("query", "qmask", "target", "tmask", "cidx")]
        idx, sq = cuda_kernels.knn_slab(*args, case["k"], case["cand_tile"])
        idx_w, sq_w = cuda_kernels.knn_slab_plain(*args, case["k"], case["cand_tile"])
        torch.cuda.synchronize()
        require(bool(torch.equal(sq, sq_w)),
                f"knn_slab edge case {case['name']}: {int((sq != sq_w).sum())} sq differ")
        require(bool(torch.equal(idx, idx_w)),
                f"knn_slab edge case {case['name']}: {int((idx != idx_w).sum())} idx differ")
    counts = synthetic.radius_count_edge_cases()
    for case in counts:
        pts, mask, center, r2 = (torch.as_tensor(case[key], device=dev)
                                 for key in ("points", "mask", "center", "r2"))
        args = (pts, mask, pts, mask, center, r2)
        cnt = cuda_kernels.radius_count(*args)
        cnt_w = cuda_kernels.radius_count_plain(*args)
        torch.cuda.synchronize()
        require(bool(torch.equal(cnt[:, mask], cnt_w[:, mask])),
                f"radius_count edge case {case['name']}: "
                f"{int((cnt != cnt_w)[:, mask].sum())} valid entries differ")
    log(f"[kernels] edge cases: knn_slab idx and sq bit-equal on all {len(slab)} "
        f"({', '.join(c['name'] for c in slab)}); radius_count equal on the valid queries "
        f"of all {len(counts)} ({', '.join(c['name'] for c in counts)})")
    return len(slab) + len(counts)


def rel_to_max(name, a, b, tol=1e-5):
    """|a - b| within `tol` of b's largest |entry|; where b is all 0, a must
    be exactly 0.  Returns max |a - b|."""
    m = float(b.abs().max())
    if m == 0.0:
        require(not bool(a.any()), f"{name}: nonzero where the plain version is 0")
        return 0.0
    return check_close(name, a / m, b / m, 0.0, tol) * m


# linearize.cu's kernels in the profiler, a prefix that ndt_linearize_kernel never holds
LIN_KERNEL = "::linearize_kernel<{raw}"
LIN_TOLERANCE = {
    "elementwise": "err rtol 1e-4; H, b rtol 3e-3 atol 0.5; aux rtol 1e-5 atol 1e-5",
    "rel_max": "err, H, b within 1e-5 of their largest entry; aux rtol 1e-5 atol 1e-5",
}


def lin_wrappers(raw):
    """(wrapper, plain version) of linearize_raw (raw rows) or linearize."""
    from fast_gicp_tpu_torch.ops import cuda_linearize as cl

    return (cl.linearize_raw, cl.linearize_raw_plain) if raw else (cl.linearize,
                                                                   cl.linearize_plain)


def check_lin_outputs(name, got, want, tol):
    """err, H, b and aux of a linearize launch against its plain version:
    `tol` "elementwise" (VGICP's) or "rel_max" (GICP's), LIN_TOLERANCE;
    H exactly symmetric.  Returns max |diff|."""
    require(bool(torch.equal(got[1], got[1].T)), f"{name}: H is not exactly symmetric")
    if tol == "elementwise":
        errs = [check_close(f"{name} err", got[0], want[0], 1e-4, 0.0),
                check_close(f"{name} H", got[1], want[1], 3e-3, 0.5),
                check_close(f"{name} b", got[2], want[2], 3e-3, 0.5)]
    else:
        errs = [rel_to_max(f"{name} err", got[0].reshape(1), want[0].reshape(1)),
                rel_to_max(f"{name} H", got[1], want[1]),
                rel_to_max(f"{name} b", got[2], want[2])]
    return max(errs + [check_close(f"{name} aux", got[3], want[3], 1e-5, 1e-5)])


def check_linearize(name, raw, P, CA, x, table, valid, ids, tol):
    """linearize_raw (raw) or linearize in the idx form (correspondence n
    reads row ids[n] of table): bit-equal to the gathered form (table[ids]
    first) and to a repeat launch, within `tol` of the plain version, H
    exactly symmetric.  Returns (outputs, max |diff|)."""
    fn, plain = lin_wrappers(raw)
    require(bool(((ids >= 0) & (ids < table.shape[0])).all()), f"{name}: ids out of range")
    rows = table[ids]
    got = fn(P, CA, x, table, valid, ids)
    again = fn(P, CA, x, table, valid, ids)
    gathered = fn(P, CA, x, rows, valid)
    want = plain(P, CA, x, rows, valid)
    torch.cuda.synchronize()
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, gathered)),
            f"{name}: the idx form differs from the gathered form")
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            f"{name}: a repeat launch differs")
    return got, check_lin_outputs(name, got, want, tol)


def check_linearize_edge_cases(dev):
    """Both linearize kernels on every case of
    `utils.synthetic.linearize_edge_cases` (L = 1,001, 91, 1 and 157,696,
    every lane invalid or a miss, a singular C_B + R C_A R^T, repeated ids),
    with int64 and int32 ids: as check_linearize, int32 and int64 bit-equal,
    at each kernel's tolerance (the singular case's sums, ~1e20, relative to
    their largest entry for both), and err, H, b exactly 0 where no lane
    counts.  Returns the number of cases."""
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.linearize_edge_cases()
    for case in cases:
        t = {k: torch.as_tensor(case[k], device=dev)
             for k in ("p", "ca", "x", "raw", "fin", "ids", "valid")}
        singular = case["name"] == "singular"
        for raw in (True, False):
            name = f"{'linearize_raw' if raw else 'linearize'} edge case {case['name']}"
            tol = "elementwise" if raw and not singular else "rel_max"
            outs = [check_linearize(f"{name} ({dt})", raw, t["p"], t["ca"], t["x"],
                                    t["raw" if raw else "fin"], t["valid"], t["ids"].to(dt),
                                    tol)[0]
                    for dt in (torch.int64, torch.int32)]
            require(all(bool(torch.equal(a, b)) for a, b in zip(*outs)),
                    f"{name}: int32 and int64 ids differ")
            if case["name"] == "all_invalid_or_miss":
                require(not any(bool(o.any()) for o in outs[0][:3]),
                        f"{name}: err, H, b not exactly 0")
    log(f"[kernels] linearize edge cases: both kernels, int32 and int64 ids, bit-equal to "
        f"the gathered form and a repeat, within tolerance, H symmetric, on all "
        f"{len(cases)} ({', '.join(c['name'] for c in cases)})")
    return len(cases)


def linearize_record(raw, P, CA, x, table, valid, ids, max_err, tol, build):
    """The record of linearize_raw (raw) or linearize at its path's inputs
    (the idx form): its device time and the plain version's (which gathers
    first), the gathered form's time, the device time of all the ops from
    ids to the normal equations (the idx form; a gather and the gathered
    form), and the idx form at 7 L (a grid-stride loop), checked against
    the plain version and a repeat launch first; the bound counts the rows
    the ids name once."""
    fn, plain = lin_wrappers(raw)
    name = "linearize_raw" if raw else "linearize"
    kname = LIN_KERNEL.format(raw=str(raw).lower())
    L = P.shape[1]
    rows = table[ids]
    tm_ = timings(lambda: fn(P, CA, x, table, valid, ids),
                  lambda: plain(P, CA, x, table[ids], valid), kname, 200, 50)
    forms = dict(
        gathered_ms=device_ms(lambda: fn(P, CA, x, rows, valid), 200, kname),
        idx_ops_ms=device_ms(lambda: fn(P, CA, x, table, valid, ids), 200),
        gather_and_gathered_ops_ms=device_ms(
            lambda: fn(P, CA, x, table[ids.long()], valid), 200))
    P7, CA7 = P.repeat(1, 7).contiguous(), CA.repeat(1, 7).contiguous()
    ids7, v7 = ids.repeat(7).contiguous(), valid.repeat(7).contiguous()
    got, again = fn(P7, CA7, x, table, v7, ids7), fn(P7, CA7, x, table, v7, ids7)
    want = plain(P7, CA7, x, table[ids7], v7)
    torch.cuda.synchronize()
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            f"{name} at L = {7 * L}: a repeat launch differs")
    check_lin_outputs(f"{name} at L = {7 * L}", got, want, tol)
    forms["grid_stride_lanes"] = 7 * L
    forms["grid_stride_ms"] = device_ms(lambda: fn(P7, CA7, x, table, v7, ids7), 200, kname)
    unique_rows = int(torch.unique(ids).numel())
    nbytes = (L * (12 + 24 + 4 + 40 + ids.element_size()) + unique_rows * 64 + 64
              + 43 * 4)
    b_ms, b_by = bound_ms(nbytes, L * LINEARIZE_OPS)
    regs, stack = build.get(f"{name}<{'i64' if ids.element_size() == 8 else 'i32'}>",
                            (None, None))
    log(f"[kernels] {name} at L = {7 * L} (grid-stride): {forms['grid_stride_ms']:.5f} ms "
        f"a launch")
    return dict(
        name=name, route="cuda", source="fast_gicp_tpu_torch/csrc/linearize.cu",
        replaces="fast_gicp_tpu/ops/pallas_linearize.py:" + ("193" if raw else "180"),
        max_abs_err=max_err,
        tolerance=LIN_TOLERANCE[tol] + "; idx form bit-equal to the gathered form and to a "
                  "repeat launch; H exactly symmetric",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, lanes=L, bytes=nbytes,
        unique_rows=unique_rows, registers=regs, stack_bytes=stack,
        **forms, **tm_)


RBF_TOLERANCE = "rtol 5e-3; atol 1e-4/2e-2/5e-2"


def check_rbf(name, args):
    """rbf_moments against its plain version on the query's valid rows
    (RBF_TOLERANCE: sum w, sum w y, sum w yy), and a repeat launch
    bit-identical.  Returns max |diff|."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    got = cuda_kernels.rbf_moments(*args)
    want = cuda_kernels.rbf_moments_plain(*args)
    again = cuda_kernels.rbf_moments(*args)
    torch.cuda.synchronize()
    v = args[1]
    errs = [
        check_close(f"{name} sum w", got[0, v], want[0, v], 5e-3, 1e-4),
        check_close(f"{name} sum w y", got[1:4][:, v], want[1:4][:, v], 5e-3, 2e-2),
        check_close(f"{name} sum w yy", got[4:13][:, v], want[4:13][:, v], 5e-3, 5e-2),
    ]
    # the warps' partial sums are added in a fixed order: no atomics
    require(bool(torch.equal(got, again)), f"{name}: a repeat launch differs")
    return max(errs)


def check_knn_moments(label, args, kwargs=None):
    """knn_moments against its plain version: kth bit-equal, mom within 1e-4
    of each row's largest entry, a repeat launch bit-identical.  Returns
    max |diff| of mom."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    kwargs = kwargs or {}
    n = args[0].shape[0]
    mom, kth = cuda_kernels.knn_moments(*args, **kwargs)
    again = cuda_kernels.knn_moments(*args, **kwargs)
    mom_w, kth_w = cuda_kernels.knn_moments_plain(*args, **kwargs)
    torch.cuda.synchronize()
    require(bool(torch.equal(kth, kth_w)),
            f"knn_moments {label} kth: {int((kth != kth_w).sum())} of {n} not bit-equal")
    scale = mom_w.abs().amax(dim=1, keepdim=True)
    err = check_close(f"knn_moments {label} mom", mom / scale, mom_w / scale, 0.0, 1e-4)
    # one warp a query, its sums by a fixed xor tree: no atomics
    require(bool(torch.equal(mom, again[0]) and torch.equal(kth, again[1])),
            f"knn_moments {label}: a repeat launch differs")
    log(f"[kernels] knn_moments {label}: kth bit-equal on all {n}, a repeat launch "
        f"bit-identical; mom max diff / row scale {err:.3e}")
    return float((mom - mom_w).abs().max())


def phase_kernels(dev, pair):
    """Each kernel against its plain version at the main path's shapes."""
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, make_vgicp_objective
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_solver
    from fast_gicp_tpu_torch.ops.covariance import masked_mean, rbf_covariance_cols
    from fast_gicp_tpu_torch.ops.voxelmap import (
        auto_grid_dims, build_raw_grid, neighbor_offsets,
    )
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    n = sp.shape[0]
    log(f"[kernels] source {len(source)} -> {n} padded, target {len(target)} "
        f"-> {tp.shape[0]} padded")
    src = torch.as_tensor(sp, device=dev)
    smask = torch.as_tensor(sm, device=dev)
    tgt = torch.as_tensor(tp, device=dev)
    tmask = torch.as_tensor(tm, device=dev)
    records = []

    # -- RBF moments: the target cloud against itself about its mean ------
    c = masked_mean(tgt, tmask)
    args = (tgt, tmask, tgt, tmask, c, 0.5, 3.0)
    max_err = check_rbf("rbf", args)
    edge_cases = check_rbf_edge_cases(dev)
    # data-dependent work: only pairs within max_dist need the exp and the
    # moment update
    y = (tgt - c)[tmask]
    pairs = pairs_within(y, y, 9.0)
    packed = cuda_kernels._pack(tgt, tmask, c)
    visited = rbf_visited_pairs(packed, packed, cuda_kernels._constants(0.5, 3.0)[1])
    log(f"[kernels] rbf_moments: a repeat launch bit-identical; {pairs} pairs within "
        f"3 m, {visited} visited ({visited / pairs:.2f}x)")
    # timed with the target's chunk boxes, which the wrapper builds here
    tm = timings(lambda: cuda_kernels.rbf_moments(*args),
                 lambda: cuda_kernels.rbf_moments_plain(*args),
                 ("chunk_bbox_kernel", "rbf_moments_kernel"), 20, 3)
    b_ms, b_by = bound_ms(2 * n * 16 + 16 * n * 4, pairs * RBF_OPS_PER_PAIR)
    records.append(dict(
        name="rbf_moments", route="cuda",
        source="fast_gicp_tpu_torch/csrc/rbf_moments.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:417",
        max_abs_err=max_err,
        tolerance=f"{RBF_TOLERANCE} (and on {edge_cases} edge cases); a repeat launch "
                  "bit-identical",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs_in_range=pairs,
        pairs_visited=visited, **tm))

    # -- linearize_raw / error at the first linearization of the solve ----
    scov = rbf_covariance_cols(src - c, smask)
    tcov = rbf_covariance_cols(tgt - c, tmask)
    dims = auto_grid_dims(target, 1.0)
    cfg = VGICPConfig(grid_dims=dims, refresh_iterations=2)
    vmap = build_raw_grid(tgt - c, tmask, 1.0, tcov, dims)
    lin, err_fn, freeze, lin_frozen = make_vgicp_objective(
        src - c, smask, scov, vmap, neighbor_offsets("direct1"), cfg)
    x = torch.eye(4, device=dev)
    ids = freeze(x)  # int64 row ids into vmap.rows, as the path passes them
    P = (src - c).T.contiguous()
    CA = scov.contiguous()
    valid = smask.to(torch.float32)
    L = P.shape[1]
    got, max_err = check_linearize("linearize_raw", True, P, CA, x, vmap.rows, valid, ids,
                                   "elementwise")
    records.append(linearize_record(True, P, CA, x, vmap.rows, valid, ids, max_err,
                                    "elementwise", kernel_build_report()))

    aux = got[3]
    x2 = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005],
                                  device=dev))
    e_got = cuda_linearize.error(P, x2, aux)
    e_want = cuda_linearize.error_plain(P, x2, aux)
    torch.cuda.synchronize()
    e_err = check_close("error", e_got, e_want, 1e-4, 0.0)
    tm = timings(lambda: cuda_linearize.error(P, x2, aux),
                 lambda: cuda_linearize.error_plain(P, x2, aux),
                 "error_kernel", 200, 50)
    b_ms, b_by = bound_ms(L * (12 + 40) + 64 + 4, L * ERROR_OPS)
    records.append(dict(
        name="error", route="cuda",
        source="fast_gicp_tpu_torch/csrc/linearize.cu",
        replaces="fast_gicp_tpu/ops/pallas_linearize.py:633",
        max_abs_err=e_err, tolerance="rtol 1e-4",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **tm))

    # -- lm_trial on the first linearization's normal equations ----------
    _e, H, b, _aux = got
    lam = (1e-9 * torch.max(torch.abs(torch.diagonal(H)))).reshape(1)
    tg = cuda_solver.lm_trial(H, b, lam, x2)
    tw = cuda_solver.lm_trial_plain(H, b, lam.reshape(()), x2)
    torch.cuda.synchronize()
    errs = [
        check_close("lm_trial d", tg[2], tw[2], 1e-5, 1e-7),
        check_close("lm_trial delta", tg[1], tw[1], 1e-5, 1e-6),
        check_close("lm_trial xi", tg[0], tw[0], 1e-5, 1e-6),
        check_close("lm_trial denom", tg[3], tw[3], 1e-4, 1e-10),
    ]
    tm = timings(lambda: cuda_solver.lm_trial(H, b, lam, x2),
                 lambda: cuda_solver.lm_trial_plain(H, b, lam.reshape(()), x2),
                 "lm_trial_kernel", 200, 20)
    b_ms, b_by = bound_ms((36 + 6 + 1 + 16 + 39) * 4, LM_TRIAL_OPS)
    records.append(dict(
        name="lm_trial", route="cuda",
        source="fast_gicp_tpu_torch/csrc/lm_trial.cu",
        replaces="fast_gicp_tpu/ops/pallas_solver.py:127",
        max_abs_err=max(errs), tolerance="d rtol 1e-5 atol 1e-7; delta, xi rtol 1e-5 atol 1e-6",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **tm))
    for r in records:
        log(f"[kernels] {r['name']}: max_abs_diff {r['max_abs_err']:.3e} "
            f"({r['tolerance']}), {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"({r['timing']}); per call with the host's enqueue: "
            f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    return records


def phase_gicp_kernels(dev, pair):
    """The GICP path's kernels against their plain versions, at the shapes
    `gicp_register_fresh` gives them on the full-size pair."""
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.models.gicp import (
        GICPConfig, make_gicp_objective, target_rows16,
    )
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols, masked_mean
    from fast_gicp_tpu_torch.ops.neighbors import _masked_target, select_candidate_tiles
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    src, smask, tgt, tmask = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    n = tgt.shape[0]
    records = []

    # -- knn_moments: the target cloud's covariances, k = 20 --------------
    k, ct, C = 20, 128, 16
    Q = n // cuda_kernels.KNN_TILE

    def knn_args(width, kk):
        cidx, _excluded = select_candidate_tiles(
            tgt.reshape(Q, cuda_kernels.KNN_TILE, 3),
            _masked_target(tgt, tmask).reshape(n // ct, ct, 3), width)
        return (tgt, torch.ones_like(tmask), tgt, tmask, cidx, kk)

    args = knn_args(C, k)
    max_err = check_knn_moments(f"C = {C} x {ct}, k = {k}", args)
    # the widest slab the contract takes and the round-by-round form (k > 32)
    wide, k48 = knn_args(32, k), knn_args(C, 48)
    check_knn_moments(f"C = 32 x {ct}, k = {k}", wide)
    check_knn_moments(f"C = {C} x {ct}, k = 48", k48)
    edge_cases = check_knn_moments_edge_cases(dev)
    tm_ = timings(lambda: cuda_kernels.knn_moments(*args),
                  lambda: cuda_kernels.knn_moments_plain(*args),
                  "knn_moments_kernel", 50, 5)
    wide_ms = device_ms(lambda: cuda_kernels.knn_moments(*wide), 20, "knn_moments_kernel")
    k48_ms = device_ms(lambda: cuda_kernels.knn_moments(*k48), 5, "knn_moments_rounds_kernel")
    b_ms, b_by = bound_ms(n * 16 + n * 16 + Q * C * 4 + n * 11 * 4,
                          n * C * ct * KNN_OPS_PER_CANDIDATE + n * k * KNN_OPS_PER_NEIGHBOUR)
    records.append(dict(
        name="knn_moments", route="cuda",
        source="fast_gicp_tpu_torch/csrc/knn_moments.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:302",
        max_abs_err=max_err,
        tolerance=f"kth bit-equal; mom within 1e-4 of each row's largest entry (also at "
                  f"C = 32 x 128, k = 48 and on {edge_cases} edge cases); a repeat launch "
                  "bit-identical",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, wide_slab_ms=wide_ms, k48_ms=k48_ms,
        **tm_))
    log(f"[kernels] knn_moments: C = 32 x 128 {wide_ms:.4f} ms, k = 48 (rounds) "
        f"{k48_ms:.4f} ms")

    # -- nn_search at the first re-search of a solve: the transformed,
    # centered source against the centered target --------------------------
    c = masked_mean(tgt, tmask)
    src_c, tgt_c = src - c, tgt - c
    x = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005], device=dev))
    q = se3.transform_points(x, src_c).contiguous()
    idx, d2 = cuda_kernels.nn_search(q, tgt_c, tmask, smask)
    idx_w, d2_w = cuda_kernels.nn_search_plain(q, tgt_c, tmask)
    torch.cuda.synchronize()
    # the lexicographic (d^2, index) minimum: bit-equal on every valid query
    require(bool(torch.equal(idx[smask], idx_w[smask])),
            f"nn_search idx: {int((idx != idx_w)[smask].sum())} valid queries differ")
    require(bool(torch.equal(d2[smask], d2_w[smask])),
            f"nn_search d2: {int((d2 != d2_w)[smask].sum())} valid queries differ")
    require(bool(torch.isfinite(d2).all()), "nn_search d2: non-finite rows")
    edge_cases = check_nn_edge_cases(dev)
    # the pairs the kernel's walk visits (emulated, and its result checked)
    parked = _masked_target(tgt_c, tmask)
    idx_e, d2_e, visited = nn_search_emulated(
        torch.cat([q, smask.to(q.dtype)[:, None]], 1), cuda_kernels._pack_masked(tgt_c, tmask))
    require(bool(torch.equal(idx_e[smask], idx_w[smask]) and torch.equal(d2_e[smask], d2_w[smask])),
            "nn_search_emulated differs from the plain version")

    # the pairs an exact cull at the kernel's granularity must visit: the
    # (32 queries, 32-target chunk) pairs in which some valid query's
    # point-to-box gap^2 is <= its own nearest d^2
    tlo, thi = _boxes(parked, torch.ones_like(tmask), CHUNK)
    reach = (_gap2(q, q, tlo, thi) <= d2_w[:, None]) & smask[:, None]
    pairs = int(reach.reshape(-1, 32, tlo.shape[0]).any(1).sum()) * 32 * CHUNK
    # timed with the target's chunk boxes, which the wrapper builds here
    tm_ = timings(lambda: cuda_kernels.nn_search(q, tgt_c, tmask, smask),
                  lambda: cuda_kernels.nn_search_plain(q, tgt_c, tmask),
                  ("chunk_bbox_kernel", "nn_search_kernel"), 100, 5)
    b_ms, b_by = bound_ms(n * 12 + n * 12 + n * 8, pairs * NN_OPS_PER_PAIR)
    records.append(dict(
        name="nn_search", route="cuda",
        source="fast_gicp_tpu_torch/csrc/nn_search.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:99",
        max_abs_err=float((d2 - d2_w)[smask].abs().max()),
        tolerance=f"idx and d2 bit-equal on every valid query (and on {edge_cases} edge cases)",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs_to_visit=pairs,
        pairs_visited=visited, **tm_))
    log(f"[kernels] nn_search: idx and d2 bit-equal on all {int(smask.sum())} valid queries; "
        f"exact-cull pairs {pairs} of {n * n}, visited {visited}")

    # -- linearize at the first linearization of the solve ---------------
    scov = knn_covariance_cols(src, smask)
    tcov = knn_covariance_cols(tgt, tmask)
    _lin, _err, freeze, _lin_frozen = make_gicp_objective(
        src_c, smask, scov, tgt_c, tmask, tcov, GICPConfig(), with_freeze=True)
    idx, valid = freeze(x)  # int32 target indices, as the path passes them
    P = src_c.T.contiguous()
    CA = scov.contiguous()
    table = target_rows16(tgt_c, tcov)
    _got, max_err = check_linearize("linearize", False, P, CA, x, table, valid, idx,
                                    "rel_max")
    records.append(linearize_record(False, P, CA, x, table, valid, idx, max_err,
                                    "rel_max", kernel_build_report()))
    records[-1]["edge_cases"] = check_linearize_edge_cases(dev)
    for r in records:
        log(f"[kernels] {r['name']}: max_abs_diff {r['max_abs_err']:.3e} "
            f"({r['tolerance']}), {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"({r['timing']}); per call with the host's enqueue: "
            f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    return records


def phase_c2_kernels(dev, pair):
    """The kNN slab search and the adaptive-radius count and window
    against their plain versions, at the shapes `gicp_register_fresh`
    gives them on the full-size pair (the target cloud's covariances):
    `knn_slab` as `knn_search_culled` calls it for MIN_EIG (16 of 88
    256-point tiles a query tile) and as `knn_search` calls it for the
    exact search (all 176 128-point tiles); `radius_count` and
    `radius_window` as the adaptive estimator calls them.  library_ms is
    None for all three: no single PyTorch call computes a top-k over
    gathered per-tile slabs, per-rung radius counts or per-query windowed
    moments (each is several calls, as the plain versions are)."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.ops.covariance import (
        default_radius_ladder, masked_mean, window_radii,
    )
    from fast_gicp_tpu_torch.ops.neighbors import _masked_target, select_candidate_tiles
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    tp, tm = pad_points(target)
    tgt, tmask = (torch.as_tensor(a, device=dev) for a in (tp, tm))
    n = tgt.shape[0]
    ones = torch.ones_like(tmask)
    records = []
    edge_cases = check_edge_cases(dev)

    # -- knn_slab: the culled search (the path's shapes), then the exact one
    k = 20
    tc = tgt - masked_mean(tgt, tmask)
    Q, T = n // 256, n // 256
    cidx, _excluded = select_candidate_tiles(
        tc.reshape(Q, 256, 3), _masked_target(tc, tmask).reshape(T, 256, 3), 16)
    args = (tc, ones, tc, tmask, cidx, k, 256)
    exact = (tc, ones, tc, tmask,
             torch.arange(n // 128, dtype=torch.int32, device=dev).expand(Q, n // 128)
             .contiguous(), k, 128)
    errs = {}
    for name, a in (("culled", args), ("exact", exact)):
        idx, sq = cuda_kernels.knn_slab(*a)
        idx_w, sq_w = cuda_kernels.knn_slab_plain(*a)
        torch.cuda.synchronize()
        # the same f32 d^2 and the same tie rule (lower slab position) in both
        require(bool(torch.equal(sq, sq_w)),
                f"knn_slab {name} sq: {int((sq != sq_w).sum())} entries not bit-equal")
        require(bool(torch.equal(idx, idx_w)),
                f"knn_slab {name} idx: {int((idx != idx_w).sum())} entries differ")
        errs[name] = float((sq - sq_w).abs().max())
        log(f"[kernels] knn_slab {name}: idx equal and sq bit-equal on all {n} x {k}")
    tm_ = timings(lambda: cuda_kernels.knn_slab(*args),
                  lambda: cuda_kernels.knn_slab_plain(*args), "knn_slab_kernel", 50, 3)
    exact_ms = device_ms(lambda: cuda_kernels.knn_slab(*exact), 10, "knn_slab_kernel")
    # the MIN_EIG path searches the source cloud's slabs too (its padding
    # queries all sit at one point)
    sp, sm = (torch.as_tensor(a, device=dev) for a in pad_points(source))
    sc, ns = sp - masked_mean(sp, sm), sp.shape[0]
    scidx, _excluded = select_candidate_tiles(
        sc.reshape(ns // 256, 256, 3), _masked_target(sc, sm).reshape(ns // 256, 256, 3), 16)
    sargs = (sc, torch.ones_like(sm), sc, sm, scidx, k, 256)
    source_ms = device_ms(lambda: cuda_kernels.knn_slab(*sargs), 20, "knn_slab_kernel")
    b_ms, b_by = bound_ms(n * 16 + n * 16 + Q * 16 * 4 + n * k * 8,
                          n * 16 * 256 * SLAB_OPS_PER_CANDIDATE)
    records.append(dict(
        name="knn_slab", route="cuda", source="fast_gicp_tpu_torch/csrc/knn_slab.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:227",
        max_abs_err=max(errs.values()),
        tolerance=f"idx equal, sq bit-equal (C = 16 x 256 and C = T = {n // 128} x 128; "
                  f"and on {edge_cases} edge cases with radius_count's)",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, candidates=n * 16 * 256,
        exact_search_ms=exact_ms, exact_candidates=n * n, source_cloud_ms=source_ms, **tm_))
    log(f"[kernels] knn_slab exact (all {n} targets a query, {n * n} candidates): "
        f"{exact_ms:.4f} ms; culled on the source cloud: {source_ms:.4f} ms")

    # -- radius_count / radius_window: the adaptive estimator's two passes
    r2 = torch.as_tensor(default_radius_ladder(), device=dev)
    c = masked_mean(tgt, tmask)
    cargs = (tgt, tmask, tgt, tmask, c, r2)
    cnt = cuda_kernels.radius_count(*cargs)
    cnt_w = cuda_kernels.radius_count_plain(*cargs)
    torch.cuda.synchronize()
    require(bool(torch.equal(cnt[:, tmask], cnt_w[:, tmask])),
            f"radius_count: {int((cnt != cnt_w)[:, tmask].sum())} valid entries differ")
    y = (tgt - c)[tmask]
    in_range = pairs_within(y, y, float(r2[-1]))
    packed = cuda_kernels.radius_inputs(tgt, tmask, tgt, tmask, c)  # as radius_window_moments
    visited = int(culled_tiles(packed.q4, packed.boxes, float(r2.max())).sum()) * 128 * 128
    # timed with the target's tile boxes, which the wrapper builds here
    tm_ = timings(lambda: cuda_kernels.radius_count(*cargs),
                  lambda: cuda_kernels.radius_count_plain(*cargs),
                  ("tile_bbox_kernel", "radius_count_kernel"), 50, 2)
    L = r2.numel()
    b_ms, b_by = bound_ms(n * 16 * 2 + L * 4 + L * n * 4,
                          in_range * count_ops_per_pair(L) + n * L)
    records.append(dict(
        name="radius_count", route="cuda", source="fast_gicp_tpu_torch/csrc/radius_window.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:609", max_abs_err=0.0,
        tolerance=f"counts equal on the valid queries (and on {edge_cases} edge cases with "
                  "knn_slab's)", bound_ms=b_ms, bound_by=b_by,
        library_ms=None, pairs_in_range=in_range, pairs_visited=visited, **tm_))
    log(f"[kernels] radius_count: counts equal on all {int(tmask.sum())} valid queries x "
        f"{r2.numel()} rungs; {in_range} pairs within the largest radius, {visited} "
        f"visited by the cull ({visited / in_range:.2f}x)")

    r2q = window_radii(cnt, r2, 20)
    wargs = (tgt, tmask, tgt, tmask, c, r2q)
    got = cuda_kernels.radius_window(*wargs, packed)
    again = cuda_kernels.radius_window(*wargs, packed)
    want = cuda_kernels.radius_window_plain(*wargs)
    torch.cuda.synchronize()
    require(bool(torch.equal(got[0, tmask], want[0, tmask])),
            f"radius_window n: {int((got[0] != want[0])[tmask].sum())} valid windows differ")
    # one warp a query, its lanes' sums by a fixed xor tree: no atomics
    require(bool(torch.equal(got, again)), "radius_window: a repeat launch differs")
    # rows 1-12 against each query's own largest |entry| (a near window's
    # sums are far smaller than a far one's); the reading against each
    # row's largest entry over all queries is logged beside it
    g, w = got[1:13, tmask], want[1:13, tmask]
    row_gap = float(((g - w).abs() / w.abs().amax(1, keepdim=True).clamp(min=1e-30)).max())
    scale = w.abs().amax(0, keepdim=True).clamp(min=1e-30)
    log(f"[kernels] radius_window rows 1-12: max diff / the query's largest entry "
        f"{float(((g - w).abs() / scale).max()):.3e}; / the row's largest entry {row_gap:.3e}")
    err = check_close("radius_window rows", g / scale, w / scale, 0.0, WINDOW_REL_TOL)
    window_cases = check_window_edge_cases(dev)
    in_window = pairs_within(y, y, r2q[tmask])
    visited = window_visited_pairs(packed.q4, packed.chunk_boxes, r2q, n)
    block_visited = block_window_visited_pairs(packed.q4, packed.boxes, r2q)
    # timed with the target's chunk boxes, which the wrapper builds here
    tm_ = timings(lambda: cuda_kernels.radius_window(*wargs),
                  lambda: cuda_kernels.radius_window_plain(*wargs),
                  ("chunk_bbox_kernel", "radius_window_kernel"), 50, 3)
    b_ms, b_by = bound_ms(n * 16 * 2 + n * 4 + n * 16 * 4, in_window * WINDOW_OPS_PER_PAIR)
    records.append(dict(
        name="radius_window", route="cuda", source="fast_gicp_tpu_torch/csrc/radius_window.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:629",
        max_abs_err=float((got - want)[:, tmask].abs().max()),
        tolerance=f"row 0 (n) equal; rows 1-12 within {WINDOW_REL_TOL:g} of the query's "
                  f"largest |entry| in them, on each valid query (and on {window_cases} edge "
                  "cases); a repeat launch bit-identical",
        rel_err=err, rel_err_row_scale=row_gap, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, pairs_in_window=in_window, pairs_visited=visited,
        pairs_visited_block_cull=block_visited, **tm_))
    log(f"[kernels] radius_window: n equal on all valid queries; rows max diff / the "
        f"query's scale {err:.3e}; {in_window} pairs in the windows, {visited} visited "
        f"({visited / in_window:.2f}x; the 128-query block cull's {block_visited})")
    for r in records:
        log(f"[kernels] {r['name']}: max_abs_diff {r['max_abs_err']:.3e} "
            f"({r['tolerance']}), {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"({r['timing']}); per call with the host's enqueue: "
            f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    return records


def ndt_dims(source, target):
    """Dense-grid dims over both clouds' extent at 1 m (NDTCuda._grid_dims)."""
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims_from_extent

    return auto_grid_dims_from_extent(np.minimum(source.min(0), target.min(0)),
                                      np.maximum(source.max(0), target.max(0)), 1.0)


def ndt_path_objectives(pair, device):
    """{mode: NdtObjective} of each NDT linearize mode's path at its full
    size, from `ndt_path_objective` on `device`: d2d / p2d
    `ndt_register_fresh`'s prepared per-cloud maps, d2d_raw / p2d_raw
    `ndt_align`'s raw target grid."""
    from fast_gicp_tpu_torch.models.ndt import ndt_path_objective
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    out = {}
    for mode in NDT_MODES:
        fresh = not mode.endswith("_raw")
        make = ndt_fresh_path if fresh else ndt_align_path
        cfg = make(mode[:3])(source, target).config
        obj, _c = ndt_path_objective(sp, sm, tp, tm, cfg, fresh=fresh, device=device)
        require(obj.mode == mode, f"ndt_path_objective gave mode {obj.mode} for {mode}")
        out[mode] = obj
    return out


def eager_pack(obj, x):
    """The frozen pack (L, 16) of the objective's voxels at pose x by the
    eager freeze: `cuda_ndt.ndt_freeze_pack` where the package looks the
    voxels up in the kernel, else the objective's own freeze (a package
    before the lookup form)."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    if hasattr(cuda_ndt, "ndt_freeze_pack"):
        return cuda_ndt.ndt_freeze_pack(obj.p, obj.mask, x, obj.vmap, obj.offsets, obj.mode)
    return obj.freeze(x)


def map_on(vmap, dev):
    """A voxel map (NamedTuple) with its tensors on `dev`."""
    return type(vmap)(*(t.to(dev) if isinstance(t, torch.Tensor) else t for t in vmap))


def objective_on(obj, dev):
    """An objective built on the CPU, rebuilt on `dev` from the same
    source columns, mask, map and offsets (so its voxels are the CPU
    build's, the same every run: the card's map builds sum with atomic
    scatter-adds, so their near-degenerate voxels, and with them the
    clamp's worst case, would change from run to run)."""
    from fast_gicp_tpu_torch.models.ndt import make_ndt_objective

    return make_ndt_objective(obj.p.T.to(dev), obj.mask.to(dev),
                              None if obj.ca is None else obj.ca.to(dev),
                              map_on(obj.vmap, dev), obj.offsets)


def ndt_first_packs(dev, pair, x):
    """For each NDT linearize mode, the pack form's inputs at its path's
    first linearization, at pose x: {mode: (p, ca or None, pack (L, 16))}
    on the card; p and ca the objective's source columns ((3, N) and
    (6, N), or tiled to L in a package before the lookup form).  The maps
    and the pack are built on the CPU (see objective_on)."""
    out = {}
    for mode, obj in ndt_path_objectives(pair, "cpu").items():
        out[mode] = tuple(None if t is None else t.to(dev)
                          for t in (obj.p, obj.ca, eager_pack(obj, x.cpu())))
    return out


def same_bits(got, want):
    """Whether two tuples of float32 tensors hold the same bits."""
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


NDT_LIN_KERNEL = "ndt_linearize_kernel<{d2d}, {raw}"  # the profiler's name, a prefix
NDT_ERROR_PATH_LANES = {"d2d": "D2D fresh", "d2d_raw": "D2D align", "p2d_raw": "P2D"}


# error_kernel<kCauchy, kTrial> of csrc/trial_error.cu by its template flags
ERROR_KERNELS = {("0", "0"): "error", ("1", "0"): "ndt_error", ("0", "1"): "lm_step_gicp",
                 ("1", "1"): "lm_step_ndt"}


# ndt_linearize_kernel<kD2D, kRaw, kForm> of csrc/ndt_linearize.cu by its
# mangled template arguments (a package before the lookup form: <kD2D, kRaw>
# alone)
NDT_LIN_MANGLED = re.compile(r"ndt_linearize_kernelILb(\d)ELb(\d)E(?:Li(\d)E)?E")


# linearize_kernel<kRaw, Id> of csrc/linearize.cu by its mangled template
# arguments (a package before the idx form: <kRaw> alone)
LIN_MANGLED = re.compile(r"16linearize_kernelILb(\d)E([ix])?E")


@functools.cache
def kernel_build_report():
    """{kernel: (registers, stack frame bytes)} of the GICP and NDT
    linearize kernels, the error kernels (trial off and on) and
    block_tridiag's factor and apply from the ptxas lines of the library's
    build log, each logged (once a process).
    linearize.cu's are named "linearize<i32>" (int32 ids or none),
    "linearize_raw<i64>" and so on, and a package before the idx form
    reports "linearize" and "linearize_raw"; a package before the merged error kernel reports its
    `ndt_error_kernel` as "ndt_error"."""
    from fast_gicp_tpu_torch.ops import _build

    def ndt_lin_name(m):
        base = ("ndt_" + ("d2d" if m.group(1) == "1" else "p2d")
                + ("_raw" if m.group(2) == "1" else ""))
        if m.group(3) is None:  # a package before the lookup form
            return base
        return f"{base}[{NDT_FORMS[int(m.group(3))]}]"

    def lin_name(m):
        base = "linearize_raw" if m.group(1) == "1" else "linearize"
        if m.group(2) is None:
            return base
        return f"{base}<{'i64' if m.group(2) == 'x' else 'i32'}>"

    report, name = {}, None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            lin = NDT_LIN_MANGLED.search(m.group(1))
            err = re.search(r"12error_kernelILb(\d)ELb(\d)E", m.group(1))
            gicp = LIN_MANGLED.search(m.group(1))
            tridiag = re.search(r"block_tridiag_(factor|apply)_kernel", m.group(1))
            name = (ndt_lin_name(lin) if lin else
                    ERROR_KERNELS[err.groups()] if err else
                    lin_name(gicp) if gicp else
                    "ndt_error" if "ndt_error_kernel" in m.group(1) else
                    f"block_tridiag_{tridiag.group(1)}" if tridiag else None)
            continue
        if name is None:
            continue
        stack = re.search(r"(\d+) bytes stack frame", line)
        regs = re.search(r"Used (\d+) registers", line)
        if stack:
            report[name] = (report.get(name, (None, None))[0], int(stack.group(1)))
        if regs:
            report[name] = (int(regs.group(1)), report[name][1])
    for k, (regs, stack) in sorted(report.items()):
        log(f"[build] {k}: {regs} registers, {stack} bytes stack frame")
    return report


def check_cos_bounded(dev):
    """`cos_bounded`, the d2d_raw / p2d_raw kernels' cosine, against cosf on
    every float with |a| < 105615 (2.4e9 of them): it must give the same bits."""
    from fast_gicp_tpu_torch.ops import _build

    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _build.function("fgt_cos_bounded_mismatches", (ctypes.c_void_p, ctypes.c_void_p))
    _build.check("fgt_cos_bounded_mismatches",
                 fn(bad.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    require(int(bad) == 0, f"cos_bounded differs from cosf on {int(bad)} floats")
    log("[kernels] cos_bounded equals cosf bit for bit on every float with |a| < 105615")


def check_ndt_edge_cases(dev, check_lin, x, x2):
    """d2d_raw and ndt_error against their plain versions on every case of
    `utils.synthetic.ndt_kernel_edge_cases` (L = 7,007, 91 and 1, every lane
    invalid, near-planar, coincident and empty voxels), d2d_raw's pack form
    on untiled source columns bit-equal to the tiled ones (the lane's
    offset by the multiply-high at N = 1,001, 13 and 1), ndt_error with its
    source columns untiled, tiled and tiled as lanes of their own; each
    bit-identical on a repeat launch."""
    from fast_gicp_tpu_torch.ops import cuda_ndt
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.ndt_kernel_edge_cases()
    for case in cases:
        name, k = f"edge case {case['name']}", case["offsets"]
        p, ca, pack = (torch.as_tensor(case[key], device=dev) for key in ("p", "ca", "pack"))
        pt, cat = p.repeat(1, k).contiguous(), ca.repeat(1, k).contiguous()
        got = check_lin(f"ndt_d2d_raw {name}", pt, cat, pack, "d2d_raw", 1e-4)
        untiled = cuda_ndt.ndt_linearize(p, ca, x, pack, 1.0, "d2d_raw")
        torch.cuda.synchronize()
        require(same_bits(untiled, got[:4]),
                f"ndt_d2d_raw {name}: untiled source columns differ from tiled ones")
        aux = got[3]
        want = cuda_ndt.ndt_error_plain(pt, aux, x2, 1.0)
        calls = {"untiled": (p, k), "tiled": (pt, k), "lanes": (pt, 1)}
        for how, (pp, kk) in calls.items():
            e = cuda_ndt.ndt_error(pp, aux, x2, 1.0, offsets=kk)
            again = cuda_ndt.ndt_error(pp, aux, x2, 1.0, offsets=kk)
            torch.cuda.synchronize()
            require(bool(torch.equal(e, again)), f"ndt_error {name} ({how}): repeat differs")
            if not bool(aux[6].any()):
                require(float(e) == 0.0 and float(want) == 0.0,
                        f"ndt_error {name} ({how}): all lanes invalid, got {float(e)}")
            else:
                check_close(f"ndt_error {name} ({how})", e, want, 1e-5, 0.0)
    log(f"[kernels] NDT edge cases: d2d_raw within tolerance and repeat-identical, "
        f"untiled bit-equal to tiled, ndt_error (untiled, tiled, tiled as lanes) within rtol 1e-5 and "
        f"repeat-identical on all {len(cases)} ({', '.join(c['name'] for c in cases)})")


NDT_INVERSE_OPS = 30  # a sym-6 adjugate inverse (P2D, on valid lanes)


def ndt_kernel_name(mode, form=None):
    """The profiler's name (a prefix) of the mode's linearize kernel, of
    every form or of one form (csrc/ndt_linearize.cu's template arguments)."""
    name = NDT_LIN_KERNEL.format(d2d=str(mode.startswith("d2d")).lower(),
                                 raw=str(mode.endswith("_raw")).lower())
    if form is None:
        return name
    return f"{name}, {NDT_FORMS.index(form)}>"


NDT_FORMS = ("pack", "lookup")


def ndt_lin_bytes(mode, form, N, L, rows=0, cells=0):
    """Bytes a linearize launch must move (each input once, each output
    once): the source columns once (12 B, 24 B of covariance for D2D, and
    1 B of mask for the lookup form), the target side (pack: a lane's data
    fields, 40 B finalized or 56 B raw; lookup: each of the `cells` grid
    entries (8 B) and `rows` table rows (the 40 B a row that the kernel
    uses) that its lanes name, once), aux 40 B a lane, the pose and the 43
    floats out."""
    d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
    src = N * (12 + (24 if d2d else 0) + (1 if form == "lookup" else 0))
    target = rows * 40 + cells * 8 if form == "lookup" else L * (56 if raw else 40)
    return src + target + L * 40 + 64 + 43 * 4


def ndt_lin_ops(mode, form, L, valid):
    """FP32 operations of a linearize launch with `valid` valid lanes of L:
    the transform, the weight and the 28 sums (and the lookup) on every
    lane; the raw finalize and clamp, D2D's rotation and inverse and P2D's
    inverse from a map on the valid lanes only, which the kernel skips
    elsewhere (the P2D pack form carries M)."""
    d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
    every = NDT_P2D_LINEARIZE_OPS + (NDT_LOOKUP_OPS if form == "lookup" else 0)
    inverse = mode == "p2d_raw" or (mode == "p2d" and form == "lookup")
    on_valid = ((NDT_RAW_OPS if raw else 0) + (NDT_D2D_M_OPS if d2d else 0)
                + (NDT_INVERSE_OPS if inverse else 0))
    return L * every + valid * on_valid


def lookup_footprint(cpu_obj, x):
    """(distinct table rows, distinct in-grid cells) that the lookup form's
    lanes name at pose x, from the lookup on the CPU."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    vmap = cpu_obj.vmap
    ids, q = cuda_ndt._lookup_plain(cpu_obj.p, x.cpu(), vmap, cpu_obj.offsets)
    r = [qa.reshape(-1).long() - int(o) for qa, o in zip(q, vmap.origin)]
    gx, gy, gz = vmap.dims
    inside = ((r[0] >= 0) & (r[0] < gx) & (r[1] >= 0) & (r[1] < gy)
              & (r[2] >= 0) & (r[2] < gz))
    cells = (r[0] * gy + r[1]) * gz + r[2]
    return int(torch.unique(ids).numel()), int(torch.unique(cells[inside]).numel())


def ndt_checkers(x, build_tol_log=True):
    """(check_aux, check_lin) of the NDT kernel checks: a pack-form launch
    against its plain version and a repeat launch."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    def check_aux(name, got, want, tol):
        # M relative to each lane's largest |M| entry (near-planar voxels
        # reach |M| ~ 1e3); valid exact; mu elementwise
        scale = want[:6].abs().amax(0).clamp(min=1e-30)
        rel = (got[:6] - want[:6]).abs() / scale
        if build_tol_log:
            log(f"[kernels] {name} aux M: max diff {float(rel.max()):.2e} of the lane's "
                f"largest |M|, {int((rel > 1e-5).sum())} of {rel.numel()} entries above 1e-5")
        err_m = check_close(f"{name} aux M", got[:6] / scale, want[:6] / scale, 0.0, tol)
        require(bool(torch.equal(got[6], want[6])), f"{name} aux valid differs")
        err_mu = check_close(f"{name} aux mu", got[7:10], want[7:10], 1e-6, 1e-6)
        return max(err_m, err_mu)

    def check_lin(name, p, ca, pack, mode, m_tol, at=None, res=1.0):
        at = x if at is None else at
        got = cuda_ndt.ndt_linearize(p, ca, at, pack, res, mode)
        again = cuda_ndt.ndt_linearize(p, ca, at, pack, res, mode)
        want = cuda_ndt.ndt_linearize_plain(p, ca, at, pack, cuda_ndt._c_sq(res), mode)
        torch.cuda.synchronize()
        require(same_bits(got, again), f"{name}: a repeat launch differs")
        require(bool(torch.equal(got[1], got[1].T)), f"{name}: H is not exactly symmetric")
        errs = [rel_to_max(f"{name} err", got[0].reshape(1), want[0].reshape(1), 1e-5),
                rel_to_max(f"{name} H", got[1], want[1], 1e-5),
                rel_to_max(f"{name} b", got[2], want[2], 1e-5),
                check_aux(name, got[3], want[3], m_tol)]
        return got + (max(errs),)

    return check_aux, check_lin


def check_forms(name, obj, cpu_obj, x, x2, check_lin, m_tol):
    """The lookup form (obj.linearize at x) and the frozen phase's form
    (obj.freeze at x, then obj.linearize_frozen at x2: the lookup form with
    x as its lookup pose) against the freeze-plus-pack form on the same
    rows, bit for bit, and each against a repeat launch.  The pack form is
    held to its plain version (check_lin, m_tol).  Returns (lookup form's
    outputs, pack form's max |diff| against the plain version, the number
    of row ids where the card's eager lookup differs from the CPU's)."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    res, mode = obj.vmap.resolution, obj.mode
    pack = eager_pack(cpu_obj, x.cpu()).to(x.device)
    want = check_lin(f"{name} pack form", obj.p, obj.ca, pack, mode, m_tol, at=x, res=res)
    look, again = obj.linearize(x), obj.linearize(x)
    frozen = obj.freeze(x)
    fro, fro_again = obj.linearize_frozen(x2, frozen), obj.linearize_frozen(x2, frozen)
    pack_x2 = cuda_ndt.ndt_linearize(obj.p, obj.ca, x2, pack, res, mode)
    torch.cuda.synchronize()
    require(same_bits(look, again), f"{name} lookup form: a repeat launch differs")
    require(same_bits(look, want[:4]), f"{name}: the lookup form differs from the "
            f"freeze-plus-pack form")
    require(same_bits(fro, fro_again), f"{name} frozen lookup form: a repeat launch differs")
    require(same_bits(fro, pack_x2), f"{name}: the lookup form with another lookup pose "
            f"differs from the pack frozen at that pose")
    ids_cpu = cuda_ndt._lookup_plain(cpu_obj.p, x.cpu(), cpu_obj.vmap, cpu_obj.offsets)[0]
    ids_card = cuda_ndt._lookup_plain(obj.p, x, obj.vmap, obj.offsets)[0]
    return look, want[4], int((ids_card.cpu() != ids_cpu).sum())


def check_ndt_lookup_edge_cases(dev, check_lin, x2):
    """check_forms on every scene of `utils.synthetic.ndt_lookup_edge_cases`
    (a grid exactly the target's extent with negative coordinates, voxels
    on its first cell and its last index on each axis, voxels of 6 and 7
    points, a near-planar voxel, empty cells, sources outside the grid,
    masked and zero-padded sources; 1 m and 0.3 m voxels, the latter with
    sources on voxel faces), in all four modes (maps built on the CPU),
    at the identity and at a small pose.  The card's eager lookup
    (`voxelmap.voxel_coord`, a true division by a float32 tensor of the
    resolution) must bin every point as the kernel and the CPU do, face
    points of the 0.3 m scene included: the ids that differ are counted,
    logged and required to be 0."""
    from fast_gicp_tpu_torch.models.ndt import make_ndt_objective
    from fast_gicp_tpu_torch.ops import soa
    from fast_gicp_tpu_torch.ops.voxelmap import (
        build_ndt_grid_compact, build_ndt_raw_grid, neighbor_offsets,
    )
    from fast_gicp_tpu_torch.utils import synthetic

    cases = synthetic.ndt_lookup_edge_cases()
    x_small = torch.as_tensor(synthetic._small_pose(np.random.default_rng(3)), device=dev)
    eager_differs = {}
    for case in cases:
        tgt, tm = torch.as_tensor(case["target"]), torch.as_tensor(case["tmask"])
        res, dims = case["resolution"], case["dims"]
        maps = {True: build_ndt_raw_grid(tgt, tm, res, dims),
                False: build_ndt_grid_compact(tgt, tm, res, dims, budget=64)[0]}
        src, sm = torch.as_tensor(case["source"]), torch.as_tensor(case["smask"])
        covs = soa.sym_cols_from_covs(torch.as_tensor(case["covs"]))
        for mode in NDT_MODES:
            d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
            oc = make_ndt_objective(src, sm, covs if d2d else None, maps[raw],
                                    neighbor_offsets("direct7"))
            obj = objective_on(oc, dev)
            for pose, xn in (("identity", torch.eye(4, device=dev)), ("small pose", x_small)):
                name = f"ndt_{mode} lookup edge case {case['name']} at the {pose}"
                look, _err, differ = check_forms(name, obj, oc, xn, x2, check_lin,
                                                 1e-4 if raw else 1e-5)
                eager_differs.setdefault(mode, {})[f"{case['name']} at the {pose}"] = differ
                valid = look[3][6]
                require(bool(valid.any()) and not bool(valid.all()),
                        f"{name}: expected valid and invalid lanes")
    log(f"[kernels] NDT lookup edge cases: the lookup form, at one pose and with "
        f"another lookup pose, bit-equal to the freeze-plus-pack form and "
        f"repeat-identical on all {len(cases)} scenes x 4 modes x 2 poses "
        f"({', '.join(c['name'] for c in cases)}); ids where the card's eager lookup "
        f"differs: {eager_differs}")
    require(all(n == 0 for by_case in eager_differs.values() for n in by_case.values()),
            f"NDT lookup edge cases: the card's eager lookup bins ids elsewhere than the "
            f"CPU: {eager_differs}")
    return eager_differs


def check_ndt_two_phase(dev, pair):
    """D2D align's two-phase solve (refresh_iterations=3, `ndt_align`'s
    config) on the card from the CPU-built objective: the lookup form, and
    in the frozen phase the lookup form at the phase-1 pose, against the same
    solve with the eager freeze into a pack and the pack form everywhere
    (the freeze before the lookup form); the same pose and iterations, bit
    for bit."""
    from fast_gicp_tpu_torch.models import ndt
    from fast_gicp_tpu_torch.ops import cuda_ndt

    oc = ndt_path_objectives(pair, "cpu")["d2d_raw"]
    obj = objective_on(oc, dev)
    cfg = ndt_align_path("d2d")(*pair[:2]).config

    def freeze(x):
        return eager_pack(obj, x)

    def frozen(x, pack):
        return cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack, obj.vmap.resolution, obj.mode)

    eager = obj._replace(linearize=lambda x: frozen(x, freeze(x)), freeze=freeze,
                         linearize_frozen=frozen)
    x0 = torch.eye(4, device=dev)
    got, want = (ndt._two_phase_solve(o, x0, cfg) for o in (obj, eager))
    require(bool(torch.equal(got.transformation, want.transformation))
            and int(got.iterations) == int(want.iterations),
            f"D2D align two-phase: the lookup form ends at another pose than the "
            f"freeze-plus-pack form ({int(got.iterations)}, {int(want.iterations)} "
            f"iterations)")
    log(f"[kernels] D2D align two-phase solve on the CPU-built maps: the lookup form "
        f"bit-equal to the freeze-plus-pack form ({int(got.iterations)} iterations)")


def phase_ndt_kernels(dev, pair):
    """The four NDT linearize modes and the NDT error kernel against their
    plain versions, at the shapes their paths give them on the full-size
    pair (the error kernel at each path's lane count), each bit-identical on
    a repeat launch; each mode's lookup form, at one pose and with another
    lookup pose, bit for bit against the freeze-plus-pack form; the lookup
    form on source columns tiled over the
    offsets against the untiled ones it reads on the paths; D2D align's
    two-phase solve; the NDT edge cases; cos_bounded against cosf; the NDT
    kernels' registers and stack frames."""
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.ops import cuda_ndt

    x = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005], device=dev))
    x2 = se3.se3_exp(torch.tensor([-0.001, 0.002, 0.0, 0.01, 0.02, -0.02], device=dev))
    c_sq = 1.0
    records = []
    build = kernel_build_report()
    _check_aux, check_lin = ndt_checkers(x)

    cpu_objs = ndt_path_objectives(pair, "cpu")
    auxes, objs = {}, {}
    for mode, oc in cpu_objs.items():
        obj = objs[mode] = objective_on(oc, dev)
        d2d, raw = mode.startswith("d2d"), mode.endswith("_raw")
        N, K = obj.p.shape[1], len(obj.offsets)
        L = N * K
        # M of a raw pack goes through the eigenvalue clamp and the inverse of
        # a near-planar voxel's covariance, which magnify a last-bit difference
        # of acosf / cosf between the kernel and torch's ops: 2.46e-5 of the
        # lane's largest |M| on 244 of the 946,176 P2D entries on these
        # CPU-built inputs, up to 4.75e-5 on card-built maps (H100, full-size
        # pair).  A wrong clamp moves M by O(1) of it.
        m_tol = 1e-4 if raw else 1e-5
        look, max_err, _differ = check_forms(f"ndt_{mode}", obj, oc, x, x2, check_lin, m_tol)
        auxes[mode] = look[3]
        valid = int(look[3][6].sum())
        valid_share = valid / L
        args = (obj.p, obj.ca, obj.mask, x, obj.vmap, obj.offsets, mode)
        pt = obj.p.repeat(1, K).contiguous()
        cat = None if obj.ca is None else obj.ca.repeat(1, K).contiguous()
        tiled_args = (pt, cat) + args[2:]
        tiled = cuda_ndt.ndt_linearize_lookup(*tiled_args)
        torch.cuda.synchronize()
        require(same_bits(tiled, look), f"ndt_{mode}: tiled source columns differ")

        plain_pack = lambda: cuda_ndt.ndt_freeze_pack(  # noqa: E731
            obj.p, obj.mask, x, obj.vmap, obj.offsets, mode)
        pack_dev = plain_pack()
        tm_ = timings(lambda: obj.linearize(x),
                      lambda: cuda_ndt.ndt_linearize_plain(obj.p, obj.ca, x, plain_pack(),
                                                           c_sq, mode),
                      ndt_kernel_name(mode, "lookup"), 200, 20)
        frozen = obj.freeze(x)
        extra = dict(
            pack_ms=device_ms(lambda: cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack_dev, 1.0,
                                                             mode), 200,
                              ndt_kernel_name(mode, "pack")),
            frozen_ms=device_ms(lambda: obj.linearize_frozen(x2, frozen), 200,
                                ndt_kernel_name(mode, "lookup")),
            tiled_ms=device_ms(lambda: cuda_ndt.ndt_linearize_lookup(*tiled_args), 200,
                               ndt_kernel_name(mode, "lookup")),
            pose_to_normal_eq_ms=device_ms(lambda: obj.linearize(x), 200),
            eager_pose_to_normal_eq_ms=device_ms(
                lambda: cuda_ndt.ndt_linearize(obj.p, obj.ca, x, plain_pack(), 1.0, mode),
                200),
            valid_share=valid_share)
        rows, cells = lookup_footprint(oc, x)
        nbytes = ndt_lin_bytes(mode, "lookup", N, L, rows, cells)
        b_ms, b_by = bound_ms(nbytes, ndt_lin_ops(mode, "lookup", L, valid))
        pack_bytes = ndt_lin_bytes(mode, "pack", N, L)
        regs, stack = build.get(f"ndt_{mode}[lookup]", (None, None))
        records.append(dict(
            name=f"ndt_{mode}", route="cuda",
            source="fast_gicp_tpu_torch/csrc/ndt_linearize.cu",
            replaces="fast_gicp_tpu/ops/pallas_linearize.py:"
                     + {"d2d": "330", "p2d": "347", "d2d_raw": "492", "p2d_raw": "507"}[mode],
            max_abs_err=max_err,
            tolerance=f"the lookup form, at one pose and with another lookup pose, bit-equal "
                      f"to the freeze-plus-pack form; "
                      f"the pack form against the plain version: err, H, b within 1e-5 of "
                      f"their largest entry, aux M within {m_tol} of each lane's largest "
                      f"|M|, valid equal, mu rtol 1e-6 atol 1e-6; a repeat launch "
                      f"bit-identical",
            bound_ms=b_ms, bound_by=b_by, library_ms=None, lanes=L, bytes=nbytes,
            unique_rows=rows, unique_cells=cells,
            pack_bound_ms=bound_ms(pack_bytes, ndt_lin_ops(mode, "pack", L, valid))[0],
            registers=regs, stack_bytes=stack,
            form_registers={f: build.get(f"ndt_{mode}[{f}]") for f in NDT_FORMS},
            **tm_, **extra))
        log(f"[kernels] ndt_{mode} at L = {L}: valid lanes {100 * valid_share:.2f}%; lookup "
            f"{tm_['ms']:.5f} ms (tiled {extra['tiled_ms']:.5f}), with another lookup pose "
            f"{extra['frozen_ms']:.5f}, "
            f"pack {extra['pack_ms']:.5f}; pose to [err, H, b], all device ops: "
            f"{extra['pose_to_normal_eq_ms']:.5f} ms (eager freeze + pack form "
            f"{extra['eager_pose_to_normal_eq_ms']:.5f})")

    # the error kernel at each path's lane count (28,672 on D2D fresh, 57,344
    # on D2D align, 157,696 on P2D), as the NDT objective calls it: the
    # untiled source columns, offsets = 7
    by_lanes = {}
    for mode, path in NDT_ERROR_PATH_LANES.items():
        p, aux = objs[mode].p, auxes[mode]
        L = aux.shape[1]
        e_got = cuda_ndt.ndt_error(p, aux, x2, 1.0, offsets=NDT_OFFSETS)
        e_again = cuda_ndt.ndt_error(p, aux, x2, 1.0, offsets=NDT_OFFSETS)
        e_want = cuda_ndt.ndt_error_plain(p.repeat(1, NDT_OFFSETS), aux, x2, c_sq)
        torch.cuda.synchronize()
        require(bool(torch.equal(e_got, e_again)), f"ndt_error at L = {L}: repeat differs")
        e_err = check_close(f"ndt_error at L = {L}", e_got, e_want, 1e-5, 0.0)
        tm_ = timings(lambda: cuda_ndt.ndt_error(p, aux, x2, 1.0, offsets=NDT_OFFSETS),
                      lambda: cuda_ndt.ndt_error_plain(p.repeat(1, NDT_OFFSETS), aux, x2,
                                                       c_sq),
                      "error_kernel", 200, 20)
        nbytes = L // NDT_OFFSETS * 12 + L * 40 + 64 + 4
        b_ms, b_by = bound_ms(nbytes, L * NDT_ERROR_OPS)
        by_lanes[L] = dict(path=path, max_abs_err=e_err, bound_ms=b_ms, bound_by=b_by,
                           bytes=nbytes, **tm_)
    L = auxes["p2d_raw"].shape[1]  # the record reads P2D's, the most launches
    regs, stack = build.get("ndt_error", (None, None))
    records.append(dict(
        name="ndt_error", route="cuda", source="fast_gicp_tpu_torch/csrc/ndt_linearize.cu",
        replaces="fast_gicp_tpu/ops/pallas_linearize.py:580",
        tolerance="rtol 1e-5; a repeat launch bit-identical", library_ms=None, lanes=L,
        registers=regs, stack_bytes=stack,
        by_lanes={n: {k: v for k, v in r.items() if k in ("path", "ms", "plain_ms",
                                                          "bound_ms", "call_ms")}
                  for n, r in by_lanes.items()},
        **{k: v for k, v in by_lanes[L].items() if k != "path"}))
    check_cos_bounded(dev)
    check_ndt_two_phase(dev, pair)
    check_ndt_edge_cases(dev, check_lin, x, x2)
    differ = check_ndt_lookup_edge_cases(dev, check_lin, x2)
    for r in records:
        if r["name"].startswith("ndt_") and r["name"] != "ndt_error":
            r["edge_cases"] = {"lookup_eager_ids_differ": differ[r["name"][4:]]}
    for r in records:
        log(f"[kernels] {r['name']} at L = {r['lanes']}: max_abs_diff "
            f"{r['max_abs_err']:.3e} ({r['tolerance']}), {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms ({r['timing']}); per call with the host's enqueue: "
            f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.3e} ms ({r['bound_by']}, {r['bytes']} bytes); "
            f"{r['registers']} registers, {r['stack_bytes']} bytes stack frame")
    for n, r in sorted(by_lanes.items()):
        log(f"[kernels] ndt_error at L = {n} ({r['path']}): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    return records


def ndt_timing(dev, pair):
    """Device time of the NDT linearizes of whichever package is imported,
    on objectives `ndt_path_objective` builds on the card at each mode's
    path: the pack form's launch on the eager freeze's pack (the same work
    in every package), `obj.linearize(x)` (its kernel, and all its device
    ops: pose to [err, H, b]), the freeze alone (all device ops) and the
    frozen linearization's kernel; with the lookup form also the pack form
    on untiled and the lookup form on tiled source columns; ndt_error at each NDT
    path's lane count; D2D align's t_err over five registrations.  No
    checks.  Run by `--ndt-timing DIR` to time another checkout (an earlier design)
    in the same call as this one."""
    import inspect

    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.ops import cuda_ndt

    x = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005], device=dev))
    x2 = se3.se3_exp(torch.tensor([-0.001, 0.002, 0.0, 0.01, 0.02, -0.02], device=dev))
    kw = ({"offsets": NDT_OFFSETS}
          if "offsets" in inspect.signature(cuda_ndt.ndt_error).parameters else {})
    lookup_form = hasattr(cuda_ndt, "ndt_linearize_lookup")
    out, auxes = {"registers": kernel_build_report(), "lookup_form": lookup_form}, {}
    objs = ndt_path_objectives(pair, dev)
    for mode, obj in objs.items():
        name = ndt_kernel_name(mode)
        pack = eager_pack(obj, x)
        frozen = obj.freeze(x)
        K = pack.shape[0] // obj.p.shape[1]
        # the pack form on the source columns tiled over the offsets, as every
        # package takes them
        tiled = (obj.p.repeat(1, K).contiguous(),
                 None if obj.ca is None else obj.ca.repeat(1, K).contiguous())
        row = {"lanes": pack.shape[0],
               "pack_kernel_ms": device_ms(
                   lambda: cuda_ndt.ndt_linearize(*tiled, x, pack, 1.0, mode), 200, name),
               "linearize_device_ops": device_ops(lambda: obj.linearize(x), 50),
               "freeze_device_ops": device_ops(lambda: obj.freeze(x), 50),
               "linearize_kernel_ms": device_ms(lambda: obj.linearize(x), 200, name),
               "pose_to_normal_eq_ms": device_ms(lambda: obj.linearize(x), 200),
               "freeze_ops_ms": device_ms(lambda: obj.freeze(x), 200),
               "frozen_kernel_ms": device_ms(lambda: obj.linearize_frozen(x2, frozen), 200,
                                             name)}
        if lookup_form:
            args = (obj.p, obj.ca, obj.mask, x, obj.vmap, obj.offsets, mode)
            row.update(
                pack_untiled_kernel_ms=device_ms(
                    lambda: cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack, 1.0, mode), 200,
                    name),
                tiled_kernel_ms=device_ms(
                    lambda: cuda_ndt.ndt_linearize_lookup(*tiled, *args[2:]), 200, name))
        auxes[mode] = obj.linearize(x)[3]
        row["valid_share"] = float(auxes[mode][6].mean())
        out[f"ndt_{mode}"] = row
    for mode in NDT_ERROR_PATH_LANES:
        p, aux = objs[mode].p, auxes[mode]
        out[f"ndt_error_L{aux.shape[1]}"] = device_ms(
            lambda: cuda_ndt.ndt_error(p, aux, x2, 1.0, **kw), 200, "error_kernel")
    # t_err of D2D align over repeated registrations: the card's map builds
    # sum with atomic scatter-adds, so the pose may move from run to run
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    inputs = [torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm)]
    register = ndt_align_path("d2d")(source, target).register
    out["ndt_d2d_align_t_err_mm"] = [
        1e3 * pose_errors(register(*inputs, torch.eye(4, device=dev), dev)
                          .transformation.cpu().numpy().astype(np.float64), gt)[0]
        for _ in range(5)]
    return out


def lin_inputs(dev, pair):
    """The GICP and VGICP linearizes' inputs at the first linearization
    (pose I, the target-centroid frame) on the full-size pair, made with
    functions that every package since the first slice has, so that two
    checkouts get the same bits: seeded SPD covariances (numpy), GICP's
    row table and its nn_search ids (int32; the kernel is bit-equal), the
    VGICP raw grid and its row ids (int64) built on the CPU.
    {"linearize": (P, CA, table, valid, ids), "linearize_raw": (...)}."""
    from fast_gicp_tpu_torch.ops import soa
    from fast_gicp_tpu_torch.ops.covariance import masked_mean
    from fast_gicp_tpu_torch.ops.neighbors import nn_search
    from fast_gicp_tpu_torch.ops.voxelmap import (
        _lookup_ids, auto_grid_dims, build_raw_grid, voxel_coord,
    )
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    rng = np.random.default_rng(0)

    def spd_cols(n):
        A = rng.normal(size=(n, 3, 3))
        C = A @ np.swapaxes(A, 1, 2) * 0.01 + 0.001 * np.eye(3)
        return torch.as_tensor(C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].T.astype(np.float32))

    scov, tcov = spd_cols(len(sp)).contiguous(), spd_cols(len(tp)).contiguous()
    src, smask, tgt, tmask = (torch.as_tensor(a) for a in (sp, sm, tp, tm))
    c = masked_mean(tgt, tmask)
    src_c, tgt_c = src - c, tgt - c
    P = src_c.T.contiguous()
    valid = smask.to(torch.float32)
    nt = tgt_c.shape[0]
    table = torch.cat([tgt_c, soa.sym_cols_to_rows9(tcov), torch.ones((nt, 1)),
                       torch.zeros((nt, 3))], dim=1)
    idx, _d2 = nn_search(src_c.to(dev), tgt_c.to(dev), tmask.to(dev), smask.to(dev))
    dims = auto_grid_dims(target, 1.0)
    vmap = build_raw_grid(tgt_c, tmask, 1.0, tcov, dims)
    coords = voxel_coord(P, 1.0)
    ids = _lookup_ids(vmap.grid, vmap.origin, dims, vmap.rows.shape[0] - 1, *coords)
    on = lambda *ts: tuple(t.to(dev).contiguous() for t in ts)  # noqa: E731
    return {"linearize": on(P, scov, table, valid) + (idx,),
            "linearize_raw": on(P, scov, vmap.rows, valid, ids)}


def lin_timing(dev, pair):
    """Device time of the GICP and VGICP linearizes and the four NDT
    linearizes of whichever package is imported, on inputs that do not
    depend on the package (lin_inputs, ndt_first_packs), and digests of
    their outputs; no checks.  Each GICP kernel: its launch on gathered
    rows (the form every package takes) and the device ops from ids to the
    normal equations: table[ids] (after ids.long(), int32 ids) and that
    launch, and the idx form's launch where the package has it.  Each NDT
    mode: its launch, and all its call's device ops.  Digests (sha256 of
    the float32 bytes): the GICP kernels' aux, the NDT modes' [err, H, b].
    Run by `--lin-timing DIR` to time another checkout in the same call as
    this one; `--lin-timing DIR REF` also compares the digests with REF, the
    JSON line such a run printed."""
    import hashlib
    import inspect

    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.ops import cuda_linearize, cuda_ndt

    def digest(*ts):
        return hashlib.sha256(b"".join(t.detach().reshape(-1).cpu().numpy().tobytes()
                                       for t in ts)).hexdigest()

    out = {"registers": kernel_build_report()}
    x = torch.eye(4, device=dev)
    for name, (P, CA, table, valid, ids) in lin_inputs(dev, pair).items():
        fn = getattr(cuda_linearize, name)
        rows = table[ids.long()]
        kname = LIN_KERNEL.format(raw=str(name == "linearize_raw").lower())
        row = {"lanes": P.shape[1],
               "kernel_ms": device_ms(lambda: fn(P, CA, x, rows, valid), 200, kname),
               "gather_and_call_ops_ms": device_ms(
                   lambda: fn(P, CA, x, table[ids.long()], valid), 200),
               "aux_sha256": digest(fn(P, CA, x, rows, valid)[3])}
        if "idx" in inspect.signature(fn).parameters:
            row["idx_kernel_ms"] = device_ms(lambda: fn(P, CA, x, table, valid, ids), 200,
                                             kname)
            row["idx_call_ops_ms"] = device_ms(lambda: fn(P, CA, x, table, valid, ids), 200)
        out[name] = row
    xn = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005], device=dev))
    for mode, (p, ca, pack) in ndt_first_packs(dev, pair, xn).items():
        name = NDT_LIN_KERNEL.format(d2d=str(mode.startswith("d2d")).lower(),
                                     raw=str(mode.endswith("_raw")).lower())
        call = lambda: cuda_ndt.ndt_linearize(p, ca, xn, pack, 1.0, mode)  # noqa: E731
        err, H, b, _aux = call()
        out[f"ndt_{mode}"] = {"lanes": p.shape[1], "kernel_ms": device_ms(call, 200, name),
                              "call_ops_ms": device_ms(call, 200),
                              "normal_eq_sha256": digest(err.reshape(1), H, b)}
    return out


def compare_digests(result, ref_path):
    """{output: equal} of every digest in a lin_timing result against the
    JSON line (`{"lin_timing": {...}}`) in ref_path."""
    ref = json.loads(pathlib.Path(ref_path).read_text().strip().splitlines()[-1])
    ref = ref["lin_timing"]
    return {f"{k}.{d}": v[d] == ref[k][d] for k, v in result.items() if k != "registers"
            for d in v if d.endswith("sha256")}


TRIAL_FLOATS = 98  # the trial step reads 59 floats (H, b, lambda, x) and writes 39
TRIAL_SWEEP = 24  # sweep points a path, besides the first-trial, NaN and ragged ones


def trial_inputs(dev, pair):
    """{path: (y0, H, b, aux, cost, n_src)} at the first linearization
    (pose I, the target-centroid frame) of VGICP (22,528 lanes), GICP
    (22,528), NDT D2D fresh (7 x 4,096) and P2D fresh (7 x 22,528) on the
    full-size pair, and, in a package with the class API, of FastVGICP's
    hash map (22,528) and sparse grid map (DIRECT7, 7 x 22,528 lanes with
    misses), and, in a package with NDTCuda, of the paths of
    `new_path_trial_inputs`, as each path's objective builds them on the
    card; `cost` is the objective's error (a TrialCost in this package, a
    closure in packages before it), `n_src` the source columns the lanes
    read."""
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, make_gicp_objective
    from fast_gicp_tpu_torch.models.ndt import ndt_path_objective
    from fast_gicp_tpu_torch.models import vgicp as vgicp_module
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, make_vgicp_objective
    from fast_gicp_tpu_torch.ops.covariance import (
        knn_covariance_cols, masked_mean, rbf_covariance_cols,
    )
    from fast_gicp_tpu_torch.ops.voxelmap import (
        auto_grid_dims, build_raw_grid, neighbor_offsets,
    )
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    src, smask, tgt, tmask = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    c = masked_mean(tgt, tmask)
    x = torch.eye(4, device=dev)
    out = {}
    dims = auto_grid_dims(target, 1.0)
    vmap = build_raw_grid(tgt - c, tmask, 1.0, rbf_covariance_cols(tgt - c, tmask), dims)
    lin, cost, _f, _lf = make_vgicp_objective(
        src - c, smask, rbf_covariance_cols(src - c, smask), vmap, neighbor_offsets("direct1"),
        VGICPConfig(grid_dims=dims, refresh_iterations=2))
    N = src.shape[0]
    out["vgicp_register"] = lin(x) + (cost, N)
    scov, tcov = knn_covariance_cols(src, smask), knn_covariance_cols(tgt, tmask)
    lin, cost = make_gicp_objective(src - c, smask, scov, tgt - c, tmask, tcov, GICPConfig())
    out["gicp_register_fresh"] = lin(x) + (cost, N)
    for path in ("ndt_d2d_fresh", "ndt_p2d_fresh"):
        cfg = PATHS[path][0](source, target).config
        obj, _c = ndt_path_objective(sp, sm, tp, tm, cfg, fresh=True, device=dev)
        y0, H, b, aux = obj.linearize(x)
        out[path] = (y0, H, b, aux, obj.error, aux.shape[1] // obj.error.offsets)
    if hasattr(vgicp_module, "FastVGICP"):
        for name, (_m, _o, (lin, cost, _f, _lf), src_c, _sm, _sc) in (
                class_map_objectives(dev, pair, scov, tcov).items()):
            out[CLASS_MAP_PATHS[name]] = lin(x) + (cost, src_c.shape[0])
    from fast_gicp_tpu_torch.models import ndt as ndt_module

    if hasattr(ndt_module, "NDTCuda"):
        out.update(new_path_trial_inputs(dev, pair))
    return out


def ragged(aux, cost):
    """The same objective cut to a lane count that is no multiple of 4 (the
    kernel's lane-by-lane path): GICP form L - 3 lanes; NDT form N - 1
    sources a offset, every offset block cut alike."""
    L = aux.shape[1]
    if cost.resolution is None:
        n = L - 3
        return aux[:, :n].contiguous(), cost._replace(p=cost.p[:, :n].contiguous())
    k = cost.offsets
    N = L // k
    aux = aux.reshape(10, k, N)[:, :, :N - 1].reshape(10, -1).contiguous()
    return aux, cost._replace(p=cost.p[:, :N - 1].contiguous())


def check_schedule_traps(dev):
    """The ATen behaviour the trial kernel's schedule copies, checked on the
    card: a float32 CUDA tensor divided by a Python float eps (the
    convergence test's epsilons) is its product with f32(1 / eps), the
    reciprocal taken in double (on 2^20 random floats in [0, 4 eps) and on
    67,109 floats whose exact product is a tie between two floats); a
    Python float times a tensor is the product with its float32 rounding
    (the lambda init); `u ** 3` is u * u * u; clamp keeps NaN.  Returns how
    many quotients a float32 division by f32(eps) would have rounded
    otherwise, and how many the product with the float32 reciprocal of
    f32(eps) would."""
    from fast_gicp_tpu_torch.ops import cuda_solver
    from fast_gicp_tpu_torch.solver import LsqConfig

    g = torch.Generator(device=dev).manual_seed(0)
    # q 2^-20 with q odd and 125 q in [2^24, 2^25): q 2^-20 x 500 (or 2,000)
    # is 125 q times a power of two, a 25-bit odd number: a tie
    ties = torch.arange(134219, 268436, 2, device=dev, dtype=torch.float64) * 2.0 ** -20
    epsilons = (LsqConfig().rotation_epsilon, LsqConfig().transformation_epsilon)
    differ = {}
    for eps in epsilons:
        v = torch.cat([torch.rand(1 << 20, device=dev, generator=g) * 4 * eps,
                       ties.float()])
        by_scalar = v / eps
        require(torch.equal(by_scalar, v * cuda_solver._inverse_f32(eps)),
                f"tensor / {eps} is not its product with f32(1 / {eps})")
        differ[eps] = (int((by_scalar != v / torch.tensor(eps, device=dev)).sum()),
                       int((by_scalar != v * float(np.float32(1) / np.float32(eps))).sum()))
    t = torch.rand(1 << 20, device=dev, generator=g) * 1e4
    require(torch.equal(1e-9 * t, t * torch.tensor(np.float32(1e-9), device=dev)),
            "1e-9 * tensor is not the product with f32(1e-9)")
    u = torch.randn(1 << 20, device=dev, generator=g)
    require(torch.equal(u ** 3, u * u * u), "u ** 3 is not u * u * u")
    require(bool(torch.isnan(torch.clamp(torch.tensor(float("nan"), device=dev),
                                         min=1.0 / 3.0))), "clamp drops NaN")
    log(f"[trial] ATen on the card: tensor / eps == tensor * f32(1 / eps) for eps in "
        f"{epsilons} on 2^20 random floats and 67,109 ties (a float32 division by "
        f"f32(eps), and a product with 1 / f32(eps), would differ on {differ}); 1e-9 * t == "
        f"t * f32(1e-9); u ** 3 == u * u * u; clamp keeps NaN")
    return differ


def trial_sweeps(dev, inputs):
    """The LM trial launch (`cuda_solver.lm_step`) at each of `inputs`'
    first linearizations ({path: (y0, H, b, aux, cost, n_src)}):
    1. bit for bit against the unfused trial (the standalone `lm_trial`
       launch, the trial-off error launch, the eager schedule:
       `lm_step_plain` on the card) on a seeded sweep of lambda, trial poses
       and rho (y0 set from the trial's own error and denominator), with
       first trials, a NaN error and a ragged lane count: every float of the
       state (x, lambda, nu, the flags, xi, delta, d, denom, yi, the lambda
       used);
    2. within today's tolerances of its plain twin (`lm_trial_plain`, the
       plain cost, the eager schedule);
    3. a repeat launch bit-identical;
    then times the trial launch, the trial-off error launch and the
    standalone `lm_trial` at each path's lanes.  The sweep must hit accept,
    accept at the 1/3 clamp, reject, conv_reject, a NaN yi, a first trial
    and a ragged L."""
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.ops import cuda_solver as cs
    from fast_gicp_tpu_torch.solver import LsqConfig

    cfg = LsqConfig()
    hits = dict.fromkeys(("accept", "accept_clamp", "reject", "conv_reject", "nan_yi",
                          "first", "ragged"), 0)
    points, max_err = 0, 0.0

    def plain_trial(H, b, lam, x):
        return cs.lm_trial_plain(H, b, lam.reshape(()), x)

    def run_point(init, H, b, y0, aux, cost, first):
        """(fused state, unfused state); checks 1-3 on one point."""
        nonlocal points, max_err
        fused, again, unfused, plain = (init.clone() for _ in range(4))
        cs.lm_step(fused, H, b, y0, aux, cost, first, cfg)
        cs.lm_step(again, H, b, y0, aux, cost, first, cfg)
        cs.lm_step_plain(unfused, H, b, y0, aux, cost, first, cfg)
        cs.lm_step_plain(plain, H, b, y0, aux, cost.plain, first, cfg, trial=plain_trial)
        torch.cuda.synchronize()
        bits = (fused.view(torch.int32), unfused.view(torch.int32))
        require(torch.equal(*bits), f"trial launch differs from the unfused trial in "
                f"{int((bits[0] != bits[1]).sum())} state floats: "
                f"{fused.tolist()} vs {unfused.tolist()}")
        require(torch.equal(fused.view(torch.int32), again.view(torch.int32)),
                "a repeat trial launch differs")
        if not bool(torch.isnan(fused[cs.STATE_YI])):
            max_err = max(
                max_err,
                check_close("trial d", fused[cs.STATE_D], plain[cs.STATE_D], 1e-5, 1e-7),
                check_close("trial delta", fused[cs.STATE_DELTA], plain[cs.STATE_DELTA], 1e-5,
                            1e-6),
                check_close("trial xi", fused[cs.STATE_XI], plain[cs.STATE_XI], 1e-5, 1e-6),
                check_close("trial denom", fused[cs.STATE_DENOM], plain[cs.STATE_DENOM], 1e-4,
                            1e-10),
                check_close("trial yi", fused[cs.STATE_YI], plain[cs.STATE_YI], 1e-4, 0.0))
        points += 1
        return fused

    def classify(st, first, ragged_lanes):
        done, accepted = bool(st[cs.STATE_DONE]), torch.equal(st[cs.STATE_X], st[cs.STATE_XI])
        lam, used = float(st[cs.STATE_LAM]), float(st[cs.STATE_LAM_USED])
        hits["first"] += first
        hits["ragged"] += ragged_lanes
        hits["nan_yi"] += bool(torch.isnan(st[cs.STATE_YI]))
        if accepted:
            clamp = lam == float(np.float32(used) * np.float32(1.0 / 3.0))
            hits["accept_clamp" if clamp else "accept"] += 1
        else:
            hits["conv_reject" if done else "reject"] += 1

    records = {}
    for path, (y0, H, b, aux, cost, n_src) in inputs.items():
        rng = np.random.default_rng(len(records))
        x = torch.eye(4, device=dev)
        dmax = float(torch.diagonal(H).abs().max())
        conv_lam = 1e5 * float(b.abs().max())  # a step under the convergence test's bounds

        def init_state(lam, pose, nu=4.0):
            st = cs.lm_state(pose)
            st[cs.STATE_LAM] = lam
            st[cs.STATE_NU] = nu
            return st

        def y0_at(st, rho, a, c, first):
            """y0 that puts the trial from st at rho (its own yi and denom)."""
            probe = st.clone()
            cs.lm_step_plain(probe, H, b, y0, a, c, first, cfg)
            return (probe[cs.STATE_YI] + rho * probe[cs.STATE_DENOM]).reshape(())

        for k in range(TRIAL_SWEEP):
            scale = (1e-9, 1e-6, 1e-3, 1.0, 1e3, None)[k % 6]
            rho = (None, 1.0, 0.3, -0.5)[k // 6]
            lam = conv_lam if scale is None else scale * dmax * 10 ** rng.uniform(-0.5, 0.5)
            twist = torch.as_tensor(rng.normal(size=6) * 1e-3 * (k % 3), dtype=torch.float32)
            pose = (se3.se3_exp(twist).to(dev) @ x).contiguous()
            init = init_state(lam, pose)
            yy = y0 if rho is None else y0_at(init, rho, aux, cost, False)
            classify(run_point(init, H, b, yy, aux, cost, False), False, False)
        # the first trial after a linearization: lambda unset, nu reset
        for rho in (None, 1.0, -0.5):
            init = init_state(-1.0, x, nu=16.0)
            yy = y0 if rho is None else y0_at(init, rho, aux, cost, True)
            classify(run_point(init, H, b, yy, aux, cost, True), True, False)
        # a NaN in one lane's M: yi is NaN, the trial rejected
        bad = aux.clone()
        bad[0, 5] = float("nan")
        classify(run_point(init_state(1e-6 * dmax, x), H, b, y0, bad, cost, False), False, False)
        # a ragged lane count (no multiple of 4): the lane-by-lane loads
        ra, rc = ragged(aux, cost)
        for rho in (1.0, -0.5):
            init = init_state(1e-6 * dmax, x)
            classify(run_point(init, H, b, y0_at(init, rho, ra, rc, False), ra, rc, False),
                     False, True)

        if path in NEW_TRIAL_PATHS:
            # the same bodies at the lane counts timed above (the NDT body at
            # 28,672 and 157,696, GICP's at 22,528; NDT_CUDA's DIRECT1 at
            # 4,096): checked, not timed again
            records[path] = dict(lanes=aux.shape[1], timed=False)
            continue
        # timing at the path's lanes: the trial launch (state reset by a copy,
        # which the kernel filter leaves out), the trial-off error launch,
        # the standalone lm_trial, and the plain twin (every op)
        L = aux.shape[1]
        ndt = cost.resolution is not None
        init = init_state(1e-6 * dmax, x)
        st = init.clone()
        lam1 = init[cs.STATE_LAM:cs.STATE_LAM + 1]
        xi = cs.lm_trial(H, b, lam1, x)[0]
        # each timed call launches one error kernel (with the trial or
        # without); the state's reset is a device-to-device copy
        fused_ms = device_ms(lambda: (st.copy_(init), cs.lm_step(st, H, b, y0, aux, cost,
                                                                 False, cfg)),
                             200, "error_kernel")
        error_ms = device_ms(lambda: cost(xi, aux), 200, "error_kernel")
        trial_ms = device_ms(lambda: cs.lm_trial(H, b, lam1, x), 200, "lm_trial_kernel")
        unfused_ms = device_ms(lambda: (st.copy_(init), cs.lm_step_plain(
            st, H, b, y0, aux, cost, False, cfg)), 50)
        plain_ms = device_ms(lambda: (st.copy_(init), cs.lm_step_plain(
            st, H, b, y0, aux, cost.plain, False, cfg, trial=plain_trial)), 20)
        call_ms = cuda_ms(lambda: cs.lm_step(st, H, b, y0, aux, cost, False, cfg), 200)
        require(min(fused_ms, error_ms, trial_ms) > 0.0, f"{path}: no kernel time in the trace")
        nbytes = n_src * 12 + L * 40 + 64 + 4 + TRIAL_FLOATS * 4
        b_ms, b_by = bound_ms(nbytes, L * (NDT_ERROR_OPS if ndt else ERROR_OPS) + LM_TRIAL_OPS)
        records[path] = dict(lanes=L, ms=fused_ms, trial_off_error_ms=error_ms,
                             prologue_ms=fused_ms - error_ms, lm_trial_ms=trial_ms,
                             unfused_ms=unfused_ms, plain_ms=plain_ms, call_ms=call_ms,
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        log(f"[trial] {path} (L = {L}): trial launch {fused_ms:.5f} ms, trial-off error "
            f"{error_ms:.5f} ms (prologue {fused_ms - error_ms:+.5f}), lm_trial {trial_ms:.5f} "
            f"ms; unfused trial (all ops) {unfused_ms:.5f} ms, plain {plain_ms:.5f} ms; "
            f"bound {b_ms:.3e} ms ({b_by}); per call with the host's enqueue {call_ms:.4f} ms")
    require(all(hits.values()), f"the trial sweep missed a case: {hits}")
    log(f"[trial] {points} points, every state float bit-equal to the unfused trial, a "
        f"repeat launch bit-identical, d/delta/xi within rtol 1e-5 and yi within 1e-4 of "
        f"the plain twin; cases hit {hits}")
    return records, points, hits, max_err


def phase_trial(dev, pair):
    """`trial_sweeps` at the first linearization of VGICP, GICP, D2D and P2D
    fresh, of FastVGICP on the hash map and on the sparse grid map (DIRECT7,
    157,696 lanes with misses) and of the paths of `new_path_trial_inputs`,
    after `check_schedule_traps`; the lm_step record."""
    trap_differ = check_schedule_traps(dev)
    records, points, hits, max_err = trial_sweeps(dev, trial_inputs(dev, pair))
    main = records["ndt_d2d_fresh"]  # the most launches a registration
    regs = {k: v for k, v in kernel_build_report().items() if k.startswith("lm_step")}
    return dict(
        name="lm_step", own_path="ndt_d2d_fresh", registers=regs, route="cuda", source="fast_gicp_tpu_torch/csrc/trial_error.cu",
        replaces="fast_gicp_tpu/ops/pallas_solver.py:127 with "
                 "fast_gicp_tpu/ops/pallas_linearize.py:633 (GICP, VGICP) or :580 (NDT)",
        max_abs_err=max_err,
        tolerance=f"every state float bit-equal to lm_trial + the trial-off error launch + "
                  f"the eager schedule on {points} points ({hits}); d, delta, xi rtol 1e-5, "
                  "denom 1e-4, yi 1e-4 of the plain twin; a repeat launch bit-identical",
        library_ms=None, timing="profiler device time", by_path=records,
        aten_traps_differ=trap_differ,
        **{k: v for k, v in main.items() if k != "bytes"})


def trial_timing(dev, pair):
    """Device time a trial on trial_inputs, for whichever package is
    imported: with `cuda_solver.lm_step`, the trial launch and beside it
    the trial-off error launch and the standalone lm_trial; without it (a
    package before the trial launch), the lm_trial launch and the error
    launch a trial then made.  No checks.  Run by `--trial-timing DIR` to
    time another checkout in the same call as this one."""
    from fast_gicp_tpu_torch.ops import cuda_solver as cs
    from fast_gicp_tpu_torch.solver import LsqConfig

    cfg, out = LsqConfig(), {}
    fused = hasattr(cs, "lm_step")
    for path, (y0, H, b, aux, cost, _n) in trial_inputs(dev, pair).items():
        x = torch.eye(4, device=dev)
        lam = (1e-6 * torch.diagonal(H).abs().max()).reshape(1)
        xi = cs.lm_trial(H, b, lam, x)[0]
        row = {"lanes": aux.shape[1],
               "lm_trial_ms": device_ms(lambda: cs.lm_trial(H, b, lam, x), 200,
                                        "lm_trial_kernel"),
               "error_ms": device_ms(lambda: cost(xi, aux), 200, "error_kernel")}
        if fused:
            init = cs.lm_state(x)
            init[cs.STATE_LAM] = lam[0]
            init[cs.STATE_NU] = 4.0
            st = init.clone()
            row["trial_launch_ms"] = device_ms(
                lambda: (st.copy_(init), cs.lm_step(st, H, b, y0, aux, cost, False, cfg)),
                200, "error_kernel")
        out[path] = row
    return out


def counters():
    from fast_gicp_tpu_torch.ops import (
        cuda_kernels, cuda_linearize, cuda_ndt, cuda_pose_graph, cuda_solver,
    )

    return {
        "rbf_moments": cuda_kernels.rbf_moments,
        "linearize_raw": cuda_linearize.linearize_raw,
        "error": cuda_linearize.error,
        "lm_trial": cuda_solver.lm_trial,
        "knn_moments": cuda_kernels.knn_moments,
        "nn_search": cuda_kernels.nn_search,
        "linearize": cuda_linearize.linearize,
        "ndt_d2d": cuda_ndt.ndt_linearize_d2d,
        "ndt_p2d": cuda_ndt.ndt_linearize_p2d,
        "ndt_d2d_raw": cuda_ndt.ndt_linearize_d2d_raw,
        "ndt_p2d_raw": cuda_ndt.ndt_linearize_p2d_raw,
        "ndt_error": cuda_ndt.ndt_error,
        "lm_step": cuda_solver.lm_step,
        "knn_slab": cuda_kernels.knn_slab,
        "radius_count": cuda_kernels.radius_count,
        "radius_window": cuda_kernels.radius_window,
        "block_tridiag_factor": cuda_pose_graph.block_tridiag_factor,
        "block_tridiag_apply": cuda_pose_graph.block_tridiag_apply,
        "loop_cond": cuda_solver.loop_cond,
        "pg_cond": cuda_pose_graph.pg_cond,
    }


class Path(NamedTuple):
    """A registration path: `register(source, source_mask, target,
    target_mask, guess, device) -> LsqResult` and the config it runs."""

    register: object
    config: object


def vgicp_path(source, target):
    """`vgicp_register` as bench.py runs it: RBF covariances, the dense raw
    grid at 1 m, two-phase solve."""
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_register
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims

    del source
    cfg = VGICPConfig(grid_dims=auto_grid_dims(target, 1.0), refresh_iterations=2)

    def register(s, sm, t, tm, guess, device):
        return vgicp_register(s, sm, t, tm, guess, cfg, device=device)

    return Path(register, cfg)


def gicp_path(method, regularization):
    """`gicp_register_fresh` with FastGICP's fresh-align defaults (k = 20,
    1-NN re-search every iteration) and the covariance estimator `method`
    ("knn" or "adaptive", FastGICP's covariance_estimation) under
    `regularization`."""

    def make(source, target):
        from fast_gicp_tpu_torch.models.gicp import GICPConfig, gicp_register_fresh

        del source, target
        cfg = GICPConfig()

        def register(s, sm, t, tm, guess, device):
            return gicp_register_fresh(s, sm, t, tm, guess, cfg, method=method,
                                       regularization=regularization, device=device)[0]

        return Path(register, cfg)

    return make


def ndt_fresh_path(mode):
    """`ndt_register_fresh` with NDTCuda's defaults (DIRECT7, 1 m, no
    refresh, budgets 4,096 source / 8,192 target voxels) and grid dims over
    both clouds, as NDTCuda's fresh align runs it."""

    def make(source, target):
        from fast_gicp_tpu_torch.models.ndt import NDTConfig, ndt_register_fresh

        cfg = NDTConfig(distance_mode=mode, grid_dims=ndt_dims(source, target))

        def register(s, sm, t, tm, guess, device):
            return ndt_register_fresh(s, sm, t, tm, guess, cfg, device=device)[0]

        return Path(register, cfg)

    return make


# apps/align.py's NDT rows use 2,048 source voxels, sized for the bundled
# pair's ~1.1k occupied; the synthetic pair occupies 6,660, so the same rule
# gives 8,192 (the 2,048 budget's overflow is measured in phase_ndt_budgets).
NDT_ALIGN_SOURCE_VOXELS = 8192
APPS_ALIGN_SOURCE_VOXELS = 2048


def ndt_align_path(mode, max_source_voxels=NDT_ALIGN_SOURCE_VOXELS):
    """`ndt_align` with apps/align.py's NDT config (DIRECT7, 1 m,
    refresh_iterations=3) and grid dims over both clouds."""

    def make(source, target):
        from fast_gicp_tpu_torch.models.ndt import NDTConfig, ndt_align

        cfg = NDTConfig(distance_mode=mode, grid_dims=ndt_dims(source, target),
                        refresh_iterations=3, max_source_voxels=max_source_voxels)

        def register(s, sm, t, tm, guess, device):
            return ndt_align(s, sm, t, tm, guess, cfg, device=device)

        return Path(register, cfg)

    return make


D2D_LIMITS = (0.05, 1.0)  # gicp_test.cpp:148-149
# the covariance estimator and regularization of each GICP path
GICP_ESTIMATORS = {"gicp_register_fresh": ("knn", "plane"),
                   "gicp_adaptive_fresh": ("adaptive", "plane"),
                   "gicp_min_eig_fresh": ("knn", "min_eig")}
P2D_LIMITS = (0.10, 2.0)  # twice the reference's, as tests/test_registration.py holds P2D

# path -> (make(source, target) -> Path, kernels the path must launch, limits);
# every LM trial is one `lm_step` launch (the trial step, the path's error
# body, the schedule)
PATHS = {
    "vgicp_register": (vgicp_path, ("rbf_moments", "linearize_raw", "lm_step"), D2D_LIMITS),
    "gicp_register_fresh": (gicp_path(*GICP_ESTIMATORS["gicp_register_fresh"]),
                            ("knn_moments", "nn_search", "linearize", "lm_step"), D2D_LIMITS),
    "ndt_d2d_fresh": (ndt_fresh_path("d2d"), ("ndt_d2d", "lm_step"), D2D_LIMITS),
    "ndt_p2d_fresh": (ndt_fresh_path("p2d"), ("ndt_p2d", "lm_step"), P2D_LIMITS),
    "ndt_d2d_align": (ndt_align_path("d2d"), ("ndt_d2d_raw", "lm_step"), D2D_LIMITS),
    "ndt_p2d_align": (ndt_align_path("p2d"), ("ndt_p2d_raw", "ndt_p2d", "lm_step"),
                      P2D_LIMITS),
    "gicp_adaptive_fresh": (gicp_path(*GICP_ESTIMATORS["gicp_adaptive_fresh"]),
                            ("radius_count", "radius_window", "nn_search", "linearize",
                             "lm_step"), D2D_LIMITS),
    "gicp_min_eig_fresh": (gicp_path(*GICP_ESTIMATORS["gicp_min_eig_fresh"]),
                           ("knn_slab", "nn_search", "linearize", "lm_step"), D2D_LIMITS),
}


def _fast_vgicp_hash(device):
    """FastVGICP with the class defaults (kNN covariances, k = 20, plane,
    DIRECT1, 1 m, additive) on the hash map (grid_dims=None)."""
    from fast_gicp_tpu_torch.models.vgicp import FastVGICP

    return FastVGICP(grid_dims=None, device=device)


def _fast_vgicp_grid_mult(device):
    """FastVGICP, multiplicative accumulation, DIRECT7, grid_dims "auto":
    the sparse dense-grid map (`GridVoxelMap`)."""
    from fast_gicp_tpu_torch.models.vgicp import FastVGICP

    reg = FastVGICP(device=device)
    reg.set_voxel_accumulation_mode("multiplicative")
    reg.set_neighbor_search_method("DIRECT7")
    return reg


def _fast_gicp_class(device):
    """FastGICP with the class defaults."""
    from fast_gicp_tpu_torch.models.gicp import FastGICP

    return FastGICP(device=device)


def _ndt_cuda(mode, hash_map):
    """NDTCuda with its defaults (DIRECT7, 1 m, budgets 4,096 / 8,192) in
    `mode` ("P2D"/"D2D", the reference's spelling): the dense "auto" grid
    over both clouds (the lookup form), or after set_grid_dims(None) the
    hash map (an eager freeze and a pack-form launch a linearization)."""

    def make(device):
        from fast_gicp_tpu_torch.models.ndt import NDTCuda

        reg = NDTCuda(device=device)
        reg.set_distance_mode(mode)
        if hash_map:
            reg.set_grid_dims(None)
        return reg

    return make


def _fast_gicp_multipoints(device):
    """FastGICPMultiPoints with its defaults (kNN covariances k = 20 plane,
    radius 1 m over the exact 32 nearest neighbours)."""
    from fast_gicp_tpu_torch.models.experimental import FastGICPMultiPoints

    return FastGICPMultiPoints(device=device)


# class path -> (make(device) -> Registration, kernels the path must launch,
# the pair its card-against-CPU phase runs on: the CPU-test-sized pair for
# FastGICP, the full-size one for FastVGICP, whose kNN-covariance solve on
# the small pair's sparse 1 m voxels stalls short of the convergence test
# (64 iterations in either package, now and then, tests/test_torch_classes.py)
# or lands outside the reference's accuracy (multiplicative, DIRECT7: 67 mm))
CLASS_PATHS = {
    "fast_vgicp_hash": (_fast_vgicp_hash, ("knn_moments", "linearize", "lm_step"), "full"),
    "fast_vgicp_grid_mult": (_fast_vgicp_grid_mult, ("knn_moments", "linearize", "lm_step"),
                             "full"),
    "fast_gicp_class": (_fast_gicp_class, ("knn_moments", "nn_search", "linearize", "lm_step"),
                        "small"),
    # NDTCuda: its card-against-CPU on the full-size pair (NDT's > 6 points
    # gate); FastGICPMultiPoints on the small one (its CPU run searches all
    # targets for each point at every linearization)
    "ndt_d2d_class": (_ndt_cuda("D2D", False), ("ndt_d2d", "lm_step"), "full"),
    "ndt_p2d_class": (_ndt_cuda("P2D", False), ("ndt_p2d", "lm_step"), "full"),
    "ndt_d2d_hash": (_ndt_cuda("D2D", True), ("ndt_d2d", "lm_step"), "full"),
    "ndt_p2d_hash": (_ndt_cuda("P2D", True), ("ndt_p2d", "lm_step"), "full"),
    "fast_gicp_multipoints": (_fast_gicp_multipoints,
                              ("knn_moments", "knn_slab", "linearize", "lm_step"), "small"),
}
NDT_CLASS_PATHS = tuple(p for p in CLASS_PATHS if p.startswith("ndt_"))
# how each class path's linearizations must reach their kernel: the GICP and
# VGICP classes read target rows by index ("idx"), FastGICPMultiPoints
# passes the averaged rows gathered, NDTCuda looks its voxels up in the
# kernel on the dense grid ("lookup") and freezes a pack eagerly on the
# hash map ("pack")
CLASS_LIN_FORM = {"ndt_d2d_class": "lookup", "ndt_p2d_class": "lookup",
                  "ndt_d2d_hash": "pack", "ndt_p2d_hash": "pack",
                  "fast_gicp_multipoints": "gathered"}
CLASS_LIMITS = {"ndt_p2d_class": P2D_LIMITS, "ndt_p2d_hash": P2D_LIMITS}  # else D2D_LIMITS


def _batch_path(kind):
    """(run(arrays, device) -> stacked LsqResult) of `ndt_align_batch` (D2D,
    NDTConfig's defaults: the hash map) or `vgicp_align_batch`
    (VGICPConfig's defaults: DIRECT1 on the hash map, the kNN covariances
    in the arrays), and the per-pair call each pair must equal bit for
    bit."""
    from fast_gicp_tpu_torch.models import batch, ndt, vgicp

    if kind == "ndt":
        cfg = ndt.NDTConfig()

        def run(a, device):
            return batch.ndt_align_batch(a["sp"], a["sm"], a["tp"], a["tm"], a["guess"], cfg,
                                         device=device)

        def one(a, i, device):
            return ndt.ndt_align(a["sp"][i], a["sm"][i], a["tp"][i], a["tm"][i], a["guess"][i],
                                 cfg, device=device)
    else:
        cfg = vgicp.VGICPConfig()

        def run(a, device):
            return batch.vgicp_align_batch(a["sp"], a["sm"], a["sc"], a["tp"], a["tm"], a["tc"],
                                           a["guess"], cfg, device=device)

        def one(a, i, device):
            return vgicp.vgicp_align(a["sp"][i], a["sm"][i], a["sc"][i], a["tp"][i], a["tm"][i],
                                     a["tc"][i], a["guess"][i], cfg, device=device)
    return run, one


# batch path -> (the batch of `_batch_path`, kernels the path must launch, limits)
BATCH_PATHS = {"ndt_align_batch": ("ndt", ("ndt_d2d", "lm_step"), D2D_LIMITS),
               "vgicp_align_batch": ("vgicp", ("linearize", "lm_step"), D2D_LIMITS)}
BATCH_FRAMES = (30, 31, 32, 33, 34)  # B = 4 consecutive pairs of the drive
# pygicp path -> (align_points method, kernels it must launch, the pair of its
# card-against-CPU run, limits)
PYGICP_PATHS = {
    "pygicp_gicp": ("GICP", ("knn_moments", "nn_search", "linearize", "lm_step"), "small",
                    D2D_LIMITS),
    "pygicp_vgicp": ("VGICP", ("knn_moments", "linearize_raw", "lm_step"), "full", D2D_LIMITS),
    "pygicp_vgicp_cuda": ("VGICP_CUDA", ("knn_moments", "linearize_raw", "lm_step"), "full",
                          D2D_LIMITS),
    "pygicp_ndt_cuda": ("NDT_CUDA", ("ndt_d2d", "lm_step"), "full", D2D_LIMITS),
}
# odometry path (slice F, on the 128-frame drive) -> (kernels it must launch,
# the form of its linearize launches, check_lin_forms); scan_to_map runs
# before localization, which localizes on its saved map
ODOMETRY_PATHS = {
    "odometry_serial": (("knn_moments", "linearize_raw", "lm_step"), "idx_raw"),
    "odometry_stream": (("rbf_moments", "linearize_raw", "lm_step"), "idx_raw"),
    "odometry_scan": (("rbf_moments", "linearize_raw", "lm_step"), "idx_raw"),
    "scan_to_map": (("rbf_moments", "linearize", "lm_step"), "idx"),
    "localization": (("rbf_moments", "ndt_d2d", "lm_step"), "pack"),
}
# the standalone launches the trial launch replaces inside the LM solve, and
# the paths whose trials carry each one's body
TRIAL_CARRIED = {"lm_trial": tuple(PATHS) + tuple(CLASS_PATHS) + tuple(BATCH_PATHS)
                 + tuple(PYGICP_PATHS) + tuple(ODOMETRY_PATHS) + ("backend",),
                 "error": ("vgicp_register", "gicp_register_fresh", "gicp_adaptive_fresh",
                           "gicp_min_eig_fresh", "vgicp_align_batch", "pygicp_gicp",
                           "pygicp_vgicp", "pygicp_vgicp_cuda")
                 + tuple(p for p in CLASS_PATHS if p not in NDT_CLASS_PATHS)
                 + tuple(p for p in ODOMETRY_PATHS if p != "localization") + ("backend",),
                 "ndt_error": ("ndt_d2d_fresh", "ndt_p2d_fresh", "ndt_d2d_align",
                               "ndt_p2d_align", "ndt_align_batch", "pygicp_ndt_cuda",
                               "localization", "backend")
                 + NDT_CLASS_PATHS}
NDT_PATHS = tuple(p for p in PATHS if p.startswith("ndt_"))
# the wrappers that also count their launches that read rows by index
IDX_COUNTED = ("linearize", "linearize_raw")
# the NDT linearize wrappers, which also count their lookup-form launches
# (the rest are pack-form launches)
NDT_FORM_COUNTED = tuple(f"ndt_{m}" for m in NDT_MODES)
# the pack-form launches a path may make: P2D align's frozen phase, seeded
# from the last refresh linearization's aux (no freeze); and every NDT
# launch on the hash map (NDTCuda after set_grid_dims(None), the batch's
# maps, the persistent map of localization), which the kernel cannot look
# up: each linearization there is an eager freeze
# (`cuda_ndt.ndt_freeze_pack`) and one pack-form launch, as the JAX
# package's fused objective runs it
NDT_PACK_ALLOWED = {("ndt_p2d_align", "ndt_p2d"), ("ndt_d2d_hash", "ndt_d2d"),
                    ("ndt_p2d_hash", "ndt_p2d"), ("ndt_align_batch", "ndt_d2d"),
                    ("localization", "ndt_d2d")}


def phase_main_path(dev, pair, path):
    from fast_gicp_tpu_torch.models.metrics import fitness_score
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = pair
    make, kernels, (t_lim, r_lim) = PATHS[path]
    register = make(source, target).register
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    inputs = [torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm)]
    guess = torch.eye(4, device=dev)
    register(*inputs, guess, dev)  # warm-up
    torch.cuda.synchronize()

    for fn in counters().values():
        fn.launches = 0
    for k in IDX_COUNTED:
        counters()[k].idx_launches = 0
    for k in NDT_FORM_COUNTED:
        counters()[k].lookup_launches = 0
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    res = register(*inputs, guess, dev)
    T = res.transformation.cpu().numpy()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters().items()}
    launches.update({f"{k}[idx]": counters()[k].idx_launches for k in IDX_COUNTED})
    for k in NDT_FORM_COUNTED:
        launches[f"{k}[lookup]"] = counters()[k].lookup_launches
    syncs = lsq_solve.host_syncs

    require(T.shape == (4, 4) and np.isfinite(T).all(), f"{path}: non-finite pose")
    t_err, r_err = pose_errors(T.astype(np.float64), gt)
    iters = int(res.iterations)
    fitness = float(fitness_score(res.transformation, *inputs, device=dev))
    log(f"[main] {path}: t_err {t_err:.6f} m, r_err {r_err:.6f} deg, "
        f"iterations {iters}, converged {bool(res.converged)}, host syncs {syncs}, "
        f"wall {wall_ms:.3f} ms, fitness {fitness:.6f}, launches {launches}")
    require(math.isfinite(fitness), f"{path}: non-finite fitness")
    require(t_err < t_lim and r_err < r_lim, f"{path}: pose error {t_err} m {r_err} deg")
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    # one trial launch and one flag read a trial, no standalone trial step
    # or error launch inside the solve
    require(launches["lm_step"] == syncs, f"{path}: {launches['lm_step']} trial launches "
            f"for {syncs} trials")
    require(all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"{path}: a standalone trial or error launch in the LM solve: {launches}")
    # the GICP and VGICP solves read the target rows by index: every
    # linearize launch of the path is the idx form, with no gather before it
    require(all(launches[f"{k}[idx]"] == launches[k] for k in IDX_COUNTED if k in kernels),
            f"{path}: a linearize launch on gathered rows: {launches}")
    # the NDT solves look their voxels up in the linearize kernel: every NDT
    # linearize launch is the lookup form (no eager freeze), but P2D align's
    # frozen phase, seeded from an aux as a pack
    pack_launches = {k: launches[k] - launches[f"{k}[lookup]"] for k in NDT_FORM_COUNTED}
    require(all(n == 0 for k, n in pack_launches.items() if (path, k) not in NDT_PACK_ALLOWED),
            f"{path}: an NDT linearize launch on a frozen pack: {launches}")
    if path in NDT_PATHS:
        refresh = next(k for k in kernels if k in NDT_FORM_COUNTED)
        require(launches[f"{refresh}[lookup]"] > 0,
                f"{path}: no lookup-form launch: {launches}")
    return launches, dict(t_err_m=t_err, r_err_deg=r_err, iterations=iters,
                          host_syncs=syncs, wall_ms=wall_ms, fitness=fitness)


def phase_ndt_budgets(dev, pair):
    """The NDT voxel budgets against the full-size pair's occupied 1 m
    voxels (each cloud in its own centroid frame, as `ndt_register_fresh`
    voxelizes it, and the source in the target's frame, as `ndt_align`
    does), and `ndt_align` D2D at apps/align.py's 2,048-voxel source
    budget, whose overflow drops voxels as the JAX package does."""
    from fast_gicp_tpu_torch.ops.covariance import masked_mean
    from fast_gicp_tpu_torch.ops.voxelmap import voxel_coord
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = pair
    src, tgt = (torch.as_tensor(a, device=dev) for a in (source, target))
    tc = masked_mean(tgt, torch.ones(len(target), dtype=torch.bool, device=dev))
    sc = masked_mean(src, torch.ones(len(source), dtype=torch.bool, device=dev))

    def occupied(pts):
        return int(torch.unique(voxel_coord(pts, 1.0), dim=0).shape[0])

    occ = {"target (own frame)": occupied(tgt - tc), "source (own frame)": occupied(src - sc),
           "source (target frame)": occupied(src - tc)}
    log(f"[main] occupied 1 m voxels {occ} against the budgets 2,048 / 4,096 / 8,192")
    register = ndt_align_path("d2d", APPS_ALIGN_SOURCE_VOXELS)(source, target).register
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    res = register(*(torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm)),
                   torch.eye(4, device=dev), dev)
    T = res.transformation.cpu().numpy()
    require(np.isfinite(T).all(), "ndt_align at the 2,048 budget: non-finite pose")
    t_err, r_err = pose_errors(T.astype(np.float64), gt)
    log(f"[main] ndt_align D2D at apps/align.py's {APPS_ALIGN_SOURCE_VOXELS} source "
        f"voxels ({occ['source (target frame)'] - APPS_ALIGN_SOURCE_VOXELS} dropped): "
        f"t_err {t_err:.6f} m, r_err {r_err:.6f} deg, iterations {int(res.iterations)}")
    return dict(occupied_voxels=occ, apps_budget_t_err_m=t_err, apps_budget_r_err_deg=r_err,
                apps_budget_iterations=int(res.iterations))


def phase_card_vs_cpu(dev, pair, path):
    """The card's run of a path against the CPU run (plain versions) on
    `pair`; tolerance 1e-3 on the pose, as the CPU tests hold the port
    against the JAX package."""
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = pair
    make, _kernels, (t_lim, r_lim) = PATHS[path]
    register = make(source, target).register
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    eye = np.eye(4, dtype=np.float32)
    r_gpu = register(sp, sm, tp, tm, eye, dev)
    r_cpu = register(sp, sm, tp, tm, eye, "cpu")
    T_gpu = r_gpu.transformation.cpu().numpy()
    T_cpu = r_cpu.transformation.numpy()
    diff = float(np.abs(T_gpu - T_cpu).max())
    t_err, r_err = pose_errors(T_gpu.astype(np.float64), gt)
    log(f"[card vs cpu] {path}, {sp.shape[0]} padded points: |T_gpu - T_cpu| max "
        f"{diff:.3e}, iterations gpu {int(r_gpu.iterations)} cpu {int(r_cpu.iterations)}, "
        f"t_err {t_err:.6f} m")
    require(np.isfinite(T_gpu).all() and diff <= 1e-3, f"{path} card vs cpu: pose diff {diff}")
    require(abs(int(r_gpu.iterations) - int(r_cpu.iterations)) <= 1,
            f"{path} card vs cpu: iteration counts differ by more than 1")
    require(t_err < t_lim and r_err < r_lim,
            f"{path} card vs cpu: pose error {t_err} m {r_err} deg")
    return dict(padded_points=int(sp.shape[0]), pose_diff=diff,
                iterations_gpu=int(r_gpu.iterations), iterations_cpu=int(r_cpu.iterations))


# bench.py's protocol at a smaller depth: 20 registrations a path (bench.py:
# 100) and 4 batches (10), to keep the whole script in its time with the
# device loop's phase and the back-end's device forms
BENCH_REGS = 20
BENCH_BATCHES = 4


def phase_bench(dev, pair, path, n_regs=BENCH_REGS):
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    register = PATHS[path][0](source, target).register
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    rng = np.random.default_rng(0)
    twists = 1e-5 * rng.standard_normal((n_regs, 6)).astype(np.float32)
    jitters = se3.se3_exp(torch.as_tensor(twists)).to(dev)
    guess = torch.eye(4, device=dev)

    def jittered(J):
        sj = sp @ J[:3, :3].T + J[:3, 3]
        tj = tp @ J[:3, :3].T + J[:3, 3]
        return register(sj, sm, tj, tm, guess, dev)

    jittered(jitters[0])  # warm-up
    torch.cuda.synchronize()
    syncs0 = lsq_solve.host_syncs
    t0 = time.perf_counter()
    iters = []
    for J in jitters:
        iters.append(jittered(J).iterations)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_regs
    iters = torch.stack(iters).cpu().numpy()
    syncs = (lsq_solve.host_syncs - syncs0) / n_regs
    log(f"[bench] {path}, {n_regs} registrations: {ms:.4f} ms/registration "
        f"({1e3 / ms:.2f} reg/s), iterations mean {iters.mean():.2f}, "
        f"host syncs/registration {syncs:.2f}")
    return dict(registrations=n_regs, ms_per_registration=ms, registrations_per_s=1e3 / ms,
                mean_iterations=float(iters.mean()), host_syncs_per_registration=syncs)


def _stages_vgicp(dev, path, sp, sm, tp, tm, guess, wall_ms):
    from fast_gicp_tpu_torch.ops.covariance import masked_mean, rbf_covariance_cols
    from fast_gicp_tpu_torch.ops.voxelmap import build_raw_grid

    register, cfg = path
    dims = cfg.grid_dims
    tc = tp - masked_mean(tp, tm)
    tcov = rbf_covariance_cols(tc, tm)
    stages = {
        "register": wall_ms(lambda: register(sp, sm, tp, tm, guess, dev)),
        "covariances (both clouds)": wall_ms(
            lambda: (rbf_covariance_cols(sp, sm), rbf_covariance_cols(tp, tm))),
        "grid build": wall_ms(lambda: build_raw_grid(tc, tm, 1.0, tcov, dims)),
    }
    stages["align rest (solve)"] = (stages["register"] - stages["covariances (both clouds)"]
                                    - stages["grid build"])
    return stages


def _stages_gicp(dev, path, sp, sm, tp, tm, guess, wall_ms, estimator):
    from fast_gicp_tpu_torch.models.gicp import gicp_align
    from fast_gicp_tpu_torch.ops.covariance import estimate_covariance_cols

    method, reg = estimator
    register = path.register

    def covs(p, m):
        return estimate_covariance_cols(p, m, method, regularization=reg)

    scov, tcov = covs(sp, sm), covs(tp, tm)
    return {
        "register": wall_ms(lambda: register(sp, sm, tp, tm, guess, dev)),
        "covariances (both clouds)": wall_ms(lambda: (covs(sp, sm), covs(tp, tm))),
        "align (solve)": wall_ms(
            lambda: gicp_align(sp, sm, scov, tp, tm, tcov, guess, device=dev)),
    }


def _stages_ndt(dev, path, sp, sm, tp, tm, guess, wall_ms, fresh):
    """NDT: the maps and the objective's set-up as the entry point prepares
    them (`ndt_path_objective`; fresh: each cloud's prepared state; align:
    the raw target grid and, for D2D, the source's compact statistics), then
    the rest of the registration (the solve)."""
    from fast_gicp_tpu_torch.models.ndt import ndt_path_objective

    register, cfg = path
    stages = {"register": wall_ms(lambda: register(sp, sm, tp, tm, guess, dev)),
              "maps": wall_ms(lambda: ndt_path_objective(sp, sm, tp, tm, cfg, fresh=fresh,
                                                         device=dev))}
    stages["rest (solve)"] = stages["register"] - stages["maps"]
    return stages


# Device ops a registration predicted for each path with the NDT voxel
# lookup in the linearize kernel and D2D align's freeze returning its pose
# (PERF.md section 6, written before the traced run that tests them): the
# NDT paths' counts of the design before the lookup form less
# tests/torch_ndt_freeze_ops.py's counts, the GICP and VGICP paths unchanged.
PREDICTED_DEVICE_OPS = {"vgicp_register": 725.6, "gicp_register_fresh": 765.6,
                        "gicp_adaptive_fresh": 727.4, "gicp_min_eig_fresh": 778.6,
                        "ndt_d2d_fresh": 677.6, "ndt_p2d_fresh": 368.6,
                        "ndt_d2d_align": 409.6, "ndt_p2d_align": 126.6}


def wall_ms(fn, reps=10):
    """Host wall per call of `fn` over `reps` calls after a warm-up, closed
    by a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_profile(dev, pair, path, n_regs=5):
    """Where a registration's time goes: host-clock stage times (each stage
    alone, synchronised), then a torch.profiler trace of `n_regs`
    registrations for the device time by kernel and the device's busy
    share of the wall time."""
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    made = PATHS[path][0](source, target)
    register = made.register
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    guess = torch.eye(4, device=dev)

    if path == "vgicp_register":
        stage_fn = _stages_vgicp
    elif path in GICP_ESTIMATORS:
        stage_fn = functools.partial(_stages_gicp, estimator=GICP_ESTIMATORS[path])
    else:
        stage_fn = functools.partial(_stages_ndt, fresh=path.endswith("_fresh"))
    stages = stage_fn(dev, made, sp, sm, tp, tm, guess, wall_ms)
    log(f"[profile] {path} stage wall ms/registration: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(stage_wall_ms=stages,
                **trace_registrations(path, lambda: register(sp, sm, tp, tm, guess, dev),
                                      n_regs, PREDICTED_DEVICE_OPS[path]))


def trace_registrations(path, run, n_regs, predicted, all_ops=False):
    """Each of `n_regs` calls of `run` (one registration): its device span
    from CUDA events recorded on the stream before and after it, untraced
    and under torch.profiler, and the trace's device busy time, device ops
    and top kernels; device ops against `predicted` (a number, or a
    callable read after the runs); with `all_ops`, every device op's count
    a registration, not only the top twelve by time."""
    from torch.profiler import ProfilerActivity, profile

    def spans_ms():
        """Host wall a registration, and each registration's device span:
        CUDA events recorded on the stream before and after it (the time
        from the device reaching its first op to finishing its last, idle
        gaps included)."""
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(n_regs)]
        t0 = time.perf_counter()
        for start, end in marks:
            start.record()
            run()
            end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_regs
        return wall, [start.elapsed_time(end) for start, end in marks]

    from fast_gicp_tpu_torch.solver import lsq_solve

    wall_untraced, spans_untraced = spans_ms()
    syncs0 = lsq_solve.host_syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, spans = spans_ms()
    traced_syncs = (lsq_solve.host_syncs - syncs0) / n_regs
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_regs
    launches = sum(e.count for e in events) / n_regs
    span = sum(spans) / n_regs
    if callable(predicted):
        predicted = predicted()
    log(f"[profile] {path}, traced {n_regs} registrations: wall {wall:.3f} ms, device span "
        f"(CUDA events) {span:.3f} ms (each {', '.join(f'{v:.3f}' for v in spans)}), device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall:.1f}% of the wall, "
        f"{100 * busy_ms / span:.1f}% of the span), device ops {launches:.1f} per "
        f"registration; untraced: wall {wall_untraced:.3f} ms, device span "
        f"{sum(spans_untraced) / n_regs:.3f} ms")
    if predicted is not None:
        log(f"[profile] {path}: device ops {launches:.1f} a registration against the "
            f"predicted {predicted} ({launches - predicted:+.1f})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:None if all_ops else 12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n_regs:9.4f} ms  "
            f"x{e.count / n_regs:5.1f}  {e.key[:90 if not all_ops else 160]}")
    copies = {kind: sum(e.count for e in events if f"Memcpy {kind}" in e.key) / n_regs
              for kind in ("HtoD", "DtoH")}
    return dict(traced_wall_ms=wall, device_span_ms=span, device_busy_ms=busy_ms,
                device_ops_per_registration=launches, predicted_device_ops=predicted,
                copies_per_registration=copies, traced_host_syncs=traced_syncs,
                untraced_wall_ms=wall_untraced,
                untraced_device_span_ms=sum(spans_untraced) / n_regs)


# -- the class API: FastVGICP on the hash and grid maps, FastGICP -----------

# Device ops a class-path registration (clear_covariances + align, the fresh
# path, and the result's one read) predicted before its first traced run
# (PERF.md section 6), from `python tests/torch_class_ops.py`:
# constant + per_linearization x iterations + per_trial x trials, at the
# traced registration's own iterations and trials.  The hash constant was
# 733.6 until the table build stopped resetting its parking slot (8 host
# copies a build).
PREDICTED_CLASS_OPS = {"fast_vgicp_hash": (725.6, 65, 2),
                       "fast_vgicp_grid_mult": (692.6, 78, 2),
                       "fast_gicp_class": (553.6, 34, 2)}


def _rows_close(name, got, want, scale, tol):
    """Each row of got (C, W) within tol x that row's scale (C,) of want's;
    returns the largest |diff| / scale."""
    rel = ((got - want).abs().amax(dim=1) / torch.clamp(scale, min=1e-30))
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    worst = float(rel.max()) if rel.numel() else 0.0
    require(bool((rel <= tol).all()), f"{name}: {int((rel > tol).sum())} rows beyond "
            f"{tol} of their scale (worst {worst:.3e})")
    return worst


def check_map_card_vs_cpu(name, pts, mask, covs, res, mode, dims, dev):
    """`build_voxelmap` on the card against the same build on the CPU: the
    integer fields (counts, coords, num_voxels; the table and lut, or the
    grid and origin) exactly equal, the means within 1e-5 of each voxel's
    largest |mean|, the covariances within 1e-5 of the voxel's scale (the
    card's scatter-adds are atomic, so the sums differ in the last bits):
    additive, the largest |cov| entry; raw, the largest |E[x x^T]| entry,
    from which E[x x^T] - mu mu^T cancels; multiplicative, both scales x
    kappa, the voxel's condition number (the information-form sums are
    inverted: a last-bit difference in them grows by up to kappa).
    Returns the worst row of each field."""
    from fast_gicp_tpu_torch.ops.voxelmap import build_voxelmap

    maps = [build_voxelmap(torch.as_tensor(pts), torch.as_tensor(mask), res,
                           covs=None if covs is None else torch.as_tensor(covs), mode=mode,
                           grid_dims=dims, device=d) for d in (dev, "cpu")]
    card, cpu = maps
    ints = ("counts", "coords", "num_voxels") + (
        ("grid", "origin") if dims is not None else ("table", "lut"))
    for f in ints:
        require(bool(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))),
                f"{name}: {f} differs between card and CPU")
    live = cpu.counts > 0
    mu_c, mu = card.means.cpu()[live], cpu.means[live]
    cov_c, cov = card.covs.cpu()[live].reshape(-1, 9), cpu.covs[live].reshape(-1, 9)
    mu_scale, scale = mu.abs().amax(dim=1), cov.abs().amax(dim=1)
    if mode == "raw":
        scale = (cov + (mu[:, :, None] * mu[:, None, :]).reshape(-1, 9)).abs().amax(dim=1)
    elif mode == "multiplicative":
        w = torch.linalg.eigvalsh(cov.reshape(-1, 3, 3).double()).abs()
        kappa = (w.amax(1) / torch.clamp(w.amin(1), min=1e-30)).float()
        mu_scale, scale = mu_scale * kappa, scale * kappa
    worst = dict(means=_rows_close(f"{name} means", mu_c, mu, mu_scale, 1e-5),
                 covs=_rows_close(f"{name} covs", cov_c, cov, scale, 1e-5),
                 voxels=int(cpu.num_voxels))
    log(f"[kernels] {name}: card and CPU maps equal in {', '.join(ints)}; worst row "
        f"means {worst['means']:.2e}, covs {worst['covs']:.2e} of its scale "
        f"({worst['voxels']} voxels)")
    return worst


# the class path that runs each map of `class_map_objectives`
CLASS_MAP_PATHS = {"hash": "fast_vgicp_hash", "grid": "fast_vgicp_grid_mult"}


def class_map_objectives(dev, pair, scov, tcov):
    """{"hash": ..., "grid": ...}: the VGICP objective of the FastVGICP class
    paths' maps on the full-size pair in the target-centroid frame, as
    `vgicp_align` builds it from the kNN covariances `scov`, `tcov` (6, N)
    of the padded clouds: the hash map (the class defaults, DIRECT1,
    additive) and the sparse dense-grid map (multiplicative, DIRECT7, the
    auto grid).  Each is (map, offsets, (linearize, error, freeze,
    linearize_frozen), source, source mask, source covariances)."""
    from fast_gicp_tpu_torch.models.vgicp import (
        VGICPConfig, _build_target_map, make_vgicp_objective,
    )
    from fast_gicp_tpu_torch.ops.covariance import masked_mean
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims, neighbor_offsets
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    src, smask, tgt, tmask = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    c = masked_mean(tgt, tmask)
    src_c, tgt_c = src - c, tgt - c
    dims = auto_grid_dims(target, 1.0)
    out = {}
    for name, cfg in (("hash", VGICPConfig()),
                      ("grid", VGICPConfig(voxel_accumulation="multiplicative",
                                           neighbor_search_method="direct7", grid_dims=dims))):
        offsets = neighbor_offsets(cfg.neighbor_search_method)
        vmap = _build_target_map(tgt_c, tmask, tcov, cfg)
        out[name] = (vmap, offsets, make_vgicp_objective(src_c, smask, scov, vmap, offsets, cfg),
                     src_c, smask, scov)
    return out


def phase_class_kernels(dev, pair, records):
    """The class paths' map builds and the `linearize` kernel on their maps.
    The maps of `build_voxelmap` on the card against the CPU on the
    full-size target (hash additive and raw, grid multiplicative; 1 m), and
    on the 0.3 m face scene of `ndt_lookup_edge_cases` (hash, raw), where
    a product with the reciprocal would bin face points elsewhere.  Then
    the linearize kernel's idx form on the hash and grid maps' inputs at
    each path's first linearization (`packed` rows by voxel id, ids
    clamped, valid 0 on misses), bit for bit to the gathered form and a
    repeat launch, within tolerance of its plain version, timed; added to
    the linearize record as `class_maps`."""
    from fast_gicp_tpu_torch.ops import cuda_linearize
    from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims
    from fast_gicp_tpu_torch.utils import synthetic
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    src, smask, tgt, tmask = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    scov = knn_covariance_cols(src, smask)
    tcov = knn_covariance_cols(tgt, tmask)
    dims = auto_grid_dims(target, 1.0)
    tcov_cpu = tcov.cpu().numpy()
    maps = {
        "hash additive 1 m": check_map_card_vs_cpu("map hash additive 1 m", tp, tm, tcov_cpu,
                                                   1.0, "additive", None, dev),
        "hash raw 1 m": check_map_card_vs_cpu("map hash raw 1 m", tp, tm, None, 1.0, "raw",
                                              None, dev),
        "grid multiplicative 1 m": check_map_card_vs_cpu(
            "map grid multiplicative 1 m", tp, tm, tcov_cpu, 1.0, "multiplicative", dims, dev),
    }
    for case in synthetic.ndt_lookup_edge_cases():
        if case["resolution"] != 1.0:
            pts = np.concatenate([case["target"], case["source"]]).astype(np.float32)
            msk = np.concatenate([case["tmask"], case["smask"]])
            maps[f"hash raw {case['name']}"] = check_map_card_vs_cpu(
                f"map hash raw {case['name']}", pts, msk, None, case["resolution"], "raw",
                None, dev)

    x = torch.eye(4, device=dev)
    lin = {}
    for name, (vmap, offsets, (_l, _e, freeze, _lf), src_c, smask, scov) in (
            class_map_objectives(dev, pair, scov, tcov).items()):
        ids, valid = freeze(x)
        K = len(offsets)
        N = src_c.shape[0]
        P = src_c.T.repeat(1, K).contiguous()
        CA = scov.repeat(1, K).contiguous()
        table = vmap.packed
        require(table.is_contiguous() and table.data_ptr() % 16 == 0,
                f"linearize ({name} map): packed rows not contiguous and 16-byte aligned")
        _got, max_err = check_linearize(f"linearize ({name} map)", False, P, CA, x, table,
                                        valid, ids, "rel_max")
        src_lanes = smask.repeat(K)
        misses = int((src_lanes & (valid == 0)).sum())
        require(misses > 0 and bool(valid.any()),
                f"linearize ({name} map): expected valid lanes and misses")
        ms = device_ms(lambda: cuda_linearize.linearize(P, CA, x, table, valid, ids), 200,
                       LIN_KERNEL.format(raw="false"))
        unique_rows = int(torch.unique(ids[valid > 0]).numel())
        # each source column and covariance once (P and CA tile them K
        # times), a lane's valid, id and aux, each row the valid lanes name
        nbytes = (N * (12 + 24) + P.shape[1] * (4 + 4 + 40) + unique_rows * 64 + 64
                  + 43 * 4)
        b_ms, b_by = bound_ms(nbytes, P.shape[1] * LINEARIZE_OPS)
        lin[name] = dict(lanes=P.shape[1], source_columns=N, bytes=nbytes,
                         valid_lanes=int((valid > 0).sum()),
                         source_lanes_missing=misses, max_abs_err=max_err, ms=ms,
                         bound_ms=b_ms, bound_by=b_by, unique_rows=unique_rows,
                         rows=table.shape[0])
        log(f"[kernels] linearize ({name} map, {vmap.__class__.__name__}) at L = "
            f"{P.shape[1]}: idx form bit-equal to the gathered form and a repeat, "
            f"max_abs_diff {max_err:.3e} (rel_max); {lin[name]['valid_lanes']} valid lanes, "
            f"{misses} masked-in lanes missing; {ms:.5f} ms, bound {b_ms:.3e} ms ({b_by})")
    rec = next(r for r in records if r["name"] == "linearize")
    rec["class_maps"] = lin
    return maps


def _cached(reg):
    """[source, target] of what the clouds cache: NDTCuda's voxel map
    entries (`ndt_cache`), else the covariances."""
    ndt = hasattr(reg, "distance_mode")
    return [c.ndt_cache if ndt else c.covs for c in (reg._source, reg._target)]


def class_workflow(reg, source, target, scores=True):
    """The class API's swap workflow: set_input_target / set_input_source,
    align (the fresh path: both clouds' covariances, or NDTCuda's maps, and
    the align), then swap_source_and_target and align (on the cached state,
    which the swap moved with the clouds: the second align rebuilds none of
    it; P2D's fresh align prepares no source map, so its second align
    builds the new target's), with `scores` evaluate_cost at that pose
    (FastGICPMultiPoints has none, as in the JAX package) and
    get_fitness_score.  Returns (fresh pose, swapped pose, their
    iterations, cost, fitness, maps or covariances the second align
    built)."""
    reg.set_input_target(target)
    reg.set_input_source(source)
    T1 = reg.align()
    it1 = reg.get_num_iterations()
    before = _cached(reg)
    p2d = getattr(reg, "distance_mode", None) == "p2d"
    require(before[1] is not None and (p2d or before[0] is not None),
            f"the fresh align left nothing in the cache: {[b is None for b in before]}")
    reg.swap_source_and_target()
    T2 = reg.align()
    it2 = reg.get_num_iterations()
    after = _cached(reg)  # [the old target, the old source]
    require(after[0] is before[1] and (before[0] is None or after[1] is before[0]),
            "the align after the swap rebuilt a cloud's cached state")
    built = sum(b is None and a is not None for a, b in zip(after, before[::-1]))
    cost = fitness = None
    if scores:
        cost = None if hasattr(reg, "search_radius") else reg.evaluate_cost(T2)
        fitness = reg.get_fitness_score()
    return T1, T2, (it1, it2), cost, fitness, built


def phase_class_main(dev, pair, path):
    """A class path's workflow (`class_workflow`) on the full-size pair,
    with every launch counter set to 0 just before it and read just after:
    both poses against the ground truth and its inverse, every kernel of the
    path launched, one trial launch a host sync, no standalone trial or
    error launch, every linearize launch the idx form, none of
    linearize_raw."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    source, target, gt = pair
    make, kernels, _pair = CLASS_PATHS[path]
    class_workflow(make(dev), source, target)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    T1, T2, its, cost, fitness, built = class_workflow(make(dev), source, target)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    syncs = lsq_solve.host_syncs
    errs = [pose_errors(T1, gt), pose_errors(T2, np.linalg.inv(gt))]
    log(f"[main] {path}: fresh t_err {errs[0][0]:.6f} m r_err {errs[0][1]:.6f} deg, "
        f"swapped t_err {errs[1][0]:.6f} m r_err {errs[1][1]:.6f} deg, iterations {its}, "
        f"host syncs {syncs}, cost at the swapped pose {cost}, fitness {fitness:.6f}, "
        f"cached states the second align built {built}, "
        f"wall {wall_ms:.3f} ms (both aligns, evaluate_cost, fitness), launches {launches}")
    t_lim, r_lim = CLASS_LIMITS.get(path, D2D_LIMITS)
    require(all(np.isfinite(T).all() for T in (T1, T2)), f"{path}: non-finite pose")
    require(all(t < t_lim and r < r_lim for t, r in errs), f"{path}: pose errors {errs}")
    require((cost is None or math.isfinite(cost)) and math.isfinite(fitness),
            f"{path}: non-finite cost")
    require(built == (1 if path in ("ndt_p2d_class", "ndt_p2d_hash") else 0),
            f"{path}: the align after the swap built {built} cached states")
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    require(launches["lm_step"] == syncs, f"{path}: {launches['lm_step']} trial launches "
            f"for {syncs} trials")
    require(all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"{path}: a standalone trial or error launch in the LM solve: {launches}")
    check_lin_forms(path, launches, CLASS_LIN_FORM.get(path, "idx"))
    return launches, dict(t_err_m=[e[0] for e in errs], r_err_deg=[e[1] for e in errs],
                          iterations=list(its), host_syncs=syncs, wall_ms=wall_ms,
                          cost=cost, fitness=fitness, second_align_built=built)


def reset_counters():
    """Every launch counter (and the idx and lookup form counters) to 0."""
    for fn in counters().values():
        fn.launches = 0
    for k in IDX_COUNTED:
        counters()[k].idx_launches = 0
    for k in NDT_FORM_COUNTED:
        counters()[k].lookup_launches = 0


def read_counters():
    """{counter: launches} with "name[idx]" and "name[lookup]" for the form
    counters."""
    launches = {k: fn.launches for k, fn in counters().items()}
    launches.update({f"{k}[idx]": counters()[k].idx_launches for k in IDX_COUNTED})
    launches.update({f"{k}[lookup]": counters()[k].lookup_launches for k in NDT_FORM_COUNTED})
    return launches


def check_lin_forms(path, launches, form):
    """How the path's linearize launches reach the target side: "idx"
    (every linearize launch reads its rows by index, none on raw rows),
    "idx_raw" (every linearize_raw launch reads its raw rows by index, no
    linearize launch), "gathered" (every linearize launch on gathered
    rows), "lookup" (every NDT launch the lookup form) or "pack" (every
    NDT launch the pack form, where NDT_PACK_ALLOWED allows it)."""
    lin, idx = launches["linearize"], launches["linearize[idx]"]
    raw, raw_idx = launches["linearize_raw"], launches["linearize_raw[idx]"]
    ndt = {k: (launches[k], launches[f"{k}[lookup]"]) for k in NDT_FORM_COUNTED}
    if form == "idx_raw":
        require(raw_idx == raw and lin == 0 and not any(n for n, _l in ndt.values()),
                f"{path}: a linearize launch not in the {form} form: {launches}")
    elif form in ("idx", "gathered"):
        require(idx == (lin if form == "idx" else 0) and raw == 0
                and not any(n for n, _l in ndt.values()),
                f"{path}: a linearize launch not in the {form} form: {launches}")
    elif form == "lookup":
        require(all(n == look for n, look in ndt.values()) and lin == 0,
                f"{path}: an NDT linearize launch not in the lookup form: {launches}")
    else:
        require(all(look == 0 and (n == 0 or (path, k) in NDT_PACK_ALLOWED)
                    for k, (n, look) in ndt.items()) and lin == 0,
                f"{path}: an NDT linearize launch not in an allowed pack form: {launches}")


# NDT on the hash map: `_ndt_voxelmap` sums raw moments E[x x^T] in the
# cloud's frame (the JAX package's build), and P2D's M = cov_B^-1 of the
# clamped near-planar voxels magnifies the last bits in which the card's
# map differs from the CPU's (the atomic scatter-add order, the clamp's
# acos / cos): the fresh poses land 1.5e-3 to 1.9e-3 apart (H100,
# full-size pair; 1.7e-3 for P2D with deterministic scatter-adds too), where
# the dense grids' corner-relative moments give 2e-6.
HASH_POSE_TOL = 3e-3


def phase_class_card_vs_cpu(dev, pair, path):
    """The class workflow's two aligns on the card against the same class
    with device="cpu" (the plain versions), on `pair`: poses within 1e-3
    (the hash-map NDT paths within HASH_POSE_TOL), iterations within 1,
    the card's poses within the reference's limits."""
    source, target, gt = pair
    make = CLASS_PATHS[path][0]
    gpu, cpu = (class_workflow(make(d), source, target, scores=False) for d in (dev, "cpu"))
    diffs = [float(np.abs(a - b).max()) for a, b in zip(gpu[:2], cpu[:2])]
    tol = HASH_POSE_TOL if CLASS_LIN_FORM.get(path) == "pack" else 1e-3
    errs = [pose_errors(gpu[0], gt), pose_errors(gpu[1], np.linalg.inv(gt))]
    log(f"[card vs cpu] {path}, {len(source)} source points: |T_gpu - T_cpu| max "
        f"{diffs[0]:.3e} (fresh), {diffs[1]:.3e} (swapped); iterations gpu {gpu[2]} cpu "
        f"{cpu[2]}; t_err {errs[0][0]:.6f}, {errs[1][0]:.6f} m")
    require(max(diffs) <= tol, f"{path} card vs cpu: pose diffs {diffs}")
    require(all(abs(a - b) <= 1 for a, b in zip(gpu[2], cpu[2])),
            f"{path} card vs cpu: iteration counts differ by more than 1")
    t_lim, r_lim = CLASS_LIMITS.get(path, D2D_LIMITS)
    require(all(t < t_lim and r < r_lim for t, r in errs), f"{path} card vs cpu: {errs}")
    return dict(source_points=len(source), pose_diff=diffs, tolerance=tol,
                iterations_gpu=list(gpu[2]), iterations_cpu=list(cpu[2]))


def _fresh_class(dev, pair, path):
    """A class instance of `path` holding the pair, and one registration of
    it: clear_covariances, then align_async (the fresh path; the clouds are
    not uploaded again)."""
    source, target, _gt = pair
    reg = CLASS_PATHS[path][0](dev)
    reg.set_input_target(target)
    reg.set_input_source(source)

    def register():
        reg.clear_covariances()
        return reg.align_async()

    return reg, register


def phase_class_bench(dev, pair, path, n_regs=BENCH_REGS):
    """`n_regs` fresh class registrations after a warm-up (clear_covariances
    + align_async, the class API's form of a fresh instance per align,
    align.cpp:56-76), closed by a synchronise."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    _reg, register = _fresh_class(dev, pair, path)
    register()
    torch.cuda.synchronize()
    syncs0 = lsq_solve.host_syncs
    t0 = time.perf_counter()
    iters = [register().iterations for _ in range(n_regs)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_regs
    iters = torch.stack(iters).cpu().numpy()
    syncs = (lsq_solve.host_syncs - syncs0) / n_regs
    log(f"[bench] {path}, {n_regs} registrations: {ms:.4f} ms/registration "
        f"({1e3 / ms:.2f} reg/s), iterations mean {iters.mean():.2f}, "
        f"host syncs/registration {syncs:.2f}")
    return dict(registrations=n_regs, ms_per_registration=ms, registrations_per_s=1e3 / ms,
                mean_iterations=float(iters.mean()), host_syncs_per_registration=syncs)


def phase_class_profile(dev, pair, path, n_regs=5):
    """Stage wall times of a class path (a fresh align with its result read;
    an align after a swap, on the cached covariances), then the trace of
    `n_regs` fresh registrations (`trace_registrations`), its device ops
    against PREDICTED_CLASS_OPS at the registrations' own iterations and
    trials; the trace's host copies must be one a trial and the result's
    read, none the other way."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    reg, register = _fresh_class(dev, pair, path)

    def swapped():
        # the other way round on the cached covariances, then back
        reg.swap_source_and_target()
        reg.align()
        reg.swap_source_and_target()

    stages = {"fresh align": wall_ms(lambda: (register(), reg.get_final_transformation())),
              "swapped align (cached covariances)": wall_ms(swapped)}
    log(f"[profile] {path} stage wall ms/registration: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    syncs0, its = lsq_solve.host_syncs, []

    def run():
        register()
        its.append(reg.get_num_iterations())

    def predicted():
        if path not in PREDICTED_CLASS_OPS:
            return None
        const, per_lin, per_trial = PREDICTED_CLASS_OPS[path]
        trials = (lsq_solve.host_syncs - syncs0) / len(its)
        return round(const + per_lin * sum(its) / len(its) + per_trial * trials, 1)

    # a copy either way waits for the queue: the only ones are the flag
    # read a trial and the result's one read (the traced registrations'
    # own trials: on the hash maps the atomic sums move the iterations
    # from one registration to the next).  The profiler loses events now
    # and then (device_ms), so a trace short of read-backs is taken again;
    # one copy too many fails at once.
    for attempt in range(DEVICE_MS_TRACES):
        traced = trace_registrations(path, run, n_regs, predicted, all_ops=True)
        trials = traced["traced_host_syncs"]
        copies, want = traced["copies_per_registration"], {"HtoD": 0, "DtoH": trials + 1}
        if copies == want or copies["HtoD"] > 0 or copies["DtoH"] > want["DtoH"]:
            break
        log(f"[profile] {path}: the trace held {copies} copies a registration for {trials} "
            f"trials (trace {attempt + 1} of {DEVICE_MS_TRACES})")
    require(copies == want,
            f"{path}: host copies a registration {copies} for {trials} trials")
    return dict(stage_wall_ms=stages, iterations=sorted(set(its)),
                trials_per_registration=(lsq_solve.host_syncs - syncs0) / len(its), **traced)

# -- NDTCuda's hash map, FastGICPMultiPoints, the batch aligns, pygicp -------


class _FirstCall(Exception):
    """Raised by `first_call`'s stand-in wrapper to end the run."""


def first_call(run, module, name, match=None):
    """The arguments, tensors cloned, of the first call of `module.name` in
    `run()` for which `match(*args, **kwargs)` holds (the first call when
    `match` is None): (args, kwargs).  The stand-in launches nothing and
    ends the run there; the calls before it run as they would (a wrapper
    counts its launches on the module's name for it, the stand-in's copy
    of the count while the stand-in is in place)."""
    real, got = getattr(module, name), []

    def clone(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    @functools.wraps(real)
    def stand_in(*args, **kwargs):
        if match is not None and not match(*args, **kwargs):
            return real(*args, **kwargs)
        got.append((tuple(clone(a) for a in args),
                    {k: clone(v) for k, v in kwargs.items()}))
        raise _FirstCall

    setattr(module, name, stand_in)
    try:
        run()
    except _FirstCall:
        pass
    finally:
        setattr(module, name, real)
    require(len(got) == 1, f"the run made no call of {name} that was looked for")
    return got[0]


def first_trial(run):
    """The inputs (y0, H, b, aux, cost, n_src) of the first LM trial that
    `run()` launches: its first linearization, as the path's objective
    built it on the card; the run stops there."""
    from fast_gicp_tpu_torch.ops import cuda_solver

    (_state, H, b, y0, aux, cost, _first, _config), _kw = first_call(run, cuda_solver,
                                                                      "lm_step")
    return y0, H, b, aux, cost, aux.shape[1] // cost.offsets


def padded(pair):
    """(sp, sm, tp, tm) of a pair, padded, as numpy."""
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    return pad_points(source) + pad_points(target)


@functools.cache
def batch_arrays():
    """B = 4 consecutive full-size pairs of the drive (frames f -> target,
    f + 1 -> source, f = 30..33, 0.1 m), padded to one size: numpy (sp, sm,
    tp, tm) (B, M, ...), identity guesses (B, 4, 4) and ground truths."""
    from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
    from fast_gicp_tpu_torch.utils.padding import bucket_size
    from fast_gicp_tpu_torch.utils.synthetic import drive_scans, drive_world

    rng = np.random.default_rng(0)
    scans, gt = drive_scans(rng, n_frames=BATCH_FRAMES[-1] + 1, world=drive_world(rng))
    clouds = [voxel_downsample(scans[f], 0.1) for f in BATCH_FRAMES]
    m = bucket_size(max(len(c) for c in clouds))
    pts = np.zeros((len(clouds), m, 3), np.float32)
    mask = np.zeros((len(clouds), m), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    B = len(clouds) - 1
    return dict(sp=pts[1:], sm=mask[1:], tp=pts[:-1], tm=mask[:-1],
                guess=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
                gt=np.stack([np.linalg.inv(gt[f]) @ gt[f + 1] for f in BATCH_FRAMES[:-1]]))


def batch_on(dev):
    """`batch_arrays` as tensors on `dev`, with the kNN covariances (6, M) of
    every cloud made there (the VGICP batch's input)."""
    from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols

    a = {k: torch.as_tensor(v, device=dev) for k, v in batch_arrays().items() if k != "gt"}
    for pk, mk, ck in (("sp", "sm", "sc"), ("tp", "tm", "tc")):
        a[ck] = torch.stack([knn_covariance_cols(p, m) for p, m in zip(a[pk], a[mk])])
    return a


def pygicp_run(path, pair, device):
    """align_points of the path's method on the (already downsampled)
    pair, the rest of its arguments at their defaults."""
    from fast_gicp_tpu_torch import pygicp

    source, target, _gt = pair
    return pygicp.align_points(target, source, method=PYGICP_PATHS[path][0], device=device)


NEW_TRIAL_PATHS = ("ndt_d2d_hash", "ndt_p2d_hash", "fast_gicp_multipoints") + tuple(
    BATCH_PATHS) + tuple(PYGICP_PATHS)


def new_path_trial_inputs(dev, pair):
    """{path: first_trial of the path} for NDTCuda on the hash map,
    FastGICPMultiPoints, the two batch aligns (their first pair) and each
    pygicp method, as each runs on the full-size pair.  NDTCuda on the dense
    grid solves `ndt_register_fresh`'s objective, whose inputs
    `trial_inputs` takes as ndt_d2d_fresh / ndt_p2d_fresh."""
    source, target, _gt = pair
    out = {}
    for path in NEW_TRIAL_PATHS[:3]:
        reg = CLASS_PATHS[path][0](dev)
        reg.set_input_target(target)
        reg.set_input_source(source)
        out[path] = first_trial(reg.align)
    arrays = batch_on(dev)
    for path, (kind, _k, _l) in BATCH_PATHS.items():
        out[path] = first_trial(lambda: _batch_path(kind)[0](arrays, dev))
    for path in PYGICP_PATHS:
        out[path] = first_trial(lambda: pygicp_run(path, pair, dev))
    return out


def phase_new_path_kernels(dev, pair, records):
    """The kernels of the new paths against their plain versions at those
    paths' own shapes, added to the kernels' records:
    * ndt_d2d / ndt_p2d in the pack form on NDTCuda's hash-map path at its
      first freeze (identity, the target-centroid frame; the maps built on
      the CPU, see objective_on): the card's eager freeze equal to the
      CPU's (valid equal, misses never valid), the pack-form launch within
      the NDT tolerances of its plain version and bit-identical on a
      repeat; timed with the freeze ("pose to [err, H, b]");
    * knn_slab as the exact k = 32 search of FastGICPMultiPoints' first
      linearization (the source at identity, every 128-point target tile a
      candidate), idx equal and sq bit-equal to its plain version;
    * linearize in the gathered form on that linearization's averaged rows
      [q, cov_B, 1, pad], within GICP's tolerance of its plain version,
      bit-identical on a repeat."""
    from fast_gicp_tpu_torch.models.experimental import MultiPointConfig, averaged_rows
    from fast_gicp_tpu_torch.models.ndt import NDTConfig, ndt_path_objective
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_ndt
    from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols
    from fast_gicp_tpu_torch.ops.neighbors import _center_clouds

    by_name = {r["name"]: r for r in records}
    x = torch.eye(4, device=dev)
    sp, sm, tp, tm = padded(pair)
    _check_aux, check_lin = ndt_checkers(x)
    for mode in ("d2d", "p2d"):
        oc, _c = ndt_path_objective(sp, sm, tp, tm, NDTConfig(distance_mode=mode), fresh=True,
                                    device="cpu")
        obj = objective_on(oc, dev)
        pack = obj.freeze(x)
        want_pack = oc.freeze(x.cpu())
        require(bool(torch.equal(pack[:, 9].cpu(), want_pack[:, 9])),
                f"ndt_{mode} hash freeze: valid differs from the CPU's")
        check_close(f"ndt_{mode} hash freeze", pack.cpu(), want_pack, 1e-5, 1e-6)
        got = check_lin(f"ndt_{mode} (hash map)", obj.p, obj.ca, pack, mode, 1e-5)
        N, L = obj.p.shape[1], pack.shape[0]
        valid = int(pack[:, 9].sum())
        tm_ = timings(lambda: cuda_ndt.ndt_linearize(obj.p, obj.ca, x, pack, 1.0, mode),
                      lambda: cuda_ndt.ndt_linearize_plain(obj.p, obj.ca, x, pack, 1.0, mode),
                      ndt_kernel_name(mode, "pack"), 200, 20)
        freeze_ms = device_ms(lambda: obj.freeze(x), 50)
        nbytes = ndt_lin_bytes(mode, "pack", N, L)
        b_ms, b_by = bound_ms(nbytes, ndt_lin_ops(mode, "pack", L, valid))
        rec = dict(lanes=L, source_columns=N, valid_lanes=valid, max_abs_err=got[-1],
                   pack_ms=tm_["ms"], plain_ms=tm_["plain_ms"], call_ms=tm_["call_ms"],
                   freeze_ms=freeze_ms,
                   pose_to_normal_eq_ms=device_ms(lambda: obj.linearize(x), 50),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, timing=tm_["timing"])
        by_name[f"ndt_{mode}"]["hash_path"] = rec
        log(f"[kernels] ndt_{mode} pack form on the hash path (NDTCuda, grid_dims None) at "
            f"L = {L}: the card's freeze equal to the CPU's, within tolerance of the plain "
            f"version ({got[-1]:.3e}), {tm_['ms']:.5f} ms, plain {tm_['plain_ms']:.4f} ms; "
            f"eager freeze {freeze_ms:.5f} ms, pose to [err, H, b] "
            f"{rec['pose_to_normal_eq_ms']:.5f} ms; bound {b_ms:.3e} ms ({b_by})")

    # FastGICPMultiPoints' first linearization: the exact k = 32 search of the
    # source at identity, then the linearize of the averaged rows
    src, smask, tgt, tmask = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    scov, tcov = knn_covariance_cols(src, smask), knn_covariance_cols(tgt, tmask)
    cfg = MultiPointConfig()
    k, n = cfg.k_neighbors, src.shape[0]
    q, t = _center_clouds(src, tgt, tmask)
    T = n // 128
    cidx = torch.arange(T, dtype=torch.int32, device=dev).expand(n // 256, T).contiguous()
    ones = torch.ones_like(smask)
    args = (q, ones, t, tmask, cidx, k, 128)
    idx, sq = cuda_kernels.knn_slab(*args)
    idx_w, sq_w = cuda_kernels.knn_slab_plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.equal(sq, sq_w)) and bool(torch.equal(idx, idx_w)),
            f"knn_slab (multipoint, k = {k}): {int((idx != idx_w).sum())} ids, "
            f"{int((sq != sq_w).sum())} d^2 differ")
    tm_ = timings(lambda: cuda_kernels.knn_slab(*args),
                  lambda: cuda_kernels.knn_slab_plain(*args), "knn_slab_kernel", 20, 2)
    b_ms, b_by = bound_ms(2 * n * 16 + cidx.numel() * 4 + n * k * 8,
                          n * n * SLAB_OPS_PER_CANDIDATE)
    by_name["knn_slab"]["multipoint"] = dict(
        k=k, queries=n, candidates=n * n, max_abs_err=0.0, ms=tm_["ms"],
        plain_ms=tm_["plain_ms"], call_ms=tm_["call_ms"], bound_ms=b_ms, bound_by=b_by,
        timing=tm_["timing"])
    log(f"[kernels] knn_slab exact k = {k} (FastGICPMultiPoints' search, {n} x {n}): idx "
        f"equal, sq bit-equal; {tm_['ms']:.4f} ms, plain {tm_['plain_ms']:.3f} ms; bound "
        f"{b_ms:.3e} ms ({b_by})")
    # the objective's own averaging on these neighbours, then the
    # gathered-form launch
    rows, valid = averaged_rows(idx, sq, smask, torch.cat([tgt, tcov.T], dim=1),
                                cfg.search_radius)
    P, CA = src.T.contiguous(), scov.contiguous()
    got = cuda_linearize.linearize(P, CA, x, rows, valid)
    again = cuda_linearize.linearize(P, CA, x, rows, valid)
    want = cuda_linearize.linearize_plain(P, CA, x, rows, valid)
    torch.cuda.synchronize()
    require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            "linearize (multipoint rows): a repeat launch differs")
    err = check_lin_outputs("linearize (multipoint rows)", got, want, "rel_max")
    ms = device_ms(lambda: cuda_linearize.linearize(P, CA, x, rows, valid), 200,
                   LIN_KERNEL.format(raw="false"))
    plain_ms = device_ms(lambda: cuda_linearize.linearize_plain(P, CA, x, rows, valid), 20)
    nbytes = n * (12 + 24 + 64 + 4 + 40) + 64 + 43 * 4  # source, rows, valid, aux once
    b_ms, b_by = bound_ms(nbytes, n * LINEARIZE_OPS)
    by_name["linearize"]["multipoint"] = dict(
        lanes=n, valid_lanes=int(valid.sum()), form="gathered", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    log(f"[kernels] linearize, gathered form on FastGICPMultiPoints' averaged rows at L = "
        f"{n}: within tolerance of the plain version ({err:.3e}), a repeat bit-identical; "
        f"{ms:.5f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.3e} ms ({b_by})")


def _deterministic(fn):
    """fn() with torch's deterministic algorithms on (a warning, not an
    error, where an op has none): the maps' scatter-adds then sum in a
    fixed order, so two runs of the same registration give the same bits."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def phase_batch_main(dev, path):
    """A batch path on B = 4 consecutive full-size pairs, with every launch
    counter set to 0 just before it and read just after: each pair's pose
    against its ground truth, every kernel of the path launched, one trial
    launch a host sync, the linearize forms; then each pair's result bit for
    bit against the per-pair call (`ndt_align` / `vgicp_align` with the
    same config), both run with deterministic scatter-adds."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    kind, kernels, (t_lim, r_lim) = BATCH_PATHS[path]
    run, one = _batch_path(kind)
    arrays = batch_on(dev)
    gts = batch_arrays()["gt"]
    run(arrays, dev)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    res = run(arrays, dev)
    T = res.transformation.cpu().numpy()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    syncs = lsq_solve.host_syncs
    errs = [pose_errors(T[i].astype(np.float64), gts[i]) for i in range(len(gts))]
    iters = res.iterations.cpu().tolist()
    log(f"[main] {path}, B = {len(gts)}: t_err {[round(e[0], 6) for e in errs]} m, r_err "
        f"{[round(e[1], 6) for e in errs]} deg, iterations {iters}, host syncs {syncs}, wall "
        f"{wall:.3f} ms, launches {launches}")
    require(np.isfinite(T).all() and T.shape == (len(gts), 4, 4), f"{path}: poses")
    require(all(t < t_lim and r < r_lim for t, r in errs), f"{path}: pose errors {errs}")
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    require(launches["lm_step"] == syncs, f"{path}: {launches['lm_step']} trial launches "
            f"for {syncs} trials")
    require(all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"{path}: a standalone trial or error launch in the LM solve: {launches}")
    check_lin_forms(path, launches, "pack" if kind == "ndt" else "idx")
    got = _deterministic(lambda: run(arrays, dev))
    for i in range(len(gts)):
        want = _deterministic(lambda: one(arrays, i, dev))
        require(all(bool(torch.equal(g[i], w)) for g, w in zip(got, want)),
                f"{path}: pair {i} differs from the per-pair call")
    log(f"[main] {path}: each pair's result (pose, Hessian, error, converged, iterations) "
        f"bit-equal to the per-pair call, both with deterministic scatter-adds")
    return launches, dict(pairs=len(gts), t_err_m=[e[0] for e in errs],
                          r_err_deg=[e[1] for e in errs], iterations=iters, host_syncs=syncs,
                          wall_ms=wall, bit_equal_to_pairs=True)


def phase_batch_card_vs_cpu(dev, path):
    """The batch on the card against the same call with device="cpu" on the
    same inputs (the card's covariances carried over): poses within 1e-3
    (the NDT batch, on the hash map, within HASH_POSE_TOL), iterations
    within 1."""
    kind = BATCH_PATHS[path][0]
    tol = HASH_POSE_TOL if kind == "ndt" else 1e-3
    run = _batch_path(kind)[0]
    arrays = batch_on(dev)
    gpu = run(arrays, dev)
    cpu = run({k: v.cpu() for k, v in arrays.items()}, "cpu")
    diff = float((gpu.transformation.cpu() - cpu.transformation).abs().max())
    it_g, it_c = gpu.iterations.cpu().tolist(), cpu.iterations.tolist()
    log(f"[card vs cpu] {path}: |T_gpu - T_cpu| max {diff:.3e}, iterations gpu {it_g} cpu "
        f"{it_c}")
    require(diff <= tol, f"{path} card vs cpu: pose diff {diff}")
    require(all(abs(a - b) <= 1 for a, b in zip(it_g, it_c)),
            f"{path} card vs cpu: iteration counts differ by more than 1")
    return dict(pose_diff=diff, tolerance=tol, iterations_gpu=it_g, iterations_cpu=it_c)


def phase_batch_timing(dev, path, n_batches=BENCH_BATCHES):
    """ms a registration over `n_batches` batch calls after a warm-up, then
    a traced batch's device busy time and ops (per registration: / B)."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    run = _batch_path(BATCH_PATHS[path][0])[0]
    arrays = batch_on(dev)
    B = arrays["sp"].shape[0]
    run(arrays, dev)
    torch.cuda.synchronize()
    syncs0 = lsq_solve.host_syncs
    t0 = time.perf_counter()
    for _ in range(n_batches):
        run(arrays, dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n_batches * B)
    syncs = (lsq_solve.host_syncs - syncs0) / (n_batches * B)
    log(f"[bench] {path}, {n_batches} batches of {B}: {ms:.4f} ms/registration, host "
        f"syncs/registration {syncs:.2f}")
    traced = trace_registrations(path, lambda: run(arrays, dev), 3, None)
    per_reg = {k: traced[k] / B for k in ("device_busy_ms", "device_ops_per_registration",
                                         "device_span_ms", "traced_wall_ms")}
    log(f"[profile] {path} per registration (a batch / {B}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_reg.items()))
    return dict(ms_per_registration=ms, host_syncs_per_registration=syncs, batch=B,
                per_registration=per_reg, per_batch=traced)


def phase_pygicp(dev, pair, small, path, n_regs=20):
    """`pygicp.align_points` of the path's method on the full-size pair:
    with every launch counter set to 0 just before it and read just after,
    the pose against the ground truth, every kernel of the path launched,
    one trial launch a host sync; then the same call with device="cpu" on
    `PYGICP_PATHS`' pair (poses within 1e-3), `n_regs` calls timed, a few
    traced."""
    from fast_gicp_tpu_torch.solver import lsq_solve

    method, kernels, which, (t_lim, r_lim) = PYGICP_PATHS[path]
    gt = pair[2]
    pygicp_run(path, pair, dev)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    T = pygicp_run(path, pair, dev)
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    syncs = lsq_solve.host_syncs
    t_err, r_err = pose_errors(T, gt)
    log(f"[main] {path} (align_points {method!r}): t_err {t_err:.6f} m, r_err {r_err:.6f} "
        f"deg, host syncs {syncs}, wall {wall:.3f} ms, launches {launches}")
    require(np.isfinite(T).all() and t_err < t_lim and r_err < r_lim,
            f"{path}: pose error {t_err} m {r_err} deg")
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    require(launches["lm_step"] == syncs and all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"{path}: trial launches {launches}, {syncs} syncs")
    check_lin_forms(path, launches, {"GICP": "idx", "NDT_CUDA": "lookup"}.get(method, "idx_raw"))
    cvc = pair if which == "full" else small
    T_gpu, T_cpu = (pygicp_run(path, cvc, d) for d in (dev, "cpu"))
    diff = float(np.abs(T_gpu - T_cpu).max())
    log(f"[card vs cpu] {path} ({which} pair): |T_gpu - T_cpu| max {diff:.3e}")
    require(diff <= 1e-3, f"{path} card vs cpu: pose diff {diff}")
    syncs0 = lsq_solve.host_syncs
    t0 = time.perf_counter()
    for _ in range(n_regs):
        pygicp_run(path, pair, dev)
    ms = (time.perf_counter() - t0) * 1e3 / n_regs
    host_syncs = (lsq_solve.host_syncs - syncs0) / n_regs
    log(f"[bench] {path}, {n_regs} align_points calls: {ms:.4f} ms/registration, host syncs "
        f"{host_syncs:.2f}")
    traced = trace_registrations(path, lambda: pygicp_run(path, pair, dev), 3, None)
    return launches, dict(main_path=dict(t_err_m=t_err, r_err_deg=r_err, host_syncs=syncs,
                                         wall_ms=wall),
                          card_vs_cpu=dict(pair=which, pose_diff=diff),
                          bench=dict(registrations=n_regs, ms_per_registration=ms,
                                     host_syncs_per_registration=host_syncs),
                          profile=traced)


# -- slice F: odometry on the synthetic drive -------------------------------

ODOMETRY_SEED = 11  # tools/bench_odometry.py's drive
ODOMETRY_FRAMES = 128  # about 120 m at about 1 m and 0.7 deg a frame
ODOMETRY_DOWNSAMPLE = 0.25  # the KITTI app's default
ODOMETRY_CHUNK = 32  # the KITTI app's map mode: process_chunk of 32 frames
LOCALIZATION_FRAMES = 32
KERNEL_FRAME = 16  # scan_to_map's frame whose first linearization phase 3 checks
PROFILE_FRAMES = 8
WARMUP_FRAMES = 32  # the warm-up run before a path's timed 128 frames
SYNC_FRAMES = 32  # a chunk of scan_to_map: its fill is read before and after it
# the host reads a path makes over SYNC_FRAMES frames besides the solve's
# flag read a trial, as in the JAX package: serial the class API's result a
# frame, stream and scan the deltas once at the end, scan_to_map its fill
# before and after a chunk, localization none
ODOMETRY_READS = {"odometry_serial": SYNC_FRAMES, "odometry_stream": 1, "odometry_scan": 1,
                  "scan_to_map": 2, "localization": 0}
SCAN_TO_MAP_ATE = 0.05  # m, tests/test_scan_to_map.py:66-81
SCAN_TO_SCAN_ATE_SHARE = 0.01  # of the driven distance, tests/test_odometry.py:185-206
LOCALIZATION_TOL = 0.05  # m from the mapping pass's poses
# m, the largest per-frame pose difference of the first 8 frames of the
# small drive, card against CPU (deterministic scatter-adds).  The gap is
# the covariances': the kernels sum their moments about a centre and the
# finalize cancels most digits, so the card's and the CPU's sums, added in
# another order, part; fed the CPU's covariances the card's stream deltas
# sit within 2.4e-6 of the CPU's (ODOMETRY_SOLVE_TOL).  Read on every run
# to the bit: serial 2.7e-5, stream 8.0e-4, scan 3.9e-4, scan_to_map 9.2e-5.
# On the CPU, moments rounded by a relative 1e-7 at random move the same
# paths 2.3e-5, 2.3e-3, 1.6e-3 and 9.2e-4, and by 1e-5 1.1e-3, 4.4e-3,
# 3.8e-3 and 1.6e-3 (tests/torch_odometry_sensitivity.py): each limit is
# 2.5-11x its reading and below the second.
ODOMETRY_CARD_CPU_TOL = {"odometry_serial": 2e-4, "odometry_stream": 2e-3,
                         "odometry_scan": 2e-3, "scan_to_map": 1e-3}
ODOMETRY_SOLVE_TOL = 1e-5  # the stream's deltas on the CPU's covariances


@functools.cache
def odometry_drive(n_world=None, voxel=ODOMETRY_DOWNSAMPLE, frames=ODOMETRY_FRAMES):
    """The odometry drive: `drive_scans` with seed 11 (its default 1.4M-point
    world, or an `n_world`-point one), each scan voxel-downsampled on the
    host once, outside every timed window.  Returns (clouds, gt poses, the
    dense grid over the union of the raw scans' extents at 1 m, as the
    KITTI app's stream and scan modes size it)."""
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims_multi
    from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
    from fast_gicp_tpu_torch.utils.synthetic import drive_scans, drive_world

    rng = np.random.default_rng(ODOMETRY_SEED)
    world = drive_world(rng) if n_world is None else drive_world(rng, n=n_world)
    scans, gt = drive_scans(rng, n_frames=frames, world=world)
    return ([voxel_downsample(s, voxel) for s in scans], gt,
            auto_grid_dims_multi(scans, 1.0))


def localization_config():
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig

    return ScanToMapConfig(fuse_scans=False, objective="ndt_d2d")


def odometry_run(path, dev, frames=None, drive=None, map_path=None, device_loop=False):
    """The path over the drive's first `frames` frames (all by default) as a
    user runs it: (poses, the ScanToMapOdometry or None).  The scan-to-scan
    modes as the KITTI app builds them (serial: `FastVGICP(resolution=1)`,
    kNN covariances and the auto dense grid; stream and scan: RBF
    covariances and the dense grid over the drive), on the host-downsampled
    clouds (downsample -1: passed through); scan_to_map:
    `ScanToMapOdometry(ScanToMapConfig())` fed chunks of 32 frames, the
    app's map mode; localization: NDT D2D on the mapping pass's map saved at
    `map_path`, loaded with `load_map`, fuse_scans=False, over the first 32
    frames.  `device_loop`: the one-program forms of scan and scan_to_map
    (a frame one CUDA graph replay); the other phases run them eager."""
    from fast_gicp_tpu_torch.models.scan_to_map import (
        ScanToMapConfig, ScanToMapOdometry, load_map,
    )
    from fast_gicp_tpu_torch.models.vgicp import FastVGICP, VGICPConfig
    from fast_gicp_tpu_torch.utils import kitti

    clouds, _gt, dims = drive or odometry_drive()
    clouds = clouds[:frames]
    if path == "odometry_serial":
        return kitti.run_odometry(clouds, FastVGICP(resolution=1.0, device=dev), -1.0), None
    cfg = VGICPConfig(resolution=1.0, grid_dims=dims)
    if path == "odometry_stream":
        return kitti.run_odometry_stream(clouds, -1.0, config=cfg, device=dev), None
    if path == "odometry_scan":
        return kitti.run_odometry_scan(clouds, -1.0, config=cfg, device=dev,
                                       device_loop=device_loop), None
    if path == "scan_to_map":
        odo = ScanToMapOdometry(ScanToMapConfig(), device=dev, device_loop=device_loop)
        for lo in range(0, len(clouds), ODOMETRY_CHUNK):
            odo.process_chunk(clouds[lo:lo + ODOMETRY_CHUNK])
        return odo.poses, odo
    odo = ScanToMapOdometry(localization_config(),
                            initial_map=load_map(map_path, device=dev),
                            device=dev, device_loop=device_loop)
    odo.process_chunk(clouds[:min(len(clouds), LOCALIZATION_FRAMES)])
    return odo.poses, odo


def odometry_prepared(path, dev, n, map_path=None):
    """A callable that runs `n` frames of the path, its set-up done first:
    a scan-to-scan function over the first n + 1 frames (n registrations);
    scan_to_map one chunk of n frames after the first 32 were mapped;
    localization frames n to 2n after the first n."""
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry

    clouds, _gt, _dims = odometry_drive()
    if path.startswith("odometry_"):
        return lambda: odometry_run(path, dev, frames=n + 1)
    if path == "scan_to_map":
        odo = ScanToMapOdometry(ScanToMapConfig(), device=dev, device_loop=False)
        odo.process_chunk(clouds[:ODOMETRY_CHUNK])
        chunk = clouds[ODOMETRY_CHUNK:ODOMETRY_CHUNK + n]
    else:
        _poses, odo = odometry_run(path, dev, frames=n, map_path=map_path)
        chunk = clouds[n:2 * n]
    torch.cuda.synchronize()
    return lambda: odo.process_chunk(chunk)


def count_host_syncs(run):
    """The synchronizing CUDA calls `run()` makes (torch's sync debug mode:
    a read to the host, a stream or device synchronize, a copy from
    pageable memory), and their count by the line that made each."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter("/".join(pathlib.Path(w.filename).parts[-2:]) + f":{w.lineno}"
                                for w in syncs)
    return len(syncs), dict(sites.most_common())


def odometry_profile(path, run, n):
    """A torch.profiler trace of `run()` (n frames): device ops, device busy
    ms and device span (CUDA events on the stream) a frame, the traced wall
    and the idle share of the wall (1 - busy / wall) and of the device span
    (1 - busy / span; the profiler's host overhead inflates a traced wall)."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    ops = sum(e.count for e in events) / n
    span = start.elapsed_time(end) / n
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] {path}, {n} frames traced: wall {wall:.3f} ms, device span {span:.3f} ms, "
        f"device busy {busy:.3f} ms a frame ({100 * busy / wall:.1f}% of the wall, idle "
        f"{100 * (1 - busy / wall):.1f}%; idle {100 * (1 - busy / span):.1f}% of the span), "
        f"device ops {ops:.1f} a frame")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:9.4f} ms  x{e.count / n:6.1f}  "
            f"{e.key[:90]}")
    return dict(traced_wall_ms=wall, device_span_ms=span, device_busy_ms=busy,
                device_ops_per_frame=ops, idle_share=1.0 - busy / wall,
                idle_share_of_span=1.0 - busy / span)


def _map_stats(state):
    n = int(state.num_voxels)
    nbytes = sum(t.numel() * t.element_size() for t in (state.sums, state.coords, state.lut))
    return dict(voxels=n, capacity=state.sums.shape[0], lut_rows=state.lut.shape[0],
                bytes=nbytes)


def phase_odometry_main(dev, path, mapping):
    """A path over the 128-frame drive, after a warm-up run over its first
    32 frames (every kernel and shape of the path but the grown map's),
    with every launch counter set to 0 just before it and read just after:
    frames/s on the host clock closed by a synchronize; the trajectory against
    the ground truth (ATE under 1% of the driven distance scan to scan,
    under 0.05 m scan to map; localization within 0.05 m of the mapping
    pass); every kernel of the path launched; one trial launch a flag read;
    the linearize form.  The mapping pass saves its map (`save_map`) under
    mapping["tmp"], which must load back equal, and leaves its path and
    poses in `mapping` for the localization pass.  Then host syncs a frame
    (torch's sync debug mode over 32 frames) and a profile of 8."""
    from fast_gicp_tpu_torch.models.scan_to_map import load_map, save_map
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.kitti import trajectory_report

    kernels, form = ODOMETRY_PATHS[path]
    _clouds, gt, _dims = odometry_drive()
    map_path = mapping.get("map_path")
    odometry_run(path, dev, frames=WARMUP_FRAMES, map_path=map_path)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    poses, odo = odometry_run(path, dev, map_path=map_path)  # the poses are read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    flag_reads = lsq_solve.host_syncs
    n = len(poses)
    rep = trajectory_report(gt[:n], poses)
    fps = n / wall
    lins = launches["linearize_raw"] + launches["linearize"] + launches["ndt_d2d"]
    log(f"[odometry] {path}: {n} frames in {wall:.3f} s = {fps:.2f} frames/s; ATE "
        f"{rep['ate_rmse_m']:.4f} m (aligned {rep['ate_rmse_aligned_m']:.4f}), end error "
        f"{rep['end_error_m']:.4f} m, RPE1 {rep['rpe1_trans_m']:.4f} m "
        f"{rep['rpe1_rot_deg']:.4f} deg over {rep['path_length_m']:.1f} m; linearizations "
        f"{lins / max(n - 1, 1):.2f} and trials {launches['lm_step'] / max(n - 1, 1):.2f} a "
        f"registration; launches {launches}")
    require(len(poses) == (LOCALIZATION_FRAMES if path == "localization" else ODOMETRY_FRAMES)
            and all(np.isfinite(p).all() for p in poses), f"{path}: poses")
    stats = dict(frames=n, wall_s=wall, frames_per_s=fps, trajectory=rep,
                 linearizations_per_registration=lins / max(n - 1, 1),
                 trials_per_registration=launches["lm_step"] / max(n - 1, 1),
                 flag_reads=flag_reads)
    if path.startswith("odometry_") or path == "scan_to_map":
        bound = (SCAN_TO_MAP_ATE if path == "scan_to_map"
                 else SCAN_TO_SCAN_ATE_SHARE * rep["path_length_m"])
        log(f"[odometry] {path}: ATE {rep['ate_rmse_m']:.4f} m against the bound "
            f"{bound:.4f} m")
        require(rep["ate_rmse_m"] < bound, f"{path}: ATE {rep['ate_rmse_m']} m >= {bound} m")
        stats["ate_bound_m"] = bound
    if path == "scan_to_map":
        stats["map"] = _map_stats(odo.state)
        map_path = str(pathlib.Path(mapping["tmp"]) / "map.npz")
        save_map(map_path, odo.state)
        back = load_map(map_path, device=dev)
        require(all(bool(torch.equal(getattr(back, f), getattr(odo.state, f)))
                    for f in ("sums", "coords", "lut", "num_voxels"))
                and back.resolution == odo.state.resolution, "save_map / load_map round trip")
        mapping.update(map_path=map_path, poses=poses)
        log(f"[odometry] scan_to_map: map {stats['map']}; saved and loaded back equal")
    elif path == "localization":
        dev_m = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                    for a, b in zip(poses, mapping["poses"]))
        log(f"[odometry] localization: within {dev_m:.5f} m of the mapping pass's poses "
            f"(bound {LOCALIZATION_TOL} m)")
        require(dev_m < LOCALIZATION_TOL, f"localization: {dev_m} m from the mapping pass")
        stats.update(from_mapping_m=dev_m, ate_bound_m=None)
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    require(launches["lm_step"] == flag_reads and all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"{path}: {launches['lm_step']} trial launches for {flag_reads} flag reads")
    check_lin_forms(path, launches, form)
    run = odometry_prepared(path, dev, SYNC_FRAMES, map_path)
    flags0 = lsq_solve.host_syncs
    syncs, sites = count_host_syncs(run)
    extra = syncs - (lsq_solve.host_syncs - flags0)
    stats.update(host_syncs_per_frame=syncs / SYNC_FRAMES, host_sync_sites=sites,
                 host_reads_besides_flags=extra)
    log(f"[odometry] {path}: {syncs} host syncs over {SYNC_FRAMES} frames "
        f"({syncs / SYNC_FRAMES:.2f} a frame; {extra} besides the flag reads), by the line "
        f"that made them: {sites}")
    # the serial path may make one more a run: a synchronizing call inside
    # torch.cuda on its first frame (torch/cuda/__init__.py:1270 in torch 2.11)
    allowed = ODOMETRY_READS[path] + (path == "odometry_serial")
    require(ODOMETRY_READS[path] <= extra <= allowed,
            f"{path}: {extra} host syncs besides the flag reads, expected "
            f"{ODOMETRY_READS[path]} to {allowed}: {sites}")
    stats["profile"] = odometry_profile(
        path, odometry_prepared(path, dev, PROFILE_FRAMES, map_path), PROFILE_FRAMES)
    return launches, stats


def stream_registrations(dev, drive, covs=None):
    """`run_odometry_stream`'s loop over `drive` as `odometry_run` drives it
    (RBF covariances, the drive's dense grid, warm start), a registration
    at a time: ([(delta, iterations)] a registration, [(6, N) covariances]
    and [(N,) masks] a frame, on the host); with `covs` given, each frame
    takes those covariances in place of its own."""
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_align
    from fast_gicp_tpu_torch.ops.covariance import rbf_covariance_cols
    from fast_gicp_tpu_torch.utils.padding import bucket_size, pad_points

    clouds, _gt, dims = drive
    cfg = VGICPConfig(resolution=1.0, grid_dims=dims)
    bucket = max(bucket_size(len(c)) for c in clouds)
    delta, prev, regs, frame_covs, masks = torch.eye(4, device=dev), None, [], [], []
    for i, cloud in enumerate(clouds):
        p, m = (torch.as_tensor(a, device=dev) for a in pad_points(cloud, bucket))
        c = rbf_covariance_cols(p, m) if covs is None else covs[i].to(dev)
        if prev is not None:
            res = vgicp_align(p, m, c, *prev, delta, cfg, device=dev)
            delta = res.transformation
            regs.append((delta.cpu().numpy(), int(res.iterations)))
        prev = (p, m, c)
        frame_covs.append(c.cpu())
        masks.append(m.cpu())
    return regs, frame_covs, masks


def stream_breakdown(dev, drive, card_poses):
    """Where odometry_stream's card and CPU poses part, registration by
    registration (`stream_registrations`, deterministic scatter-adds on the
    card): each delta's largest difference, card against CPU and, with the
    CPU's covariances fed to the card, card against CPU again (within
    ODOMETRY_SOLVE_TOL, the same iterations); each frame's RBF covariances,
    card against CPU on the valid points, relative to each point's largest
    entry: the largest and the share above 1e-3.  The card's chained
    deltas must be the path's poses."""
    from fast_gicp_tpu_torch.utils.kitti import _chain

    card, covs_card, masks = _deterministic(lambda: stream_registrations(dev, drive))
    cpu, covs_cpu, _masks = stream_registrations("cpu", drive)
    mixed, _covs, _masks = _deterministic(lambda: stream_registrations(dev, drive, covs_cpu))
    same = max(float(np.abs(a - b).max()) for a, b in zip(_chain([d for d, _i in card]),
                                                           card_poses))
    require(same <= 1e-6, f"odometry_stream's loop differs from the path by {same}")
    rel = [((a - b).abs().amax(0) / b.abs().amax(0).clamp(min=1e-30))[m]
           for a, b, m in zip(covs_card, covs_cpu, masks)]
    out = dict(delta_card_cpu=[float(np.abs(a - b).max()) for (a, _i), (b, _j) in zip(card, cpu)],
               delta_card_on_cpu_covs_cpu=[float(np.abs(a - b).max())
                                           for (a, _i), (b, _j) in zip(mixed, cpu)],
               iterations_card=[i for _d, i in card], iterations_cpu=[i for _d, i in cpu],
               iterations_card_on_cpu_covs=[i for _d, i in mixed],
               covs_rel_diff=[float(r.max()) for r in rel],
               covs_share_above_1e3=[float((r > 1e-3).float().mean()) for r in rel])
    for k in range(len(card)):
        log(f"[card vs cpu] odometry_stream registration {k + 1}: delta differs by "
            f"{out['delta_card_cpu'][k]:.3e} ({out['delta_card_on_cpu_covs_cpu'][k]:.3e} on the "
            f"CPU's covariances), iterations card {out['iterations_card'][k]} cpu "
            f"{out['iterations_cpu'][k]} (on the CPU's covariances "
            f"{out['iterations_card_on_cpu_covs'][k]}); frame {k + 1}'s covariances differ by "
            f"up to {out['covs_rel_diff'][k + 1]:.3e} of a point's scale, "
            f"{100 * out['covs_share_above_1e3'][k + 1]:.2f}% of its points by more than 1e-3")
    require(max(out["delta_card_on_cpu_covs_cpu"]) <= ODOMETRY_SOLVE_TOL
            and out["iterations_card_on_cpu_covs"] == out["iterations_cpu"],
            f"odometry_stream on the CPU's covariances: {out}")
    return out


def phase_odometry_equivalences(dev):
    """The odometry's checks across devices and forms, with deterministic
    scatter-adds (the maps' sums are atomic on the card):
    * `process_chunk` (chunks of 4 and 12) against `process` frame by frame
      on the first 16 frames of the drive, on the card, within 1e-5;
    * the first 8 frames of every mapping and scan-to-scan path on the card
      against the same calls with device="cpu", on a small drive
      (`drive_world(n=400_000)`, 0.5 m downsample), within the path's
      ODOMETRY_CARD_CPU_TOL; for odometry_stream where the two part
      (`stream_breakdown`)."""
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry

    clouds, _gt, _dims = odometry_drive()

    def chunk_and_frames():
        per_frame = ScanToMapOdometry(ScanToMapConfig(), device=dev, device_loop=False)
        for s in clouds[:16]:
            per_frame.process(s)
        chunked = ScanToMapOdometry(ScanToMapConfig(), device=dev, device_loop=False)
        chunked.process_chunk(clouds[:4])
        chunked.process_chunk(clouds[4:16])
        return max(float(np.abs(a - b).max()) for a, b in zip(per_frame.poses, chunked.poses))

    chunk_diff = _deterministic(chunk_and_frames)
    log(f"[odometry] process_chunk against process, 16 frames on the card: max |diff| "
        f"{chunk_diff:.3e}")
    require(chunk_diff <= 1e-5, f"process_chunk differs from process by {chunk_diff}")
    small = odometry_drive(n_world=400_000, voxel=0.5, frames=8)
    out = dict(chunk_vs_frames=chunk_diff, small_drive_points=[len(c) for c in small[0]])
    for path in ("scan_to_map", "odometry_stream", "odometry_serial", "odometry_scan"):
        t0 = time.perf_counter()
        card = _deterministic(lambda: odometry_run(path, dev, drive=small)[0])
        cpu = odometry_run(path, "cpu", drive=small)[0]
        diffs = [float(np.abs(a - b).max()) for a, b in zip(card, cpu)]
        log(f"[card vs cpu] {path}, 8 frames of the small drive: largest per-frame pose diff "
            f"{max(diffs):.3e} ({time.perf_counter() - t0:.1f} s): {diffs}")
        out[path] = dict(max_pose_diff=max(diffs), per_frame=diffs)
        if path == "odometry_stream":
            out[path]["breakdown"] = stream_breakdown(dev, small, card)
        require(len(card) == len(cpu) == 8 and max(diffs) <= ODOMETRY_CARD_CPU_TOL[path],
                f"{path} card vs cpu: {diffs}")
    return out


def odometry_lin_record(label, raw, args, tol):
    """`check_linearize` (idx form) on the arguments (P, CA, x, table, valid,
    ids) of a path's linearization, then the kernel's device time, the
    plain version's (which gathers first) and the bound: the source columns,
    ids and aux of every lane once and each row the valid lanes name once."""
    P, CA, x, table, valid, ids = args
    fn, plain = lin_wrappers(raw)
    _got, max_err = check_linearize(label, raw, P, CA, x, table, valid, ids, tol)
    L = P.shape[1]
    ms = device_ms(lambda: fn(P, CA, x, table, valid, ids), 200,
                   LIN_KERNEL.format(raw=str(raw).lower()))
    plain_ms = device_ms(lambda: plain(P, CA, x, table[ids], valid), 20)
    unique_rows = int(torch.unique(ids[valid > 0]).numel())
    nbytes = L * (12 + 24 + 4 + 40 + ids.element_size()) + unique_rows * 64 + 64 + 43 * 4
    b_ms, b_by = bound_ms(nbytes, L * LINEARIZE_OPS)
    log(f"[kernels] {label} at L = {L} ({unique_rows} rows named of {table.shape[0]}): idx "
        f"form bit-equal to the gathered form and a repeat, within tolerance of the plain "
        f"version ({max_err:.3e}); {ms:.5f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.3e} ms "
        f"({b_by})")
    return dict(lanes=L, valid_lanes=int((valid > 0).sum()), rows=table.shape[0],
                unique_rows=unique_rows, max_abs_err=max_err, tolerance=LIN_TOLERANCE[tol],
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)


def rbf_record(label, args):
    """`check_rbf` on the arguments of a path's covariance call, then its
    device time (with the target's chunk boxes, which the wrapper builds),
    the plain version's and the bound over the pairs within max_dist."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    err = check_rbf(label, args)
    _q, qmask, t, tmask, c, _width, max_dist = args
    tm_ = timings(lambda: cuda_kernels.rbf_moments(*args),
                  lambda: cuda_kernels.rbf_moments_plain(*args),
                  ("chunk_bbox_kernel", "rbf_moments_kernel"), 20, 3)
    y = (t - c)[tmask]
    pairs = pairs_within(y, y, max_dist * max_dist)
    n = qmask.shape[0]
    b_ms, b_by = bound_ms(2 * n * 16 + 16 * n * 4, pairs * RBF_OPS_PER_PAIR)
    log(f"[kernels] rbf_moments {label}: {int(qmask.sum())} of {n} points, within "
        f"{RBF_TOLERANCE} of the plain version ({err:.3e}), a repeat bit-identical; "
        f"{tm_['ms']:.4f} ms, plain {tm_['plain_ms']:.3f} ms; bound {b_ms:.3e} ms ({b_by})")
    return dict(points=int(qmask.sum()), padded=n, pairs_in_range=pairs, max_abs_err=err,
                tolerance=RBF_TOLERANCE, bound_ms=b_ms, bound_by=b_by, **tm_)


def knn_record(label, args, kwargs):
    """`check_knn_moments` on the arguments of a path's covariance call,
    then its device time, the plain version's and the bound (every
    candidate of the slab, k neighbours a query), as phase_gicp_kernels
    counts them."""
    from fast_gicp_tpu_torch.ops import cuda_kernels

    err = check_knn_moments(label, args, kwargs)
    n, k = args[0].shape[0], args[5]
    Q, C = args[4].shape
    ct = kwargs.get("cand_tile", 128)
    tm_ = timings(lambda: cuda_kernels.knn_moments(*args, **kwargs),
                  lambda: cuda_kernels.knn_moments_plain(*args, **kwargs),
                  "knn_moments_kernel", 50, 5)
    b_ms, b_by = bound_ms(n * 16 + n * 16 + Q * C * 4 + n * 11 * 4,
                          n * C * ct * KNN_OPS_PER_CANDIDATE + n * k * KNN_OPS_PER_NEIGHBOUR)
    log(f"[kernels] knn_moments {label}: {tm_['ms']:.4f} ms, plain {tm_['plain_ms']:.3f} ms; "
        f"bound {b_ms:.3e} ms ({b_by})")
    return dict(points=int(args[3].sum()), padded=n, k=k, slab=f"{C} x {ct}",
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **tm_)


# the covariance kernel of each scan-to-scan path
SCAN_TO_SCAN_COVS = {"odometry_serial": "knn_moments", "odometry_stream": "rbf_moments",
                     "odometry_scan": "rbf_moments"}


def scan_to_scan_kernels(dev, by_name):
    """The scan-to-scan paths' kernels on their own inputs, each path run as
    `odometry_run` runs it over the 128-frame drive and stopped at the call
    wanted (`first_call`), added to the kernels' records under the path:
    * the covariance kernel on frame KERNEL_FRAME (the first call on a
      cloud of its size and points, within 1 cm: scan's are dequantized
      int16): knn_moments (serial, FastVGICP's kNN, k = 20; `knn_record`),
      rbf_moments (stream on the float cloud, scan on the dequantized one;
      `rbf_record`);
    * linearize_raw (idx form) at the path's first linearization, frame 1
      against frame 0 from the identity (serial on FastVGICP's auto dense
      grid, stream and scan on the drive's dense grid):
      `odometry_lin_record` at VGICP's tolerance.
    Returns {path: first_trial of the path} for `trial_sweeps`."""
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize

    clouds, _gt, _dims = odometry_drive()
    frame = torch.as_tensor(np.asarray(clouds[KERNEL_FRAME], np.float32), device=dev)

    def is_frame(q, qmask, t, tmask, *rest, **kw):
        return (int(tmask.sum()) == frame.shape[0]
                and float((t[tmask] - frame).abs().max()) < 1e-2)

    trials = {}
    for path, cov_kernel in SCAN_TO_SCAN_COVS.items():
        def run():
            return odometry_run(path, dev)

        args, kwargs = first_call(run, cuda_kernels, cov_kernel, match=is_frame)
        label = f"({path} frame {KERNEL_FRAME})"
        by_name[cov_kernel][path] = (knn_record(label, args, kwargs)
                                     if cov_kernel == "knn_moments" else rbf_record(label, args))
        args, _kw = first_call(run, cuda_linearize, "linearize_raw")
        by_name["linearize_raw"][path] = odometry_lin_record(
            f"linearize_raw ({path} first linearization)", True, args, "elementwise")
        trials[path] = first_trial(run)
    return trials


def phase_odometry_kernels(dev, records, map_path):
    """The kernels on the odometry paths' own inputs, against their plain
    versions, timed; added to the kernels' records:
    * the scan-to-scan paths' covariance kernels and linearize_raw
      (`scan_to_scan_kernels`);
    * rbf_moments on scan_to_map's frame 16, and `linearize` (idx form) on
      the persistent map's `packed` rows at that frame's first
      linearization (the constant-velocity guess, 16 frames mapped): bit
      for bit with its gathered form and a repeat, within tolerance of its
      plain version; the map's freeze (the lut probe) and the pose to
      [err, H, b] timed;
    * `update_map` of that frame on the card against the same call with
      device="cpu", deterministic scatter-adds: coords, lut and num_voxels
      equal, sums within 1e-5 of each row's scale;
    * `ndt_d2d` in the pack form at localization's first freeze (frame 0 on
      the mapping pass's map saved at `map_path`): the card's eager freeze equal to the CPU's in valid,
      the launch within the NDT tolerances of its plain version and
      bit-identical on a repeat;
    * the trial launch at every path's first linearization (`trial_sweeps`),
      bit for bit against the unfused trial, timed."""
    from fast_gicp_tpu_torch.models.scan_to_map import (
        ScanToMapConfig, ScanToMapOdometry, _align, _compose, _frame_covs, _state_on,
        _to_world, load_map, map_as_voxelmap, map_objective, update_map,
    )
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_ndt

    clouds, _gt, _dims = odometry_drive()
    by_name = {r["name"]: r for r in records}
    trials = scan_to_scan_kernels(dev, by_name)
    odo = ScanToMapOdometry(ScanToMapConfig(), device=dev, device_loop=False)
    for s in clouds[:KERNEL_FRAME]:
        odo.process_async(s)
    pts, mask = (t[0] for t in odo._padded([clouds[KERNEL_FRAME]]))
    args, _kw = first_call(lambda: _frame_covs(pts, mask, "rbf"), cuda_kernels, "rbf_moments")
    by_name["rbf_moments"]["scan_to_map"] = rbf_record(f"(scan_to_map frame {KERNEL_FRAME})",
                                                       args)
    covs = _frame_covs(pts, mask, "rbf")
    x = _compose(odo._last_pose, odo._last_delta)
    lin, _cost, freeze, _lf = map_objective(odo.state, pts, mask, covs, odo.config)
    ids, valid = freeze(x)
    table = map_as_voxelmap(odo.state).packed
    rec = odometry_lin_record(f"linearize (scan_to_map frame {KERNEL_FRAME})", False,
                              (pts.T.contiguous(), covs.contiguous(), x, table, valid, ids),
                              "rel_max")
    rec.update(map_voxels=int(odo.state.num_voxels), freeze_ms=device_ms(lambda: freeze(x), 50),
               pose_to_normal_eq_ms=device_ms(lambda: lin(x), 50))
    by_name["linearize"]["scan_to_map"] = rec
    log(f"[kernels] scan_to_map frame {KERNEL_FRAME} on {rec['map_voxels']} map voxels: freeze "
        f"{rec['freeze_ms']:.4f} ms, pose to [err, H, b] {rec['pose_to_normal_eq_ms']:.4f} ms")
    trials["scan_to_map"] = first_trial(lambda: _align(odo.state, pts, mask, covs, x,
                                                       odo.config))

    world, cov9 = _to_world(x, pts, covs)
    card, cpu = (_deterministic(lambda d=d: update_map(
        _state_on(odo.state, torch.device(d)), world.to(d), cov9.to(d), mask.to(d),
        new_cap=odo.config.new_per_frame_capacity, device=d)) for d in (dev, "cpu"))
    for f in ("coords", "lut", "num_voxels"):
        require(bool(torch.equal(getattr(card, f).cpu(), getattr(cpu, f))),
                f"update_map: {f} differs between card and CPU")
    worst = _rows_close("update_map sums", card.sums.cpu(), cpu.sums,
                        cpu.sums.abs().amax(dim=1), 1e-5)
    map_check = dict(voxels=int(cpu.num_voxels), new_voxels=int(cpu.num_voxels)
                     - int(odo.state.num_voxels), worst_sums_row=worst)
    log(f"[kernels] update_map of frame {KERNEL_FRAME} on the card against the CPU "
        f"(deterministic): coords, lut and num_voxels equal, sums within {worst:.2e} of each "
        f"row's scale; {map_check}")

    # localization's first freeze: frame 0 on the saved map, the anchor pose
    state = load_map(map_path, device=dev)
    loc = ScanToMapOdometry(localization_config(), initial_map=state, device=dev,
                            device_loop=False)
    pts0, mask0 = (t[0] for t in loc._padded([clouds[0]]))
    covs0 = _frame_covs(pts0, mask0, "rbf")
    x0 = _compose(loc._anchor, loc._last_delta)
    obj = map_objective(state, pts0, mask0, covs0, loc.config)
    cpu_obj = map_objective(_state_on(state, torch.device("cpu")), pts0.cpu(), mask0.cpu(),
                            covs0.cpu(), loc.config)
    pack = obj.freeze(x0)
    want_pack = cpu_obj.freeze(x0.cpu())
    require(bool(torch.equal(pack[:, 9].cpu(), want_pack[:, 9])),
            "localization freeze: valid differs from the CPU's")
    _check_aux, check_lin = ndt_checkers(x0)
    got = check_lin("ndt_d2d (localization)", obj.p, obj.ca, pack, "d2d", 1e-5,
                    res=state.resolution)
    N, L = obj.p.shape[1], pack.shape[0]
    nvalid = int(pack[:, 9].sum())
    tm_ = timings(lambda: cuda_ndt.ndt_linearize(obj.p, obj.ca, x0, pack, state.resolution,
                                                 "d2d"),
                  lambda: cuda_ndt.ndt_linearize_plain(obj.p, obj.ca, x0, pack,
                                                       cuda_ndt._c_sq(state.resolution), "d2d"),
                  ndt_kernel_name("d2d", "pack"), 200, 20)
    nbytes = ndt_lin_bytes("d2d", "pack", N, L)
    b_ms, b_by = bound_ms(nbytes, ndt_lin_ops("d2d", "pack", L, nvalid))
    rec = dict(lanes=L, source_columns=N, valid_lanes=nvalid, max_abs_err=got[-1],
               pack_ms=tm_["ms"], plain_ms=tm_["plain_ms"], call_ms=tm_["call_ms"],
               freeze_ms=device_ms(lambda: obj.freeze(x0), 50),
               pose_to_normal_eq_ms=device_ms(lambda: obj.linearize(x0), 50),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, timing=tm_["timing"])
    by_name["ndt_d2d"]["localization"] = rec
    log(f"[kernels] ndt_d2d pack form at localization's first freeze, L = {L} ({nvalid} "
        f"valid): the card's freeze valid equal to the CPU's, within tolerance of the plain "
        f"version ({got[-1]:.3e}), {tm_['ms']:.5f} ms, plain {tm_['plain_ms']:.4f} ms; freeze "
        f"{rec['freeze_ms']:.4f} ms, pose to [err, H, b] {rec['pose_to_normal_eq_ms']:.4f} "
        f"ms; bound {b_ms:.3e} ms ({b_by})")
    trials["localization"] = first_trial(lambda: _align(state, pts0, mask0, covs0, x0,
                                                        loc.config))
    trial_recs, points, hits, _err = trial_sweeps(dev, trials)
    by_name["lm_step"]["by_path"].update(trial_recs)
    return dict(update_map_card_vs_cpu=map_check, trial_points=points, trial_hits=hits)


def phase_odometry(dev, records, path_launches, summary):
    """Slice F's phases: the five odometry paths (`phase_odometry_main`),
    the kernels on their inputs (`phase_odometry_kernels`) and the
    equivalences (`phase_odometry_equivalences`)."""
    import tempfile

    t0 = time.perf_counter()
    odometry_drive()
    log(f"[odometry] drive: {ODOMETRY_FRAMES} frames, seed {ODOMETRY_SEED}, "
        f"{ODOMETRY_DOWNSAMPLE} m downsample: {[len(c) for c in odometry_drive()[0][:8]]}... "
        f"points, grid {odometry_drive()[2]} ({time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        mapping = {"tmp": tmp}
        for path in ODOMETRY_PATHS:
            path_launches[path], summary[path] = phase_odometry_main(dev, path, mapping)
        log(f"[total] {time.perf_counter() - T_START:.1f} s: odometry paths")
        summary["odometry_kernels"] = phase_odometry_kernels(dev, records, mapping["map_path"])
    summary["odometry_equivalences"] = phase_odometry_equivalences(dev)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: odometry checks")


# -- slice G: the SLAM back-end ---------------------------------------------

BACKEND_FRAMES = 512  # drive_scans' default: a bit over one revolution of the 80 m circle
ODOMETRY_EDGE_INFO = 1e2  # the odometry edges' information, examples/slam_loop_closure.py:65-69
CLOSURE_TOL = 0.1  # m from the ground truth's relative pose, tests/test_pose_graph.py:356-393
K1000 = 1000  # the JAX test's graph, tests/test_pose_graph.py:120-181
K1000_DRIFT_SHARE = 0.3  # its end drift after the solve, of the drift before
DENSE_SPARSE_TOL = 2e-3  # tests/test_pose_graph.py:81-117
WINDOW = 20  # SlidingWindowBA's default window
WINDOW_EVERY = 32  # keyframes between the window's solves on the drive
# the drive's first relatives fed to the window: 3 solves (the whole drive's
# 511, 15 solves, took 54-78 s on one NVIDIA H100 80GB HBM3, 700 W; 256, 8
# solves, 33-40 s, cut to keep the whole script in its time)
WINDOW_DRIVE_KEYFRAMES = 96
TRIDIAG_TOL = 1e-5  # block_tridiag against its plain version, of max |x|
CLOSURE_CARD_CPU = (2e-3, 1e-3)  # m, rad: the limit of the RBF paths, card against CPU
BACKEND_CARD_CPU_TOL = 1e-4  # the 64-pose sparse solve's poses and the window, card against CPU
# the 30-keyframe window's loop-edge solve, card against CPU: its objective,
# relative.  Its poses are not held: the objective is flat there.  On the CPU,
# from one window state, the JAX package and the port end 4.9e-3 m apart at
# objectives 1.1e-4 apart in float64, because whether a trial is accepted
# turns on float32 noise in the error
WINDOW_LOOP_ERROR_TOL = 1e-3
CARD_CPU_POSES = 64
# the kernels of the back-end's run: the front end's and the refine's VGICP
# (rbf_moments, linearize_raw, the GICP trial launch), the coarse NDT align on
# the hash map (ndt_d2d in the pack form, the NDT trial launch), the fitness
# (nn_search) and the preconditioner (block_tridiag)
BACKEND_KERNELS = ("rbf_moments", "linearize_raw", "lm_step", "nn_search", "ndt_d2d",
                   "block_tridiag_factor", "block_tridiag_apply", "pg_cond")
# the back-end's kernels that count their runs on the device (their slots of
# `cuda_pose_graph.pg_counts`): the solves replay them from CUDA graphs
DEVICE_COUNTED = {"block_tridiag_factor": "factors", "block_tridiag_apply": "applies",
                  "pg_cond": "pg_cond"}
# the growing graph's solves (`signature_sequence`): the 512-pose graph cut
# after its 1st, 3rd, 5th and 7th closure (each a signature of its own), the
# eager form beside the first and the last
SIGNATURE_CLOSURES = (1, 3, 5, 7)
# the pose-graph condition kernel (csrc/device_loop.cu pg_cond_kernel) at its
# commonest mode, a CG iteration's step: it reads the trip counter, res.res and
# the threshold and two tally ints, and writes the counter, the flag and the
# two tally ints; a compare, an add, a few logic operations
PG_COND_BYTES = (1 + 2 + 2) * 4 + (1 + 1 + 2) * 4
PG_COND_OPS = 6
# FP32 operations a step, counted from the kernels' arithmetic, and the
# dependent ones among them (the serial chain)
TRIDIAG_APPLY_OPS = 210  # U^T y 66, r - . 6, C^-1 v 66; G x 66, y - . 6
TRIDIAG_APPLY_CHAIN = 20  # 6-term dots 6 + 1 + 6 forward, 6 + 1 backward
TRIDIAG_FACTOR_OPS = 1393  # C 432, LL^T 97, 12 column solves 864
TRIDIAG_FACTOR_CHAIN = 124  # C's dot 12, LL^T 40, a column's two substitutions 72
TRIDIAG_CYCLES_PER_OP = 4  # a dependent FP32 operation's latency, for the chain's time
# chain lengths at the kernels' edges (csrc/block_tridiag.cu): one, two and
# three steps (an odd last chunk's rows end short of a bulk copy's 16 bytes),
# each side of the first, second and third turn of a chunk of kChunk = 16
# steps (the factor's ring holds 2 chunks, the apply's 3); and each side of
# the apply's y on chip (kOnChipSteps = 1024)
TRIDIAG_EDGE_K = (1, 2, 3, 15, 16, 17, 31, 32, 33, 47, 48, 49)
TRIDIAG_ON_CHIP_K = (1023, 1024, 1025)
# the previous design's device time a launch (the apply: one thread walking
# both sweeps from a shared-memory double buffer with a block barrier every 32
# steps; the factor: three block barriers a step), ms, at the back-end's first
# PCG of the 512-pose and the 1k solve, from `--backend --tridiag-previous DIR`
# on NVIDIA H100 80GB HBM3 at 700 W, in one process beside this design
TRIDIAG_PREVIOUS_MS = {
    "block_tridiag_apply": {"graph_512": (0.1663, 0.1664), "graph_1k": (0.3195, 0.3196)},
    "block_tridiag_factor": {"graph_512": (1.7810, 1.7818), "graph_1k": (3.4782, 3.4908)},
}
TRIDIAG_PREVIOUS_TREE = None  # `--tridiag-previous DIR`: the checkout whose design is timed


def make_backend_drive():
    """The back-end's drive: `drive_scans` at its defaults (512 frames) on
    seed 11's 1.4M-point world.  Returns (raw scans, the clouds at 0.25 m
    downsampled on the host once, gt poses, the dense grid over the union of
    the raw scans at 1 m)."""
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims_multi
    from fast_gicp_tpu_torch.utils.downsample import voxel_downsample
    from fast_gicp_tpu_torch.utils.synthetic import drive_scans, drive_world

    rng = np.random.default_rng(ODOMETRY_SEED)
    scans, gt = drive_scans(rng, n_frames=BACKEND_FRAMES, world=drive_world(rng))
    return (scans, [voxel_downsample(s, ODOMETRY_DOWNSAMPLE) for s in scans], gt,
            auto_grid_dims_multi(scans, 1.0))


def _drive_worker(queue):
    queue.put(make_backend_drive())


DRIVE_MAKER = []  # (process, queue) making the back-end's drive, while it runs


def start_backend_drive():
    """Make the back-end's drive (~80 s of host time) in a process of its own,
    one thread, while the phases before the back-end run."""
    import multiprocessing
    import os

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_drive_worker, args=(queue,), daemon=True)
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                             "MKL_NUM_THREADS")}
    os.environ.update(dict.fromkeys(saved, "1"))
    try:
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    DRIVE_MAKER.append((proc, queue))


def stop_backend_drive():
    """End the drive's process if it still runs."""
    while DRIVE_MAKER:
        proc, _queue = DRIVE_MAKER.pop()
        if proc.is_alive():
            proc.terminate()
        proc.join()


@functools.cache
def backend_drive():
    """`make_backend_drive()`'s result, from its process when one was
    started."""
    import queue as queue_mod

    if DRIVE_MAKER:
        proc, queue = DRIVE_MAKER[0]
        while True:
            try:
                data = queue.get(timeout=5.0 if proc.is_alive() else 1.0)
                break
            except queue_mod.Empty:
                require(proc.is_alive(), "the drive's process ended without a result")
        proc.join()
        DRIVE_MAKER.clear()
        return data
    return make_backend_drive()


def front_end(dev, frames=None):
    """`run_odometry_stream` over the drive's first `frames` frames (all by
    default) as the KITTI app's stream mode runs it: RBF covariances, the
    dense grid over the drive, the host-downsampled clouds."""
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig
    from fast_gicp_tpu_torch.utils import kitti

    _scans, clouds, _gt, dims = backend_drive()
    return kitti.run_odometry_stream(clouds[:frames], -1.0,
                                     config=VGICPConfig(resolution=1.0, grid_dims=dims),
                                     device=dev)


def closure_graph(poses, closures):
    """The pose graph of `examples/slam_loop_closure.py`: odometry edges
    (i, i + 1) at 1e2 I from the poses, the closures weighted by their
    Hessians.  (poses (K, 4, 4), edge_i, edge_j, edge_rel, edge_info)."""
    from fast_gicp_tpu_torch.models.pose_graph import edges_from_odometry

    k = len(poses)
    i, j, rel = edges_from_odometry(poses)
    edge_i = np.concatenate([i, [c.i for c in closures]]).astype(np.int32)
    edge_j = np.concatenate([j, [c.j for c in closures]]).astype(np.int32)
    edge_rel = np.concatenate([rel] + [c.relative[None] for c in closures])
    info = np.broadcast_to(np.eye(6, dtype=np.float32) * ODOMETRY_EDGE_INFO,
                           (len(edge_i), 6, 6)).copy()
    for n, c in enumerate(closures):
        info[k - 1 + n] = c.information
    return np.stack(poses).astype(np.float32), edge_i, edge_j, edge_rel, info


def _chain_np(k, step):
    """Ground-truth chain with a constant step twist (test_pose_graph._chain),
    the step through the port's se3_exp."""
    from fast_gicp_tpu_torch import se3

    step_T = se3.se3_exp(torch.tensor(step, dtype=torch.float32)).double().numpy()
    T, out = np.eye(4), []
    for _ in range(k):
        out.append(T.copy())
        T = T @ step_T
    return out


def _noisy_chain(gt, rng, scale):
    """(relative odometry with noise exp(n), the drifted integration)."""
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.models.pose_graph import edges_from_odometry

    i, j, rel = edges_from_odometry(gt)
    noise = rng.normal(scale=scale, size=(len(rel), 6)).astype(np.float32)
    rel = np.einsum("eij,ejk->eik", rel, se3.se3_exp(torch.as_tensor(noise)).numpy())
    drifted = [np.eye(4)]
    for r in rel:
        drifted.append(drifted[-1] @ r.astype(np.float64))
    return i, j, rel.astype(np.float32), drifted


def k1000_graph():
    """tests/test_pose_graph.py's 1k graph, seed 42: a 1,000-pose chain
    curving 6 rad, odometry noise 0.004, 10 closures across the loop at
    1e4 I.  (poses, edge_i, edge_j, edge_rel, edge_info, gt)."""
    rng = np.random.default_rng(42)
    gt = _chain_np(K1000, [0, 0, 0.006, 1.0, 0.0, 0])
    i, j, rel, drifted = _noisy_chain(gt, rng, 0.004)
    lc_i = (np.arange(10) * 25).astype(np.int32)
    lc_j = (K1000 - 1 - np.arange(10) * 25).astype(np.int32)
    lc_rel = np.stack([(np.linalg.inv(gt[a]) @ gt[b]).astype(np.float32)
                       for a, b in zip(lc_i, lc_j)])
    edge_i = np.concatenate([i, lc_i]).astype(np.int32)
    edge_j = np.concatenate([j, lc_j]).astype(np.int32)
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (len(edge_i), 6, 6)).copy()
    info[K1000 - 1:] *= 1e4
    return (np.stack(drifted).astype(np.float32), edge_i, edge_j,
            np.concatenate([rel, lc_rel]), info, gt)


def small_graph():
    """test_sparse_matches_dense's 10-pose graph, seed 42."""
    rng = np.random.default_rng(42)
    gt = _chain_np(10, [0, 0, 0.15, 1.0, 0.1, 0])
    i, j, rel, drifted = _noisy_chain(gt, rng, 0.01)
    lc = (np.linalg.inv(gt[0]) @ gt[-1]).astype(np.float32)
    edge_i = np.concatenate([i, [0]]).astype(np.int32)
    edge_j = np.concatenate([j, [9]]).astype(np.int32)
    info = np.broadcast_to(np.eye(6, dtype=np.float32), (10, 6, 6)).copy()
    info[-1] *= 1e4
    return (np.stack(drifted).astype(np.float32), edge_i, edge_j,
            np.concatenate([rel, lc[None]]), info)


def window_chain():
    """test_sliding_window_ba's 30-keyframe chain, seed 42: (noisy
    relatives, gt)."""
    gt = _chain_np(30, [0, 0, 0.05, 0.8, 0.0, 0])
    _i, _j, rel, _drifted = _noisy_chain(gt, np.random.default_rng(42), 0.005)
    return rel, gt


def window_loop(ba, rel, gt):
    """test_sliding_window_ba on `ba` (window 10): the 30 keyframes, a solve,
    a loop edge base -> 29 at 1e4 I, a solve.  (tail error before, after,
    the poses after the first solve, the loop-edge solve's result, the first
    solve's result)."""
    for r in rel:
        ba.add_keyframe(r)
    first_res = ba.optimize()
    first = np.stack(ba.poses)
    gi, gj = ba.base, len(gt) - 1
    lc = (np.linalg.inv(gt[gi]) @ gt[gj]).astype(np.float32)

    def tail():
        want = np.asarray(ba.poses[0], np.float64) @ np.linalg.inv(gt[gi]) @ gt[gj]
        return float(np.linalg.norm(np.asarray(ba.poses[-1], np.float64)[:3, 3] - want[:3, 3]))

    before = tail()
    ba.add_loop_edge(gi, gj, lc, 1e4 * np.eye(6, dtype=np.float32))
    res = ba.optimize()
    return before, tail(), first, res, first_res


def synced(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(dev, fn):
    """(fn(), its wall seconds closed by a synchronize)."""
    synced(dev)
    t0 = time.perf_counter()
    out = fn()
    synced(dev)
    return out, time.perf_counter() - t0


def sparse_solve(dev, graph, device_loop=False, **config):
    """The sparse solve of `graph`, in the eager form unless `device_loop`."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs

    poses, ei, ej, rel, info = graph[:5]
    return pgs.optimize_pose_graph_sparse(poses, ei, ej, rel, info,
                                          config=pgs.SparsePGConfig(**config), device=dev,
                                          device_loop=device_loop)


def pg_tally(dev, since=None):
    """The device tally (`cuda_pose_graph.pg_counts`) as a dict: what
    pg_cond and the block_tridiag kernels ran, replays included; with
    `since` (a dict of it read before), what they ran since."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    now = dict(zip(cpg.PG_COUNTS, cpg.pg_counts(dev).tolist()))
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def solve_stats(label, res, wall, gt=None, before=None, tally=None):
    """The sparse solve's counters (since the last reset_stats; with
    `tally`, the device form's, read from its device tally), its wall and,
    with gt, ATE and end error before and after."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.utils.kitti import ate_rmse

    f = pgs.optimize_pose_graph_sparse
    poses = res.poses.cpu().numpy().astype(np.float64)
    stats = dict(poses=len(poses), iterations=int(res.iterations),
                 converged=bool(res.converged), error=float(res.error))
    if tally is None:
        stats.update(lm_trials=f.trials, pcgs=f.pcgs,
                     cg_iterations=f.pcgs * pgs.SparsePGConfig().cg_iterations,
                     cg_iterations_before_tolerance=int(f.cg_iterations_run),
                     host_reads=f.host_syncs, wall_s=wall)
    else:
        stats.update(form="device", lm_trials=tally["trials"], pcgs=tally["pcgs"],
                     cg_iterations=tally["cg_iterations"],
                     cg_iterations_before_tolerance=tally["cg_iterations"],
                     tridiag_applies=tally["applies"], tridiag_factors=tally["factors"],
                     host_reads=0, wall_s=wall)
    if gt is not None:
        stats.update(ate_before_m=ate_rmse(gt, list(before)), ate_after_m=ate_rmse(gt, list(poses)),
                     end_error_before_m=float(np.linalg.norm(before[-1][:3, 3] - gt[-1][:3, 3])),
                     end_error_after_m=float(np.linalg.norm(poses[-1][:3, 3] - gt[-1][:3, 3])))
    log(f"[backend] {label}: " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                                          for k, v in stats.items()))
    return stats


def pose_gap(a, b):
    """(m, rad) between two poses: the translation and the rotation angle of
    a^-1 b, the angle from the antisymmetric part and the trace together
    (atan2), which resolves the micro-radian angles arccos of the trace
    loses to float32."""
    d = np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64)
    R = d[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.linalg.norm(d[:3, 3])), float(np.arctan2(s, 0.5 * (np.trace(R) - 1.0)))


def closure_errors(closures, gt):
    """Each closure's relative pose against the ground truth's: (m, rad)."""
    return [pose_gap(np.linalg.inv(gt[c.i]) @ gt[c.j], c.relative) for c in closures]


def window_drive(dev, front_poses, device_loop):
    """SlidingWindowBA (window 20) over the drive's first
    WINDOW_DRIVE_KEYFRAMES relatives at the odometry edges' information, a
    solve every 32 keyframes.  (the window, the solves' results)."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs

    ba = pgs.SlidingWindowBA(window=WINDOW, device=dev, device_loop=device_loop)
    rels = [np.linalg.inv(a) @ b for a, b in zip(front_poses[:WINDOW_DRIVE_KEYFRAMES],
                                                  front_poses[1:WINDOW_DRIVE_KEYFRAMES + 1])]
    info = ODOMETRY_EDGE_INFO * np.eye(6, dtype=np.float32)
    results = []
    for k, r in enumerate(rels):
        ba.add_keyframe(r, info)
        if (k + 1) % WINDOW_EVERY == 0:
            results.append(ba.optimize())
    return ba, results


def backend_run(dev, front_poses):
    """Stages 2-6 of the back-end on the drive's stream poses, as a user runs
    them (the solves in their device form, the default): `detect_loop_closures`,
    the sparse solve over the 512 poses (the first call captures its graph,
    the timed one replays it), the 1k graph likewise, dense and sparse on the
    10-pose graph, SlidingWindowBA over the drive's first
    WINDOW_DRIVE_KEYFRAMES relatives (window 20, a solve every 32
    keyframes) and on the 30-keyframe chain.  Each stage's checks, the
    solves' counts from the device tally (read before and after each, never
    zeroed: the caller reads the whole run's); returns (stats, the 512-pose
    graph, the closures)."""
    from fast_gicp_tpu_torch.models import pose_graph as pg
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.models.loop_closure import LoopClosureConfig, detect_loop_closures

    scans, _clouds, gt, _dims = backend_drive()
    n = len(front_poses)
    stats = {}
    closures, wall = timed(dev, lambda: detect_loop_closures(scans[:n], front_poses,
                                                           LoopClosureConfig(), device=dev))
    errs = closure_errors(closures, gt)
    stats["closures"] = dict(found=[(c.i, c.j) for c in closures], wall_s=wall,
                             error_m=[e[0] for e in errs], error_rad=[e[1] for e in errs],
                             fitness=[c.fitness for c in closures])
    log(f"[backend] detect_loop_closures: {len(closures)} closures {stats['closures']}")
    require(closures, "no loop closure found on the closed drive")
    require(all(e[0] < CLOSURE_TOL for e in errs),
            f"a closure is {max(e[0] for e in errs)} m off the ground truth (bound {CLOSURE_TOL})")

    graph = closure_graph(front_poses, closures)
    # the first call's set-up: the capture of the device form's graph
    _res, cold = timed(dev, lambda: sparse_solve(dev, graph, device_loop=True))
    base = pg_tally(dev)
    res, wall = timed(dev, lambda: sparse_solve(dev, graph, device_loop=True))
    stats["graph_512"] = s = solve_stats(f"sparse solve, {n} poses, {len(graph[1])} edges "
                                         "(device form, a replay)", res, wall, gt[:n], graph[0],
                                         tally=pg_tally(dev, base))
    s["cold_wall_s"] = cold
    require(bool(torch.isfinite(res.poses).all()), "512-pose solve: non-finite poses")
    require(s["end_error_after_m"] < s["end_error_before_m"],
            f"512-pose solve: the end error rose {s['end_error_before_m']} -> "
            f"{s['end_error_after_m']} m")

    g1k = k1000_graph()
    # warm-up, as the JAX test's: the capture
    sparse_solve(dev, g1k, device_loop=True, max_iterations=15)
    base = pg_tally(dev)
    res, wall = timed(dev, lambda: sparse_solve(dev, g1k, device_loop=True, max_iterations=15))
    stats["graph_1k"] = s = solve_stats("sparse solve, 1k graph (device form, a replay)", res,
                                        wall, g1k[5], g1k[0], tally=pg_tally(dev, base))
    require(s["end_error_after_m"] < K1000_DRIFT_SHARE * s["end_error_before_m"],
            f"1k graph: end drift {s['end_error_after_m']} m, not under "
            f"{K1000_DRIFT_SHARE} x {s['end_error_before_m']} m")

    g10 = small_graph()
    dense = pg.optimize_pose_graph(*g10, pg.PoseGraphConfig(max_iterations=20), device=dev)
    sparse = sparse_solve(dev, g10, device_loop=True, max_iterations=20)
    gap = float((dense.poses - sparse.poses).abs().max())
    stats["dense_vs_sparse"] = dict(max_abs_diff=gap, dense_iterations=int(dense.iterations),
                                    sparse_iterations=int(sparse.iterations))
    log(f"[backend] dense against sparse on the 10-pose graph: {gap:.3e} "
        f"(bound {DENSE_SPARSE_TOL}); {stats['dense_vs_sparse']}")
    require(gap < DENSE_SPARSE_TOL, f"dense and sparse part by {gap}")

    base = pg_tally(dev)
    (ba, _results), wall = timed(dev, lambda: window_drive(dev, front_poses, True))
    rels = min(WINDOW_DRIVE_KEYFRAMES, len(front_poses) - 1)
    require(all(np.isfinite(p).all() for p in ba.poses) and len(ba.poses) == WINDOW,
            "SlidingWindowBA: poses")
    stats["window_drive"] = dict(keyframes=rels, window=WINDOW, solves=rels // WINDOW_EVERY,
                                 base=ba.base, wall_s=wall, ms_per_keyframe=1e3 * wall / rels,
                                 form="device", lm_trials=pg_tally(dev, base)["trials"])
    log(f"[backend] SlidingWindowBA over the drive: {stats['window_drive']}")
    rel30, gt30 = window_chain()
    before, after, _first, _res, _first_res = window_loop(pgs.SlidingWindowBA(
        window=10, config=pgs.SparsePGConfig(max_iterations=10), device=dev), rel30, gt30)
    stats["window_loop"] = dict(tail_before_m=before, tail_after_m=after)
    log(f"[backend] SlidingWindowBA, 30 keyframes, window 10: the loop edge takes the tail "
        f"error {before:.5f} -> {after:.5f} m")
    require(after < 0.5 * before + 1e-6, f"the window's loop edge: {before} -> {after} m")
    return stats, graph, closures


def stage_profile(label, run, dev, tag="backend"):
    """One traced run of a stage: wall, device busy, device ops and the idle
    share of the wall (1 - busy / wall), and the device span (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    out = dict(traced_wall_ms=wall, device_span_ms=start.elapsed_time(end),
               device_busy_ms=busy, device_ops=ops, idle_share=1.0 - busy / wall)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {tag} {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle "
        f"{100 * out['idle_share']:.1f}% of the wall), device ops {ops}; top: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                    for e in top))
    return out


def tridiag_check(label, D, U, r, plain=None):
    """block_tridiag's factor and apply against their plain versions on the
    same inputs (factor then apply, each side its own; `plain`, the plain
    factor's (Cinv, G) where the caller has them): Cinv, G and x bit for bit
    the plain versions', x also within TRIDIAG_TOL of max |x|, and a repeat
    bit-identical; returns (max |x - x_plain| / max |x|, the factor's max
    diff)."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    Cinv, G = cpg.block_tridiag_factor(D, U)
    x = cpg.block_tridiag_apply(Cinv, G, U, r)
    again = cpg.block_tridiag_apply(*cpg.block_tridiag_factor(D, U), U, r)
    Cinv_p, G_p = cpg.block_tridiag_factor_plain(D, U) if plain is None else plain
    x_p = cpg.block_tridiag_apply_plain(Cinv_p, G_p, U, r)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(x).all()), f"block_tridiag {label}: non-finite x")
    require(bool(torch.equal(x, again)), f"block_tridiag {label}: a repeat differs")
    scale = float(x_p.abs().max())
    err = float((x - x_p).abs().max()) / scale
    fac = max(float((Cinv - Cinv_p).abs().max() / Cinv_p.abs().max()),
              float((G - G_p).abs().max() / G_p.abs().max().clamp(min=1e-30)))
    equal = {k: bool(torch.equal(a, b)) for k, a, b in (("Cinv", Cinv, Cinv_p), ("G", G, G_p),
                                                         ("x", x, x_p))}
    log(f"[kernels] block_tridiag {label} (K = {D.shape[0]}): x within {err:.3e} of max |x| "
        f"({scale:.3e}) of the plain version (bound {TRIDIAG_TOL}); the factor's Cinv and G "
        f"within {fac:.3e} of their largest entry; bit for bit the plain versions: {equal}; "
        "a repeat bit-identical")
    require(err <= TRIDIAG_TOL, f"block_tridiag {label}: {err} of max |x| off the plain version")
    require(all(equal.values()), f"block_tridiag {label}: not bit for bit the plain versions "
            f"({equal})")
    return err, fac


def tridiag_chain(rng, K, lam, near_singular_at=None):
    """D, U (float32 numpy) of a seeded SPD chain (pose-graph blocks, pose 0
    pinned, each pose its own SPD block) at lambda; with `near_singular_at`
    = a (0 < a < K - 1), C_a is near-singular: its smallest eigenvalue 1e-4
    of its largest."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    D = np.zeros((K, 6, 6))
    U = np.zeros((K, 6, 6))
    for k in range(K - 1):
        J = np.concatenate([-(np.eye(6) + 0.1 * rng.normal(size=(6, 6))),
                            np.eye(6) + 0.1 * rng.normal(size=(6, 6))], 1)
        H = J.T @ np.diag(rng.uniform(0.5, 2.0, 6)) @ J
        D[k] += H[:6, :6]
        D[k + 1] += H[6:, 6:]
        U[k] = H[:6, 6:]
    D[0] += 1e3 * np.eye(6)
    for k in range(K):
        B = rng.normal(size=(6, 6))
        D[k] += B @ B.T / 6 + 0.5 * np.eye(6)
    D += lam * np.eye(6)
    D, U = D.astype(np.float32), U.astype(np.float32)
    a = near_singular_at
    if a is not None:
        # D_a = U_{a-1}^T G_{a-1} + C, G_{a-1} the float32 factor's own (the
        # plain version on the CPU, the kernel's arithmetic) and C the
        # chain's C_a with its smallest eigenvalue set to 1e-4 of its
        # largest, so that C_a = C to within rounding
        _Cinv, G = cpg.block_tridiag_factor_plain(torch.as_tensor(D[:a]), torch.as_tensor(U[:a]))
        prod = U[a - 1].T.astype(np.float64) @ G[a - 1].double().numpy()
        w, V = np.linalg.eigh(D[a].astype(np.float64) - prod)
        w[0] = 1e-4 * w[-1]
        D[a] = prod + (V * w) @ V.T
        # and C_a's weak direction q coupled 1e-3 as strongly to pose a + 1,
        # which keeps the whole system SPD (C_{a+1} = D_{a+1} - U_a^T C_a^-1 U_a)
        q = V[:, 0]
        U[a] = U[a] - (1.0 - 1e-3) * np.outer(q, q @ U[a])
    return D, U


def tridiag_sweep(dev):
    """block_tridiag on seeded SPD chains (`tridiag_chain`): at lambda from
    1e-7 to 1e4, K = 64, each well conditioned and with C_40 near-singular;
    then at the kernels' edges (TRIDIAG_EDGE_K, lambda 1e-3; one system with
    C_16 near-singular at a chunk's turn, one whose inputs are views 4 bytes
    off a 16-byte boundary, which the wrappers copy) and on each side of
    the apply's on-chip y (TRIDIAG_ON_CHIP_K: prefixes of one chain, whose
    plain factor is the prefix of the longest one's, taken once).  Returns
    the worst error and the points checked."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    rng = np.random.default_rng(7)
    worst, points, K = 0.0, 0, 64
    systems = [(f"sweep lambda {lam:g}" + (", near-singular C_40" if ns else ""), K, lam,
                40 if ns else None)
               for lam in (1e-7, 1e-5, 1e-3, 1e-1, 1e1, 1e3, 1e4) for ns in (False, True)]
    systems += [(f"edge K = {k}", k, 1e-3, None) for k in TRIDIAG_EDGE_K]
    systems.append(("edge K = 33, near-singular C_16", 33, 1e-3, 16))
    systems.append(("edge K = 17, inputs off a 16-byte boundary", 17, 1e-3, None))
    for label, k, lam, at in systems:
        D, U = tridiag_chain(rng, k, lam, at)
        args = [torch.as_tensor(a.astype(np.float32), device=dev)
                for a in (D, U, rng.normal(size=(k, 6)))]
        if "boundary" in label:
            args = [torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape).copy_(a)
                    for a in args]
        err, _fac = tridiag_check(label, *args)
        worst, points = max(worst, err), points + 1
    n = max(TRIDIAG_ON_CHIP_K)
    D, U = tridiag_chain(rng, n, 1e-3)
    D, U, r = [torch.as_tensor(a.astype(np.float32), device=dev)
               for a in (D, U, rng.normal(size=(n, 6)))]
    Cinv_p, G_p = cpg.block_tridiag_factor_plain(D, U)
    for k in TRIDIAG_ON_CHIP_K:
        err, _fac = tridiag_check(f"y on chip's edge K = {k}", D[:k], U[:k], r[:k],
                                  plain=(Cinv_p[:k], G_p[:k]))
        worst, points = max(worst, err), points + 1
    return worst, points


@functools.cache
def sm_clock_mhz():
    """(the card's largest SM clock, its SM clock now) in MHz, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    top, now = (float(v) for v in out.split(","))
    return top, now


def dense_tridiag(D, U):
    """The assembled (6K)^2 block-tridiagonal matrix of D and U."""
    K = D.shape[0]
    A = torch.zeros((6 * K, 6 * K), dtype=D.dtype, device=D.device)
    blocks = A.view(K, 6, K, 6)
    k = torch.arange(K, device=D.device)
    blocks[k, :, k, :] = D
    blocks[k[:-1], :, k[1:], :] = U[:-1]
    blocks[k[1:], :, k[:-1], :] = U[:-1].transpose(1, 2)
    return A


@functools.cache
def previous_tridiag(tree):
    """(factor, apply) of the block_tridiag kernels of the package under
    `tree` (another checkout), built from its `csrc/block_tridiag.cu` alone
    into a library of their own with this package's flags: the same C
    entries, called as the wrappers call them but not counted."""
    from fast_gicp_tpu_torch.ops import _build

    src = pathlib.Path(tree).resolve() / "fast_gicp_tpu_torch" / "csrc" / "block_tridiag.cu"
    so = _build.BUILD_DIR / "previous_block_tridiag.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-shared",
                           str(src), "-o", str(so)], capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"the previous block_tridiag.cu did not build:\n{proc.stdout}"
            f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            log(f"[build] previous block_tridiag: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    fac, app = lib.fgt_block_tridiag_factor, lib.fgt_block_tridiag_apply
    fac.argtypes, app.argtypes = (P, P, P, P, I, P), (P, P, P, P, P, I, P)
    fac.restype = app.restype = ctypes.c_int

    def factor(D, U):
        Cinv, G = torch.empty_like(D), torch.empty_like(D)
        _build.check("previous factor", fac(D.data_ptr(), U.data_ptr(), Cinv.data_ptr(),
                                            G.data_ptr(), D.shape[0],
                                            torch.cuda.current_stream().cuda_stream))
        return Cinv, G

    def apply(Cinv, G, U, r):
        x = torch.empty_like(r)
        _build.check("previous apply", app(Cinv.data_ptr(), G.data_ptr(), U.data_ptr(),
                                           r.data_ptr(), x.data_ptr(), r.shape[0],
                                           torch.cuda.current_stream().cuda_stream))
        return x

    return factor, apply


def tridiag_record(name, inputs, errors, sweep):
    """The record of block_tridiag's factor or apply entry from its inputs at
    the back-end's first PCG of the 512-pose solve and of the 1k solve: the
    errors of `tridiag_check` there and on the sweep, the device time of a
    launch, µs a step, registers and stack frame, the plain version's time
    (the apply's from a profiler trace; the factor's, ~200 launches a step,
    from CUDA events), the bound (the larger of the bytes, each input read
    once and each output written once, and the FP32 operations over the
    card's rates), the serial chain (K steps x the step's dependent FP32
    operations x TRIDIAG_CYCLES_PER_OP at the card's largest SM clock) and
    the launch's time over it, and the library's time: one PyTorch call on
    the assembled (6K)^2 matrix (`torch.linalg.cholesky_ex` beside the
    factor, `torch.cholesky_solve` with its dense lower factor beside the
    apply).  With `--tridiag-previous DIR`, the previous design's kernel is
    timed on the same inputs in turns (previous, this, this, previous);
    without, its time from such a run (TRIDIAG_PREVIOUS_MS) is printed."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    apply = name == "block_tridiag_apply"
    kernel = f"{name}_kernel"
    regs, stack = kernel_build_report().get(name, (None, None))
    clock_max, clock_now = sm_clock_mhz()
    previous = previous_tridiag(TRIDIAG_PREVIOUS_TREE) if TRIDIAG_PREVIOUS_TREE else None
    by_k = {}
    for label, (D, U, r) in inputs.items():
        K = D.shape[0]
        Cinv, G = cpg.block_tridiag_factor(D, U)
        A = dense_tridiag(D, U)
        L, info = torch.linalg.cholesky_ex(A)
        if apply:
            reps = 100
            run = lambda: cpg.block_tridiag_apply(Cinv, G, U, r)  # noqa: E731
            prev = previous and (lambda: previous[1](Cinv, G, U, r))
            plain_ms = device_ms(lambda: cpg.block_tridiag_apply_plain(Cinv, G, U, r), 2)
            rhs = r.reshape(-1, 1)
            library_ms = device_ms(lambda: torch.cholesky_solve(rhs, L), 20)
            nbytes = K * (3 * 36 + 6 + 6) * 4
            nops, chain = K * TRIDIAG_APPLY_OPS, K * TRIDIAG_APPLY_CHAIN
        else:
            reps = 20
            run = lambda: cpg.block_tridiag_factor(D, U)  # noqa: E731
            prev = previous and (lambda: previous[0](D, U))
            plain_ms = cuda_ms(lambda: cpg.block_tridiag_factor_plain(D, U), 1)
            library_ms = device_ms(lambda: torch.linalg.cholesky_ex(A), 5)
            nbytes = K * 4 * 36 * 4
            nops, chain = K * TRIDIAG_FACTOR_OPS, K * TRIDIAG_FACTOR_CHAIN
        if previous:
            prev_ms, ms = [device_ms(prev, reps, kernel)], [device_ms(run, reps, kernel)]
            ms.append(device_ms(run, reps, kernel))
            prev_ms.append(device_ms(prev, reps, kernel))
            p_out, out = prev(), run()
            same = all(torch.equal(a, b) for a, b in zip(
                p_out if isinstance(p_out, tuple) else (p_out,),
                out if isinstance(out, tuple) else (out,)))
            previous_note = (f"previous design {prev_ms[0]:.4f}, {prev_ms[1]:.4f} ms (this one "
                             f"{ms[0]:.4f}, {ms[1]:.4f}; outputs bit-equal: {same})")
        else:
            ms = [device_ms(run, reps, kernel)]
            prev_ms, same = None, None
            lo, hi = TRIDIAG_PREVIOUS_MS[name][label]
            previous_note = f"previous design {lo}-{hi} ms (recorded, TRIDIAG_PREVIOUS_MS)"
        b_ms, b_by = bound_ms(nbytes, nops)
        chain_ms = chain * TRIDIAG_CYCLES_PER_OP / (clock_max * 1e3)
        by_k[label] = dict(K=K, ms=ms[0], ms_runs=ms, previous_ms_runs=prev_ms,
                           previous_outputs_equal=same, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, operations=nops,
                           serial_chain_operations=chain, serial_chain_ms=chain_ms,
                           chain_ratio=ms[0] / chain_ms, sm_clock_mhz=[clock_max, clock_now],
                           us_per_step=1e3 * ms[0] / K, library_ms=library_ms,
                           library_cholesky_info=int(info), x_err_of_max=errors[label][0],
                           factor_err_of_max=errors[label][1])
        log(f"[kernels] {name} at {label} (K = {K}): {ms[0]:.4f} ms a launch "
            f"({1e3 * ms[0] / K:.4f} us a step; {regs} registers, {stack} bytes stack frame); "
            f"{previous_note}; plain {plain_ms:.3f} ms; dense (6K)^2 "
            f"{'torch.cholesky_solve' if apply else 'torch.linalg.cholesky_ex'} "
            f"{library_ms:.4f} ms (cholesky info {int(info)}); bound {b_ms:.3e} ms ({b_by}); "
            f"serial chain {chain} dependent operations, {chain_ms:.4f} ms at "
            f"{TRIDIAG_CYCLES_PER_OP} cycles each and {clock_max:.0f} MHz (now {clock_now:.0f}): "
            f"the launch {ms[0] / chain_ms:.2f}x it")
    main = by_k["graph_512"]
    return dict(name=name, own_path="backend", route="cuda",
                source="fast_gicp_tpu_torch/csrc/block_tridiag.cu",
                replaces="none: XLA's lax.scan in fast_gicp_tpu/models/pose_graph_sparse.py:89",
                registers=regs, stack_bytes=stack,
                max_abs_err=max([e[0] for e in errors.values()] + [sweep[0]]),
                tolerance=f"Cinv, G and x bit for bit the plain versions' (factor then apply), "
                          f"x within {TRIDIAG_TOL} of max |x|, at both solves' first PCG and on "
                          f"{sweep[1]} sweep systems; a repeat bit-identical",
                timing="profiler device time" if apply else
                "kernel: profiler device time; plain: CUDA events (host-bound)",
                library="dense (6K)^2: " + ("torch.cholesky_solve(r, L), L its lower Cholesky "
                                            "factor" if apply else "torch.linalg.cholesky_ex"),
                by_k=by_k, **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms")})


def first_pcg_inputs(run):
    """(D, U, r) of the first PCG of the sparse solve `run()` makes: the
    factor's blocks and the first apply's right-hand side (b)."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs

    (D, U), _kw = first_call(run, pgs, "block_tridiag_factor")
    (_Cinv, _G, _U, r), _kw = first_call(run, pgs, "block_tridiag_apply")
    return D, U, r


def trial_at(run, ndt):
    """The inputs (y0, H, b, aux, cost, n_src) of the first LM trial of
    `run()` whose cost is NDT's (ndt) or GICP's (not ndt)."""
    from fast_gicp_tpu_torch.ops import cuda_solver

    (_s, H, b, y0, aux, cost, _f, _c), _kw = first_call(
        run, cuda_solver, "lm_step",
        match=lambda *a, **k: (a[5].resolution is not None) == ndt)
    return y0, H, b, aux, cost, aux.shape[1] // cost.offsets


def nth_call(n):
    """A `first_call` match that takes the n-th call (0 first)."""
    seen = [0]

    def match(*_a, **_k):
        seen[0] += 1
        return seen[0] == n + 1

    return match


def ndt_pack_record(label, P, CA, x, pack, res, mode):
    """An NDT linearize in the pack form on its arguments against its plain
    version (the NDT tolerances, a repeat bit-identical), timed, with its
    bound."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    _check_aux, check_lin = ndt_checkers(x)
    got = check_lin(label, P, CA, pack, mode, 1e-5, res=res)
    N, L = P.shape[1], pack.shape[0]
    nvalid = int(pack[:, 9].sum())
    tm_ = timings(lambda: cuda_ndt.ndt_linearize(P, CA, x, pack, res, mode),
                  lambda: cuda_ndt.ndt_linearize_plain(P, CA, x, pack, cuda_ndt._c_sq(res), mode),
                  ndt_kernel_name(mode, "pack"), 200, 20)
    nbytes = ndt_lin_bytes(mode, "pack", N, L)
    b_ms, b_by = bound_ms(nbytes, ndt_lin_ops(mode, "pack", L, nvalid))
    log(f"[kernels] {label} ({res} m, L = {L}, {nvalid} valid): within tolerance of the plain "
        f"version ({got[-1]:.3e}), {tm_['ms']:.5f} ms, plain {tm_['plain_ms']:.4f} ms; bound "
        f"{b_ms:.3e} ms ({b_by})")
    return dict(lanes=L, source_columns=N, valid_lanes=nvalid, resolution=res,
                max_abs_err=got[-1], pack_ms=tm_["ms"], plain_ms=tm_["plain_ms"],
                call_ms=tm_["call_ms"], bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                timing=tm_["timing"])


def nn_record(label, q, t, tmask, qmask):
    """nn_search on its arguments: idx and d2 bit-equal to the plain version
    on every valid query, timed, with its bound over the chunk pairs this
    run's queries reach."""
    from fast_gicp_tpu_torch.ops import cuda_kernels
    from fast_gicp_tpu_torch.ops.neighbors import _masked_target

    idx, d2 = cuda_kernels.nn_search(q, t, tmask, qmask)
    idx_w, d2_w = cuda_kernels.nn_search_plain(q, t, tmask)
    torch.cuda.synchronize()
    require(bool(torch.equal(idx[qmask], idx_w[qmask]) and torch.equal(d2[qmask], d2_w[qmask])),
            f"nn_search {label}: {int((idx != idx_w)[qmask].sum())} ids, "
            f"{int((d2 != d2_w)[qmask].sum())} d2 differ on valid queries")
    tm_ = timings(lambda: cuda_kernels.nn_search(q, t, tmask, qmask),
                  lambda: cuda_kernels.nn_search_plain(q, t, tmask),
                  ("chunk_bbox_kernel", "nn_search_kernel"), 100, 5)
    parked = _masked_target(t, tmask)
    tlo, thi = _boxes(parked, torch.ones_like(tmask), CHUNK)
    reach = (_gap2(q, q, tlo, thi) <= d2_w[:, None]) & qmask[:, None]
    pad = (-q.shape[0]) % 32
    reach = torch.cat([reach, reach.new_zeros((pad, reach.shape[1]))])
    pairs = int(reach.reshape(-1, 32, tlo.shape[0]).any(1).sum()) * 32 * CHUNK
    nq, nt = q.shape[0], t.shape[0]
    b_ms, b_by = bound_ms(nq * 12 + nt * 12 + nq * 8, pairs * NN_OPS_PER_PAIR)
    log(f"[kernels] nn_search {label}, {nq} x {nt}: idx and d2 bit-equal on every valid "
        f"query; {tm_['ms']:.4f} ms, plain {tm_['plain_ms']:.3f} ms; bound {b_ms:.3e} ms "
        f"({b_by})")
    return dict(queries=nq, targets=nt, max_abs_err=float((d2 - d2_w)[qmask].abs().max()),
                pairs_to_visit=pairs, bound_ms=b_ms, bound_by=b_by, **tm_)


def closure_kernels(dev, by_name, run):
    """The kernels of the first verify_closure against their plain
    versions, at its own inputs, added to the records under "backend":
    rbf_moments on both clouds, ndt_d2d in the pack form at the coarse
    align's first freeze (the hash map: the card's eager freeze, then the
    pack form; within the NDT tolerances, a repeat bit-identical),
    linearize_raw (idx form) at the refine's first linearization, nn_search
    at the fitness (idx and d2 bit-equal on every valid query) and the trial
    launches (`trial_sweeps`, NDT and GICP)."""
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_ndt

    for n, cloud in enumerate(("source", "target")):
        args, _kw = first_call(run, cuda_kernels, "rbf_moments", match=nth_call(n))
        by_name["rbf_moments"][f"backend_{cloud}"] = rbf_record(
            f"(backend, first verify_closure, {cloud})", args)
    (P, CA, x, pack, res, mode), _kw = first_call(run, cuda_ndt, "ndt_linearize")
    require(mode == "d2d", f"the coarse align linearizes in mode {mode}, not d2d")
    by_name["ndt_d2d"]["backend"] = ndt_pack_record(
        "ndt_d2d pack form at the coarse align's first freeze", P, CA, x, pack, res, mode)
    args, _kw = first_call(run, cuda_linearize, "linearize_raw")
    by_name["linearize_raw"]["backend"] = odometry_lin_record(
        "linearize_raw (backend refine, first linearization)", True, args, "elementwise")
    args, _kw = first_call(run, cuda_kernels, "nn_search")
    by_name["nn_search"]["backend"] = nn_record("(backend fitness)", *args)
    recs, points, hits, _err = trial_sweeps(dev, {"backend_ndt": trial_at(run, True),
                                                  "backend_gicp": trial_at(run, False)})
    by_name["lm_step"]["by_path"].update(recs)
    return dict(trial_points=points, trial_hits=hits)


def backend_card_vs_cpu(dev, front_poses, first_candidate):
    """The back-end on the card against the same calls with device="cpu":
    verify_closure on the first candidate (the relative pose within 2e-3 m
    and 1e-3 rad, the limit of the RBF paths), the sparse solve on the
    drive's first 64 odometry poses with a closure 0 -> 63 from the ground
    truth at 1e4 I (poses within 1e-4), and SlidingWindowBA on the
    30-keyframe chain (the poses after its first solve and prior_info within
    1e-4 of their largest entry, the loop-edge solve's objective within
    1e-3; its poses reported); the solves in the device form (the default),
    with deterministic scatter-adds."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.models.loop_closure import LoopClosure, verify_closure

    scans, _clouds, gt, _dims = backend_drive()
    i, j = first_candidate
    guess = (np.linalg.inv(front_poses[i]) @ front_poses[j]).astype(np.float32)
    card, cpu = (verify_closure(scans[i], scans[j], guess, device=d) for d in (dev, "cpu"))
    t_gap, r_gap = pose_gap(cpu[0], card[0])
    log(f"[backend] verify_closure ({i}, {j}) card against CPU: {t_gap:.3e} m, {r_gap:.3e} rad "
        f"(bounds {CLOSURE_CARD_CPU}); fitness {card[2]:.6f} / {cpu[2]:.6f}, ok {card[3]} / "
        f"{cpu[3]}")
    require(t_gap < CLOSURE_CARD_CPU[0] and r_gap < CLOSURE_CARD_CPU[1] and card[3] == cpu[3],
            f"verify_closure card against CPU: {t_gap} m, {r_gap} rad")

    n = CARD_CPU_POSES
    lc = LoopClosure(i=0, j=n - 1, relative=(np.linalg.inv(gt[0]) @ gt[n - 1]).astype(
        np.float32), information=1e4 * np.eye(6, dtype=np.float32), fitness=0.0)
    graph = closure_graph(front_poses[:n], [lc])
    solves = [_deterministic(lambda d=d: sparse_solve(torch.device(d), graph, device_loop=True))
              for d in (dev, "cpu")]
    gap = float((solves[0].poses.cpu() - solves[1].poses).abs().max())
    its = [int(s.iterations) for s in solves]
    log(f"[backend] sparse solve, {n} poses, card against CPU: poses within {gap:.3e} (bound "
        f"{BACKEND_CARD_CPU_TOL}); iterations {its}")
    require(gap < BACKEND_CARD_CPU_TOL, f"the {n}-pose solve: card and CPU part by {gap}")

    rel30, gt30 = window_chain()
    bas = [pgs.SlidingWindowBA(window=10, config=pgs.SparsePGConfig(max_iterations=10),
                               device=d) for d in (dev, "cpu")]
    runs = [_deterministic(lambda ba=ba: window_loop(ba, rel30, gt30)) for ba in bas]
    w_gap = float(np.abs(runs[0][2] - runs[1][2]).max() / np.abs(runs[1][2]).max())
    scale = float(np.abs(bas[1].prior_info).max())
    i_gap = float(np.abs(bas[0].prior_info - bas[1].prior_info).max()) / scale
    errs = [float(r[3].error) for r in runs]
    e_gap = abs(errs[0] - errs[1]) / errs[1]
    loop_gap = float(np.abs(np.stack(bas[0].poses) - np.stack(bas[1].poses)).max())
    log(f"[backend] SlidingWindowBA card against CPU: poses after the first solve within "
        f"{w_gap:.3e} of their largest entry, prior_info within {i_gap:.3e} of its largest "
        f"entry (bounds {BACKEND_CARD_CPU_TOL}); after the loop-edge solve the objective "
        f"{errs[0]:.6e} / {errs[1]:.6e} ({e_gap:.3e} apart, bound {WINDOW_LOOP_ERROR_TOL}), "
        f"the poses {loop_gap:.3e} m apart (a flat valley: not held)")
    require(w_gap < BACKEND_CARD_CPU_TOL and i_gap < BACKEND_CARD_CPU_TOL
            and e_gap < WINDOW_LOOP_ERROR_TOL,
            f"SlidingWindowBA card against CPU: poses {w_gap}, prior_info {i_gap}, "
            f"objective {e_gap}")
    return dict(verify_closure_m=t_gap, verify_closure_rad=r_gap, sparse_64_poses=gap,
                sparse_64_iterations=its, window_poses=w_gap, window_prior_info=i_gap,
                window_loop_objective=e_gap, window_loop_poses_m=loop_gap)


def _bits(t):
    """A tensor's bits on the host (float32 as int32, so NaNs compare too)."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def forms_equal(a, b):
    """Two runs' (results, host arrays) bit for bit: every field of every
    PoseGraphResult and every array."""
    (ra, xa), (rb, xb) = a, b
    return (len(ra) == len(rb) and len(xa) == len(xb)
            and all(torch.equal(_bits(getattr(p, f)), _bits(getattr(q, f)))
                    for p, q in zip(ra, rb) for f in p._fields)
            and all(np.array_equal(np.asarray(u, np.float32).view(np.int32),
                                   np.asarray(v, np.float32).view(np.int32))
                    for u, v in zip(xa, xb)))


def backend_solves(dev, graph, front_poses):
    """The back-end's solves as `run(device_loop) -> (results, host arrays,
    one)`: the 512-pose and the 1k sparse solves, the dense 10-pose one, and
    SlidingWindowBA over the drive (window 20, 96 relatives) and on the
    30-keyframe chain (window 10, the loop edge), each window's poses, prior
    pose and prior information after its last solve; `one(device_loop)`
    runs the last solve's signature once more from the same state (a
    window's poses put back first) and returns its result."""
    from fast_gicp_tpu_torch.models import pose_graph as pg
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs

    g1k, g10 = k1000_graph(), small_graph()
    rel30, gt30 = window_chain()

    def state(ba):
        return [np.stack(ba.poses), ba.prior_pose, ba.prior_info]

    def again(ba):
        poses = list(ba.poses)

        def one(loop):
            ba.poses, ba.device_loop = list(poses), loop
            return ba.optimize()
        return one

    def drive(loop):
        ba, results = window_drive(dev, front_poses, loop)
        return results, state(ba), again(ba)

    def chain(loop):
        ba = pgs.SlidingWindowBA(window=10, config=pgs.SparsePGConfig(max_iterations=10),
                                 device=dev, device_loop=loop)
        _before, _after, first, res, first_res = window_loop(ba, rel30, gt30)
        return [first_res, res], [first] + state(ba), again(ba)

    def single(solve):
        def run(loop):
            return [solve(loop)], [], solve
        return run

    return {
        "graph_512": single(lambda loop: sparse_solve(dev, graph, device_loop=loop)),
        "graph_1k": single(lambda loop: sparse_solve(dev, g1k, device_loop=loop,
                                                     max_iterations=15)),
        "dense_10": single(lambda loop: pg.optimize_pose_graph(
            *g10, pg.PoseGraphConfig(max_iterations=20), device=dev, device_loop=loop)),
        "window_drive": drive,
        "window_chain": chain,
    }


def timed_span(dev, fn):
    """(fn(), its wall seconds closed by a synchronize, its device span ms
    from CUDA events on the current stream)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def new_setups(keys0):
    """(warm_s, capture_s) of each program `graphs.replay_cached` holds now
    and did not hold under the keys `keys0`."""
    from fast_gicp_tpu_torch import graphs

    return [(g.warm_s, g.capture_s) for k, (_static, g) in graphs._programs.items()
            if k not in keys0]


def replay_profile(form):
    """A sparse solve's stage record from its `backend_forms` entry: the
    replay, the main path's form.  Its device time is the CUDA-event span
    (the graph's whole run on the stream) with the tally's counts; the
    traced busy time and ops are lower bounds (CUPTI misses kernels of
    conditional bodies in some runs)."""
    keys = ("replay_wall_ms", "device_span_ms", "tally", "traced_device_busy_ms",
            "traced_wall_ms", "traced_idle_share", "traced_device_ops", "card")
    out = {k: form[k] for k in keys}
    out.update(form="device (a replay of the whole solve)",
               span_idle_share=1.0 - form["device_span_ms"] / form["replay_wall_ms"])
    return out


def signature_sequence(dev, front_poses, closures):
    """The device form where each call is a new signature: a growing graph,
    the 512-pose graph cut after each of SIGNATURE_CLOSURES closures (in the
    order of their later pose) and solved once at each size, as a SLAM
    back-end re-solves at each loop closure.  Each solve's first call (the
    warm-up, the capture and one replay), the eager form's wall beside the
    first and the last, and the device memory the cached graphs hold (the
    caching allocator's reserved and allocated bytes before and after each
    capture)."""
    from fast_gicp_tpu_torch import graphs

    ordered = sorted(closures, key=lambda c: (c.j, c.i))
    rows = []
    for n in SIGNATURE_CLOSURES:
        if n > len(ordered):
            break
        k = ordered[n - 1].j + 1
        g = closure_graph(front_poses[:k], ordered[:n])
        keys0 = set(graphs._programs)
        reserved0, allocated0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        res, wall = timed(dev, lambda: sparse_solve(dev, g, device_loop=True))
        setups = new_setups(keys0)
        row = dict(poses=k, edges=len(g[1]), closures=n, first_call_ms=1e3 * wall,
                   warm_up_ms=1e3 * sum(w for w, _c in setups),
                   capture_ms=1e3 * sum(c for _w, c in setups), captures=len(setups),
                   reserved_mib=(torch.cuda.memory_reserved() - reserved0) / 2**20,
                   allocated_mib=(torch.cuda.memory_allocated() - allocated0) / 2**20,
                   iterations=int(res.iterations), error=float(res.error))
        if n in (SIGNATURE_CLOSURES[0], SIGNATURE_CLOSURES[-1]):
            eager, eager_wall = timed(dev, lambda: sparse_solve(dev, g))
            row.update(eager_wall_ms=1e3 * eager_wall, eager_error=float(eager.error))
        rows.append(row)
        log(f"[backend_device] growing graph, {k} poses, {n} closures: {row}")
        require(len(setups) == 1 and bool(torch.isfinite(res.poses).all()),
                f"growing graph at {k} poses: {len(setups)} captures, or non-finite poses")
    out = dict(solves=rows, programs_held=len(graphs._programs), programs_max=graphs.PROGRAMS,
               card=card_line())
    log(f"[backend_device] growing graph: {len(rows)} signatures, {out['programs_held']} "
        f"programs held (at most {graphs.PROGRAMS}); {out['card']}")
    return out


def backend_forms(dev, graph, front_poses, card, repeats=None):
    """Each back-end solve in the device form beside the eager form: with
    deterministic scatter-adds on both sides (the graph captured under them)
    every result and window state bit for bit, and the trials, PCGs and CG
    iterations the eager form counts on the host equal to the device tally.
    Then one solve of the last signature (a window's last solve again, from
    its state): with atomic scatter-adds the gap beside the eager form's own
    repeat gap; the replay's wall and device span (CUDA events) in one run,
    its tally (block_tridiag_apply's calls one a PCG and one a CG
    iteration), the eager form's wall, a traced replay's device busy time
    and idle share (the trace misses kernels of conditional bodies: lower
    bounds) and, for the single solves, the host syncs between the replay's
    enqueue and its result read (none allowed; a window's solve reads its
    poses back).  The warm-up and capture are timed on the deterministic
    graphs (their signatures' first calls).  `repeats`: an eager result of
    a solve made before (the 512-pose solve's host-sync count) that stands
    for its eager repeat."""
    from fast_gicp_tpu_torch import graphs
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    f = pgs.optimize_pose_graph_sparse
    out = {}
    count_host_syncs(lambda: None)  # a process's first sync-debug window counts one in torch.cuda
    for name, run in backend_solves(dev, graph, front_poses).items():
        t0 = time.perf_counter()
        single = not name.startswith("window")
        # deterministic scatter-adds: both forms, the device form captured under
        # them (a signature of its own: its warm-up and capture are timed)
        keys0 = set(graphs._programs)
        cpg.pg_counts(dev).zero_()
        det_dev = _deterministic(lambda: run(True))
        setups = new_setups(keys0)
        det_tally = pg_tally(dev)
        pgs.reset_stats()
        det_eager = _deterministic(lambda: run(False))
        host = dict(trials=f.trials, pcgs=f.pcgs, cg_iterations=int(f.cg_iterations_run))
        bit_equal = forms_equal(det_dev[:2], det_eager[:2])
        # atomic scatter-adds: one solve of the last signature in each form
        one = det_dev[2]
        one(True)  # its graph without deterministic algorithms, if not yet captured
        cpg.pg_counts(dev).zero_()
        dev_res, wall, span = timed_span(dev, lambda: one(True))
        tally = pg_tally(dev)
        eager_res, eager_wall = timed(dev, lambda: one(False))
        repeat = (repeats or {}).get(name) or one(False)
        gap = float((dev_res.poses - eager_res.poses).abs().max())
        repeat_gap = float((repeat.poses - eager_res.poses).abs().max())
        syncs, sites = count_host_syncs(lambda: one(True)) if single else (None, None)
        prof = stage_profile(f"{name}, device form (a replay)", lambda: one(True), dev)
        setup_ms = 1e3 * sum(w + c for w, c in setups)
        stats = dict(bit_equal_deterministic=bit_equal, eager_counts_deterministic=host,
                     tally_deterministic=det_tally, tally=tally,
                     iterations=int(dev_res.iterations), signatures=len(setups),
                     warm_up_and_capture_ms=setup_ms,
                     warm_up_ms=1e3 * sum(w for w, _c in setups),
                     capture_ms=1e3 * sum(c for _w, c in setups), replay_wall_ms=1e3 * wall,
                     eager_wall_ms=1e3 * eager_wall, device_span_ms=span,
                     traced_device_busy_ms=prof["device_busy_ms"],
                     traced_wall_ms=prof["traced_wall_ms"], traced_idle_share=prof["idle_share"],
                     traced_device_ops=prof["device_ops"], gap_atomic=gap,
                     eager_repeat_gap_atomic=repeat_gap, host_syncs=syncs,
                     host_sync_sites=sites, card=card)
        out[name] = stats
        log(f"[backend_device] {name}: deterministic bit-equal {bit_equal} (tally {det_tally}, "
            f"eager {host}); {len(setups)} signatures, warm-up + capture {setup_ms:.1f} ms; "
            f"one solve: replay {1e3 * wall:.1f} ms, device span {span:.1f} ms, eager "
            f"{1e3 * eager_wall:.1f} ms, traced busy {prof['device_busy_ms']:.1f} ms of "
            f"{prof['traced_wall_ms']:.1f} (idle {100 * prof['idle_share']:.1f}%; lower bounds); "
            f"tally {tally}; atomic gap {gap:.3e} (eager repeat {repeat_gap:.3e}); host syncs "
            f"{syncs} {sites} ({time.perf_counter() - t0:.1f} s; {card})")
        require(bit_equal, f"{name}: the device form differs from the eager form with "
                "deterministic scatter-adds")
        require(all(det_tally[k] == host[k] for k in ("trials", "pcgs", "cg_iterations"))
                and det_tally["applies"] == det_tally["pcgs"] + det_tally["cg_iterations"]
                and det_tally["factors"] == det_tally["pcgs"],
                f"{name}: device tally {det_tally} against the eager form's counts {host}")
        require(tally["solves"] == 1 and tally["iterations"] == int(dev_res.iterations)
                and tally["trials"] == tally["pcgs"] == tally["factors"]
                and tally["applies"] == tally["pcgs"] + tally["cg_iterations"],
                f"{name}: tally {tally} for {int(dev_res.iterations)} iterations")
        require(not single or syncs == 0, f"{name}: {syncs} host syncs in a replay: {sites}")
    return out


def pg_cond_sweep(dev):
    """pg_cond against its plain version on every mode, at trip counters on
    both sides of each cap and of the refresh period, both stop flags and
    res.res on both sides of, at and NaN against the threshold: the counters
    and flags bit for bit case by case, the tallies in all.  Returns the
    cases run."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    rng = np.random.default_rng(20)
    rows = []
    for mode in range(cpg.PG_REFRESH + 1):
        caps = (cpg.CG_REFRESH, 1, 3) if mode == cpg.PG_REFRESH else (0, 1, 8, 100)
        for cap in caps:
            for n in sorted({0, max(cap - 2, 0), max(cap - 1, 0), cap, cap + 1, 62, 63, 64}):
                for stop in (0, 1):
                    th = np.float32(rng.uniform(1e-12, 1.0))
                    for rr in (np.nextafter(th, np.float32(0)), th,
                               np.nextafter(th, np.float32(np.inf)), np.float32(np.nan)):
                        rows.append((mode, cap, n, stop, rr, th))
    m = len(rows)
    cols = list(zip(*rows))
    host = dict(counter=torch.tensor(cols[2], dtype=torch.int32),
                stop=torch.tensor(cols[3], dtype=torch.bool),
                rr=torch.tensor(np.asarray(cols[4], np.float32)),
                thresh=torch.tensor(np.asarray(cols[5], np.float32)),
                flag=torch.full((m,), 7, dtype=torch.int32))
    card = {k: v.to(dev) for k, v in host.items()}
    tallies = []
    for side, t in (("cuda", card), ("cpu", host)):
        d = t["counter"].device
        before = cpg.pg_counts(d).clone()
        for c, (mode, cap, *_rest) in enumerate(rows):
            args = [t[k][c:c + 1] for k in ("counter", "flag")]
            kw = {k: t[k][c:c + 1] for k in ("stop", "rr", "thresh")}
            if side == "cuda":
                cpg.pg_cond(mode, cap, *args, **kw)
            else:
                cpg.pg_cond_plain(mode, cap, *args, **kw)
        tallies.append((cpg.pg_counts(d) - before).cpu())
    torch.cuda.synchronize()
    for k in ("counter", "flag"):
        diff = (card[k].cpu() != host[k]).nonzero().flatten().tolist()
        require(not diff, f"pg_cond's {k} differs from its plain version on cases "
                f"{[rows[c] for c in diff[:5]]}")
    require(torch.equal(*tallies), f"pg_cond's tally {tallies[0].tolist()} against its plain "
            f"version's {tallies[1].tolist()}")
    return m


def pg_cond_record(dev, launches):
    """The pose-graph condition kernel's record: the sweep bit for bit, a
    launch's device time at a CG step against the plain version's, the
    bound."""
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg

    cases = pg_cond_sweep(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    counter, flag = torch.zeros((), **i32), torch.zeros(1, **i32)
    rr, th = torch.ones((), device=dev), torch.zeros((), device=dev)
    kw = dict(rr=rr, thresh=th)
    run = lambda: cpg.pg_cond(cpg.PG_CG_STEP, 100, counter, flag, **kw)  # noqa: E731
    plain = lambda: cpg.pg_cond_plain(cpg.PG_CG_STEP, 100, counter, flag, **kw)  # noqa: E731
    t = timings(run, plain, "pg_cond_kernel", 200, 20)
    b_ms, b_by = bound_ms(PG_COND_BYTES, PG_COND_OPS)
    log(f"[kernels] pg_cond: {cases} cases bit for bit its plain version; {t['ms']:.5f} ms a "
        f"launch, plain {t['plain_ms']:.4f} ms; bound {b_ms:.3e} ms ({b_by})")
    return dict(name="pg_cond", own_path="backend", route="cuda",
                source="fast_gicp_tpu_torch/csrc/device_loop.cu",
                replaces="none: the predicates of the lax.while_loops and the CG's lax.cond in "
                         "fast_gicp_tpu/models/pose_graph_sparse.py:255-323 and "
                         "pose_graph.py:111-116 (evaluated by XLA)",
                launches=launches, max_abs_err=0.0, tolerance=f"bit for bit on {cases} cases",
                bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=PG_COND_BYTES, **t)


def flag_read_lines():
    """The lines of `models/pose_graph_sparse.py` that read the solve's two
    flags (the trial's accept, the iteration's convergence)."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs

    lines = pathlib.Path(pgs.__file__).read_text().splitlines()
    out = [n + 1 for n, line in enumerate(lines)
           if "if bool(ok):" in line or "conv = bool(conv_t)" in line]
    require(len(out) == 2, f"flag reads of the sparse solve: {out}")
    return out


def phase_backend(dev, records, path_launches, summary):
    """Slice G's phases on the 512-frame drive: the front end, then the
    back-end's run with every launch counter set to 0 just before it and
    read just after (`backend_run`), the host reads of the 512-pose solve
    and its launches, the device forms (`backend_forms`), pg_cond, the
    growing graph (`signature_sequence`), the kernels at the back-end's own
    inputs, card against CPU and a traced run of each stage."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.models.loop_closure import (
        LoopClosureConfig, detect_loop_closures, find_loop_candidates, verify_closure,
    )
    from fast_gicp_tpu_torch.ops import cuda_pose_graph as cpg
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.kitti import trajectory_report

    t0 = time.perf_counter()
    scans, clouds, gt, dims = backend_drive()
    log(f"[backend] drive: {len(scans)} frames, seed {ODOMETRY_SEED}, {ODOMETRY_DOWNSAMPLE} m "
        f"downsample: {[len(c) for c in clouds[:4]]}... points, grid {dims} "
        f"({time.perf_counter() - t0:.1f} s)")
    front_end(dev, frames=WARMUP_FRAMES)  # warm-up
    reset_counters()
    lsq_solve.host_syncs = 0
    poses, wall = timed(dev, lambda: front_end(dev))
    front = dict(frames=len(poses), wall_s=wall, frames_per_s=len(poses) / wall,
                 trajectory=trajectory_report(gt, poses), flag_reads=lsq_solve.host_syncs,
                 launches=read_counters())
    log(f"[backend] front end (run_odometry_stream): {front}")
    require(len(poses) == BACKEND_FRAMES and all(np.isfinite(p).all() for p in poses),
            "front end: poses")

    # stages 2-6, every launch counter and the device tally at 0 just before
    # and read just after.  The solves run as graph replays, so the
    # launches of their kernels are what the kernels counted on the device;
    # their wrappers' host counts are enqueues (into a graph, under capture)
    reset_counters()
    cpg.pg_counts(dev).zero_()
    lsq_solve.host_syncs = 0
    t1 = time.perf_counter()
    stats, graph, closures = backend_run(dev, poses)
    launches = read_counters()
    tally = pg_tally(dev)
    enqueued = {k: launches[k] for k in DEVICE_COUNTED}
    launches.update({k: tally[slot] for k, slot in DEVICE_COUNTED.items()})
    stats.update(front_end=front, wall_s=time.perf_counter() - t1, launches=launches,
                 tally=tally, host_counted_enqueues=enqueued)
    log(f"[backend] back-end run: {stats['wall_s']:.1f} s; launches {launches} (the solves' "
        f"kernels from the device tally {tally}; their wrappers' host counts {enqueued})")
    require(all(launches[k] > 0 for k in BACKEND_KERNELS),
            f"backend: a kernel of the path was not launched: {launches}")
    require(launches["lm_step"] == lsq_solve.host_syncs
            and all(launches[k] == 0 for k in TRIAL_CARRIED),
            f"backend: {launches['lm_step']} trial launches for {lsq_solve.host_syncs} flag "
            f"reads, or a standalone trial or error launch")
    require(launches["ndt_d2d[lookup]"] == 0, "backend: the hash-map NDT align made a "
            "lookup-form launch")

    # the 512-pose solve again in the eager form: host reads (one a trial and
    # one a Gauss-Newton iteration, none inside a PCG) and one block_tridiag
    # launch an application of the preconditioner
    reset_counters()
    pgs.reset_stats()
    base = pg_tally(dev)
    eager_512 = []
    syncs, sites = count_host_syncs(lambda: eager_512.append(sparse_solve(dev, graph)))
    f = pgs.optimize_pose_graph_sparse
    applies = read_counters()
    ran = pg_tally(dev, base)
    cg = pgs.SparsePGConfig().cg_iterations
    stats["graph_512"].update(host_syncs=syncs, host_sync_sites=sites)
    log(f"[backend] 512-pose solve: {syncs} host syncs for {f.trials} trials and "
        f"{f.host_syncs - f.trials} convergence reads ({sites}); block_tridiag factor "
        f"{applies['block_tridiag_factor']}, apply {applies['block_tridiag_apply']} launches "
        f"for {f.pcgs} PCGs of {cg} iterations")
    flag_lines = {f"models/pose_graph_sparse.py:{n}" for n in flag_read_lines()}
    extra = {k: v for k, v in sites.items() if k not in flag_lines}
    stats["graph_512"]["host_syncs_besides_flags"] = extra
    # besides the flag reads at most one: the synchronizing call inside
    # torch.cuda that the serial odometry path also meets on its first frame
    require(sum(sites.get(k, 0) for k in flag_lines) == f.host_syncs
            and sum(extra.values()) <= 1 and all(k.startswith("cuda/") for k in extra),
            f"the sparse solve made {syncs} host syncs for {f.host_syncs} flag reads: a read "
            f"inside a PCG or elsewhere ({sites})")
    require(applies["block_tridiag_apply"] == f.pcgs * (cg + 1)
            and applies["block_tridiag_factor"] == f.trials == f.pcgs,
            f"preconditioner launches {applies} for {f.pcgs} PCGs")
    require(ran["applies"] == applies["block_tridiag_apply"]
            and ran["factors"] == applies["block_tridiag_factor"],
            f"the eager solve's block_tridiag runs counted on the device {ran} against its "
            f"launches {applies}")

    # each solve in the device form beside the eager form; pg_cond's record
    stats["device_forms"] = backend_forms(dev, graph, poses, card_line(),
                                          repeats={"graph_512": eager_512[0]})
    records.append(pg_cond_record(dev, launches["pg_cond"]))
    stats["signatures"] = signature_sequence(dev, poses, closures)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: back-end device forms, pg_cond")

    # kernels at the back-end's own inputs
    by_name = {r["name"]: r for r in records}
    inputs = {"graph_512": first_pcg_inputs(lambda: sparse_solve(dev, graph)),
              "graph_1k": first_pcg_inputs(lambda: sparse_solve(dev, k1000_graph(),
                                                                max_iterations=15))}
    errors = {k: tridiag_check(f"at the first PCG of {k}", *v) for k, v in inputs.items()}
    sweep = tridiag_sweep(dev)
    for name in ("block_tridiag_apply", "block_tridiag_factor"):
        records.append(tridiag_record(name, inputs, errors, sweep))
    cands = find_loop_candidates(poses, LoopClosureConfig())
    i, j = cands[0]
    guess = (np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: back-end run, block_tridiag checks")
    stats["closure_kernels"] = closure_kernels(
        dev, by_name, lambda: verify_closure(scans[i], scans[j], guess, device=dev))
    log(f"[total] {time.perf_counter() - T_START:.1f} s: back-end kernel checks")
    stats["card_vs_cpu"] = backend_card_vs_cpu(dev, poses, (i, j))
    log(f"[total] {time.perf_counter() - T_START:.1f} s: back-end card against CPU")

    # a traced run of each stage, the window cut to 33 keyframes (13
    # marginalizations and one solve); the two sparse solves' are their
    # replays' from `backend_forms`, each with its CUDA-event span and tally
    # (the trace misses kernels of conditional bodies in some runs)
    forms = stats["device_forms"]
    ba_rels = [np.linalg.inv(a) @ b for a, b in zip(poses[:33], poses[1:34])]

    def window_33():
        ba = pgs.SlidingWindowBA(window=WINDOW, device=dev)
        for k, r in enumerate(ba_rels):
            ba.add_keyframe(r, ODOMETRY_EDGE_INFO * np.eye(6, dtype=np.float32))
            if (k + 1) % WINDOW_EVERY == 0:
                ba.optimize()

    stats["profile"] = {
        "front_end_16_frames": stage_profile("front end, 16 frames",
                                             lambda: front_end(dev, frames=16), dev),
        "detect_loop_closures": stage_profile(
            "detect_loop_closures",
            lambda: detect_loop_closures(scans, poses, LoopClosureConfig(), device=dev), dev),
        "sparse_512": replay_profile(forms["graph_512"]),
        "sparse_1k": replay_profile(forms["graph_1k"]),
        "window_33_keyframes": stage_profile("SlidingWindowBA, 33 keyframes", window_33, dev),
    }
    summary["backend"] = stats
    path_launches["backend"] = launches
    log(f"[total] {time.perf_counter() - T_START:.1f} s: back-end")


# -- slice H: multi-device on torch.distributed ---------------------------------

PARALLEL_WORLD = 2  # the world of two: two processes on the one card, over gloo
PARALLEL_ALIGNS = ("gicp", "vgicp_raw", "vgicp_hash", "ndt_d2d", "ndt_p2d")
PARALLEL_TIMED = 2  # timed registrations of each align and each form, after a warm-up
PARALLEL_ALIGN_TOL = 1e-4  # world 2 against the single call's pose: tests/test_sharded.py
# m, frame by frame over the drive's first PARALLEL_HELD_FRAMES frames, against
# ScanToMapOdometry: world 1 at ODOMETRY_CARD_CPU_TOL's scan_to_map limit (card
# against CPU run), world 2 at tests/test_scan_to_map.py:107-131's (4 frames there); over
# the whole drive both are held by its ATE bound, and the gap is reported beside
# the single odometry's own between two runs (its maps' scatter-adds are atomic)
PARALLEL_ODOMETRY_TOL = {1: 1e-3, 2: 5e-3}
PARALLEL_HELD_FRAMES = 8
PARALLEL_GRAPH_TOL = 1e-4  # the 10-pose graph's objective, world 2 against single, relative
PARALLEL_PROFILE_FRAMES = 8  # the odometry's traced and sync-counted frames
# the 1k graph's Gauss-Newton iterations here: its end drift is under 1e-4x
# of the drift after 3 (CPU; the JAX test's cap of 15 takes 4-6 s a solve on
# the card and 11-16 s at world 2), and a whole solve traces ~25,000 device ops
PARALLEL_GRAPH_ITERATIONS = 3
# the iterations of its traced run (~17,000 device ops an iteration; the
# profiler's processing of a 3-iteration trace took seconds at each world)
PARALLEL_TRACED_GRAPH_ITERATIONS = 1
PARALLEL_TIMEOUT = 900  # s, the world of two
# the kernels each parallel path must launch (the trial: the standalone
# lm_trial and the trial-off error launch, never the fused trial launch)
PARALLEL_KERNELS = {
    "gicp": ("nn_search", "linearize", "lm_trial", "error"),
    "vgicp_raw": ("linearize_raw", "lm_trial", "error"),
    "vgicp_hash": ("linearize", "lm_trial", "error"),
    "ndt_d2d": ("ndt_d2d", "lm_trial", "ndt_error"),
    "ndt_p2d": ("ndt_p2d", "lm_trial", "ndt_error"),
    "pose_graph_1k": ("block_tridiag_factor", "block_tridiag_apply"),
    "odometry": ("rbf_moments", "linearize", "lm_trial", "error"),
}


def parallel_inputs(dev):
    """The parallel phase's inputs as numpy (the world of two gets them
    pickled): the full-size pair padded, kNN covariances from the card, the
    raw grid's dims over the target, the 1k and 10-pose graphs and the
    128-frame odometry drive."""
    from fast_gicp_tpu_torch.ops.covariance import knn_covariances
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims

    sp, sm, tp, tm = padded(synthetic_pair())
    clouds, gt, _dims = odometry_drive()
    return dict(source=sp, source_mask=sm, target=tp, target_mask=tm,
                scovs=knn_covariances(sp, sm, device=dev).cpu().numpy(),
                tcovs=knn_covariances(tp, tm, device=dev).cpu().numpy(),
                guess=np.eye(4, dtype=np.float32),
                grid_dims=tuple(int(d) for d in auto_grid_dims(tp[tm], 1.0)),
                graph_1k=k1000_graph(), graph_10=small_graph(), drive=clouds, gt=gt)


def parallel_calls(inp, dev):
    """name -> (single(), sharded(mesh)) of each align on the pair, the
    arrays uploaded to `dev` once: GICP (its defaults), VGICP at 1 m on the
    raw grid and on the hash map, NDT D2D and P2D at 1 m on the hash map (the
    source budget of the align paths, which divides by the mesh size)."""
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, gicp_align
    from fast_gicp_tpu_torch.models.ndt import NDTConfig, ndt_align
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_align
    from fast_gicp_tpu_torch.parallel import sharded as sh

    s, sm, sc, t, tm, tc, g = (torch.as_tensor(inp[k]).to(dev) for k in (
        "source", "source_mask", "scovs", "target", "target_mask", "tcovs", "guess"))
    out = {"gicp": (lambda: gicp_align(s, sm, sc, t, tm, tc, g, GICPConfig(), device=dev),
                    lambda mesh: sh.gicp_align_sharded(mesh, s, sm, sc, t, tm, tc, g))}
    for name, dims in (("vgicp_raw", inp["grid_dims"]), ("vgicp_hash", None)):
        cfg = VGICPConfig(resolution=1.0, grid_dims=dims)
        out[name] = (lambda cfg=cfg: vgicp_align(s, sm, sc, t, tm, tc, g, cfg, device=dev),
                     lambda mesh, cfg=cfg: sh.vgicp_align_sharded(mesh, s, sm, sc, t, tm, tc, g,
                                                                  cfg))
    for mode in ("d2d", "p2d"):
        cfg = NDTConfig(resolution=1.0, distance_mode=mode,
                        max_source_voxels=NDT_ALIGN_SOURCE_VOXELS)
        out[f"ndt_{mode}"] = (lambda cfg=cfg: ndt_align(s, sm, t, tm, g, cfg, device=dev),
                              lambda mesh, cfg=cfg: sh.ndt_align_sharded(mesh, s, sm, t, tm, g,
                                                                         cfg))
    return out


def same_result(a, b):
    """Two NamedTuple results (LsqResult, PoseGraphResult) bit-equal."""
    return all(bool(torch.equal(getattr(a, f), getattr(b, f))) for f in a._fields)


def parallel_measure(dev, label, run, n_timed, rank=0, trace=True):
    """`run()` timed `n_timed` times after the caller's warm-up (host clock
    closed by a synchronize), then one counted run (timed too): launches,
    the collectives and their bytes, the flag reads and every host sync
    (torch's sync debug mode), then, with `trace`, a traced run (device
    busy and idle share) of `run`, or of `trace` where it is a callable.
    Only rank 0 traces; the other ranks run the call untraced beside it, so
    that every rank makes the same collectives."""
    from fast_gicp_tpu_torch.parallel import mesh as pmesh
    from fast_gicp_tpu_torch.solver import lsq_solve

    walls = [timed(dev, run)[1] for _ in range(n_timed)]
    reset_counters()
    pmesh.reset_stats()
    lsq_solve.host_syncs = 0
    counted = []
    syncs, sites = count_host_syncs(lambda: counted.append(timed(dev, run)))
    (result, wall), = counted
    walls.append(wall)
    launches, coll, flags = read_counters(), dict(pmesh.stats), lsq_solve.host_syncs
    traced = run if trace is True else trace
    if not trace:
        prof = dict(idle_share=None, device_busy_ms=None, device_ops=None)
    elif rank == 0:
        prof = stage_profile(label, traced, dev, tag="parallel")
    else:
        traced()
        prof = dict(idle_share=None, device_busy_ms=0.0, device_ops=0)
    stats = dict(wall_ms=[1e3 * w for w in walls], wall_ms_min=1e3 * min(walls),
                 launches={k: v for k, v in launches.items() if v},
                 collectives=coll["collectives"], collective_bytes=coll["bytes"],
                 by_kind={k: coll[k] for k in ("all_reduce", "all_gather", "all_to_all")},
                 flag_reads=flags, host_syncs=syncs, host_sync_sites=sites,
                 idle_share=prof["idle_share"], device_busy_ms=prof["device_busy_ms"],
                 device_ops=prof["device_ops"])
    log(f"[parallel] {label}: {stats['wall_ms_min']:.3f} ms (min of {len(walls)}), "
        f"{stats['collectives']:.1f} collectives of {stats['collective_bytes']:.0f} B, "
        f"{stats['host_syncs']:.1f} host syncs "
        f"({stats['flag_reads']:.1f} flag reads), idle share {stats['idle_share']}; "
        f"launches {stats['launches']}")
    return result, launches, coll, stats


def check_collectives(label, coll, launches):
    """The aligns' collectives: one all-reduce of 43 floats a linearization
    and one of a float a trial (a trial is one standalone lm_trial launch)."""
    trials = launches["lm_trial"]
    lins = coll["collectives"] - trials
    require(coll["all_reduce"] == coll["collectives"] and lins > 0
            and coll["bytes"] == 172 * lins + 4 * trials,
            f"{label}: collectives {coll} for {trials} trials")


def parallel_world(dev, mesh, inp, with_single=False):
    """Every parallel path on `mesh`, each after a warm-up: the five aligns
    on the full-size pair, the edge-sharded 1k solve (3 Gauss-Newton
    iterations) and the 10-pose one, and ShardedScanToMapOdometry over the
    128-frame drive (chunks of 32, the default config) with its first
    frame's voxel count; `with_single` (the world of one) adds each
    single-device call beside it and the bit-for-bit checks.  Returns ({path: stats, results as numpy},
    {path: launches of the path's counted run})."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry
    from fast_gicp_tpu_torch.parallel import mesh as pmesh
    from fast_gicp_tpu_torch.parallel.sharded_map import (
        ShardedScanToMapOdometry, _owner_hash_np,
    )

    out, path_launches = {}, {}
    world = f"world {mesh.size}"
    if mesh.rank == 0:  # the profiler's first trace takes seconds to start
        stage_profile("profiler warm-up", lambda: torch.ones(1, device=dev) + 1, dev,
                      tag="parallel")
    for name, (single, sharded) in parallel_calls(inp, dev).items():
        sharded(mesh)  # warm-up
        res, launches, coll, stats = parallel_measure(dev, f"{name}, {world}",
                                                      lambda: sharded(mesh), PARALLEL_TIMED,
                                                      rank=mesh.rank)
        require(all(launches[k] > 0 for k in PARALLEL_KERNELS[name]) and launches["lm_step"] == 0,
                f"{name}, {world}: a kernel of the path was not launched, or a fused trial "
                f"launch: {launches}")
        check_collectives(f"{name}, {world}", coll, launches)
        # the maps' scatter-adds are atomic: with deterministic ones every
        # call builds the same map, and only the split's sums part the results
        det = _deterministic(lambda: sharded(mesh))
        stats.update(T=res.transformation.cpu().numpy(), converged=bool(res.converged),
                     iterations=int(res.iterations), error=float(res.error),
                     T_deterministic=det.transformation.cpu().numpy(),
                     converged_deterministic=bool(det.converged))
        if with_single:
            single()
            want, _l, _c, stats["single"] = parallel_measure(dev, f"{name}, single device",
                                                             single, PARALLEL_TIMED)
            want_det = _deterministic(single)
            require(same_result(det, want_det), f"{name}: the sharded align on a mesh of one "
                    "is not bit-equal to the single-device call (deterministic scatter-adds)")
            # the single call against itself with atomic scatter-adds: the
            # noise that the deterministic comparison takes out
            again = single().transformation
            stats.update(bit_equal_to_single=True,
                         single_repeat_gap_atomic=float(
                             (again - want.transformation).abs().max()),
                         single_T=want.transformation.cpu().numpy(),
                         single_T_deterministic=want_det.transformation.cpu().numpy())
        out[name], path_launches[f"parallel_{name}"] = stats, launches
        log(f"[total] {time.perf_counter() - T_START:.1f} s: parallel {name}, {world}")

    # the pose graph: the 1k graph at PARALLEL_GRAPH_ITERATIONS, the 10-pose one
    g1k, g10 = inp["graph_1k"], inp["graph_10"]
    cfg1k = pgs.SparsePGConfig(max_iterations=PARALLEL_GRAPH_ITERATIONS)
    cfg20 = pgs.SparsePGConfig(max_iterations=20)

    def solve_1k(config=cfg1k):
        return pgs.optimize_pose_graph_sparse_sharded(mesh, *g1k[:5], config=config)

    res, launches, coll, stats = parallel_measure(
        dev, f"sparse solve, 1k graph, {world} (traced: "
        f"{PARALLEL_TRACED_GRAPH_ITERATIONS} iteration)", solve_1k, 0, rank=mesh.rank,
        trace=lambda: solve_1k(pgs.SparsePGConfig(
            max_iterations=PARALLEL_TRACED_GRAPH_ITERATIONS)))
    drift0 = float(np.linalg.norm(g1k[0][-1, :3, 3] - g1k[5][-1][:3, 3]))
    drift1 = float(np.linalg.norm(res.poses[-1, :3, 3].cpu().numpy() - g1k[5][-1][:3, 3]))
    stats.update(poses=res.poses.cpu().numpy(), error=float(res.error),
                 iterations=int(res.iterations), end_drift_before_m=drift0,
                 end_drift_after_m=drift1, trials=launches["block_tridiag_factor"])
    require(all(launches[k] > 0 for k in PARALLEL_KERNELS["pose_graph_1k"])
            and coll["all_reduce"] == coll["collectives"] > 0,
            f"1k graph, {world}: launches {launches}, collectives {coll}")
    require(drift1 < K1000_DRIFT_SHARE * drift0,
            f"1k graph, {world}: end drift {drift1} m, not under {K1000_DRIFT_SHARE} x {drift0}")
    path_launches["parallel_pose_graph_1k"] = launches
    r10 = pgs.optimize_pose_graph_sparse_sharded(mesh, *g10, config=cfg20)
    stats["graph_10"] = dict(poses=r10.poses.cpu().numpy(), error=float(r10.error),
                             iterations=int(r10.iterations))
    if with_single:
        def single_1k():
            return pgs.optimize_pose_graph_sparse(*g1k[:5], config=cfg1k, device=dev)

        # traced in the back-end phase (the 1k graph's replay)
        want, _l, _c, stats["single"] = parallel_measure(
            dev, "sparse solve, 1k graph, single device", single_1k, 0, trace=False)
        stats["single"].update(error=float(want.error),
                               end_drift_after_m=float(np.linalg.norm(
                                   want.poses[-1, :3, 3].cpu().numpy() - g1k[5][-1][:3, 3])))
        # with deterministic scatter-adds the two solves give the same bits
        a = _deterministic(single_1k)
        b = _deterministic(solve_1k)
        c10 = pgs.optimize_pose_graph_sparse(*g10, config=cfg20, device=dev)
        stats["graph_10"]["single_error"] = float(c10.error)
        require(same_result(a, b), "1k graph: the edge-sharded solve on a mesh of one is not "
                "bit-equal to the single-device solve (deterministic scatter-adds)")
        stats["bit_equal_to_single_deterministic"] = True
        log(f"[parallel] 1k graph: world 1 bit-equal to the single solve with deterministic "
            f"scatter-adds; without them objectives {float(res.error):.6g} (sharded) and "
            f"{float(want.error):.6g} (single), end drift {drift1:.4g} and "
            f"{stats['single']['end_drift_after_m']:.4g} m")
    out["pose_graph_1k"] = stats
    log(f"[total] {time.perf_counter() - T_START:.1f} s: parallel pose graph, {world}")

    # the sharded odometry over the drive, in the map mode's chunks of 32
    clouds, n = inp["drive"], len(inp["drive"])

    config = ScanToMapConfig()

    def odometry(frames):
        odo = ShardedScanToMapOdometry(config, mesh=mesh)
        for lo in range(0, frames, ODOMETRY_CHUNK):
            odo.process_chunk(clouds[lo:min(lo + ODOMETRY_CHUNK, frames)])
        return odo

    # the first frame's voxels: the config's cap on new voxels a frame is the
    # whole map's, however many shards hold it
    first = odometry(1)
    first_voxels = int(mesh.reduce(first.state.shard.num_voxels.to(torch.int64).reshape(1)))
    # warm-up, then a later chunk counted and traced
    warm = odometry(WARMUP_FRAMES)
    chunk = clouds[WARMUP_FRAMES:WARMUP_FRAMES + PARALLEL_PROFILE_FRAMES]
    syncs, sites = count_host_syncs(lambda: warm.process_chunk(chunk))
    later = clouds[WARMUP_FRAMES + PARALLEL_PROFILE_FRAMES:
                   WARMUP_FRAMES + 2 * PARALLEL_PROFILE_FRAMES]
    if mesh.rank == 0:
        prof = stage_profile(f"ShardedScanToMapOdometry, {PARALLEL_PROFILE_FRAMES} frames, "
                             f"{world}", lambda: warm.process_chunk(later), dev, tag="parallel")
    else:  # only rank 0 traces
        warm.process_chunk(later)
        prof = dict(idle_share=None, device_ops=0)
    reset_counters()
    pmesh.reset_stats()
    odo, wall = timed(dev, lambda: odometry(n))
    launches, coll = read_counters(), dict(pmesh.stats)
    poses = np.stack(odo.poses)
    shard = odo.state.shard
    nv = int(shard.num_voxels)
    owners_ok = bool((_owner_hash_np(shard.coords[:nv].cpu().numpy(), mesh.size)
                      == mesh.rank).all())
    require(owners_ok, f"odometry, {world}: a voxel of rank {mesh.rank}'s shard is another "
            "rank's")
    require(all(launches[k] > 0 for k in PARALLEL_KERNELS["odometry"]) and launches["lm_step"] == 0,
            f"odometry, {world}: launches {launches}")
    path_launches["parallel_odometry"] = launches
    out["odometry"] = dict(poses=poses, frames=n, wall_s=wall, frames_per_s=n / wall,
                           wall_ms=1e3 * wall / n, collectives=coll["collectives"] / n,
                           collective_bytes=coll["bytes"] / n,
                           by_kind={k: coll[k] / n for k in ("all_reduce", "all_gather",
                                                             "all_to_all")},
                           launches={k: v for k, v in launches.items() if v},
                           host_syncs=syncs / PARALLEL_PROFILE_FRAMES, host_sync_sites=sites,
                           idle_share=prof["idle_share"],
                           device_ops=prof["device_ops"] / PARALLEL_PROFILE_FRAMES,
                           shard_voxels=nv, shard_capacity=shard.sums.shape[0],
                           owners_checked=nv, first_frame_voxels=first_voxels)
    log(f"[parallel] ShardedScanToMapOdometry, {world}: {n} frames in {wall:.2f} s "
        f"({n / wall:.2f} frames/s), {out['odometry']['collectives']:.1f} collectives of "
        f"{out['odometry']['collective_bytes']:.0f} B a frame, "
        f"{syncs / PARALLEL_PROFILE_FRAMES:.1f} host syncs a frame, idle "
        f"share {prof['idle_share']}; rank {mesh.rank}'s shard {nv} voxels, every one its own; "
        f"{first_voxels} voxels after the first frame")
    if with_single:
        def single_odometry(frames):
            s = ScanToMapOdometry(config, device=dev, device_loop=False)
            for lo in range(0, frames, ODOMETRY_CHUNK):
                s.process_chunk(clouds[lo:min(lo + ODOMETRY_CHUNK, frames)])
            return s

        single_odometry(WARMUP_FRAMES)
        s, swall = timed(dev, lambda: single_odometry(n))
        again = np.stack(single_odometry(n).poses)
        out["odometry"]["single"] = dict(first_frame_voxels=int(single_odometry(1).state.num_voxels),
                                         cap=config.new_per_frame_capacity,
                                         poses=np.stack(s.poses), wall_s=swall,
                                         frames_per_s=n / swall, repeat_gap_m=float(
                                             np.abs(again[:, :3, 3]
                                                    - np.stack(s.poses)[:, :3, 3]).max()))
    return out, path_launches


def parallel_kernel_args(dev, mesh, inp):
    """The arguments, on the host, of the first launch of each kernel on the
    parallel paths at this rank's inputs (every rank calls it: each capture
    ends every rank's run at the same call): nn_search and linearize (GICP),
    linearize_raw and linearize (VGICP), the NDT pack forms, the first trial
    (its TrialCost: the trial-off error's inputs), the first PCG's
    block_tridiag inputs, and the odometry's rbf_moments (the query block
    against the gathered cloud) and linearize (the routed queries)."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_ndt, cuda_solver
    from fast_gicp_tpu_torch.parallel.sharded_map import ShardedScanToMapOdometry

    calls = parallel_calls(inp, dev)

    def run(name):
        return lambda: calls[name][1](mesh)

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if isinstance(a, cuda_solver.TrialCost):
            return a._replace(p=a.p.cpu())
        return a

    def trial(name):
        (state, H, b, y0, aux, cost, first, config), _kw = first_call(run(name), cuda_solver,
                                                                      "lm_step_plain")
        return tuple(host(a) for a in (y0, H, b, aux, cost.cost)) + (aux.shape[1] // cost.cost.offsets,)

    out = {"nn_search": first_call(run("gicp"), cuda_kernels, "nn_search")[0],
           "linearize": first_call(run("gicp"), cuda_linearize, "linearize")[0],
           "linearize_hash": first_call(run("vgicp_hash"), cuda_linearize, "linearize")[0],
           "linearize_raw": first_call(run("vgicp_raw"), cuda_linearize, "linearize_raw")[0],
           "ndt_d2d": first_call(run("ndt_d2d"), cuda_ndt, "ndt_linearize")[0],
           "ndt_p2d": first_call(run("ndt_p2d"), cuda_ndt, "ndt_linearize")[0],
           "trial_gicp": trial("gicp"), "trial_ndt_d2d": trial("ndt_d2d")}
    g1k = inp["graph_1k"][:5]
    solve = lambda: pgs.optimize_pose_graph_sparse_sharded(  # noqa: E731
        mesh, *g1k, config=pgs.SparsePGConfig(max_iterations=PARALLEL_GRAPH_ITERATIONS))
    out["block_tridiag"] = first_pcg_inputs(solve)

    def odometry():
        odo = ShardedScanToMapOdometry(ScanToMapConfig(), mesh=mesh)
        odo.process_chunk(inp["drive"][:2])

    out["rbf_moments"] = first_call(odometry, cuda_kernels, "rbf_moments")[0]
    out["linearize_odometry"] = first_call(odometry, cuda_linearize, "linearize")[0]
    return {k: tuple(host(a) for a in v) for k, v in out.items()}


def parallel_kernel_checks(dev, records, args, world):
    """Each kernel of the parallel paths against its plain version at the
    arguments rank 0 of the world of `world` gave it (`parallel_kernel_args`),
    timed, added to the kernels' records under "parallel"."""
    from fast_gicp_tpu_torch.ops import cuda_ndt

    by_name = {r["name"]: r for r in records}
    on = {k: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in v)
          for k, v in args.items() if k not in ("trial_gicp", "trial_ndt_d2d")}
    tag = f"rank 0 of {world}"
    by_name["nn_search"]["parallel"] = nn_record(f"(GICP, {tag})", *on["nn_search"])
    for key, name, raw, tol in (("linearize", "linearize", False, "rel_max"),
                                ("linearize_hash", "linearize", False, "rel_max"),
                                ("linearize_odometry", "linearize", False, "rel_max"),
                                ("linearize_raw", "linearize_raw", True, "elementwise")):
        by_name[name].setdefault("parallel", {})[key] = odometry_lin_record(
            f"{name} ({key}, {tag})", raw, on[key], tol)
    for mode in ("d2d", "p2d"):
        P, CA, x, pack, res, m = on[f"ndt_{mode}"]
        require(m == mode, f"the sharded NDT {mode} align linearizes in mode {m}")
        by_name[f"ndt_{mode}"]["parallel"] = ndt_pack_record(f"ndt_{mode} ({tag})", P, CA, x,
                                                             pack, res, mode)
    by_name["rbf_moments"]["parallel"] = rbf_record(f"(odometry frame 0, {tag})",
                                                    on["rbf_moments"])
    D, U, r = on["block_tridiag"]
    err = tridiag_check(f"at the first PCG of the 1k graph, {tag}", D, U, r)
    for name in ("block_tridiag_factor", "block_tridiag_apply"):
        by_name[name]["parallel"] = dict(K=D.shape[0], x_err_of_max=err[0],
                                         factor_err_of_max=err[1])
    trials = {}
    for key in ("trial_gicp", "trial_ndt_d2d"):
        y0, H, b, aux, cost, n_src = args[key]
        trials[f"parallel_{key[6:]}"] = (y0.to(dev), H.to(dev), b.to(dev), aux.to(dev),
                                         cost._replace(p=cost.p.to(dev)), n_src)
    recs, points, hits, _err = trial_sweeps(dev, trials)
    by_name["lm_step"]["by_path"].update(recs)
    return dict(trial_points=points, trial_hits=hits)


def parallel_rank(rank, world, inp):
    """One rank of the world of two, on the card (gloo on its CUDA tensors:
    NCCL refuses two ranks on one device): every parallel path, and at rank
    0 the kernels' arguments at its inputs."""
    from fast_gicp_tpu_torch.parallel import sharded

    LOG_PREFIX[:] = [f"[rank {rank}]"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = sharded.make_mesh(device=dev, backend="gloo")
    require(mesh.backend == "gloo" and mesh.size == world and mesh.device == dev,
            f"the world of two's mesh: {mesh}")
    out, launches = parallel_world(dev, mesh, inp)
    out["launches"] = launches
    kernel_args = parallel_kernel_args(dev, mesh, inp)
    if rank == 0:
        out["kernel_args"] = kernel_args
    return out


def run_world_two(inp, dev):
    """The world of two, spawned from this process (its kernels already
    built, so no child builds): every rank's results; a rank that fails, or
    a world that outlives PARALLEL_TIMEOUT, fails the phase."""
    from fast_gicp_tpu_torch.parallel.distributed import spawn_world

    return spawn_world(parallel_rank, PARALLEL_WORLD, inp, timeout=PARALLEL_TIMEOUT, device=dev,
                       backend="gloo")


def parallel_compare(one, two):
    """The world of two against the single-device calls and across its
    ranks: each align's pose within PARALLEL_ALIGN_TOL of the single call's
    and converged equal, both with deterministic scatter-adds; the 10-pose graph's objective within
    PARALLEL_GRAPH_TOL; the odometry's poses within PARALLEL_ODOMETRY_TOL
    over the drive's first frames and its ATE under the scan-to-map bound;
    every rank's result bit-equal to rank 0's."""
    from fast_gicp_tpu_torch.utils.kitti import ate_rmse

    out = {}
    r0 = two[0]
    for other in two[1:]:
        for name in PARALLEL_ALIGNS:
            require(np.array_equal(other[name]["T"], r0[name]["T"]),
                    f"{name}: the ranks of the world of two part")
        require(np.array_equal(other["odometry"]["poses"], r0["odometry"]["poses"])
                and np.array_equal(other["pose_graph_1k"]["poses"], r0["pose_graph_1k"]["poses"]),
                "the ranks of the world of two part (odometry or pose graph)")
    for name in PARALLEL_ALIGNS:
        # deterministic scatter-adds on both sides: the same maps, so the
        # gap is the split's order of sums (without them, the maps' atomics
        # part two runs of one call too)
        gap = float(np.abs(r0[name]["T_deterministic"]
                           - one[name]["single_T_deterministic"]).max())
        conv = (r0[name]["converged_deterministic"], one[name]["converged_deterministic"])
        require(gap <= PARALLEL_ALIGN_TOL and conv[0] == conv[1],
                f"{name}: world 2 {gap} from the single call (bound {PARALLEL_ALIGN_TOL}), "
                f"converged {conv}")
        out[name] = dict(max_abs_pose_diff=gap,
                         max_abs_pose_diff_atomic=float(np.abs(r0[name]["T"]
                                                               - one[name]["single_T"]).max()),
                         single_repeat_gap_atomic=one[name]["single_repeat_gap_atomic"],
                         iterations=(r0[name]["iterations"], one[name]["iterations"]))
    g = r0["pose_graph_1k"]["graph_10"]
    want = one["pose_graph_1k"]["graph_10"]["single_error"]
    rel = abs(g["error"] - want) / abs(want)
    require(rel <= PARALLEL_GRAPH_TOL, f"10-pose graph: world 2's objective {g['error']} is "
            f"{rel} from the single solve's {want}")
    out["graph_10"] = dict(objective_rel_diff=rel)
    out["graph_1k"] = dict(error=r0["pose_graph_1k"]["error"],
                           single_error=one["pose_graph_1k"]["single"]["error"],
                           end_drift_after_m=r0["pose_graph_1k"]["end_drift_after_m"])
    gt, single = one["odometry"]["gt"], one["odometry"]["single"]
    # the first frame's new voxels: the config's cap binds there, and the
    # shards of either world admit the single map's count
    firsts = (single["first_frame_voxels"], one["odometry"]["first_frame_voxels"],
              r0["odometry"]["first_frame_voxels"])
    log(f"[parallel] odometry: {firsts[0]} voxels after the first frame on one device (cap "
        f"{single['cap']}), {firsts[1]} at world 1, {firsts[2]} at world 2")
    require(firsts[0] == single["cap"] and firsts[1] == firsts[2] == firsts[0],
            f"odometry: first-frame voxels {firsts}, cap {single['cap']}")
    out["odometry_first_frame_voxels"] = dict(zip(("single", "world1", "world2"), firsts))
    for world, run in ((1, one["odometry"]), (2, r0["odometry"])):
        gaps = np.abs(run["poses"][:, :3, 3] - single["poses"][:, :3, 3]).max(axis=1)
        held = float(gaps[:PARALLEL_HELD_FRAMES].max())
        ate = ate_rmse(gt[:len(run["poses"])], list(run["poses"]))
        log(f"[parallel] odometry, world {world}: the first {PARALLEL_HELD_FRAMES} frames "
            f"within {held:.3e} m of ScanToMapOdometry (bound {PARALLEL_ODOMETRY_TOL[world]}), "
            f"all {len(gaps)} within {float(gaps.max()):.3e} m (the single odometry's own "
            f"repeat: {single['repeat_gap_m']:.3e} m); ATE {ate:.4f} m (bound "
            f"{SCAN_TO_MAP_ATE})")
        require(held <= PARALLEL_ODOMETRY_TOL[world] and ate < SCAN_TO_MAP_ATE,
                f"odometry, world {world}: {held} m from the single odometry over the first "
                f"{PARALLEL_HELD_FRAMES} frames, ATE {ate} m")
        out[f"odometry_world{world}"] = dict(
            held_frames_max_abs_diff_m=held, max_abs_diff_m=float(gaps.max()),
            single_repeat_gap_m=single["repeat_gap_m"], ate_m=ate,
            single_ate_m=ate_rmse(gt, list(single["poses"])))
    log(f"[parallel] world 2 against the single-device calls: {out}")
    return out


def parallel_table(one, two):
    """The summary's table: each path's wall, collectives, bytes, host
    syncs and idle share at world 1, world 2 (rank 0) and on one device."""
    rows = {}
    for name in PARALLEL_ALIGNS + ("pose_graph_1k", "odometry"):
        rows[name] = {}
        for label, st in (("world1", one[name]), ("world2", two[0][name]),
                          ("single", one[name].get("single"))):
            if st is None:
                continue
            rows[name][label] = {k: st[k] for k in (
                "wall_ms_min", "wall_ms", "frames_per_s", "collectives", "collective_bytes",
                "host_syncs", "flag_reads", "idle_share", "device_ops")
                if k in st}
    return rows


def phase_parallel(dev, records, path_launches, summary):
    """Slice H on the card.  The world of one: this process alone in an NCCL
    group; each sharded align bit-equal to its single call, the edge-sharded
    1k solve bit-equal to the single solve with deterministic scatter-adds,
    the sharded odometry against ScanToMapOdometry; each path counted with
    every launch counter at 0 just before it.  Then the world of two: two
    spawned processes on the one card over gloo (`parallel_rank`), held to
    the single-device calls, and every kernel of the slice's paths against
    its plain version at rank 0's inputs.  Two ranks on one card share its
    SMs: the world of two measures the collectives' cost and the split's
    correctness, not scaling."""
    import torch.distributed as dist

    from fast_gicp_tpu_torch.parallel import distributed, sharded

    t0 = time.perf_counter()
    inp = parallel_inputs(dev)
    log(f"[parallel] inputs: pair {inp['source'].shape[0]} padded points, raw grid "
        f"{inp['grid_dims']}, drive {len(inp['drive'])} frames "
        f"({time.perf_counter() - t0:.1f} s)")
    distributed.initialize(device=dev)
    try:
        mesh = sharded.make_mesh(device=dev)
        require(mesh.backend == ("nccl" if dev.type == "cuda" else "gloo") and mesh.size == 1
                and mesh.device == dev,
                f"the world of one: {mesh}")
        one, launches = parallel_world(dev, mesh, inp, with_single=True)
    finally:
        dist.destroy_process_group()
    one["odometry"]["gt"] = inp["gt"]
    path_launches.update(launches)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: parallel, world of one")
    two = run_world_two(inp, dev)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: parallel, world of two")
    checks = parallel_kernel_checks(dev, records, two[0].pop("kernel_args"), PARALLEL_WORLD)
    compare = parallel_compare(one, two)
    summary["parallel"] = dict(
        table=parallel_table(one, two), world2_against_single=compare, kernel_checks=checks,
        world2_launches_rank0=two[0]["launches"],
        pose_graph_1k_world1=dict(error=one["pose_graph_1k"]["error"],
                                  end_drift_after_m=one["pose_graph_1k"]["end_drift_after_m"]))
    log(f"[total] {time.perf_counter() - T_START:.1f} s: parallel")


# -- the device-resident LM loop: the apps/align.py twin, its device-loop rows
# and the one-program odometry forms -------------------------------------------

ALIGN_CLASS_N = 10  # the twin's --n for its class rows
DEVICE_LOOP_N = 20  # trips a device-loop row
DEVICE_LOOP_REPS = 2  # timed runs of a row (the root app's timed() takes 5)
# apps/align.py's 2,048 NDT source voxels overflow the synthetic pair
# (6,660 occupied at 1 m): the rows here take 8,192, as the align paths do
DEVICE_LOOP_SOURCE_VOXELS = 8192
DEVICE_LOOP_METHODS = ("fgicp", "vgicp", "vgicp_rbf", "ndt_d2d", "ndt_p2d")
# the condition kernel: it reads the state's flags and counters (5 floats),
# H (36) and y0 and writes 3 state floats, H_out (36), y, converged (1 byte),
# iterations and the flag; a few compares and adds
LOOP_COND_BYTES = (5 + 36 + 1 + 3 + 36 + 1 + 1 + 1) * 4 + 1
LOOP_COND_OPS = 8
# the kernels a trip of each row launches outside its loops (profiler names;
# the reuse rows rotate precomputed covariances), besides those the loops
# launch: a linearization an outer iteration, the trial launch and the
# condition kernel, which `cuda_solver.loop_counts` tallies on the device (a
# profiler does not see every kernel of a conditional body)
DEVICE_LOOP_KERNELS = {
    ("fgicp", "fresh"): ("knn_moments",),
    ("fgicp_adaptive", "fresh"): ("radius_count", "radius_window"),
    ("vgicp", "fresh"): ("knn_moments",),
    ("vgicp_adaptive", "fresh"): ("radius_count", "radius_window"),
    ("vgicp_rbf", "fresh"): ("rbf_moments",),
}


def card_line():
    """The card's name and power limit as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_align_twin(dev, pair, card):
    """The `apps/align.py` twin's class rows (single, Nx, Nx reuse, fitness)
    at --n 10 on the full-size pair, written as PCD files and loaded by the
    app as a user runs it; its JSON keys are the root app's."""
    import tempfile

    from fast_gicp_tpu_torch.apps import align as app
    from fast_gicp_tpu_torch.utils.io import save_pcd

    source, target, _gt = pair
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="align_twin_"))
    save_pcd(str(tmp / "target.pcd"), target)
    save_pcd(str(tmp / "source.pcd"), source)
    t0 = time.perf_counter()
    rc = app.main([str(tmp / "target.pcd"), str(tmp / "source.pcd"), "--n", str(ALIGN_CLASS_N),
                   "--exact-downsample", "--json", str(tmp / "rows.json")])
    wall = time.perf_counter() - t0
    table = json.loads((tmp / "rows.json").read_text())
    require(rc == 0 and set(table) == {"n", "pipelined", "downsample", "n_target", "n_source",
                                       "methods"}
            and set(table["methods"]) == set(DEVICE_LOOP_METHODS)
            and all(math.isfinite(r["fitness"]) for r in table["methods"].values()),
            f"the align twin's class rows: rc {rc}, {table}")
    for name, r in table["methods"].items():
        log(f"[align] {name}: single {r['single_ms']} ms, {ALIGN_CLASS_N}x {r[f'{ALIGN_CLASS_N}x_ms']}"
            f" ms, {ALIGN_CLASS_N}x reuse {r[f'{ALIGN_CLASS_N}x_reuse_ms']} ms, fitness "
            f"{r['fitness']} ({card})")
    log(f"[align] the twin's class rows in {wall:.1f} s")
    return dict(table, wall_s=wall, card=card)


def loop_cond_sweep(dev):
    """The condition kernel against its plain version on every mode, both
    optimizers, done/conv flags and trial counters about the caps, each from
    a seeded state: every output bit for bit.  Returns the cases run."""
    from fast_gicp_tpu_torch.ops import cuda_solver as cs
    from fast_gicp_tpu_torch.solver import LsqConfig

    rng = np.random.default_rng(17)
    cases = 0
    for opt in ("lm", "gn"):
        cfg = LsqConfig(optimizer=opt, max_iterations=5, lm_max_iterations=3)
        for mode in (cs.LOOP_OUTER_ENTER, cs.LOOP_FIRST_TRIAL, cs.LOOP_AFTER_TRIAL,
                     cs.LOOP_AFTER_INNER):
            for done, conv, count in [(d, c, k) for d in (0.0, 1.0) for c in (0.0, 1.0)
                                      for k in (0.0, 1.0, 2.0, 4.0)]:
                state = torch.as_tensor(rng.standard_normal(cs.STATE_FLOATS).astype(np.float32))
                state[cs.STATE_DONE], state[cs.STATE_CONV] = done, conv
                state[cs.STATE_TRIAL] = state[cs.STATE_ITERATION] = count
                state[cs.STATE_TRIALS_RUN] = 3.0 * count
                H = torch.as_tensor(rng.standard_normal((6, 6)).astype(np.float32))
                y0 = torch.as_tensor(np.float32(rng.standard_normal()))
                init = [torch.as_tensor(rng.standard_normal(t.shape)).to(t.dtype)
                        for t in cs.loop_out(torch.device("cpu"))]
                outs = []
                for d in (dev, torch.device("cpu")):
                    st = state.clone().to(d)
                    out = cs.LoopOut(*[t.clone().to(d) for t in init])
                    if d.type == "cuda":
                        cs.loop_cond(st, out, mode, cfg, H.to(d), y0.to(d))
                    else:
                        cs.loop_cond_plain(st, out, mode, cfg, H, y0)
                    outs.append([st.cpu(), *[t.cpu() for t in out]])
                require(all(torch.equal(a, b) for a, b in zip(*outs)),
                        f"loop_cond mode {mode} ({opt}, done {done}, conv {conv}, count {count}) "
                    "differs from its plain version")
                cases += 1
    return cases


def loop_cond_record(dev, launches):
    """The condition kernel's record: the sweep bit for bit, a launch's
    device time at a solve's state against the plain version's, the bound."""
    from fast_gicp_tpu_torch.ops import cuda_solver as cs
    from fast_gicp_tpu_torch.solver import LsqConfig

    cases = loop_cond_sweep(dev)
    cfg = LsqConfig()
    state = cs.lm_state(torch.eye(4, device=dev))
    out = cs.loop_out(dev)
    H, y0 = torch.eye(6, device=dev), torch.zeros((), device=dev)
    run = lambda: cs.loop_cond(state, out, cs.LOOP_AFTER_INNER, cfg, H, y0)  # noqa: E731
    plain = lambda: cs.loop_cond_plain(state, out, cs.LOOP_AFTER_INNER, cfg, H, y0)  # noqa: E731
    t = timings(run, plain, "loop_cond_kernel", 200, 20)
    b_ms, b_by = bound_ms(LOOP_COND_BYTES, LOOP_COND_OPS)
    log(f"[kernels] loop_cond: {cases} cases bit for bit its plain version; "
        f"{t['ms']:.5f} ms a launch, plain {t['plain_ms']:.4f} ms; bound {b_ms:.3e} ms ({b_by})")
    return dict(name="loop_cond", own_path="device_loop", route="cuda",
                source="fast_gicp_tpu_torch/csrc/device_loop.cu",
                replaces="none: the predicates of the lax.while_loops in "
                         "fast_gicp_tpu/solver.py (evaluated by XLA)",
                launches=launches, max_abs_err=0.0, tolerance=f"bit for bit on {cases} cases",
                bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=LOOP_COND_BYTES, **t)


def loop_tally(run, n, dev):
    """What the loops of `run()` (n trips) ran a trip, from the device's
    `loop_counts`: condition launches, trials (trial launches), outer
    iterations (linearizations) and solves."""
    from fast_gicp_tpu_torch.ops import cuda_solver as cs

    counts = cs.loop_counts(dev)
    torch.cuda.synchronize()
    counts.zero_()
    run()
    torch.cuda.synchronize()
    return dict(zip(cs.LOOP_COUNTS, (v / n for v in counts.tolist())))


def row_profile(run, n, kernels):
    """A torch.profiler trace of `run()` (n trips): device ops, busy ms and
    the idle share of the traced wall a trip, and the launches a trip of
    each named kernel outside the loops.  The trace misses kernels of the
    conditional bodies: its ops and busy time are lower bounds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    ops = sum(e.count for e in events) / n
    per_trip = {k: sum(e.count for e in events if k in e.key) / n for k in kernels}
    return dict(traced_device_ops_per_trip=ops, traced_device_busy_ms=busy,
                traced_wall_ms=wall, traced_idle_share=1.0 - busy / wall,
                traced_launches_per_trip=per_trip)


def span_ms(run, n):
    """The device span a trip of `run()` (n trips) from CUDA events on the
    stream: the device's own time for the trips, idle gaps inside included."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device_loop_rows(dev, pair, card):
    """The twin's 14 --device-loop rows (7 bodies, fresh and reuse) at n = 20
    with 2 timed runs, each trip one replay of the row's captured graph: ms
    an align beside the same bodies called eagerly, host syncs between a
    run's first enqueue and its read (none allowed), device ops, busy and
    idle a trip and the kernels' launches a trip; each trip's iterations
    equal to the eager call's on its jitter and its pose bit for bit, both
    with deterministic scatter-adds (a row captured again under them); with
    the default atomic ones the gap beside the eager call's own repeat gap."""
    from fast_gicp_tpu_torch import graphs
    from fast_gicp_tpu_torch.apps import align as app

    source, target, _gt = pair
    count_host_syncs(lambda: None)  # a process's first sync-debug window counts one in torch.cuda
    reset_counters()
    captures0 = graphs.DeviceGraph.captures
    rows_out = {}
    t0 = time.perf_counter()
    table = app.run_device_rows(list(DEVICE_LOOP_METHODS), source, target, DEVICE_LOOP_N,
                                device=dev, reps=DEVICE_LOOP_REPS,
                                max_source_voxels=DEVICE_LOOP_SOURCE_VOXELS, rows_out=rows_out)
    launches = read_counters()
    require(len(rows_out) == 14 and graphs.DeviceGraph.captures - captures0 == 14,
            f"device-loop rows: {len(rows_out)} rows, "
            f"{graphs.DeviceGraph.captures - captures0} captures")
    log(f"[device_loop] 14 rows run (warm-up, capture, {DEVICE_LOOP_REPS} timed runs) in "
        f"{time.perf_counter() - t0:.1f} s; launches at warm-up and capture {launches}")
    bodies = app.device_bodies(source, target, dev, DEVICE_LOOP_SOURCE_VOXELS)
    jit = next(iter(rows_out.values())).jit
    n = jit.shape[0]
    out = {}
    for (name, col), row in rows_out.items():
        body = bodies[name][0 if col == "fresh" else 1]
        label = f"{name} {col}"
        syncs, sites = count_host_syncs(row.run)
        poses, iters = (t.cpu() for t in row.run())
        t1 = time.perf_counter()
        eager = [body(jit[k]) for k in range(n)]
        e_poses = torch.stack([r.transformation for r in eager]).cpu()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t1) * 1e3 / n
        e_iters = torch.stack([r.iterations for r in eager]).cpu()
        repeat = torch.stack([body(jit[k]).transformation for k in range(n)]).cpu()
        gap = float((poses - e_poses).abs().max())
        repeat_gap = float((repeat - e_poses).abs().max())

        def deterministic():
            drow = app.DeviceRow(body, jit)
            d_poses, d_iters = (t.cpu() for t in drow.run())
            d_eager = [body(jit[k]) for k in range(n)]
            return (d_poses, d_iters, torch.stack([r.transformation for r in d_eager]).cpu(),
                    torch.stack([r.iterations for r in d_eager]).cpu())

        d_poses, d_iters, de_poses, de_iters = _deterministic(deterministic)
        kernels = DEVICE_LOOP_KERNELS.get((name, col), ())
        prof = row_profile(row.run, n, kernels)
        tally = loop_tally(row.run, n, dev)
        span = span_ms(row.run, n)
        ms = table[name][f"{col}_ms_per_align"]
        stats = dict(ms_per_align=ms, eager_ms_per_align=eager_ms, device_span_ms=span,
                     host_syncs=syncs, host_sync_sites=sites, loops_per_trip=tally,
                     iterations=iters.tolist(), eager_iterations=e_iters.tolist(),
                     gap_atomic=gap, eager_repeat_gap_atomic=repeat_gap,
                     deterministic_bit_equal=bool(torch.equal(d_poses, de_poses)),
                     deterministic_iterations_equal=bool(torch.equal(d_iters, de_iters)),
                     **prof, card=card)
        out[f"{name}_{col}"] = stats
        log(f"[device_loop] {label}: {ms} ms an align (eager calls {eager_ms:.3f}), device span "
            f"{span:.3f} ms a trip, host syncs in a run {syncs} {sites}; loops a trip {tally}; "
            f"traced: device ops {prof['traced_device_ops_per_trip']:.1f}, busy "
            f"{prof['traced_device_busy_ms']:.3f} ms, idle {100 * prof['traced_idle_share']:.1f}%"
            f" of the wall, {prof['traced_launches_per_trip']}; iterations {iters.tolist()} "
            f"(eager {e_iters.tolist()}); atomic gap {gap:.3e} (eager repeat {repeat_gap:.3e}); "
            f"deterministic: poses bit-equal {stats['deterministic_bit_equal']}, iterations "
            f"equal {stats['deterministic_iterations_equal']} ({card})")
        require(syncs == 0, f"{label}: {syncs} host syncs inside a run: {sites}")
        require(stats["deterministic_bit_equal"] and stats["deterministic_iterations_equal"],
                f"{label}: the graph's trips differ from the eager calls with deterministic "
                f"scatter-adds: iterations {d_iters.tolist()} against {de_iters.tolist()}, "
                f"max |dT| {float((d_poses - de_poses).abs().max())}")
        require(torch.isfinite(poses).all() and tally["trials"] >= tally["iterations"] > 0
                and round(tally["iterations"] * n) == int(iters.sum())
                and all(prof["traced_launches_per_trip"][k] > 0 for k in kernels),
                f"{label}: a kernel of the trip did not run, or the tally is not the trips' "
                f"iterations: {tally}, {prof['traced_launches_per_trip']}")
    return launches, out


def phase_device_loop_odometry(dev, card):
    """`run_odometry_scan` and `ScanToMapOdometry.process_chunk` in their
    one-program forms (a frame one graph replay) over the 128-frame drive,
    against their eager forms: poses bit for bit with deterministic
    scatter-adds, the atomic gap beside the eager form's own repeat gap, the
    ATE bounds, frames/s of both forms, and the host syncs of a chunk of 32
    after the capture (the fill read before and after it, as in the JAX
    package) and of a whole scan run (the warm-up's condition reads before
    the capture and the one read of the deltas)."""
    from fast_gicp_tpu_torch import graphs
    from fast_gicp_tpu_torch.utils.kitti import trajectory_report

    _clouds, gt, _dims = odometry_drive()
    out = {}
    for path in ("odometry_scan", "scan_to_map"):
        bound = None
        runs = {}
        for form in ("eager", "graph"):
            loop = form == "graph"
            odometry_run(path, dev, frames=WARMUP_FRAMES, device_loop=loop)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            poses, odo = odometry_run(path, dev, device_loop=loop)
            wall = time.perf_counter() - t0
            rep = trajectory_report(gt[:len(poses)], poses)
            # the eager form's own repeat gap (atomic scatter-adds)
            repeat = odometry_run(path, dev)[0] if form == "eager" else None
            det = _deterministic(lambda: odometry_run(path, dev, device_loop=loop)[0])
            runs[form] = dict(poses=np.asarray(poses), repeat=np.asarray(repeat),
                              det=np.asarray(det), frames_per_s=len(poses) / wall, ate=rep)
            bound = (SCAN_TO_MAP_ATE if path == "scan_to_map"
                     else SCAN_TO_SCAN_ATE_SHARE * rep["path_length_m"])
            require(rep["ate_rmse_m"] < bound, f"{path} ({form}): ATE {rep['ate_rmse_m']} m")
        g, e = runs["graph"], runs["eager"]
        stats = dict(frames_per_s=g["frames_per_s"], eager_frames_per_s=e["frames_per_s"],
                     ate_m=g["ate"]["ate_rmse_m"], eager_ate_m=e["ate"]["ate_rmse_m"],
                     ate_bound_m=bound,
                     deterministic_bit_equal=bool(np.array_equal(g["det"], e["det"])),
                     gap_atomic=float(np.abs(g["poses"] - e["poses"]).max()),
                     eager_repeat_gap_atomic=float(np.abs(e["repeat"] - e["poses"]).max()),
                     card=card)
        if path == "scan_to_map":
            syncs, sites = count_host_syncs(_graph_chunk(dev))
            stats.update(host_syncs_a_chunk=syncs, host_sync_sites=sites)
            require(syncs <= ODOMETRY_READS["scan_to_map"],
                    f"scan_to_map graph form: {syncs} host syncs in a chunk of {SYNC_FRAMES}: "
                    f"{sites}")
        else:
            reads0 = graphs.host_reads
            syncs, sites = count_host_syncs(lambda: odometry_run(path, dev, device_loop=True))
            warm_reads = graphs.host_reads - reads0
            stats.update(host_syncs_a_run=syncs, warm_up_reads=warm_reads, host_sync_sites=sites)
            require(syncs - warm_reads <= ODOMETRY_READS["odometry_scan"] + 1,
                    f"odometry_scan graph form: {syncs} host syncs, {warm_reads} of them the "
                    f"warm-up's: {sites}")
        log(f"[device_loop] {path}: graph {stats['frames_per_s']:.1f} frames/s (eager "
            f"{stats['eager_frames_per_s']:.1f}); ATE {stats['ate_m']:.4f} m (eager "
            f"{stats['eager_ate_m']:.4f}, bound {bound:.4f}); deterministic bit-equal "
            f"{stats['deterministic_bit_equal']}; atomic gap {stats['gap_atomic']:.3e} (eager "
            f"repeat {stats['eager_repeat_gap_atomic']:.3e}); host syncs "
            f"{ {k: v for k, v in stats.items() if 'sync' in k or 'warm' in k} } ({card})")
        require(stats["deterministic_bit_equal"],
                f"{path}: the graph form differs from the eager form with deterministic "
                f"scatter-adds: {float(np.abs(g['det'] - e['det']).max())}")
        out[path] = stats
    return out


def _graph_chunk(dev):
    """A chunk of 32 frames of scan_to_map's graph form after 32 mapped (the
    graph captured by then): the run whose host syncs are counted."""
    from fast_gicp_tpu_torch.models.scan_to_map import ScanToMapConfig, ScanToMapOdometry

    clouds, _gt, _dims = odometry_drive()
    odo = ScanToMapOdometry(ScanToMapConfig(), device=dev)
    odo.process_chunk(clouds[:ODOMETRY_CHUNK])
    chunk = clouds[ODOMETRY_CHUNK:ODOMETRY_CHUNK + SYNC_FRAMES]
    torch.cuda.synchronize()
    return lambda: odo.process_chunk(chunk)


def phase_device_loop(dev, records, path_launches, summary, pair=None):
    """The device-resident LM loop's phase: the condition kernel against its
    plain version, the align twin's class rows, its 14 device-loop rows and
    the one-program odometry forms.  The launch counters are set to 0 just
    before the rows and read just after: the condition kernel's launches
    (warm-ups and captures) go into its record."""
    card = card_line()
    pair = pair or synthetic_pair()
    t0 = time.perf_counter()
    summary["align_twin"] = phase_align_twin(dev, pair, card)
    path_launches["device_loop"], summary["device_loop_rows"] = phase_device_loop_rows(
        dev, pair, card)
    records.append(loop_cond_record(dev, path_launches["device_loop"]["loop_cond"]))
    summary["device_loop_odometry"] = phase_device_loop_odometry(dev, card)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: the device loop's phase "
        f"({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    global TRIDIAG_PREVIOUS_TREE
    timing = {"--ndt-timing": ndt_timing, "--trial-timing": trial_timing,
              "--lin-timing": lin_timing}
    if sys.argv[-2:-1] == ["--tridiag-previous"] and sys.argv[1:-2] in ([], ["--backend"]):
        TRIDIAG_PREVIOUS_TREE = sys.argv[-1]
        del sys.argv[-2:]
    timing_only = (len(sys.argv) == 3 and sys.argv[1] in timing
                   or len(sys.argv) == 4 and sys.argv[1] == "--lin-timing")
    odometry_only = sys.argv[1:] == ["--odometry"]
    backend_only = sys.argv[1:] == ["--backend"]
    parallel_only = sys.argv[1:] == ["--parallel"]
    align_only = sys.argv[1:] == ["--align"]
    if timing_only:  # time the kernels of the package under DIR
        sys.path.insert(0, str(pathlib.Path(sys.argv[2]).resolve()))
    elif len(sys.argv) > 1 and not (odometry_only or backend_only or parallel_only
                                    or align_only):
        print("usage: chip_smoke.py [--odometry | --backend | --parallel | --align | "
              "--ndt-timing DIR | --trial-timing DIR | --lin-timing DIR [REF]] "
              "| [--backend] --tridiag-previous DIR", file=sys.stderr)
        return 2
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (timing_only or odometry_only or backend_only or parallel_only or align_only):
        start_backend_drive()
    try:
        return run_phases(timing, timing_only, odometry_only, backend_only, parallel_only,
                          align_only)
    finally:
        stop_backend_drive()


def run_phases(timing, timing_only, odometry_only, backend_only, parallel_only=False,
               align_only=False) -> int:
    """The phases of `main`'s mode, after the device check."""
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # phase 2: build
    from fast_gicp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    if odometry_only:  # slice F's phases alone
        records = [{"name": n} for n in ("rbf_moments", "knn_moments", "linearize_raw",
                                         "linearize", "ndt_d2d")]
        records.append({"name": "lm_step", "by_path": {}})
        summary, path_launches = {}, {}
        phase_odometry(dev, records, path_launches, summary)
        summary["profiler_fallbacks"] = PROFILER_FALLBACKS
        print(json.dumps({"odometry": summary, "kernels": records,
                          "launches_by_path": path_launches}))
        return 0
    if backend_only:  # slice G's phases alone
        records = [{"name": n} for n in ("rbf_moments", "linearize_raw", "nn_search", "ndt_d2d")]
        records.append({"name": "lm_step", "by_path": {}})
        summary, path_launches = {}, {}
        phase_backend(dev, records, path_launches, summary)
        summary["profiler_fallbacks"] = PROFILER_FALLBACKS
        print(json.dumps({"backend": summary, "kernels": records,
                          "launches_by_path": path_launches}))
        return 0
    if parallel_only:  # slice H's phases alone
        records = [{"name": n} for n in ("nn_search", "linearize", "linearize_raw", "ndt_d2d",
                                         "ndt_p2d", "rbf_moments", "block_tridiag_factor",
                                         "block_tridiag_apply")]
        records.append({"name": "lm_step", "by_path": {}})
        summary, path_launches = {}, {}
        phase_parallel(dev, records, path_launches, summary)
        summary["profiler_fallbacks"] = PROFILER_FALLBACKS
        print(json.dumps({"parallel": summary, "kernels": records,
                          "launches_by_path": path_launches}))
        return 0
    if align_only:  # the device-resident LM loop's phase alone
        records = []
        summary, path_launches = {}, {}
        phase_device_loop(dev, records, path_launches, summary)
        summary["profiler_fallbacks"] = PROFILER_FALLBACKS
        print(json.dumps({"device_loop": summary, "kernels": records,
                          "launches_by_path": path_launches}))
        return 0
    pair = synthetic_pair()
    if timing_only:
        import fast_gicp_tpu_torch

        fn = timing[sys.argv[1]]
        result = fn(dev, pair)
        line = {"package": str(pathlib.Path(fast_gicp_tpu_torch.__file__).parent),
                fn.__name__: result}
        if len(sys.argv) == 4:  # --lin-timing DIR REF: the digests against REF's
            line["bit_equal_to_ref"] = compare_digests(result, sys.argv[3])
        print(json.dumps(line))
        return 0
    records = (phase_kernels(dev, pair) + phase_gicp_kernels(dev, pair)
               + phase_ndt_kernels(dev, pair) + phase_c2_kernels(dev, pair))
    log(f"[total] {time.perf_counter() - T_START:.1f} s: kernel checks")
    records.append(phase_trial(dev, pair))
    log(f"[total] {time.perf_counter() - T_START:.1f} s: trial checks")
    summary = {"map_card_vs_cpu": phase_class_kernels(dev, pair, records)}
    phase_new_path_kernels(dev, pair, records)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: kernels")
    path_launches = {}
    for path in PATHS:
        path_launches[path], main_stats = phase_main_path(dev, pair, path)
        summary[path] = {"main_path": main_stats}
    for path in CLASS_PATHS:
        path_launches[path], main_stats = phase_class_main(dev, pair, path)
        summary[path] = {"main_path": main_stats}
    for path in BATCH_PATHS:
        path_launches[path], main_stats = phase_batch_main(dev, path)
        summary[path] = {"main_path": main_stats}
    summary["ndt_budgets"] = phase_ndt_budgets(dev, pair)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: main paths")
    small = synthetic_pair(n_world=400_000, voxel=0.3)
    for path in PYGICP_PATHS:
        path_launches[path], summary[path] = phase_pygicp(dev, pair, small, path)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: pygicp")
    for path in PATHS:
        summary[path]["card_vs_cpu"] = phase_card_vs_cpu(
            dev, pair if path in NDT_PATHS else small, path)
    for path, (_make, _kernels, which) in CLASS_PATHS.items():
        summary[path]["card_vs_cpu"] = phase_class_card_vs_cpu(
            dev, pair if which == "full" else small, path)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: card against CPU")
    for path in BATCH_PATHS:
        summary[path]["card_vs_cpu"] = phase_batch_card_vs_cpu(dev, path)
        summary[path]["timing"] = phase_batch_timing(dev, path)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: batches")
    phase_odometry(dev, records, path_launches, summary)
    phase_backend(dev, records, path_launches, summary)
    phase_parallel(dev, records, path_launches, summary)
    phase_device_loop(dev, records, path_launches, summary, pair)
    for path in PATHS:
        summary[path]["bench"] = phase_bench(dev, pair, path)
    for path in CLASS_PATHS:
        summary[path]["bench"] = phase_class_bench(dev, pair, path)
    for path in PATHS:
        summary[path]["profile"] = phase_profile(dev, pair, path)
    for path in CLASS_PATHS:
        summary[path]["profile"] = phase_class_profile(dev, pair, path)
    log(f"[total] {time.perf_counter() - T_START:.1f} s: bench and profile")
    for r in records:
        name = r["name"]
        if name in TRIAL_CARRIED:
            # run inside the trial launch on the main paths: its launches are
            # the trial launches that carry its body, its own wrapper's 0
            carriers = TRIAL_CARRIED[name]
            r["launches_by_path"] = {p: path_launches[p]["lm_step"] if p in carriers else 0
                                     for p in path_launches}
            r["launches"] = r["launches_by_path"][carriers[0]]
            r["launched_in"] = "lm_step"
            r["standalone_launches_by_path"] = {p: path_launches[p][name]
                                                for p in path_launches}
            continue
        # a kernel's launches on its own path (the first path that runs it,
        # unless the record names one)
        own = r.get("own_path") or next(p for p, (_make, ks, _lim) in PATHS.items()
                                         if name in ks)
        r["launches"] = path_launches[own][name]
        r["launches_by_path"] = {p: path_launches[p][name] for p in path_launches}
        if name in IDX_COUNTED:
            r["idx_launches_by_path"] = {p: path_launches[p][f"{name}[idx]"]
                                         for p in path_launches}
        if name in NDT_FORM_COUNTED:
            r["form_launches_by_path"] = {
                p: {"lookup": path_launches[p][f"{name}[lookup]"],
                    "pack": path_launches[p][name] - path_launches[p][f"{name}[lookup]"]}
                for p in path_launches if path_launches[p][name]}
    summary["profiler_fallbacks"] = PROFILER_FALLBACKS
    log("[summary] " + json.dumps(summary))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("tolerance", "timing", "call_ms", "plain_call_ms", "launches_by_path",
             "launched_in", "standalone_launches_by_path", "registers", "stack_bytes",
             "by_lanes", "by_path", "lanes", "trial_off_error_ms", "prologue_ms",
             "lm_trial_ms", "unfused_ms", "aten_traps_differ", "idx_launches_by_path",
             "gathered_ms", "idx_ops_ms", "gather_and_gathered_ops_ms", "grid_stride_lanes",
             "grid_stride_ms", "pack_ms", "frozen_ms", "tiled_ms", "pose_to_normal_eq_ms",
             "eager_pose_to_normal_eq_ms", "valid_share", "pack_bound_ms", "form_registers",
             "form_launches_by_path", "unique_rows", "unique_cells", "bytes", "edge_cases",
             "class_maps", "hash_path", "multipoint", "scan_to_map", "localization",
             "odometry_serial", "odometry_stream", "odometry_scan", "by_k", "backend",
             "backend_source", "backend_target", "parallel", "library")
    work = ("candidates", "exact_candidates", "exact_search_ms", "source_cloud_ms",
            "pairs_visited", "pairs_in_range", "pairs_to_visit", "pairs_in_window",
            "pairs_visited_block_cull", "wide_slab_ms", "k48_ms")
    kernels = [{k: r[k] for k in keys + extra + work if k in r} for r in records]
    require(all(math.isfinite(r["ms"]) for r in kernels), "kernel timings")
    log(f"[total] {time.perf_counter() - T_START:.1f} s from the start of the script")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
