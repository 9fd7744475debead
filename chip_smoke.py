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
  6. bench protocol: registrations of each path through a 1e-5 rigid
     jitter of both clouds (bench.py's protocol), after a warm-up;
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


def log(*args):
    print(*args, flush=True)


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
    """Device time per call of `fn` from a torch.profiler trace of `reps`
    calls: the self device time of the kernels whose name holds `kernel`
    (a name or a tuple of names), or of every device op when `kernel` is
    None.  0.0 if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    total = sum(e.self_device_time_total for e in device_events(prof)
                if names is None or any(k in e.key for k in names))
    return total / 1e3 / reps


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
    the plain version's ops), and the CUDA-event time per call of each.
    Without device time in the trace, ms and plain_ms fall back to the
    event times, and `timing` says so."""
    t = dict(call_ms=cuda_ms(kernel_fn, reps),
             plain_call_ms=cuda_ms(plain_fn, plain_reps),
             ms=device_ms(kernel_fn, reps, kernel_name),
             plain_ms=device_ms(plain_fn, plain_reps),
             timing="profiler device time")
    if t["ms"] <= 0.0 or t["plain_ms"] <= 0.0:
        t.update(ms=t["call_ms"], plain_ms=t["plain_call_ms"],
                 timing="cuda events (no device time in the trace)")
    return t


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
    got = cuda_kernels.rbf_moments(*args)
    want = cuda_kernels.rbf_moments_plain(*args)
    torch.cuda.synchronize()
    v = tmask
    errs = [
        check_close("rbf sum w", got[0, v], want[0, v], 5e-3, 1e-4),
        check_close("rbf sum w y", got[1:4][:, v], want[1:4][:, v], 5e-3, 2e-2),
        check_close("rbf sum w yy", got[4:13][:, v], want[4:13][:, v], 5e-3, 5e-2),
    ]
    again = cuda_kernels.rbf_moments(*args)
    torch.cuda.synchronize()
    # the warps' partial sums are added in a fixed order: no atomics
    require(bool(torch.equal(got, again)), "rbf_moments: a repeat launch differs")
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
        max_abs_err=max(errs),
        tolerance=f"rtol 5e-3; atol 1e-4/2e-2/5e-2 (and on {edge_cases} edge cases); "
                  "a repeat launch bit-identical",
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

    def knn_check(label, a):
        mom, kth = cuda_kernels.knn_moments(*a)
        again = cuda_kernels.knn_moments(*a)
        mom_w, kth_w = cuda_kernels.knn_moments_plain(*a)
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

    args = knn_args(C, k)
    max_err = knn_check(f"C = {C} x {ct}, k = {k}", args)
    # the widest slab the contract takes and the round-by-round form (k > 32)
    wide, k48 = knn_args(32, k), knn_args(C, 48)
    knn_check(f"C = 32 x {ct}, k = {k}", wide)
    knn_check(f"C = {C} x {ct}, k = 48", k48)
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
    linearize kernels and the error kernels (trial off and on) from the
    ptxas lines of the library's build log, each logged (once a process).
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
            name = (ndt_lin_name(lin) if lin else
                    ERROR_KERNELS[err.groups()] if err else
                    lin_name(gicp) if gicp else
                    "ndt_error" if "ndt_error_kernel" in m.group(1) else None)
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


def phase_trial(dev, pair):
    """The LM trial launch (`cuda_solver.lm_step`) at the first linearization
    of VGICP, GICP, D2D and P2D fresh and of FastVGICP on the hash map and
    on the sparse grid map (DIRECT7, 157,696 lanes with misses):
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
    trap_differ = check_schedule_traps(dev)
    inputs = trial_inputs(dev, pair)
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
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_ndt, cuda_solver

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
# the standalone launches the trial launch replaces inside the LM solve, and
# the paths whose trials carry each one's body
TRIAL_CARRIED = {"lm_trial": tuple(PATHS) + tuple(CLASS_PATHS) + tuple(BATCH_PATHS)
                 + tuple(PYGICP_PATHS),
                 "error": ("vgicp_register", "gicp_register_fresh", "gicp_adaptive_fresh",
                           "gicp_min_eig_fresh", "vgicp_align_batch", "pygicp_gicp",
                           "pygicp_vgicp", "pygicp_vgicp_cuda")
                 + tuple(p for p in CLASS_PATHS if p not in NDT_CLASS_PATHS),
                 "ndt_error": ("ndt_d2d_fresh", "ndt_p2d_fresh", "ndt_d2d_align",
                               "ndt_p2d_align", "ndt_align_batch", "pygicp_ndt_cuda")
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
# maps), which the kernel cannot look up: each linearization there is an
# eager freeze (`cuda_ndt.ndt_freeze_pack`) and one pack-form launch, as the
# JAX package's fused objective runs it
NDT_PACK_ALLOWED = {("ndt_p2d_align", "ndt_p2d"), ("ndt_d2d_hash", "ndt_d2d"),
                    ("ndt_p2d_hash", "ndt_p2d"), ("ndt_align_batch", "ndt_d2d")}


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


def phase_bench(dev, pair, path, n_regs=100):
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


def phase_class_bench(dev, pair, path, n_regs=100):
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

    traced = trace_registrations(path, run, n_regs, predicted, all_ops=True)
    # a copy either way waits for the queue: the only ones are the flag
    # read a trial and the result's one read (the traced registrations'
    # own trials: on the hash maps the atomic sums move the iterations
    # from one registration to the next)
    trials = traced["traced_host_syncs"]
    require(traced["copies_per_registration"] == {"HtoD": 0, "DtoH": trials + 1},
            f"{path}: host copies a registration {traced['copies_per_registration']} for "
            f"{trials} trials")
    return dict(stage_wall_ms=stages, iterations=sorted(set(its)),
                trials_per_registration=(lsq_solve.host_syncs - syncs0) / len(its), **traced)

# -- NDTCuda's hash map, FastGICPMultiPoints, the batch aligns, pygicp -------


class _FirstTrial(Exception):
    """Raised by `first_trial`'s stand-in trial launch to end the run."""


def first_trial(run):
    """The inputs (y0, H, b, aux, cost, n_src) of the first LM trial that
    `run()` launches: its first linearization, as the path's objective
    built it on the card; the run stops there."""
    from fast_gicp_tpu_torch.ops import cuda_solver

    launch, got = cuda_solver.lm_step, []

    def capture(state, H, b, y0, aux, cost, first, config):
        got.append((y0.clone(), H.clone(), b.clone(), aux.clone(), cost,
                    aux.shape[1] // cost.offsets))
        raise _FirstTrial

    cuda_solver.lm_step = capture
    try:
        run()
    except _FirstTrial:
        pass
    finally:
        cuda_solver.lm_step = launch
    require(len(got) == 1, "the run launched no LM trial")
    return got[0]


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


def phase_batch_timing(dev, path, n_batches=10):
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


def main() -> int:
    timing = {"--ndt-timing": ndt_timing, "--trial-timing": trial_timing,
              "--lin-timing": lin_timing}
    timing_only = (len(sys.argv) == 3 and sys.argv[1] in timing
                   or len(sys.argv) == 4 and sys.argv[1] == "--lin-timing")
    if timing_only:  # time the kernels of the package under DIR
        sys.path.insert(0, str(pathlib.Path(sys.argv[2]).resolve()))
    elif len(sys.argv) > 1:
        print("usage: chip_smoke.py [--ndt-timing DIR | --trial-timing DIR | "
              "--lin-timing DIR [REF]]", file=sys.stderr)
        return 2
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    for path in PATHS:
        summary[path]["bench"] = phase_bench(dev, pair, path)
    for path in CLASS_PATHS:
        # the new paths' 50 fresh registrations keep the script's time down
        summary[path]["bench"] = phase_class_bench(
            dev, pair, path, n_regs=50 if path in CLASS_LIN_FORM else 100)
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
             "class_maps", "hash_path", "multipoint")
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
