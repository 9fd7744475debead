"""Drive the PyTorch/CUDA port (`fast_gicp_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Two registration paths run: `vgicp_register` (RBF covariances, dense raw
voxel grid, two-phase LM solve) and `gicp_register_fresh` (kNN covariances,
exact 1-NN correspondences re-searched at every linearization, LM solve).
Phases, each fatal on failure (exit code != 0, no result line):
  1. device: CUDA must be present; prints the card's name and power limit;
  2. build: compiles the seven CUDA kernels from `fast_gicp_tpu_torch/csrc`;
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs, at the shapes its path gives it on the full-size synthetic
     pair (22,528 padded points per cloud), with the stated tolerances,
     timed from a torch.profiler trace;
  4. main paths: each path on the full-size pair, with every launch
     counter set to 0 just before it and read just after; checks the pose
     against the synthetic ground truth (t < 0.05 m, r < 1 deg) and that
     every kernel of the path ran;
  5. small pair: each path on the card against the same call with
     device="cpu" (the plain versions) on the CPU-test-sized pair;
  6. bench protocol: registrations of each path through a 1e-5 rigid
     jitter of both clouds (bench.py's protocol), after a warm-up;
  7. profile: stage wall times and a torch.profiler trace of a few
     registrations of each path (device time by kernel, device busy share).

The last lines are the `nvidia-smi` name/power-limit line, one
{"kernels": [...]} JSON line and the {"ok": true, ...} JSON line.
This script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
# FP32 operations each kernel needs, counted from its arithmetic:
RBF_OPS_PER_PAIR = 28  # distance 8, exp 1, moment products 9 and sums 10
LINEARIZE_OPS = 300  # per correspondence: transform, R C R^T, inverse, 28 terms
ERROR_OPS = 43  # per correspondence: transform, e, M e, e^T M e, sum
LM_TRIAL_OPS = 700  # two 6x6 Cholesky solves, residual, se3_exp, 4x4 product
NN_OPS_PER_PAIR = 8  # 3 differences, 3 squares, 2 adds
KNN_OPS_PER_CANDIDATE = 11  # distance 8, key 2, one compare of a k-selection
KNN_OPS_PER_NEIGHBOUR = 22  # local coordinates 6, moment products 6, sums 10


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
    # data-dependent work: only pairs within max_dist need the exp and the
    # moment update
    y = (tgt - c)[tmask]
    pairs = 0
    for s in range(0, y.shape[0], 2048):
        d2 = torch.cdist(y[s:s + 2048], y,
                         compute_mode="donot_use_mm_for_euclid_dist").square()
        pairs += int((d2 <= 9.0).sum())
    tm = timings(lambda: cuda_kernels.rbf_moments(*args),
                 lambda: cuda_kernels.rbf_moments_plain(*args),
                 "rbf_moments_kernel", 20, 3)
    b_ms, b_by = bound_ms(2 * n * 16 + 16 * n * 4, pairs * RBF_OPS_PER_PAIR)
    records.append(dict(
        name="rbf_moments", route="cuda",
        source="fast_gicp_tpu_torch/csrc/rbf_moments.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:417",
        max_abs_err=max(errs), tolerance="rtol 5e-3; atol 1e-4/2e-2/5e-2",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs_in_range=pairs,
        **tm))

    # -- linearize_raw / error at the first linearization of the solve ----
    scov = rbf_covariance_cols(src - c, smask)
    tcov = rbf_covariance_cols(tgt - c, tmask)
    dims = auto_grid_dims(target, 1.0)
    cfg = VGICPConfig(grid_dims=dims, refresh_iterations=2)
    vmap = build_raw_grid(tgt - c, tmask, 1.0, tcov, dims)
    lin, err_fn, freeze, lin_frozen = make_vgicp_objective(
        src - c, smask, scov, vmap, neighbor_offsets("direct1"), cfg)
    x = torch.eye(4, device=dev)
    rows = freeze(x)
    P = (src - c).T.contiguous()
    CA = scov.contiguous()
    valid = smask.to(torch.float32)
    L = P.shape[1]
    got = cuda_linearize.linearize_raw(P, CA, x, rows, valid)
    want = cuda_linearize.linearize_raw_plain(P, CA, x, rows, valid)
    torch.cuda.synchronize()
    errs = [
        check_close("linearize err", got[0], want[0], 1e-4, 0.0),
        check_close("linearize H", got[1], want[1], 3e-3, 0.5),
        check_close("linearize b", got[2], want[2], 3e-3, 0.5),
        check_close("linearize aux", got[3], want[3], 1e-5, 1e-5),
    ]
    tm = timings(lambda: cuda_linearize.linearize_raw(P, CA, x, rows, valid),
                 lambda: cuda_linearize.linearize_raw_plain(P, CA, x, rows, valid),
                 "linearize_kernel<true>", 200, 50)
    b_ms, b_by = bound_ms(L * (12 + 24 + 64 + 4 + 40) + 64 + 28 * 4, L * LINEARIZE_OPS)
    records.append(dict(
        name="linearize_raw", route="cuda",
        source="fast_gicp_tpu_torch/csrc/linearize.cu",
        replaces="fast_gicp_tpu/ops/pallas_linearize.py:193",
        max_abs_err=max(errs), tolerance="err rtol 1e-4; H, b rtol 3e-3 atol 0.5; aux rtol 1e-5 atol 1e-5",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **tm))

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
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, make_gicp_objective
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize
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
    cidx, _excluded = select_candidate_tiles(
        tgt.reshape(Q, cuda_kernels.KNN_TILE, 3),
        _masked_target(tgt, tmask).reshape(n // ct, ct, 3), C)
    ones = torch.ones_like(tmask)
    args = (tgt, ones, tgt, tmask, cidx, k)
    mom, kth = cuda_kernels.knn_moments(*args)
    mom_w, kth_w = cuda_kernels.knn_moments_plain(*args)
    torch.cuda.synchronize()
    require(bool(torch.equal(kth, kth_w)),
            f"knn_moments kth: {int((kth != kth_w).sum())} of {n} not bit-equal")
    scale = mom_w.abs().amax(dim=1, keepdim=True)
    err_mom = check_close("knn_moments mom", mom / scale, mom_w / scale, 0.0, 1e-4)
    tm_ = timings(lambda: cuda_kernels.knn_moments(*args),
                  lambda: cuda_kernels.knn_moments_plain(*args),
                  "knn_moments_kernel", 50, 5)
    b_ms, b_by = bound_ms(n * 16 + n * 16 + Q * C * 4 + n * 11 * 4,
                          n * C * ct * KNN_OPS_PER_CANDIDATE + n * k * KNN_OPS_PER_NEIGHBOUR)
    records.append(dict(
        name="knn_moments", route="cuda",
        source="fast_gicp_tpu_torch/csrc/knn_moments.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:302",
        max_abs_err=float((mom - mom_w).abs().max()),
        tolerance="kth bit-equal; mom within 1e-4 of each row's largest entry",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **tm_))
    log(f"[kernels] knn_moments: kth bit-equal on all {n}; mom max diff / row scale "
        f"{err_mom:.3e}")

    # -- nn_search at the first re-search of a solve: the transformed,
    # centered source against the centered target --------------------------
    c = masked_mean(tgt, tmask)
    src_c, tgt_c = src - c, tgt - c
    x = se3.se3_exp(torch.tensor([0.002, -0.001, 0.003, 0.02, -0.01, 0.005], device=dev))
    q = se3.transform_points(x, src_c).contiguous()
    idx, d2 = cuda_kernels.nn_search(q, tgt_c, tmask, smask)
    idx_w, d2_w = cuda_kernels.nn_search_plain(q, tgt_c, tmask)
    torch.cuda.synchronize()
    # near-ties among the valid queries, from chunked distance rows
    parked = _masked_target(tgt_c, tmask)
    unique = torch.empty_like(tmask)
    for s0 in range(0, n, 2048):
        dd = torch.cdist(q[s0:s0 + 2048], parked,
                         compute_mode="donot_use_mm_for_euclid_dist").square()
        unique[s0:s0 + 2048] = (dd <= dd.amin(1, keepdim=True) * (1 + 1e-6)).sum(1) == 1
    ok = (idx == idx_w) | ~unique | ~smask
    require(bool(ok.all()), f"nn_search idx: {int((~ok).sum())} unique nearest differ")
    require(bool(torch.isfinite(d2).all()), "nn_search d2: non-finite rows")
    err_d2 = check_close("nn_search d2", d2[smask], d2_w[smask], 1e-6, 0.0)

    # the pairs an exact cull at this tiling must visit: the (128-query,
    # 128-target) tile pairs whose box gap^2 is <= the query tile's worst
    # nearest d^2, over the valid queries
    inf = torch.full_like(q, float("inf"))
    qlo = torch.where(smask[:, None], q, inf).reshape(-1, 128, 3).amin(1)
    qhi = torch.where(smask[:, None], q, -inf).reshape(-1, 128, 3).amax(1)
    tlo = parked.reshape(-1, 128, 3).amin(1)
    thi = parked.reshape(-1, 128, 3).amax(1)
    gap = torch.clamp(torch.maximum(qlo[:, None] - thi[None], tlo[None] - qhi[:, None]),
                      min=0.0)
    worst = torch.where(smask, d2_w, torch.zeros_like(d2_w)).reshape(-1, 128).amax(1)
    need = (gap.square().sum(-1) <= worst[:, None]) & (worst[:, None] > 0)
    pairs = int(need.sum()) * 128 * 128
    tm_ = timings(lambda: cuda_kernels.nn_search(q, tgt_c, tmask, smask),
                  lambda: cuda_kernels.nn_search_plain(q, tgt_c, tmask),
                  ("tile_bbox_kernel", "nn_search_kernel"), 100, 5)
    b_ms, b_by = bound_ms(n * 12 + n * 12 + n * 8, pairs * NN_OPS_PER_PAIR)
    records.append(dict(
        name="nn_search", route="cuda",
        source="fast_gicp_tpu_torch/csrc/nn_search.cu",
        replaces="fast_gicp_tpu/ops/pallas_kernels.py:99",
        max_abs_err=err_d2,
        tolerance="valid queries: idx equal where the nearest is unique; d2 rtol 1e-6",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, pairs_to_visit=pairs, **tm_))
    log(f"[kernels] nn_search: idx equal on all {int((unique & smask).sum())} unique "
        f"nearest of valid queries, {int((~unique & smask).sum())} near-ties; "
        f"exact-cull pairs {pairs} of {n * n}")

    # -- linearize at the first linearization of the solve ---------------
    scov = knn_covariance_cols(src, smask)
    tcov = knn_covariance_cols(tgt, tmask)
    _lin, _err, freeze, _lin_frozen = make_gicp_objective(
        src_c, smask, scov, tgt_c, tmask, tcov, GICPConfig(), with_freeze=True)
    rows, valid = freeze(x)
    P = src_c.T.contiguous()
    CA = scov.contiguous()
    L = P.shape[1]
    got = cuda_linearize.linearize(P, CA, x, rows, valid)
    want = cuda_linearize.linearize_plain(P, CA, x, rows, valid)
    torch.cuda.synchronize()

    def rel_to_max(name, a, b):
        m = float(b.abs().max())
        return check_close(name, a / m, b / m, 0.0, 1e-5) * m

    errs = [
        rel_to_max("linearize err", got[0].reshape(1), want[0].reshape(1)),
        rel_to_max("linearize H", got[1], want[1]),
        rel_to_max("linearize b", got[2], want[2]),
        check_close("linearize aux", got[3], want[3], 1e-5, 1e-5),
    ]
    tm_ = timings(lambda: cuda_linearize.linearize(P, CA, x, rows, valid),
                  lambda: cuda_linearize.linearize_plain(P, CA, x, rows, valid),
                  "linearize_kernel<false>", 200, 50)
    b_ms, b_by = bound_ms(L * (12 + 24 + 64 + 4 + 40) + 64 + 28 * 4, L * LINEARIZE_OPS)
    records.append(dict(
        name="linearize", route="cuda",
        source="fast_gicp_tpu_torch/csrc/linearize.cu",
        replaces="fast_gicp_tpu/ops/pallas_linearize.py:180",
        max_abs_err=max(errs),
        tolerance="err, H, b within 1e-5 of their largest entry; aux rtol 1e-5 atol 1e-5",
        bound_ms=b_ms, bound_by=b_by, library_ms=None, **tm_))
    for r in records:
        log(f"[kernels] {r['name']}: max_abs_diff {r['max_abs_err']:.3e} "
            f"({r['tolerance']}), {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
            f"({r['timing']}); per call with the host's enqueue: "
            f"{r['call_ms']:.4f} ms, plain {r['plain_call_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.3e} ms ({r['bound_by']})")
    return records


def counters():
    from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_solver

    return {
        "rbf_moments": cuda_kernels.rbf_moments,
        "linearize_raw": cuda_linearize.linearize_raw,
        "error": cuda_linearize.error,
        "lm_trial": cuda_solver.lm_trial,
        "knn_moments": cuda_kernels.knn_moments,
        "nn_search": cuda_kernels.nn_search,
        "linearize": cuda_linearize.linearize,
    }


def vgicp_path(target):
    """`vgicp_register` as bench.py runs it: RBF covariances, the dense raw
    grid at 1 m, two-phase solve."""
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_register
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims

    cfg = VGICPConfig(grid_dims=auto_grid_dims(target, 1.0), refresh_iterations=2)

    def register(s, sm, t, tm, guess, device):
        return vgicp_register(s, sm, t, tm, guess, cfg, device=device)

    return register


def gicp_path(target):
    """`gicp_register_fresh` with the defaults FastGICP's fresh align uses:
    kNN covariances (k = 20, plane), 1-NN re-search every iteration."""
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, gicp_register_fresh

    del target

    def register(s, sm, t, tm, guess, device):
        return gicp_register_fresh(s, sm, t, tm, guess, GICPConfig(), device=device)[0]

    return register


PATHS = {
    "vgicp_register": (vgicp_path, ("rbf_moments", "linearize_raw", "error", "lm_trial")),
    "gicp_register_fresh": (gicp_path, ("knn_moments", "nn_search", "linearize", "error",
                                        "lm_trial")),
}


def phase_main_path(dev, pair, path):
    from fast_gicp_tpu_torch.models.metrics import fitness_score
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = pair
    make, kernels = PATHS[path]
    register = make(target)
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    inputs = [torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm)]
    guess = torch.eye(4, device=dev)
    register(*inputs, guess, dev)  # warm-up
    torch.cuda.synchronize()

    for fn in counters().values():
        fn.launches = 0
    lsq_solve.host_syncs = 0
    t0 = time.perf_counter()
    res = register(*inputs, guess, dev)
    T = res.transformation.cpu().numpy()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters().items()}
    syncs = lsq_solve.host_syncs

    require(T.shape == (4, 4) and np.isfinite(T).all(), f"{path}: non-finite pose")
    t_err, r_err = pose_errors(T.astype(np.float64), gt)
    iters = int(res.iterations)
    fitness = float(fitness_score(res.transformation, *inputs, device=dev))
    log(f"[main] {path}: t_err {t_err:.6f} m, r_err {r_err:.6f} deg, "
        f"iterations {iters}, converged {bool(res.converged)}, host syncs {syncs}, "
        f"wall {wall_ms:.3f} ms, fitness {fitness:.6f}, launches {launches}")
    require(math.isfinite(fitness), f"{path}: non-finite fitness")
    require(t_err < 0.05 and r_err < 1.0, f"{path}: pose error {t_err} m {r_err} deg")
    require(all(launches[k] > 0 for k in kernels),
            f"{path}: a kernel of the path was not launched: {launches}")
    return launches, dict(t_err_m=t_err, r_err_deg=r_err, iterations=iters,
                          host_syncs=syncs, wall_ms=wall_ms, fitness=fitness)


def phase_small_pair(dev, small, path):
    """The card's run of a path against the CPU run (plain versions) on the
    small synthetic pair; tolerance 1e-3 on the pose, as the CPU tests hold
    the port against the JAX package."""
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, gt = small
    register = PATHS[path][0](target)
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    eye = np.eye(4, dtype=np.float32)
    r_gpu = register(sp, sm, tp, tm, eye, dev)
    r_cpu = register(sp, sm, tp, tm, eye, "cpu")
    T_gpu = r_gpu.transformation.cpu().numpy()
    T_cpu = r_cpu.transformation.numpy()
    diff = float(np.abs(T_gpu - T_cpu).max())
    t_err, r_err = pose_errors(T_gpu.astype(np.float64), gt)
    log(f"[small] {path}, {sp.shape[0]} padded points: |T_gpu - T_cpu| max {diff:.3e}, "
        f"iterations gpu {int(r_gpu.iterations)} cpu {int(r_cpu.iterations)}, "
        f"t_err {t_err:.6f} m")
    require(np.isfinite(T_gpu).all() and diff <= 1e-3, f"small pair: pose diff {diff}")
    require(abs(int(r_gpu.iterations) - int(r_cpu.iterations)) <= 1,
            "small pair: iteration counts differ by more than 1")
    require(t_err < 0.05 and r_err < 1.0, f"small pair: pose error {t_err} m {r_err} deg")
    return dict(pose_diff=diff, iterations_gpu=int(r_gpu.iterations),
                iterations_cpu=int(r_cpu.iterations))


def phase_bench(dev, pair, path, n_regs=100):
    from fast_gicp_tpu_torch import se3
    from fast_gicp_tpu_torch.solver import lsq_solve
    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    register = PATHS[path][0](target)
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


def _stages_vgicp(dev, target, sp, sm, tp, tm, guess, register, wall_ms):
    from fast_gicp_tpu_torch.ops.covariance import masked_mean, rbf_covariance_cols
    from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims, build_raw_grid

    dims = auto_grid_dims(target, 1.0)
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


def _stages_gicp(dev, target, sp, sm, tp, tm, guess, register, wall_ms):
    from fast_gicp_tpu_torch.models.gicp import gicp_align
    from fast_gicp_tpu_torch.ops.covariance import knn_covariance_cols

    del target
    scov, tcov = knn_covariance_cols(sp, sm), knn_covariance_cols(tp, tm)
    return {
        "register": wall_ms(lambda: register(sp, sm, tp, tm, guess, dev)),
        "covariances (both clouds)": wall_ms(
            lambda: (knn_covariance_cols(sp, sm), knn_covariance_cols(tp, tm))),
        "align (solve)": wall_ms(
            lambda: gicp_align(sp, sm, scov, tp, tm, tcov, guess, device=dev)),
    }


def phase_profile(dev, pair, path, n_regs=5):
    """Where a registration's time goes: host-clock stage times (each stage
    alone, synchronised), then a torch.profiler trace of `n_regs`
    registrations for the device time by kernel and the device's busy
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from fast_gicp_tpu_torch.utils.padding import pad_points

    source, target, _gt = pair
    register = PATHS[path][0](target)
    sp, sm = pad_points(source)
    tp, tm = pad_points(target)
    sp, sm, tp, tm = (torch.as_tensor(a, device=dev) for a in (sp, sm, tp, tm))
    guess = torch.eye(4, device=dev)

    def wall_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    stage_fn = _stages_vgicp if path == "vgicp_register" else _stages_gicp
    stages = stage_fn(dev, target, sp, sm, tp, tm, guess, register, wall_ms)
    log(f"[profile] {path} stage wall ms/registration: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_regs):
            register(sp, sm, tp, tm, guess, dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_regs
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n_regs
    launches = sum(e.count for e in events) / n_regs
    log(f"[profile] {path}, traced {n_regs} registrations: wall {wall:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall:.1f}%), device ops "
        f"{launches:.0f} per registration")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n_regs:9.4f} ms  "
            f"x{e.count / n_regs:5.1f}  {e.key[:90]}")
    return dict(stage_wall_ms=stages, traced_wall_ms=wall, device_busy_ms=busy_ms,
                device_ops_per_registration=launches)


def main() -> int:
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
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    pair = synthetic_pair()
    records = phase_kernels(dev, pair) + phase_gicp_kernels(dev, pair)
    summary = {}
    path_launches = {}
    for path in PATHS:
        path_launches[path], main_stats = phase_main_path(dev, pair, path)
        summary[path] = {"main_path": main_stats}
    small = synthetic_pair(n_world=400_000, voxel=0.3)
    for path in PATHS:
        summary[path]["small_pair"] = phase_small_pair(dev, small, path)
    for path in PATHS:
        summary[path]["bench"] = phase_bench(dev, pair, path)
    for path in PATHS:
        summary[path]["profile"] = phase_profile(dev, pair, path)
    for r in records:
        # a kernel's launches on its own path (the first path that runs it)
        own = next(p for p, (_make, ks) in PATHS.items() if r["name"] in ks)
        r["launches"] = path_launches[own][r["name"]]
        r["launches_by_path"] = {p: path_launches[p][r["name"]] for p in PATHS}
    log("[summary] " + json.dumps(summary))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("tolerance", "timing", "call_ms", "plain_call_ms", "launches_by_path")
    kernels = [{k: r[k] for k in keys + extra} for r in records]
    require(all(math.isfinite(r["ms"]) for r in kernels), "kernel timings")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
