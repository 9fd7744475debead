"""Where FastVGICP's default solve stops short on the small pair.

FastVGICP with the class defaults (kNN covariances, k 20, plane, DIRECT1,
1 m, additive) on the hash map (grid_dims=None), on the small synthetic pair
(frames 30/31 of a 400k-point drive, 0.3 m downsample) of each seed: the
forward align and the align after swap_source_and_target, each run twice
in a row on fresh instances.  For each align it prints the iterations,
has_converged and the pose error; for the port's aligns also, at each
linearization, the step from the previous linearization's pose (and from
the last one to the result) as the convergence test reads it
(max |R - I| / 2e-3 and max |t| / 5e-4; the solve stops when an accepted
step has both below 1) and how many source lanes look up
another voxel than at the linearization before (a changed voxel mean or
validity in the linearization's aux).  `cycle` is the shortest period p
(1-4) with the last pose equal to the one p linearizations back, to 1e-6.

    python tests/torch_vgicp_convergence.py [--device cuda] [--seeds 0 1 2]
        [--jax] [--out FILE]

--device is the port's device ("cpu" by default; "cuda" on a card),
--jax adds the JAX package's class on the CPU with its kNN covariances
from the fused Pallas kernel in interpret mode (as
tests/test_torch_classes.py runs it; the JAX package's own CPU path
searches other candidate tiles).  Prints one JSON line (also written to
--out).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fast_gicp_tpu_torch.models import vgicp  # noqa: E402
from fast_gicp_tpu_torch.solver import LsqConfig  # noqa: E402
from fast_gicp_tpu_torch.utils import downsample, synthetic  # noqa: E402

EPS = LsqConfig()


def small_pair(seed):
    rng = np.random.default_rng(seed)
    world = synthetic.drive_world(rng, n=400_000)
    scans, gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    return (downsample.voxel_downsample(scans[30], 0.3),
            downsample.voxel_downsample(scans[31], 0.3),
            np.linalg.inv(gt[30]) @ gt[31])


def pose_errors(T, T_gt):
    d = np.linalg.inv(T_gt) @ np.asarray(T, np.float64)
    cos = np.clip((np.trace(d[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.linalg.norm(d[:3, 3])), float(np.degrees(np.arccos(cos)))


class Recorder:
    """Wraps `lsq_solve` in `models.vgicp`: the pose and the aux of every
    linearization of the solves made while it is installed."""

    def __init__(self):
        self.solves = []
        self._solve = vgicp.lsq_solve

    def __enter__(self):
        def solve(linearize, error, x0, config, **kw):
            trace = []
            self.solves.append(trace)

            def recorded(x):
                out = linearize(x)
                trace.append((x.detach().cpu().double().numpy().copy(),
                              out[3].detach().cpu().numpy().copy()))
                return out

            res = self._solve(recorded, error, x0, config, **kw)
            final = res[0] if kw.get("with_aux") else res
            trace.append((final.transformation.detach().cpu().double().numpy(), None))
            return res

        vgicp.lsq_solve = solve
        return self

    def __exit__(self, *exc):
        vgicp.lsq_solve = self._solve


def summarize(trace):
    """Steps between consecutive linearizations, the last one to the
    solve's result, and the voxel changes between linearizations."""
    steps, changed = [], []
    for (x0, a0), (x1, a1) in zip(trace, trace[1:]):
        d = np.linalg.inv(x0) @ x1
        steps.append([float(np.abs(d[:3, :3] - np.eye(3)).max() / EPS.rotation_epsilon),
                      float(np.abs(d[:3, 3]).max() / EPS.transformation_epsilon)])
        if a1 is not None:
            v0, v1 = a0[6] != 0, a1[6] != 0
            moved = (v0 != v1) | (v0 & v1 & np.any(a0[7:10] != a1[7:10], axis=0))
            changed.append(int(moved.sum()))
    xs = [x for x, _a in trace[:-1]]
    cycle = next((p for p in range(1, 5) if len(xs) > p
                  and np.abs(xs[-1] - xs[-1 - p]).max() <= 1e-6), None)
    return dict(linearizations=len(xs), last_steps=steps[-6:],
                last_changed_lanes=changed[-6:], cycle=cycle)


def workflow(reg, target, source):
    out = []
    reg.set_input_target(target)
    reg.set_input_source(source)
    for swap in (False, True):
        if swap:
            reg.swap_source_and_target()
        T = reg.align()
        out.append((np.asarray(T, np.float64), int(reg.get_num_iterations()),
                    bool(reg.has_converged())))
    return out


def run_port(pair, device):
    target, source, gt = pair
    with Recorder() as rec:
        res = workflow(vgicp.FastVGICP(grid_dims=None, device=device), target, source)
    rows = []
    for (T, it, conv), T_gt, trace in zip(res, (gt, np.linalg.inv(gt)), rec.solves):
        t, r = pose_errors(T, T_gt)
        rows.append(dict(iterations=it, converged=conv, t_err_m=t, r_err_deg=r,
                         **summarize(trace)))
    return rows


def run_jax(pair):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from fast_gicp_tpu.models import vgicp as jvgicp
    from fast_gicp_tpu.ops import covariance as jcov
    from fast_gicp_tpu.ops import soa as jsoa

    def fused_cols(points, mask, k=20, method="plane", chunk_size=1024, approx=True):
        mom, _kth, _excl = jcov._knn_moment_cols_fused(points, mask, k, interpret=True)
        cov6 = jcov._finalize_mom_cols(mom)
        return jsoa.plane_covs_cols(cov6) if method == "plane" else cov6

    jcov.knn_covariance_cols = fused_cols
    target, source, gt = pair
    res = workflow(jvgicp.FastVGICP(grid_dims=None), target, source)
    return [dict(iterations=it, converged=conv,
                 **dict(zip(("t_err_m", "r_err_deg"), pose_errors(T, T_gt))))
            for (T, it, conv), T_gt in zip(res, (gt, np.linalg.inv(gt)))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    result = {"device": args.device}
    if args.device != "cpu":
        result["device_name"] = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        pair = small_pair(seed)
        row = {"points": [len(pair[0]), len(pair[1])],
               "port": [run_port(pair, args.device) for _ in range(2)]}
        if args.jax:
            row["jax"] = [run_jax(pair) for _ in range(2)]
        result[f"seed{seed}"] = row
        short = {k: [[(a["iterations"], a["converged"], round(a["t_err_m"], 5)) for a in run]
                     for run in v] for k, v in row.items() if k != "points"}
        print(f"seed {seed}: {short}", file=sys.stderr, flush=True)
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
