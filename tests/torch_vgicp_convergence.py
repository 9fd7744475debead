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
        [--jax] [--stages] [--out FILE]

--device is the port's device ("cpu" by default; "cuda" on a card),
--jax adds the JAX package's class on the CPU with its kNN covariances
from the fused Pallas kernel in interpret mode (as
tests/test_torch_classes.py runs it; the JAX package's own CPU path
searches other candidate tiles).  --stages (CPU only) instead holds the
port's CPU against JAX's CPU stage by stage on each seed's forward align
(`stages`): the kNN covariances, the hash map's rows and ids, the voxel
ids and [err, H, b] at each linearization pose, and the pose after each
LM iteration.  Prints one JSON line (also written to --out).
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


def _jax_cov_cols(points, mask):
    """JAX's class kNN covariances (k 20, plane) from the fused Pallas
    kernel in interpret mode, as `run_jax` takes them."""
    from fast_gicp_tpu.ops import covariance as jcov
    from fast_gicp_tpu.ops import soa as jsoa

    mom, _kth, _excl = jcov._knn_moment_cols_fused(points, mask, 20, interpret=True)
    return np.asarray(jsoa.plane_covs_cols(jcov._finalize_mom_cols(mom)))


def _rel_rows(a, b, mask):
    """max over masked-in columns of |a - b| / the column's largest |b|."""
    a, b = np.asarray(a, np.float64)[..., mask], np.asarray(b, np.float64)[..., mask]
    scale = np.maximum(np.abs(b).max(axis=0), 1e-30)
    return float((np.abs(a - b).max(axis=0) / scale).max())


def _jax_trajectory(jvgicp, args):
    """The JAX align's linearization poses (centred frame), recorded with
    jit off so that its LM loops run in Python."""
    import jax

    poses, solve = [], jvgicp.lsq_solve

    def recorded(linearize, error, x0, config, **kw):
        def lin(x):
            poses.append(np.asarray(x, np.float64))
            return linearize(x)
        return solve(lin, error, x0, config, **kw)

    jvgicp.lsq_solve = recorded
    try:
        with jax.disable_jit():
            res = jvgicp.vgicp_align(*args)
    finally:
        jvgicp.lsq_solve = solve
    return poses, res


def stages(pair):
    """The port's CPU against JAX's CPU on the forward align of FastVGICP's
    class defaults (kNN k 20 plane, DIRECT1, 1 m, additive, hash map), stage
    by stage: (1) both clouds' covariances; (2) the target hash map's rows
    and integer fields, built from each package's own covariances and from
    the same (JAX's) covariances; (3, 4) at every linearization pose of the
    port's solve, the voxel ids each package looks up and its [err, H, b],
    each package on its own covariances and map; (5) the pose after each LM
    iteration of both solves, and at each pose where they part, the lanes
    whose voxel differs between the two poses (points on a voxel face)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from fast_gicp_tpu.models import vgicp as jvgicp
    from fast_gicp_tpu.ops import covariance as jcov
    from fast_gicp_tpu.ops import voxelmap as jvm
    from fast_gicp_tpu_torch.ops import covariance, soa, voxelmap
    from fast_gicp_tpu_torch.utils.padding import pad_points

    target, source, gt = pair
    (sp, sm), (tp, tm) = pad_points(source), pad_points(target)
    t = {k: torch.as_tensor(v) for k, v in dict(sp=sp, sm=sm, tp=tp, tm=tm).items()}
    out = {}
    # 1. covariances
    covs = {}
    for name, pts, m in (("source", sp, sm), ("target", tp, tm)):
        port = covariance.knn_covariance_cols(t["sp" if name == "source" else "tp"],
                                              t["sm" if name == "source" else "tm"])
        jx = _jax_cov_cols(jnp.asarray(pts), jnp.asarray(m))
        covs[name] = (port, jx)
        d = np.abs(port.numpy() - jx)[:, m].max(axis=0) / np.maximum(
            np.abs(jx)[:, m].max(axis=0), 1e-30)
        # the raw moments about each query tile's first point, before the
        # finalize's cancellation E[y y^T] - mean mean^T
        pm, pk, pe = covariance._knn_moment_cols_fused(torch.as_tensor(pts), torch.as_tensor(m),
                                                       20)
        jm, jk, je = jcov._knn_moment_cols_fused(jnp.asarray(pts), jnp.asarray(m), 20,
                                                 interpret=True)
        out[f"1_covariances_{name}"] = dict(
            max_rel=float(d.max()), points_over_1e_4=int((d > 1e-4).sum()),
            points=int(m.sum()),
            kth_equal=bool(np.array_equal(pk.numpy()[m], np.asarray(jk)[m])),
            excluded_gaps_equal=bool(np.array_equal(pe.numpy(), np.asarray(je))),
            moments_max_rel=_rel_rows(pm.numpy(), np.asarray(jm), m),
            none_cov_max_rel=_rel_rows(covariance._finalize_mom_cols(pm).numpy(),
                                       np.asarray(jcov._finalize_mom_cols(jm)), m))
    # 2. the target hash map in the target-centroid frame
    c = tp[tm].astype(np.float64).mean(axis=0).astype(np.float32)
    c_t = covariance.masked_mean(t["tp"], t["tm"])
    tgt_c, src_c = t["tp"] - c_t, t["sp"] - c_t
    jtgt_c, jsrc_c = jnp.asarray(tgt_c.numpy()), jnp.asarray(src_c.numpy())
    ints = ("counts", "coords", "table", "lut", "num_voxels")

    def build_port(cov):
        return voxelmap.build_voxelmap(tgt_c, t["tm"], 1.0, covs=torch.as_tensor(cov),
                                       device="cpu")

    jmap = jvm.build_voxelmap(jtgt_c, jnp.asarray(tm), 1.0, covs=jnp.asarray(covs["target"][1]))
    for label, pmap in (("own_covariances", build_port(covs["target"][0])),
                        ("same_covariances", build_port(covs["target"][1]))):
        occ = np.asarray(jmap.counts) > 0
        out[f"2_map_{label}"] = dict(
            integers_equal={f: bool(np.array_equal(np.asarray(getattr(pmap, f)),
                                                   np.asarray(getattr(jmap, f)))) for f in ints},
            packed_max_rel=_rel_rows(pmap.packed.numpy().T, np.asarray(jmap.packed).T, occ))
    pmap = build_port(covs["target"][0])
    pmap_same = build_port(covs["target"][1])
    # 3, 4. ids and [err, H, b] at the port's linearization poses
    cfg = vgicp.VGICPConfig()
    offsets = voxelmap.neighbor_offsets("direct1")
    plin = vgicp.make_vgicp_objective(src_c, t["sm"], covs["source"][0], pmap, offsets,
                                      cfg)[0]
    plin_same = vgicp.make_vgicp_objective(src_c, t["sm"], torch.as_tensor(covs["source"][1]),
                                           pmap_same, offsets, cfg)[0]
    jlin, _jerr = jvgicp.make_vgicp_objective(
        jsrc_c, jnp.asarray(sm), jnp.asarray(covs["source"][1]), jmap, jnp.asarray(offsets),
        jvgicp.VGICPConfig())

    def jids(x):
        p_t = np.asarray(x[:3, :3], np.float32) @ src_c.numpy().T.astype(np.float32)
        q = jnp.floor((jnp.asarray(p_t) + jnp.asarray(x[:3, 3:4], jnp.float32)) / 1.0 - 0.5
                      ).astype(jnp.int32)
        return np.asarray(jvm.lookup_voxels_cols(jmap, q[0], q[1], q[2]))

    def pids(x):
        vids = voxelmap.lookup_voxels_cols(pmap, *vgicp._query_cols(
            soa.cols_from_points(src_c), torch.as_tensor(x, dtype=torch.float32), 1.0, offsets))
        return vids.reshape(-1).numpy()

    with Recorder() as rec:
        pres = vgicp.vgicp_align(t["sp"], t["sm"], covs["source"][0], t["tp"], t["tm"],
                                 covs["target"][0], torch.eye(4), cfg, device="cpu")
    pposes = [x for x, _a in rec.solves[0][:-1]]
    jposes, jres = _jax_trajectory(jvgicp, (
        jnp.asarray(sp), jnp.asarray(sm), jnp.asarray(covs["source"][1]), jnp.asarray(tp),
        jnp.asarray(tm), jnp.asarray(covs["target"][1]), jnp.eye(4), jvgicp.VGICPConfig()))
    # the recorded poses are centred-frame (both packages solve about c)
    rows = []
    for i, x in enumerate(pposes):
        xf = torch.as_tensor(x, dtype=torch.float32)
        je, jH, jb, _ = jlin(jnp.asarray(x, jnp.float32))
        pv, jv = pids(x), jids(x).reshape(-1)
        eq = np.concatenate([[float(je)], np.asarray(jH).ravel(), np.asarray(jb)])
        row = dict(iteration=i, ids_differ=int((pv != jv).sum()))
        for label, lin in (("own_covariances", plin), ("same_covariances", plin_same)):
            pe, pH, pb, _ = lin(xf)
            got = np.concatenate([[float(pe)], pH.numpy().ravel(), pb.numpy()])
            row[f"normal_eq_max_rel_{label}"] = float(np.abs(got - eq).max() / np.abs(eq).max())
        rows.append(row)
    out["3_4_at_port_poses"] = rows
    # 5. the trajectories
    traj = []
    for i in range(max(len(pposes), len(jposes))):
        a = pposes[i] if i < len(pposes) else None
        b = jposes[i] if i < len(jposes) else None
        row = dict(iteration=i)
        if a is not None and b is not None:
            row["pose_max_diff"] = float(np.abs(a - b).max())
            va, vb = pids(a), pids(b)  # one package's lookup at the two poses
            row["lanes_in_another_voxel"] = int((va != vb).sum())
        traj.append(row)
    out["5_trajectory"] = traj
    # the port's solve on JAX's covariances
    with Recorder() as rec2:
        same = vgicp.vgicp_align(t["sp"], t["sm"], torch.as_tensor(covs["source"][1]), t["tp"],
                                 t["tm"], torch.as_tensor(covs["target"][1]), torch.eye(4), cfg,
                                 device="cpu")
    sposes = [x for x, _a in rec2.solves[0][:-1]]
    out["5_trajectory_same_covariances"] = [
        dict(iteration=i, pose_max_diff=float(np.abs(a - b).max()))
        for i, (a, b) in enumerate(zip(sposes, jposes))]
    out["port_on_jax_covariances"] = dict(
        iterations=int(same.iterations), converged=bool(same.converged),
        t_err_m=pose_errors(same.transformation.numpy(), gt)[0], **summarize(rec2.solves[0]))
    out["port"] = dict(iterations=int(pres.iterations), converged=bool(pres.converged),
                       t_err_m=pose_errors(pres.transformation.numpy(), gt)[0])
    out["jax"] = dict(iterations=int(jres.iterations), converged=bool(jres.converged),
                      t_err_m=pose_errors(np.asarray(jres.transformation), gt)[0])
    del c
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    result = {"device": args.device}
    if args.device != "cpu":
        result["device_name"] = torch.cuda.get_device_name(0)
    for seed in args.seeds:
        pair = small_pair(seed)
        if args.stages:
            result[f"seed{seed}"] = stages(pair)
            print(f"seed {seed}: {result[f'seed{seed}']}", file=sys.stderr, flush=True)
            continue
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
