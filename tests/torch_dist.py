"""Multi-process worlds for the port's parallel tests, on the CPU with gloo.

`run_world(cases, world, payload)` runs `cases(rank, world, payload)` (a
function of this module, named "module:function") in each of `world`
processes joined into one gloo process group
(`fast_gicp_tpu_torch.parallel.distributed.spawn_world`); each rank's
returned dict of numpy values comes back to the caller, a list by rank.
The children import torch and the port, never JAX: the payload (numpy
arrays that the caller made, JAX references included) travels pickled.  A
rank that raises fails the whole world; a world that outlives `timeout`
seconds is killed.
"""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cases(rank, world, p):
    """A rank's cases, and the JAX modules it imported (none, the tests
    check)."""
    torch.set_num_threads(1)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    module, name = p["cases"].split(":")
    out = getattr(importlib.import_module(module), name)(rank, world, p["payload"])
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "fast_gicp_tpu"))
    return out


def run_world(cases: str, world: int, payload, timeout: float = 600.0, env: bool = False):
    """The per-rank result dicts of `cases` run in a gloo world of `world`
    processes on the CPU, each joined by `distributed.initialize`: its
    arguments, or with `env` the FAST_GICP_TPU_* variables."""
    from fast_gicp_tpu_torch.parallel.distributed import spawn_world

    return spawn_world(_run_cases, world, dict(cases=cases, payload=payload), timeout=timeout,
                       device="cpu", env=env)


def np_(a):
    """A tensor (or a tuple of them) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def lsq(res):
    """An LsqResult as a dict of numpy values."""
    return dict(T=np_(res.transformation), H=np_(res.hessian), error=np_(res.error),
                converged=bool(res.converged), iterations=int(res.iterations))


# -- tests/test_torch_sharded.py's world ---------------------------------------

def _align_calls(p):
    """name -> (single(device), sharded(mesh), config) for each align of the
    pair (tests/test_sharded.py's configs; VGICP also on the raw grid, NDT
    also P2D)."""
    from fast_gicp_tpu_torch.models.gicp import GICPConfig, gicp_align
    from fast_gicp_tpu_torch.models.ndt import NDTConfig, ndt_align
    from fast_gicp_tpu_torch.models.vgicp import VGICPConfig, vgicp_align
    from fast_gicp_tpu_torch.parallel import sharded
    from fast_gicp_tpu_torch.solver import LsqConfig

    lsq16 = LsqConfig(max_iterations=16)
    sp, tp, m, eye = p["source"], p["target"], p["mask"], p["guess"]
    sc, tc = p["scovs"], p["tcovs"]
    calls = {}
    cfg = GICPConfig(lsq=lsq16)
    calls["gicp"] = (lambda dev, cfg=cfg: gicp_align(sp, m, sc, tp, m, tc, eye, cfg, device=dev),
                     lambda mesh, cfg=cfg: sharded.gicp_align_sharded(mesh, sp, m, sc, tp, m, tc,
                                                                       eye, cfg), cfg)
    for name, dims in (("vgicp_hash", None), ("vgicp_raw", p["grid_dims"])):
        cfg = VGICPConfig(resolution=1.0, neighbor_search_method="direct7", grid_dims=dims,
                          lsq=lsq16)
        calls[name] = (
            lambda dev, cfg=cfg: vgicp_align(sp, m, sc, tp, m, tc, eye, cfg, device=dev),
            lambda mesh, cfg=cfg: sharded.vgicp_align_sharded(mesh, sp, m, sc, tp, m, tc, eye,
                                                              cfg), cfg)
    for mode in ("d2d", "p2d"):
        cfg = NDTConfig(resolution=2.0, distance_mode=mode, lsq=lsq16)
        calls[f"ndt_{mode}"] = (
            lambda dev, cfg=cfg: ndt_align(sp, m, tp, m, eye, cfg, device=dev),
            lambda mesh, cfg=cfg: sharded.ndt_align_sharded(mesh, sp, m, tp, m, eye, cfg), cfg)
    return calls


def _bit_equal(a, b):
    return all(bool(torch.equal(getattr(a, f), getattr(b, f))) for f in a._fields)


def sharded_cases(rank, world, p):
    """Each sharded align at world 1 (a subgroup of rank 0) and at world
    `world`, the single-device calls, the multi-process form, and the
    refusals: a source that does not divide, blocks of unequal shapes."""
    from fast_gicp_tpu_torch.parallel import distributed, mesh as mesh_mod, sharded

    out = {}
    calls = _align_calls(p)
    single = {name: s("cpu") for name, (s, _sh, _cfg) in calls.items()}
    mesh1 = sharded.make_mesh(1, device="cpu")
    mesh = sharded.make_mesh(device="cpu")
    out["mesh"] = (mesh.rank, mesh.size, str(mesh.device), mesh.backend, mesh1 is None)
    for name, (_s, sh, _cfg) in calls.items():
        out[f"single_{name}"] = lsq(single[name])
        if mesh1 is not None:
            res1 = sh(mesh1)
            out[f"world1_bit_equal_{name}"] = _bit_equal(res1, single[name])
        mesh_mod.reset_stats()
        res = sh(mesh)
        out[f"sharded_{name}"] = lsq(res)
        out[f"collectives_{name}"] = dict(mesh_mod.stats)
    n = p["source"].shape[0]
    rows = slice(rank * n // world, (rank + 1) * n // world)
    local = (p["source"][rows], p["mask"][rows], p["scovs"][rows], p["target"], p["mask"],
             p["tcovs"], p["guess"])
    out["multihost_gicp"] = lsq(distributed.gicp_align_multihost(
        distributed.make_global_mesh(device="cpu"), *local, calls["gicp"][2]))
    out["multihost_vgicp_hash"] = lsq(distributed.vgicp_align_multihost(
        mesh, *local, calls["vgicp_hash"][2]))
    try:
        sharded.gicp_align_sharded(mesh, p["source"][:-1], p["mask"][:-1], p["scovs"][:-1],
                                   p["target"], p["mask"], p["tcovs"], p["guess"])
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        distributed.shard_across(mesh, np.zeros((4 + rank, 3), np.float32))
        out["unequal_blocks"] = None
    except ValueError as e:
        out["unequal_blocks"] = str(e)
    out["process"] = (distributed.process_index(), distributed.process_count())
    return out


# -- tests/test_torch_pose_graph_sharded.py's world ----------------------------

def _graph_result(res):
    return dict(poses=np_(res.poses), error=float(res.error), iterations=int(res.iterations),
                converged=bool(res.converged))


def pose_graph_cases(rank, world, p):
    """The edge-sharded sparse solve of each graph of `p["graphs"]` (name ->
    (args, kwargs, SparsePGConfig fields)) on a mesh of 2 ranks (a
    subgroup) and of the whole world, with the collectives it ran."""
    from fast_gicp_tpu_torch.models import pose_graph_sparse as pgs
    from fast_gicp_tpu_torch.parallel import mesh as mesh_mod, sharded

    meshes = {2: sharded.make_mesh(2, device="cpu"), world: sharded.make_mesh(device="cpu")}
    out = {}
    for size, mesh in meshes.items():
        if mesh is None:
            continue
        for name, (args, kwargs, cfg) in p["graphs"].items():
            mesh_mod.reset_stats()
            pgs.reset_stats()
            res = pgs.optimize_pose_graph_sparse_sharded(mesh, *args, **kwargs,
                                                         config=pgs.SparsePGConfig(**cfg))
            out[f"{name}@{size}"] = _graph_result(res)
            out[f"{name}@{size}:collectives"] = dict(mesh_mod.stats)
            out[f"{name}@{size}:trials"] = pgs.optimize_pose_graph_sparse.trials
    return out


# -- tests/test_torch_sharded_map.py's world -----------------------------------

_MAP_FIELDS = ("sums", "coords", "lut", "num_voxels")


def _fields(state):
    """A MapState's fields as numpy."""
    return {f: np_(getattr(state, f)) for f in _MAP_FIELDS}


def _fill(mesh, state, frames, update):
    for pts, covs, mask in frames:
        state = update(mesh, state, pts, covs, mask)
    return state


def sharded_map_cases(rank, world, p):
    """The sharded map's state, storage, updates and aligns, and the sharded
    odometry, on the mesh of the whole world."""
    from fast_gicp_tpu_torch.models import scan_to_map as stm
    from fast_gicp_tpu_torch.ops.covariance import rbf_covariances
    from fast_gicp_tpu_torch.ops.voxelmap import _hash_coords, lookup_voxels
    from fast_gicp_tpu_torch.parallel import sharded_map as sm
    from fast_gicp_tpu_torch.parallel.sharded import make_mesh

    mesh1 = make_mesh(1, device="cpu")
    mesh = make_mesh(device="cpu")
    out = {}
    if mesh1 is not None:
        # a mesh of one runs the single odometry's frames, the per-frame cap
        # on new voxels binding from the first frame
        cfg = stm.ScanToMapConfig(**p["capped_config"])
        one = sm.ShardedScanToMapOdometry(cfg, mesh=mesh1, covariance="knn")
        single = stm.ScanToMapOdometry(cfg, covariance="knn", device="cpu")
        out["world1_odometry"] = [(one.process(s), single.process(s)) for s in p["drive"]]
    c = torch.as_tensor(p["owner_coords"])
    out["owner_of"] = np_(sm._owner_of(_hash_coords(c[:, 0], c[:, 1], c[:, 2]), world))

    # the replicated and the routed update from an empty map, then merged
    empty = sm.empty_sharded_map(mesh, p["cap_local"], 1.0)
    state = _fill(mesh, empty, p["frames"], sm.update_sharded_map)
    routed = _fill(mesh, empty, p["frames"], sm.update_sharded_map_routed)
    out["shard"] = _fields(state.shard)
    out["routed_shard"] = _fields(routed.shard)
    out["merged"] = _fields(sm.merge_sharded_map(state))

    # checkpoints: JAX's file read in, the port's written out
    out["loaded_shard"] = _fields(sm.load_sharded_map(mesh, p["jax_checkpoint"],
                                                      p["cap_local"]).shard)
    sm.save_sharded_map(p["port_checkpoint"], state)

    # re-anchoring in the mesh against the offline detour
    k = np.int32(p["shift_cells"])
    inmesh = sm.re_anchor_sharded_map(mesh, state, k)
    offline = sm.distribute_map(mesh, stm.re_anchor_map(sm.merge_sharded_map(state), k),
                                capacity_per_device=p["cap_local"])
    out["re_anchor_inmesh"] = _fields(inmesh.shard)
    out["re_anchor_offline"] = _fields(offline.shard)

    # growth keeps every shard's rows and lookups
    grown = sm.grow_sharded_map(mesh, state, 2 * p["cap_local"])
    nv = int(state.shard.num_voxels)
    vids = lookup_voxels(stm.map_as_voxelmap(grown.shard), grown.shard.coords[:nv])
    out["grow"] = dict(capacity=grown.shard.sums.shape[0], num_voxels=int(grown.shard.num_voxels),
                       rows_equal=bool(torch.equal(grown.shard.sums[:nv], state.shard.sums[:nv])),
                       lookups=np_(vids), nv=nv)

    # eviction (tests/test_scan_to_map.py::test_sharded_eviction_matches_policy)
    near, far, covs = p["near"], p["far"], p["eye_covs"]
    mask = np.ones(len(near), bool)
    ev = sm.empty_sharded_map(mesh, 512, 1.0)
    ev = sm.update_sharded_map(mesh, ev, near, covs, mask)
    ev = sm.update_sharded_map(mesh, ev, far, covs, mask)
    mass = [float(mesh.reduce(ev.shard.sums[:, 0].sum().reshape(1)))]
    ev = sm.compact_sharded_map(mesh, ev, np.zeros(3, np.float32), 50.0)
    mass.append(float(mesh.reduce(ev.shard.sums[:, 0].sum().reshape(1))))
    ev = sm.update_sharded_map(mesh, ev, far, covs, mask)
    mass.append(float(mesh.reduce(ev.shard.sums[:, 0].sum().reshape(1))))
    out["eviction_mass"] = mass

    # aligns against the sharded map and against the single map fused from
    # the same frames (a rebuilt lut, as the merged map's, can drop voxels
    # whose probe passes MAX_PROBE slots: every lookup of these maps hits)
    single = stm.empty_map(world * p["cap_local"], 1.0, device="cpu")
    for pts, covs, mask in p["frames"]:
        single = stm.update_map(single, pts, covs, mask, device="cpu")
    for name, st in (("single", single), ("shard", state.shard)):
        n = int(st.num_voxels)
        vids = lookup_voxels(stm.map_as_voxelmap(st), st.coords[:n])
        out[f"lookups_{name}"] = bool(torch.equal(vids.long(), torch.arange(n)))
    pts, msk, scovs, guess = p["align_scan"]
    cfg = stm.ScanToMapConfig(resolution=1.0, capacity=1 << 13)
    out["align_single"] = lsq(stm.align_to_map(single, pts, msk, scovs, guess, cfg,
                                               device="cpu"))
    out["align_replicated"] = lsq(sm.align_to_sharded_map(mesh, state, pts, msk, scovs, guess,
                                                          cfg))
    out["align_partitioned"] = lsq(sm.align_to_sharded_map_partitioned(
        mesh, state, pts, msk, scovs, guess, cfg))
    ndt = cfg._replace(objective="ndt_d2d")
    out["align_single_ndt"] = lsq(stm.align_to_map(single, pts, msk, scovs, guess, ndt,
                                                   device="cpu"))
    out["align_partitioned_ndt"] = lsq(sm.align_to_sharded_map_partitioned(
        mesh, state, pts, msk, scovs, guess, ndt))
    out["routing_load"] = np_(sm.sharded_routing_load(mesh, state, pts, msk, guess, cfg))

    # query-split RBF covariances against the single estimate
    rp, rm = p["rbf_points"], p["rbf_mask"]
    out["rbf_block"] = np_(sm.sharded_rbf_covariances(mesh, rp, rm))
    out["rbf_single"] = np_(rbf_covariances(rp, rm, device="cpu"))

    # the sharded odometry over the drive, and a growing one
    odo = sm.ShardedScanToMapOdometry(stm.ScanToMapConfig(resolution=1.0, capacity=1 << 13),
                                      mesh=mesh, covariance="knn")
    out["odometry"] = [odo.process(s) for s in p["drive"]]
    # the map's cap on new voxels a frame binding on the mesh of the world
    capped = sm.ShardedScanToMapOdometry(stm.ScanToMapConfig(**p["capped_config"]), mesh=mesh,
                                         covariance="knn")
    voxels = []
    for s in p["drive"]:
        capped.process(s)
        voxels.append(int(mesh.reduce(capped.state.shard.num_voxels.to(torch.int64).reshape(1))))
    out["capped_odometry"] = dict(poses=np.stack(capped.poses), voxels=voxels,
                                  merged=_fields(sm.merge_sharded_map(capped.state)))
    g = sm.ShardedScanToMapOdometry(
        stm.ScanToMapConfig(resolution=0.5, capacity=world * 64, max_capacity=world * 4096,
                            grow_check_every=1), mesh=mesh, covariance="knn")
    cap0 = g.state.shard.sums.shape[0]
    for s in p["growth_scans"]:
        g.process(s)
    out["odometry_growth"] = dict(cap0=cap0, cap=g.state.shard.sums.shape[0],
                                  finite=all(np.isfinite(q).all() for q in g.poses))
    return out
