"""The port's hash-sharded persistent map (`fast_gicp_tpu_torch/parallel/
sharded_map.py`) in a world of two gloo processes on the CPU, held to the
JAX package's `parallel/sharded_map.py` (two devices of the conftest's CPU
mesh) and to the port's single-device map.

The scene is `tests/test_odometry._trajectory_scans` (seed 5, 4 frames, 0.2
m downsample): three frames fused at their ground-truth poses, identity
covariances at 1 cm, and the 4-frame drive of
`tests/test_scan_to_map.py::test_sharded_scan_to_map_matches_single`.
One spawned world (`tests/torch_dist.py`) runs every case.  Tolerances:
  * the ownership hash bit-equal to JAX's `_owner_hash_np`, on random and
    negative coordinates and the int32 extremes;
  * each shard's and the merged map's integer fields (coords, lut,
    num_voxels) exactly JAX's; the sums within 1e-5 of each row's largest
    |entry| (scatter-adds in another order);
  * checkpoints both ways: JAX's file loads into the port's shards equal to
    JAX's, the port's file loads in JAX equal to JAX's merged map;
  * the routed update's integer fields equal to the replicated update's
    (and JAX's routed update's);
  * re-anchoring in the mesh equal to the offline detour (merge,
    `re_anchor_map`, distribute): coords exact, sums within 1e-5 relative
    and 2e-3 absolute (the JAX test's bounds), and to JAX's in-mesh
    re-anchor's integers;
  * growth keeps every row and lookup; eviction leaves exactly the near
    mass (the JAX test's policy);
  * the aligns against the sharded map within 1e-4 of `align_to_map` on
    the single map fused from the same frames (every voxel of both found by
    its lookup; the merged map's rebuilt lut can drop a voxel whose probe
    passes MAX_PROBE slots, in both packages); the routed queries sum to the
    valid queries;
  * `sharded_rbf_covariances` within 1e-6 of the single estimate;
  * `ShardedScanToMapOdometry` on the drive within 5e-3 of the port's and
    JAX's `ScanToMapOdometry` and of JAX's sharded odometry, ATE under 0.05
    m (the JAX test's bounds); with the per-frame cap on new voxels binding,
    the shards admit the single map's voxels, frame by frame.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fast_gicp_tpu.models import scan_to_map as JM
from fast_gicp_tpu.ops.covariance import knn_covariances as jknn_covariances
from fast_gicp_tpu.parallel import sharded_map as J
from fast_gicp_tpu.parallel.sharded import make_mesh as jax_mesh
from fast_gicp_tpu.utils.downsample import voxel_downsample
from fast_gicp_tpu_torch import convert
from fast_gicp_tpu_torch.models import scan_to_map as TM
from fast_gicp_tpu_torch.parallel import sharded_map as T
from fast_gicp_tpu_torch.utils.kitti import ate_rmse
from fast_gicp_tpu_torch.utils.padding import pad_points

from tests.test_odometry import _trajectory_scans
from tests.torch_dist import run_world

WORLD = 2
CAP_LOCAL = 4096
SHIFT = (3, -2, 1)
INTS = ("coords", "lut", "num_voxels")


def _covs(n):
    return np.broadcast_to(0.01 * np.eye(3, dtype=np.float32), (n, 3, 3)).copy()


def _world_frame(scan, pose):
    pts, mask = pad_points(scan, 256)
    world = (pts @ np.asarray(pose, np.float32)[:3, :3].T
             + np.asarray(pose, np.float32)[:3, 3]).astype(np.float32)
    return world, _covs(len(pts)), mask


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_map")
    scans, gt = _trajectory_scans(np.random.default_rng(5), n_frames=4)
    drive = [voxel_downsample(s, 0.2) for s in scans]
    rng = np.random.default_rng(11)
    coords = np.concatenate([rng.integers(-10**6, 10**6, (4096, 3)),
                             [[-2**31, 2**31 - 1, 0], [-1, -1, -1], [0, 0, 0]]]).astype(np.int32)
    pts, mask = pad_points(drive[3], 256)
    scovs = np.asarray(jknn_covariances(jnp.asarray(pts), jnp.asarray(mask), k=20))
    rbf = rng.uniform(-10, 10, (2048, 3)).astype(np.float32)
    growth = [(rng.uniform(size=(512, 3)) * 20 - 10).astype(np.float32)
              + np.float32([i * 2.0, 0, 0]) for i in range(4)]
    near = (rng.random((128, 3)) * 8).astype(np.float32)
    return dict(owner_coords=coords, cap_local=CAP_LOCAL, gt=gt,
                capped_config=dict(resolution=1.0, capacity=1 << 13, new_per_frame_capacity=256),
                frames=[_world_frame(drive[f], gt[f]) for f in range(3)],
                jax_checkpoint=str(tmp / "jax.npz"), port_checkpoint=str(tmp / "port.npz"),
                shift_cells=SHIFT, near=near, far=near + np.float32(200.0), eye_covs=_covs(128),
                align_scan=(pts, mask, scovs, np.asarray(gt[3], np.float32)),
                rbf_points=rbf, rbf_mask=rng.uniform(size=2048) > 0.05, drive=drive,
                growth_scans=growth)


def _host(state):
    return {f: np.array(getattr(state, f)) for f in ("sums", "coords", "lut", "num_voxels",
                                                     "resolution")}


@pytest.fixture(scope="module")
def jax_maps(payload):
    """JAX's sharded maps from the same frames (host copies: the calls
    donate their input state), its checkpoint written to the payload's
    path."""
    mesh = jax_mesh(WORLD)

    def fill(update):
        st = J.empty_sharded_map(mesh, CAP_LOCAL, 1.0)
        for pts, covs, mask in payload["frames"]:
            st = update(mesh, st, jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask))
        return st

    state = fill(J.update_sharded_map)
    out = {"state": _host(state), "routed": _host(fill(J.update_sharded_map_routed)),
           "merged": _host(J.merge_sharded_map(state))}
    J.save_sharded_map(payload["jax_checkpoint"], state)
    out["loaded"] = _host(J.load_sharded_map(mesh, payload["jax_checkpoint"], CAP_LOCAL))
    out["re_anchor"] = _host(J.re_anchor_sharded_map(mesh, fill(J.update_sharded_map),
                                                     jnp.asarray(np.int32(SHIFT))))
    out["mesh"] = mesh
    return out


@pytest.fixture(scope="module")
def world(payload, jax_maps):
    return run_world("tests.torch_dist:sharded_map_cases", WORLD, payload)


class _Fields:
    def __init__(self, d):
        self.__dict__.update(d)


def _jax_shards(fields):
    return convert.sharded_map_shards_from_numpy(_Fields(fields), device="cpu")


def _same_ints(got, want, name):
    for f in INTS:
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]), err_msg=f"{name} {f}")


def _sums_close(got, want, name):
    g, w = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-30)
    assert (np.abs(g - w) <= 1e-5 * scale).all(), name


def test_owner_hash_is_jax_bit_for_bit(world, payload):
    c = payload["owner_coords"]
    want = J._owner_hash_np(c, WORLD)
    np.testing.assert_array_equal(T._owner_hash_np(c, WORLD), want)
    for out in world:
        np.testing.assert_array_equal(out["owner_of"], want)
    for d in (1, 3, 8):
        np.testing.assert_array_equal(T._owner_hash_np(c, d), J._owner_hash_np(c, d))


def test_shards_and_merged_map_equal_jax(world, jax_maps):
    shards = _jax_shards(jax_maps["state"])
    for rank, out in enumerate(world):
        want = {f: getattr(shards[rank], f) for f in ("sums",) + INTS}
        _same_ints(out["shard"], want, f"shard {rank}")
        _sums_close(out["shard"]["sums"], want["sums"], f"shard {rank}")
        # every voxel of the shard is owned by its rank
        nv = int(out["shard"]["num_voxels"])
        assert (T._owner_hash_np(out["shard"]["coords"][:nv], WORLD) == rank).all()
        _same_ints(out["merged"], jax_maps["merged"], "merged")
        _sums_close(out["merged"]["sums"], jax_maps["merged"]["sums"], "merged")


def test_checkpoints_round_trip_both_ways(world, payload, jax_maps):
    """JAX's checkpoint loads into the port's shards as JAX loads it (a
    loaded shard's lut is rebuilt, so it is held to JAX's loaded shards);
    the port's loads in JAX as JAX's own merged map, and reshards as JAX's
    checkpoint does."""
    shards = _jax_shards(jax_maps["loaded"])
    for rank, out in enumerate(world):
        want = {f: getattr(shards[rank], f) for f in ("sums",) + INTS}
        _same_ints(out["loaded_shard"], want, f"JAX's checkpoint on rank {rank}")
        np.testing.assert_array_equal(out["loaded_shard"]["sums"], want["sums"].numpy())
    back = JM.load_map(payload["port_checkpoint"])
    _same_ints(_host(back), jax_maps["merged"], "the port's checkpoint in JAX")
    _sums_close(np.asarray(back.sums), jax_maps["merged"]["sums"], "the port's checkpoint")
    resharded = J.load_sharded_map(jax_maps["mesh"], payload["port_checkpoint"], CAP_LOCAL)
    _same_ints(_host(resharded), jax_maps["loaded"], "the port's checkpoint, resharded in JAX")


def test_routed_update_equals_replicated_update(world, jax_maps):
    jax_routed = _jax_shards(jax_maps["routed"])
    for rank, out in enumerate(world):
        _same_ints(out["routed_shard"], out["shard"], f"routed {rank}")
        _sums_close(out["routed_shard"]["sums"], out["shard"]["sums"], f"routed {rank}")
        _same_ints(out["routed_shard"], {f: getattr(jax_routed[rank], f) for f in INTS},
                   f"JAX routed {rank}")


def test_re_anchor_in_mesh_equals_offline(world, jax_maps):
    jax_shards = _jax_shards(jax_maps["re_anchor"])
    for rank, out in enumerate(world):
        a, b = out["re_anchor_inmesh"], out["re_anchor_offline"]
        assert int(a["num_voxels"]) == int(b["num_voxels"])
        nv = int(a["num_voxels"])
        oa, ob = np.lexsort(a["coords"][:nv].T), np.lexsort(b["coords"][:nv].T)
        np.testing.assert_array_equal(a["coords"][:nv][oa], b["coords"][:nv][ob])
        np.testing.assert_allclose(a["sums"][:nv][oa], b["sums"][:nv][ob], rtol=1e-5, atol=2e-3)
        _same_ints(a, {f: getattr(jax_shards[rank], f) for f in INTS}, f"JAX re-anchor {rank}")


def test_grow_keeps_rows_and_eviction_follows_policy(world):
    for out in world:
        g = out["grow"]
        assert g["capacity"] == 2 * CAP_LOCAL and g["num_voxels"] == g["nv"] and g["rows_equal"]
        np.testing.assert_array_equal(np.sort(g["lookups"]), np.arange(g["nv"]))
        assert out["eviction_mass"] == [256.0, 128.0, 256.0]
        growth = out["odometry_growth"]
        assert growth["cap"] > growth["cap0"] and growth["finite"]


def test_aligns_against_the_sharded_map(world, payload):
    n_valid = int(payload["align_scan"][1].sum())
    for out in world:
        assert out["lookups_single"] and out["lookups_shard"]
        for name in ("align_replicated", "align_partitioned"):
            np.testing.assert_allclose(out[name]["T"], out["align_single"]["T"], atol=1e-4,
                                       err_msg=name)
            assert out[name]["converged"] == out["align_single"]["converged"]
        np.testing.assert_allclose(out["align_partitioned_ndt"]["T"],
                                   out["align_single_ndt"]["T"], atol=1e-4)
        np.testing.assert_array_equal(out[name]["T"], world[0][name]["T"])
        load = out["routing_load"]
        assert load.sum() == n_valid and load.min() >= n_valid // WORLD // 2


def test_sharded_rbf_covariances_match_single(world):
    got = np.concatenate([out["rbf_block"] for out in world])
    np.testing.assert_allclose(got, world[0]["rbf_single"], rtol=0, atol=1e-6)


def test_sharded_odometry_matches_single(world, payload):
    drive, gt = payload["drive"], payload["gt"]
    cfg = dict(resolution=1.0, capacity=1 << 13)
    port = TM.ScanToMapOdometry(TM.ScanToMapConfig(**cfg), covariance="knn", device="cpu")
    jax_single = JM.ScanToMapOdometry(JM.ScanToMapConfig(**cfg), covariance="knn")
    jax_sharded = J.ShardedScanToMapOdometry(JM.ScanToMapConfig(**cfg), mesh=jax_mesh(WORLD),
                                             covariance="knn")
    for f, s in enumerate(drive):
        p1, pj = port.process(s), np.asarray(jax_single.process(s))
        pjs = np.asarray(jax_sharded.process(s))
        for out in world:
            np.testing.assert_allclose(out["odometry"][f], p1, atol=5e-3)
            np.testing.assert_allclose(out["odometry"][f], pj, atol=5e-3)
            np.testing.assert_allclose(out["odometry"][f], pjs, atol=5e-3)
    assert ate_rmse(gt, world[0]["odometry"]) < 0.05
    for out in world[1:]:
        np.testing.assert_array_equal(np.stack(out["odometry"]), np.stack(world[0]["odometry"]))


def test_sharded_map_state_wraps_a_port_map():
    assert T.ShardedMapState._fields == ("shard", "mesh")
    assert torch.equal(torch.as_tensor(T._owner_hash_np(np.zeros((1, 3), np.int32), 4)),
                       torch.as_tensor([int(J._owner_hash_np(np.zeros((1, 3), np.int32), 4)[0])]))


def test_frame_runs_its_hooks(payload):
    """`ScanToMapOdometry`'s frame is its `_covs`, `_align` and `_fuse`
    hooks (the ones the sharded odometry overrides): a subclass whose hooks
    count their calls and defer to the base class's gives the same poses
    and map, bit for bit, through `process_chunk` as the base class through
    `process`, every frame covariances and a fusion, every frame but the
    anchor an align."""
    calls = {"_covs": 0, "_align": 0, "_fuse": 0}

    class Counted(TM.ScanToMapOdometry):
        def _covs(self, *a):
            calls["_covs"] += 1
            return super()._covs(*a)

        def _align(self, *a):
            calls["_align"] += 1
            return super()._align(*a)

        def _fuse(self, *a):
            calls["_fuse"] += 1
            return super()._fuse(*a)

    cfg = TM.ScanToMapConfig(resolution=1.0, capacity=1 << 13)
    drive = payload["drive"]
    plain = TM.ScanToMapOdometry(cfg, covariance="knn", device="cpu")
    counted = Counted(cfg, covariance="knn", device="cpu")
    for s in drive:
        plain.process(s)
    counted.process_chunk(drive)
    np.testing.assert_array_equal(np.stack(counted.poses), np.stack(plain.poses))
    for f in ("sums", "coords", "lut", "num_voxels"):
        assert torch.equal(getattr(counted.state, f), getattr(plain.state, f)), f
    n = len(drive)
    assert calls == {"_covs": n, "_align": n - 1, "_fuse": n}


def test_sharded_odometry_holds_the_map_cap_at_world_two(world, payload):
    """With `new_per_frame_capacity` (256) binding from the first frame, the
    shards of the world of two admit together the single map's new voxels:
    each frame's voxel count, and the merged map's coords, equal the port's
    and JAX's `ScanToMapOdometry`'s, and the poses lie within 5e-3 of both
    (the JAX test's bound).  JAX's sharded odometry admits 16,384 new voxels
    a shard whatever the config says: at this config its map grows frame by
    frame as the uncapped single map's (the default config, at which
    `test_sharded_odometry_matches_single` holds the port to it)."""
    cfg = payload["capped_config"]
    cap = cfg["new_per_frame_capacity"]
    uncapped = dict(cfg, new_per_frame_capacity=TM.ScanToMapConfig().new_per_frame_capacity)
    single = TM.ScanToMapOdometry(TM.ScanToMapConfig(**cfg), covariance="knn", device="cpu")
    free = TM.ScanToMapOdometry(TM.ScanToMapConfig(**uncapped), covariance="knn", device="cpu")
    jax_single = JM.ScanToMapOdometry(JM.ScanToMapConfig(**cfg), covariance="knn")
    jax_sharded = J.ShardedScanToMapOdometry(JM.ScanToMapConfig(**cfg), mesh=jax_mesh(WORLD),
                                             covariance="knn")
    voxels, free_voxels, jax_voxels, jax_sharded_voxels = [], [], [], []
    for s in payload["drive"]:
        for odo in (single, free, jax_single, jax_sharded):
            odo.process(s)
        voxels.append(int(single.state.num_voxels))
        free_voxels.append(int(free.state.num_voxels))
        jax_voxels.append(int(jax_single.state.num_voxels))
        jax_sharded_voxels.append(int(np.sum(np.asarray(jax_sharded.state.num_voxels))))
    assert voxels[0] == cap < free_voxels[0] and voxels == jax_voxels
    assert jax_sharded_voxels == free_voxels
    n = voxels[-1]
    want = np.sort(np.asarray(single.state.coords[:n]).view("i4,i4,i4"), axis=0)
    for out in world:
        got = out["capped_odometry"]
        assert got["voxels"] == voxels
        merged = got["merged"]["coords"][:int(got["merged"]["num_voxels"])]
        np.testing.assert_array_equal(np.sort(merged.view("i4,i4,i4"), axis=0), want)
        for ref in (single.poses, jax_single.poses):
            np.testing.assert_allclose(got["poses"], np.stack(ref), atol=5e-3)


def test_sharded_odometry_on_a_mesh_of_one_is_the_single_odometry(world):
    """On a mesh of one the sharded odometry's frames are the single
    odometry's, bit for bit, with `new_per_frame_capacity` (256) binding
    from the first frame: each shard admits the config's new voxels a
    frame, as `ScanToMapOdometry` does."""
    for sharded, single in world[0]["world1_odometry"]:
        np.testing.assert_array_equal(sharded, single)
