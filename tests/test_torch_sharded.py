"""The port's sharded aligns and multi-process launch
(`fast_gicp_tpu_torch/parallel/sharded.py`, `parallel/distributed.py`) in a
world of two gloo processes on the CPU, held to the port's single-device
calls and to the JAX package's sharded and single calls.

The pair is `tests/test_sharded.py`'s (512 points, seed 7, kNN covariances
from the JAX package), with its configs: GICP, VGICP (DIRECT7, on the hash
map and on the raw grid) and NDT at 2 m (D2D and P2D).  One spawned world
(`tests/torch_dist.py`) runs every case; the JAX references run in this
process, the sharded ones on two devices of the conftest's CPU mesh.
Tolerances:
  * world 2: poses within 1e-4 of the port's single call and of JAX's
    sharded and single calls (the JAX test's bound), `converged` equal,
    both ranks' results bit-equal;
  * world 1 (a subgroup of rank 0): bit-equal to the single call (a
    one-rank all-reduce is the identity, and the unfused trial gives the
    fused one's bits);
  * one all-reduce of 43 floats a linearization and one of 1 float a trial.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from fast_gicp_tpu.models.gicp import GICPConfig as JGICPConfig, gicp_align as jgicp_align
from fast_gicp_tpu.models.ndt import NDTConfig as JNDTConfig, ndt_align as jndt_align
from fast_gicp_tpu.models.vgicp import VGICPConfig as JVGICPConfig, vgicp_align as jvgicp_align
from fast_gicp_tpu.ops.covariance import knn_covariances as jknn_covariances
from fast_gicp_tpu.parallel import sharded as J
from fast_gicp_tpu.solver import LsqConfig as JLsqConfig
from fast_gicp_tpu_torch.ops.voxelmap import auto_grid_dims

from tests.torch_dist import run_world

WORLD = 2
POSE_TOL = 1e-4
NAMES = ("gicp", "vgicp_hash", "vgicp_raw", "ndt_d2d", "ndt_p2d")


@pytest.fixture(scope="module")
def pair():
    """tests/test_sharded.py's pair, as numpy."""
    rng = np.random.default_rng(7)
    n = 512
    base = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
    target = np.concatenate([base, (np.sin(base[:, :1]) + 0.2 * base[:, 1:])],
                            axis=1).astype(np.float32)
    c, s = np.cos(0.04), np.sin(0.04)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    source = target @ R.T + np.float32([0.15, -0.1, 0.05])
    mask = np.ones(n, bool)
    scovs = np.asarray(jknn_covariances(jnp.asarray(source), jnp.asarray(mask), k=10,
                                        approx=False))
    tcovs = np.asarray(jknn_covariances(jnp.asarray(target), jnp.asarray(mask), k=10,
                                        approx=False))
    return dict(source=source, target=target, mask=mask, scovs=scovs, tcovs=tcovs,
                guess=np.eye(4, dtype=np.float32),
                grid_dims=tuple(int(d) for d in auto_grid_dims(target, 1.0)))


@pytest.fixture(scope="module")
def world(pair):
    # the ranks join through the JAX package's FAST_GICP_TPU_* variables
    return run_world("tests.torch_dist:sharded_cases", WORLD, pair, env=True)


def _jax_calls(p):
    lsq16 = JLsqConfig(max_iterations=16)
    args = [jnp.asarray(p[k]) for k in ("source", "mask", "scovs", "target", "mask", "tcovs",
                                        "guess")]
    sp, m, sc, tp, _m, tc, eye = args
    out = {"gicp": (lambda: jgicp_align(*args, JGICPConfig(lsq=lsq16)),
                    lambda mesh: J.gicp_align_sharded(mesh, *args, JGICPConfig(lsq=lsq16)))}
    for name, dims in (("vgicp_hash", None), ("vgicp_raw", p["grid_dims"])):
        cfg = JVGICPConfig(resolution=1.0, neighbor_search_method="direct7", grid_dims=dims,
                           lsq=lsq16)
        out[name] = (lambda cfg=cfg: jvgicp_align(*args, cfg),
                     lambda mesh, cfg=cfg: J.vgicp_align_sharded(mesh, *args, cfg))
    for mode in ("d2d", "p2d"):
        cfg = JNDTConfig(resolution=2.0, distance_mode=mode, lsq=lsq16)
        out[f"ndt_{mode}"] = (lambda cfg=cfg: jndt_align(sp, m, tp, m, eye, cfg),
                              lambda mesh, cfg=cfg: J.ndt_align_sharded(mesh, sp, m, tp, m, eye,
                                                                        cfg))
    return out


@pytest.fixture(scope="module")
def jax_results(pair):
    mesh = J.make_mesh(WORLD)
    out = {}
    for name, (single, sharded) in _jax_calls(pair).items():
        s, sh = single(), sharded(mesh)
        out[name] = {k: (np.asarray(r.transformation), bool(r.converged))
                     for k, r in (("single", s), ("sharded", sh))}
    return out


def test_world_is_two_gloo_ranks_without_jax(world):
    for rank, out in enumerate(world):
        assert out["mesh"] == (rank, WORLD, "cpu", "gloo", rank != 0)
        assert out["process"] == (rank, WORLD)
        assert out["jax_modules"] == []


@pytest.mark.parametrize("name", NAMES)
def test_sharded_align_matches_single_and_jax(world, jax_results, name):
    got = world[0][f"sharded_{name}"]
    for other in world[1:]:
        for k in ("T", "H", "error"):
            np.testing.assert_array_equal(other[f"sharded_{name}"][k], got[k])
    single = world[0][f"single_{name}"]
    np.testing.assert_allclose(got["T"], single["T"], atol=POSE_TOL)
    assert got["converged"] == single["converged"]
    for kind in ("single", "sharded"):
        T, conv = jax_results[name][kind]
        np.testing.assert_allclose(got["T"], T, atol=POSE_TOL, err_msg=kind)
        assert got["converged"] == conv, kind


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_is_bit_equal_to_single(world, name):
    assert world[0][f"world1_bit_equal_{name}"] is True


@pytest.mark.parametrize("name", NAMES)
def test_one_packed_all_reduce_a_linearization(world, name):
    """Each linearization sums [err, H, b] in one all-reduce of 43 floats,
    each trial the error in one of a float: bytes = 172 L + 4 (C - L)."""
    stats = world[0][f"collectives_{name}"]
    iters = world[0][f"sharded_{name}"]["iterations"]
    c = stats["collectives"]
    assert stats["all_reduce"] == c and c > iters
    assert stats["bytes"] == 172 * iters + 4 * (c - iters)


def test_multihost_forms_equal_the_sharded_aligns(world):
    for out in world:
        for name in ("gicp", "vgicp_hash"):
            for k in ("T", "H", "error"):
                np.testing.assert_array_equal(out[f"multihost_{name}"][k],
                                              out[f"sharded_{name}"][k])


def test_check_divisible_raises_as_jax(world, pair):
    mesh = J.make_mesh(WORLD)
    args = [jnp.asarray(pair[k][:-1] if k in ("source", "scovs") else pair[k])
            for k in ("source", "mask", "scovs", "target", "mask", "tcovs", "guess")]
    args[1] = args[1][:-1]
    with pytest.raises(ValueError) as e:
        J.gicp_align_sharded(mesh, *args)
    for out in world:
        assert out["indivisible"] == str(e.value)


def test_shard_across_refuses_unequal_blocks(world):
    for out in world:
        assert out["unequal_blocks"].startswith("ranks hold blocks of different shapes")


@pytest.mark.parametrize("module", ["sharded", "distributed", "sharded_map"])
def test_parallel_modules_carry_the_jax_public_names(module):
    """Every public name the JAX module defines (or, DATA_AXIS, exports)
    has its counterpart in the port's module of the same name."""
    import importlib

    jm = importlib.import_module(f"fast_gicp_tpu.parallel.{module}")
    tm = importlib.import_module(f"fast_gicp_tpu_torch.parallel.{module}")
    names = [n for n, v in vars(jm).items() if not n.startswith("_")
             and (getattr(v, "__module__", None) == jm.__name__ or n == "DATA_AXIS")]
    assert names and not [n for n in names if not hasattr(tm, n)]


def test_initialize_refuses_a_partial_world():
    """A configured world that lacks a setting raises before any group
    starts (the JAX package's `initialize` would pass it on)."""
    import torch.distributed as dist

    from fast_gicp_tpu_torch.parallel import distributed

    with pytest.raises(ValueError, match="coordinator address, the process count"):
        distributed.initialize(coordinator_address="localhost:1", num_processes=2,
                               device="cpu")
    assert not dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
