"""The `apps/align.py` twin (`python -m fast_gicp_tpu_torch.apps.align`) on
the CPU against the JAX package's root app and class API.

The bundled PCD pair is absent here, so the pair is frames 30/31 of the
seed-0 synthetic drive (a 250k-point world), written with
`utils.io.save_pcd`; the app loads, strips and downsamples it (0.5 m, the
PCL-compatible filter) as a user's run does.  The twin runs with
`--device cpu --n 2 --json`: its JSON has the root app's keys, and each
method's fitness is within rtol 1e-3 of the JAX class API's on the same
clouds (one align a method, built by the root app's own `build_methods`),
its pose within 1e-3.  On this pair JAX's CPU kNN covariances (another
candidate search than the port's fused contract, tests/test_torch_classes.py)
move no pose by 1e-3.  `--pipelined` gives the synchronous
poses; an unknown `--methods` name raises SystemExit with the list.  The 14
`--device-loop` bodies are held to the JAX package's in
tests/test_torch_align_rows_gicp.py, _vgicp.py and _ndt.py."""

import argparse
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from fast_gicp_tpu_torch.apps import align as app
from fast_gicp_tpu_torch.utils import downsample, io, synthetic

ROOT = pathlib.Path(__file__).resolve().parent.parent
DOWNSAMPLE = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def root_app():
    """The JAX package's `apps/align.py`, loaded from its file."""
    spec = importlib.util.spec_from_file_location("root_align_app", ROOT / "apps" / "align.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    world = synthetic.drive_world(rng, n=250_000)
    scans, _gt = synthetic.drive_scans(rng, n_frames=32, world=world)
    root = tmp_path_factory.mktemp("align_pair")
    io.save_pcd(str(root / "target.pcd"), scans[30])
    io.save_pcd(str(root / "source.pcd"), scans[31])
    clouds = {k: downsample.approximate_voxel_downsample(
        io.strip_near_origin(io.load_pcd(str(root / f"{k}.pcd"))), DOWNSAMPLE)
        for k in ("target", "source")}
    return root, clouds


@pytest.fixture(scope="module")
def app_json(files):
    root, _clouds = files
    out = root / "rows.json"
    rc = app.main([str(root / "target.pcd"), str(root / "source.pcd"), "--device", "cpu",
                   "--n", "2", "--downsample", str(DOWNSAMPLE), "--json", str(out)])
    assert rc == 0
    return json.loads(out.read_text())


def test_json_keys_are_the_root_apps(app_json, files):
    _root, clouds = files
    assert set(app_json) == {"n", "pipelined", "downsample", "n_target", "n_source", "methods"}
    assert app_json["n"] == 2 and app_json["pipelined"] is False
    assert app_json["n_target"] == len(clouds["target"])
    assert app_json["n_source"] == len(clouds["source"])
    assert list(app_json["methods"]) == ["fgicp", "vgicp", "vgicp_rbf", "ndt_d2d", "ndt_p2d"]
    for row in app_json["methods"].values():
        assert set(row) == {"single_ms", "2x_ms", "2x_reuse_ms", "fitness"}
        assert all(np.isfinite(v) for v in row.values())


def test_fitness_and_pose_match_the_jax_class_api(app_json, files):
    """rtol 1e-3 on the fitness (the app rounds it to 6 decimals), 1e-3 on
    the pose, against the root app's own method factories."""
    _root, clouds = files
    jmethods = root_app().build_methods(argparse.Namespace(methods=None))
    pmethods = app.build_methods(argparse.Namespace(methods=None, device="cpu"))
    assert list(jmethods) == list(pmethods)
    for name, make in jmethods.items():
        jreg = make()
        jreg.set_input_target(clouds["target"])
        jreg.set_input_source(clouds["source"])
        T_j = np.asarray(jreg.align())
        preg = pmethods[name]()
        preg.set_input_target(clouds["target"])
        preg.set_input_source(clouds["source"])
        T_p = preg.align()
        np.testing.assert_allclose(T_p, T_j, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(app_json["methods"][name]["fitness"],
                                   jreg.get_fitness_score(), rtol=1e-3, err_msg=name)


def test_pipelined_gives_the_synchronous_poses(files):
    """The --pipelined rows' loops (clear_covariances + align_async, then
    align_async + swap, one read at the end) end on the poses of the same
    loops run synchronously; the app's --pipelined JSON says so."""
    root, clouds = files
    for name in ("vgicp", "ndt_p2d"):
        make = app.build_methods(argparse.Namespace(methods=[name], device="cpu"))[name]
        sync, pipe = make(), make()
        for reg in (sync, pipe):
            reg.set_input_target(clouds["target"])
            reg.set_input_source(clouds["source"])
        for _ in range(2):
            sync.clear_covariances()
            sync.align()
            pipe.clear_covariances()
            pipe.align_async()
        np.testing.assert_array_equal(pipe.get_final_transformation(),
                                      sync.get_final_transformation())
        for _ in range(2):
            sync.align()
            sync.swap_source_and_target()
            pipe.align_async()
            pipe.swap_source_and_target()
        np.testing.assert_array_equal(pipe.get_final_transformation(),
                                      sync.get_final_transformation())
    out = root / "pipelined.json"
    assert app.main([str(root / "target.pcd"), str(root / "source.pcd"), "--device", "cpu",
                     "--n", "1", "--downsample", str(DOWNSAMPLE), "--pipelined",
                     "--methods", "ndt_p2d", "--json", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows["pipelined"] is True and list(rows["methods"]) == ["ndt_p2d"]


def test_unknown_method_raises_with_the_list(files):
    root, _clouds = files
    with pytest.raises(SystemExit, match="available: .*fgicp"):
        app.main([str(root / "target.pcd"), str(root / "source.pcd"), "--device", "cpu",
                  "--methods", "icp"])
