"""Port vs JAX: the native host paths of `fast_gicp_tpu_torch.native`
(`build`, `voxel_downsample`, `load_kitti_bin`), the native branch of
`utils.downsample.voxel_downsample`, and the package's `merge_maps` and
`pose_error` exports.

The library is built with the port's `build()` into a copy of the repo's
`native/` tree under the test's temporary directory (cmake and a C++
toolchain), so that no other test's build of `native/build/` races it; the
port's loader is pointed at that copy for this module.  The native filter
is held bit for bit to the numpy path of both packages."""

import shutil

import numpy as np
import pytest

from fast_gicp_tpu import native as jnative
from fast_gicp_tpu.utils import downsample as jdownsample
from fast_gicp_tpu_torch import native
from fast_gicp_tpu_torch.utils import downsample, io


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's `build()` on a copy of native/ (its CMakeLists.txt and
    sources); the loader reads the copy's library for this module."""
    root = tmp_path_factory.mktemp("native")
    src = native._NATIVE_DIR
    shutil.copy(f"{src}/CMakeLists.txt", root / "CMakeLists.txt")
    shutil.copytree(f"{src}/src", root / "src")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "_NATIVE_DIR", str(root))
    mp.setattr(native, "_LIB_PATHS", [str(root / "build" / "libfast_gicp_native.so")])
    mp.setattr(native, "_lib", None)
    ok = native.build()
    yield ok, root
    mp.undo()
    native._lib = None


def test_build_compiles_in_the_tree_and_loads(built):
    ok, root = built
    if shutil.which("cmake") is None:
        pytest.skip("cmake is not installed: build() cannot run")
    assert ok and native.available()
    assert (root / "build" / "libfast_gicp_native.so").is_file()
    assert native.quantize_available()


def test_build_reports_failure_without_cmake(built, monkeypatch):
    """A build that cannot run returns False and leaves the loaded library."""
    monkeypatch.setenv("PATH", "")
    assert native.build() is False


@pytest.mark.parametrize("res", [0.7, 0.25])
def test_native_downsample_bit_equal_to_numpy_and_jax(built, rng, monkeypatch, res):
    """Bit for bit (floor(p / res), float64 sums in point order, voxel-key
    sorted output): the native filter, the port's numpy path and the JAX
    package's numpy path; `utils.downsample.voxel_downsample` takes the
    native branch when the library is built."""
    assert built[0]
    pts = (rng.random((5000, 3)) * 30 - 15).astype(np.float32)
    got = native.voxel_downsample(pts, res)
    calls = []
    real = native.voxel_downsample
    monkeypatch.setattr(native, "voxel_downsample",
                        lambda p, r: calls.append(len(p)) or real(p, r))
    dispatched = downsample.voxel_downsample(pts, res)
    assert calls == [5000]
    np.testing.assert_array_equal(dispatched, got)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(downsample.voxel_downsample(pts, res), got)
    monkeypatch.setattr(jnative, "available", lambda: False)
    np.testing.assert_array_equal(jdownsample.voxel_downsample(pts, res), got)


def test_native_branch_drops_non_finite_rows(built, rng, monkeypatch):
    """NaN and inf rows are dropped before the native filter, as the numpy
    path drops them; float64 input is taken as float32 (exact here)."""
    assert built[0]
    pts = (rng.random((3000, 3)) * 20).astype(np.float32)
    pts[[5, 77, 2100], [0, 2, 1]] = [np.nan, np.inf, -np.inf]
    got = downsample.voxel_downsample(pts.astype(np.float64), 0.5)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(got, downsample.voxel_downsample(pts, 0.5))
    all_bad = np.full((4, 3), np.nan, np.float32)
    monkeypatch.undo()
    assert downsample.voxel_downsample(all_bad, 0.5).shape == (0, 3)


def test_native_downsample_passthrough_without_resolution(built, rng):
    pts = rng.random((100, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.voxel_downsample(pts, -1.0), pts)


def test_load_kitti_bin_native_equals_numpy(built, tmp_path, rng, monkeypatch):
    """x, y, z of each x, y, z, reflectance record, natively and with numpy
    (the JAX package's loader gives the same)."""
    assert built[0]
    data = (rng.random((100, 4)) * 50).astype(np.float32)
    path = tmp_path / "000000.bin"
    data.tofile(path)
    got = native.load_kitti_bin(str(path))
    assert got.dtype == np.float32 and got.shape == (100, 3)
    np.testing.assert_array_equal(got, data[:, :3])
    np.testing.assert_array_equal(got, io.load_kitti_bin(str(path)))
    np.testing.assert_array_equal(got, jnative.load_kitti_bin(str(path)))
    with pytest.raises(FileNotFoundError):
        native.load_kitti_bin(str(tmp_path / "missing.bin"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATHS", [])
    np.testing.assert_array_equal(native.load_kitti_bin(str(path)), data[:, :3])


def test_merge_maps_and_pose_error_are_exported():
    import fast_gicp_tpu_torch as port
    from fast_gicp_tpu_torch.models.metrics import pose_error
    from fast_gicp_tpu_torch.models.scan_to_map import merge_maps

    assert port.merge_maps is merge_maps and port.pose_error is pose_error
    T = np.eye(4)
    T[:3, 3] = [0.3, 0.0, 0.4]
    t_err, r_err = port.pose_error(np.eye(4), T)
    assert abs(t_err - 0.5) < 1e-12 and abs(r_err) < 1e-9
