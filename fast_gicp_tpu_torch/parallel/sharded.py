"""Multi-device registration: the source split across the ranks, the target
and the pose replicated (port of `fast_gicp_tpu.parallel.sharded`).

Each rank linearizes its own block of the source against the whole target
and the ranks sum the normal equations [err, H, b] with one 43-float
all-reduce a linearization, and the error with one a trial; every rank then
takes the same LM step from the same sums, so all of them walk the same
trajectory (the reference's per-thread H/b accumulators,
fast_gicp_impl.hpp:162-211: thread -> rank, serial sum -> all-reduce).  The
trials run in the unfused order of `solver.lsq_solve` (the standalone trial
kernel and the error kernel with the trial off), since a rank's trial
launch would see only its own error.

`*_sharded(mesh, ...)` keep the JAX package's signatures: every rank passes
the whole arrays and takes its contiguous block of the source rows, as
`P(axis)` splits them; the row count must divide by the mesh size.  Each
align runs in the target-centroid frame (`models.base.centered_frame_align`)
with the single-device align's solve, `refresh_iterations` included (the
JAX package's sharded aligns run one phase): on a mesh of one the result is
the single-device call's, bit for bit.
"""

from __future__ import annotations

from .. import device as _device
from ..models import ndt as _ndt
from ..models.base import centered_frame_align
from ..models.gicp import GICPConfig, _gicp_solve
from ..models.ndt import NDTConfig
from ..models.vgicp import VGICPConfig, _vgicp_solve
from ..precision import f32_matmuls
from .mesh import DATA_AXIS, Mesh, build

__all__ = ["DATA_AXIS", "Mesh", "make_mesh", "gicp_align_sharded", "vgicp_align_sharded",
           "ndt_align_sharded"]


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS, device="cuda",
              backend: str | None = None) -> Mesh | None:
    """The 1-D mesh over the first `n_devices` ranks of the default process
    group (all of them by default), one device a rank: `device` is "cuda"
    (each rank's card is its local rank modulo the visible cards), an
    explicit "cuda:i" (two ranks may then share one card, over gloo) or
    "cpu".  Without a process group it starts a world of one
    (`distributed.initialize`).  The backend is nccl for CUDA and gloo for
    the CPU unless `backend` names one.  Every rank must call it; a rank
    outside a smaller mesh gets None.  Runs on `device` (CUDA unless the
    caller asks for the CPU)."""
    return build(n_devices, axis, device, backend)


def _check_divisible(n: int, mesh: Mesh, axis: str):
    size = mesh.shape[axis]
    if n % size != 0:
        raise ValueError(f"point count {n} not divisible by mesh axis {size}")


def _rows(mesh: Mesh):
    """rows(n): this rank's contiguous block of n rows (n divisible by the
    mesh size)."""
    def rows(n):
        _check_divisible(n, mesh, mesh.axis)
        m = n // mesh.size
        return slice(mesh.rank * m, (mesh.rank + 1) * m)

    return rows


def _block(mesh, source, source_mask, source_covs):
    """This rank's block of the source, its mask and covariances ((N, 3, 3)
    rows or (6, N) sym-6 columns)."""
    sl = _rows(mesh)(source.shape[0])
    covs = source_covs[:, sl] if source_covs.dim() == 2 else source_covs[sl]
    return source[sl], source_mask[sl], covs


def _on_mesh(mesh, *arrays):
    """(points, mask, covs) triples and trailing poses -> tensors on the
    rank's device: float32, masks bool."""
    return [_device.as_bool(a, mesh.device) if i % 3 == 1 else _device.as_f32(a, mesh.device)
            for i, a in enumerate(arrays)]


def _gicp_local(mesh, source, source_mask, source_covs, target, target_mask, target_covs,
                guess, config):
    """The GICP align of this rank's source block, summed across the mesh."""
    source, source_mask, source_covs, target, target_mask, target_covs, guess = _on_mesh(
        mesh, source, source_mask, source_covs, target, target_mask, target_covs, guess)

    def run(src_c, tgt_c, x0):
        return _gicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask, target_covs,
                           x0, config, reduce=mesh.reduce)

    return centered_frame_align(run, source, target, target_mask, guess)


def _vgicp_local(mesh, source, source_mask, source_covs, target, target_mask, target_covs,
                 guess, config):
    """The VGICP align of this rank's source block against the whole map
    (built on every rank), summed across the mesh."""
    source, source_mask, source_covs, target, target_mask, target_covs, guess = _on_mesh(
        mesh, source, source_mask, source_covs, target, target_mask, target_covs, guess)

    def run(src_c, tgt_c, x0):
        return _vgicp_solve(src_c, source_mask, source_covs, tgt_c, target_mask, target_covs,
                            x0, config, reduce=mesh.reduce)

    return centered_frame_align(run, source, target, target_mask, guess)


@f32_matmuls
def gicp_align_sharded(mesh: Mesh, source, source_mask, source_covs, target, target_mask,
                       target_covs, guess, config: GICPConfig = GICPConfig()):
    """GICP align with the source points (and covariances, (N, 3, 3) or
    (6, N) columns) split over the mesh: each rank searches the 1-NN
    correspondences of its block in the whole target."""
    src = _on_mesh(mesh, source, source_mask, source_covs)
    return _gicp_local(mesh, *_block(mesh, *src), target, target_mask, target_covs, guess,
                       config)


@f32_matmuls
def vgicp_align_sharded(mesh: Mesh, source, source_mask, source_covs, target, target_mask,
                        target_covs, guess, config: VGICPConfig = VGICPConfig()):
    """VGICP align: the source split, the target's voxel map (the raw grid
    with `grid_dims`, the hash map without) built on every rank; each rank
    looks up its own block's correspondences."""
    src = _on_mesh(mesh, source, source_mask, source_covs)
    return _vgicp_local(mesh, *_block(mesh, *src), target, target_mask, target_covs, guess,
                        config)


@f32_matmuls
def ndt_align_sharded(mesh: Mesh, source, source_mask, target, target_mask, guess,
                      config: NDTConfig = NDTConfig()):
    """NDT align, the target map built on every rank: P2D splits the raw
    source points, D2D the compacted source voxels (every rank builds the
    source's voxel statistics, then takes its block of the
    `max_source_voxels` rows, which must divide by the mesh size)."""
    _ndt._check_mode(config)
    dev = mesh.device
    source, target, guess = (_device.as_f32(a, dev) for a in (source, target, guess))
    source_mask, target_mask = _device.as_bool(source_mask, dev), _device.as_bool(target_mask, dev)

    def run(src_c, tgt_c, x0):
        obj = _ndt._align_objective(src_c, source_mask, tgt_c, target_mask, config,
                                    rows=_rows(mesh), reduce=mesh.reduce)
        return _ndt._solve(obj, x0, config)

    return centered_frame_align(run, source, target, target_mask, guess)
