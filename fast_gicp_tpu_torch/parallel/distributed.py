"""The multi-process launch (port of `fast_gicp_tpu.parallel.distributed`).

Every process runs the same program with one device, `initialize` joins them
into one `torch.distributed` world, and `make_global_mesh` is the mesh over
all of them.  `shard_across` and `replicate` put a process's data on its
device, checking with one small collective what they can (the row counts,
the replicated shapes).  `gicp_align_multihost` and `vgicp_align_multihost`
take each process's own source rows; every process gets the same pose.
`spawn_world` starts such a world on one host, one process a rank.

Per linearization the ranks exchange one 43-float all-reduce of [err, H, b]
and per LM trial one of the error, so scaling rides the collective's
latency, not its bandwidth.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

from .. import device as _device
from .mesh import DATA_AXIS, Mesh, build, default_backend, free_port

_ENV_COORDINATOR = "FAST_GICP_TPU_COORDINATOR"
_ENV_NUM_PROCESSES = "FAST_GICP_TPU_NUM_PROCESSES"
_ENV_PROCESS_ID = "FAST_GICP_TPU_PROCESS_ID"
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, local_device_ids: list[int] | None = None,
               backend: str | None = None, device="cuda") -> None:
    """Join (or start) the process group of a multi-process run.

    Each setting is taken from, in this order: the explicit argument; the
    JAX package's FAST_GICP_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}
    variables (one runbook serves both packages; the coordinator is
    "host:port"); torchrun's `env://` variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  With none of them set it makes a world of one (this
    process alone, on a free localhost port).  When a world is configured
    and `init_process_group` fails, the error is raised.

    `backend` defaults to nccl for a CUDA `device` and gloo for the CPU;
    `local_device_ids[0]` is the card this process uses (its LOCAL_RANK
    otherwise).  A call once the group exists does nothing."""
    if dist.is_initialized():
        return
    dev = _device.resolve(device)
    backend = backend or default_backend(dev)
    if local_device_ids:
        os.environ["LOCAL_RANK"] = str(int(local_device_ids[0]))
    if coordinator_address is None:
        coordinator_address = os.environ.get(_ENV_COORDINATOR)
    if num_processes is None and _ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[_ENV_NUM_PROCESSES])
    if process_id is None and _ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[_ENV_PROCESS_ID])
    if coordinator_address is not None or num_processes is not None:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator address, the "
                             "process count and this process's id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)


def make_global_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
                     device="cuda", backend: str | None = None) -> Mesh | None:
    """The 1-D mesh over every process of the world (its first `n_devices`
    ranks if given), one device a rank; ranks keep their order, so each
    process's rows stay one contiguous block.  Runs on `device` (CUDA
    unless the caller asks for the CPU); see `sharded.make_mesh`."""
    return build(n_devices, axis, device, backend)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _shape_row(t: torch.Tensor, lead: bool) -> torch.Tensor:
    """(ndim, shape padded to 4 dims) as int64 on the host; `lead` keeps the
    leading dimension."""
    shape = list(t.shape) if lead else [0] + list(t.shape[1:])
    if len(shape) > 4:
        raise ValueError(f"arrays of at most 4 dimensions, not {tuple(t.shape)}")
    return torch.tensor([len(shape)] + shape + [0] * (4 - len(shape)), dtype=torch.int64)


def _gather_shapes(mesh: Mesh, row: torch.Tensor) -> torch.Tensor:
    return mesh.all_gather(row.to(mesh.device)[None]).cpu()


def shard_across(mesh: Mesh, local_data, axis: str = DATA_AXIS) -> torch.Tensor:
    """This process's contiguous block of a sharded array (the rows of the
    global array that follow the lower ranks' blocks) as a tensor on the
    rank's device.  Every rank's block must have the same shape, as the
    JAX package's even split needs; one all-gather of the shapes checks it."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's ({mesh.axis!r})")
    t = torch.as_tensor(local_data).to(mesh.device)
    shapes = _gather_shapes(mesh, _shape_row(t, lead=True))
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(f"ranks hold blocks of different shapes: {shapes.tolist()}")
    return t


def replicate(mesh: Mesh, data) -> torch.Tensor:
    """A replicated array (every process passes the same whole array: the
    target cloud, a map, the initial guess) as a tensor on the rank's
    device; one all-gather checks that every rank's shape is the same."""
    t = torch.as_tensor(data).to(mesh.device)
    shapes = _gather_shapes(mesh, _shape_row(t, lead=True))
    if not bool((shapes == shapes[0]).all()):
        raise ValueError(f"a replicated array differs in shape across ranks: "
                         f"{shapes.tolist()}")
    return t


def gicp_align_multihost(mesh: Mesh, local_source, local_source_mask, local_source_covs,
                         target, target_mask, target_covs, guess, config=None):
    """GICP align across processes: each process passes its own block of the
    source (points, mask, covariances (n, 3, 3)) and the whole target; the
    LsqResult is the same on every process.  See
    `sharded.gicp_align_sharded`."""
    from ..models.gicp import GICPConfig
    from .sharded import _gicp_local

    return _gicp_local(
        mesh, shard_across(mesh, local_source), shard_across(mesh, local_source_mask),
        shard_across(mesh, local_source_covs), replicate(mesh, target),
        replicate(mesh, target_mask), replicate(mesh, target_covs), replicate(mesh, guess),
        config or GICPConfig())


def vgicp_align_multihost(mesh: Mesh, local_source, local_source_mask, local_source_covs,
                          target, target_mask, target_covs, guess, config=None):
    """VGICP align across processes (the voxel map built on every process,
    the source split); see `gicp_align_multihost`."""
    from ..models.vgicp import VGICPConfig
    from .sharded import _vgicp_local

    return _vgicp_local(
        mesh, shard_across(mesh, local_source), shard_across(mesh, local_source_mask),
        shard_across(mesh, local_source_covs), replicate(mesh, target),
        replicate(mesh, target_mask), replicate(mesh, target_covs), replicate(mesh, guess),
        config or VGICPConfig())


def _spawned_rank(rank, fn, world, port, payload_path, out_dir, device, backend, env):
    """One rank of `spawn_world`: join the world, run fn, pickle its result."""
    if env:  # the JAX package's variables, as a multi-host runbook sets them
        os.environ.update({_ENV_COORDINATOR: f"localhost:{port}",
                           _ENV_NUM_PROCESSES: str(world), _ENV_PROCESS_ID: str(rank)})
        initialize(backend=backend, device=device)
    else:
        initialize(f"localhost:{port}", world, rank, backend=backend, device=device)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = fn(rank, world, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, world: int, payload, timeout: float = 600.0, device="cuda",
                backend: str | None = None, env: bool = False) -> list:
    """Run `fn(rank, world, payload)` in `world` spawned processes on this
    host, joined into one process group on a free localhost port
    (`initialize`: its arguments, or with `env` the FAST_GICP_TPU_*
    variables), and return their results, a list by rank.

    `fn` is a module-level function and `payload` and the results travel
    pickled.  Each rank runs on `device` (CUDA unless the caller asks for
    the CPU; two ranks on one card need `backend="gloo"`).  A rank that
    raises fails the call; a world that outlives `timeout` seconds is
    killed and raises TimeoutError.  Build the CUDA kernels before the
    call: the build lock holds only within a process."""
    import torch.multiprocessing as mp

    device = _device.resolve(device)
    with tempfile.TemporaryDirectory() as tmp:
        payload_path = os.path.join(tmp, "payload.pkl")
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        ctx = mp.start_processes(
            _spawned_rank, args=(fn, world, free_port(), payload_path, tmp, str(device),
                                 backend, env),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world} outlived {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
