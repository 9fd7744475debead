"""The device ops (kernel launches, fills, copies) that the NDT objective's
eager freeze and its set-up enqueue, counted from the code: the ops run on
tensors of the "meta" device (shapes only, no data), and each aten operator
that the dispatcher reaches counts as one device op on a CUDA tensor,
unless it is a view, an allocation or a Python scalar made on the CPU.  It
is the count behind the device ops a registration of the NDT paths saves
once the lookup runs inside the linearize kernel
(`cuda_ndt.ndt_linearize_lookup`).  Python scalars of `torch.where` count
as the CUDA build of torch launches them: `torch.where(cond, tensor,
scalar)` passes the scalar as a wrapped number (no device op), while
`torch.where(cond, scalar, scalar)` fills both scalars on the condition's
device (two).  A build may make the first kind's scalar on the
condition's device too (the meta device here does): this count leaves it
out, as torch.profiler on an H100 with torch 2.11 did
(`chip_smoke.py --ndt-timing`, PERF.md).

    python tests/torch_ndt_freeze_ops.py

Prints one JSON line: for each linearize mode, the ops of one eager freeze
(`cuda_ndt.ndt_freeze_pack`, the freeze every linearization ran before the
lookup form) and of one lookup-form call besides its launch (0), and the
ops of the objective's set-up in the earlier form (source columns, source
covariances and source validity tiled over the offsets, and the pack's zero
padding) and in this one (contiguous source columns and covariances); then
for each NDT path of `chip_smoke.py` the change in device ops a
registration: its linearizations and freezes times the freeze's ops, the
set-up's difference (D2D align's frozen phase looks its voxels up at the
frozen pose in the linearize launch: its freeze launches nothing).
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fast_gicp_tpu_torch.models.ndt import make_ndt_objective  # noqa: E402
from fast_gicp_tpu_torch.ops import cuda_ndt, soa  # noqa: E402
from fast_gicp_tpu_torch.ops.voxelmap import (  # noqa: E402
    build_ndt_grid_compact, build_ndt_raw_grid, neighbor_offsets,
)

# operators that enqueue nothing on the device
_FREE = {"empty", "empty_strided", "empty_like", "lift_fresh", "detach", "alias"}

# (path, mode, linearizations that freeze, extra freezes)
PATHS = (("ndt_d2d_fresh", "d2d", 7, 0), ("ndt_p2d_fresh", "p2d", 6, 0),
         ("ndt_d2d_align", "d2d_raw", 3, 1), ("ndt_p2d_align", "p2d_raw", 3, 0))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []
        self.scalars = []  # scalar_tensor fills not yet taken by an operator

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name == "scalar_tensor":
            if torch.device(kwargs.get("device") or "cpu").type != "cpu":
                self.scalars.append(name)
        else:
            # a lone scalar of torch.where is a wrapped number on the card
            if not (name == "where" and len(self.scalars) == 1):
                self.ops += self.scalars
            self.scalars = []
            if not func.is_view and name not in _FREE:
                self.ops.append(name)
        return func(*args, **kwargs)


def count(fn):
    with _Count() as c:
        fn()
    return c.ops


def _on(t, device):
    if hasattr(t, "_fields"):  # a voxel map
        return type(t)(*(_on(v, device) for v in t))
    return t.to(device) if isinstance(t, torch.Tensor) else t


def _inputs(mode, n=256, seed=0, device="meta"):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.normal(size=(4 * n, 3)).astype(np.float32) * 4.0)
    tmask = torch.ones(4 * n, dtype=torch.bool)
    dims = (32, 32, 32)
    vmap = (build_ndt_raw_grid(pts, tmask, 1.0, dims) if mode.endswith("_raw")
            else build_ndt_grid_compact(pts, tmask, 1.0, dims, budget=2 * n)[0])
    # the source state as the paths hand it over: means (N, 3), a bool mask,
    # and for D2D sym-6 covariance columns (6, N) sliced from a wider budget
    # as ndt_prepare_cloud trims them (fresh) or whole (align)
    means = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32) * 4.0)
    mask = torch.ones(n, dtype=torch.bool)
    covs = None
    if mode.startswith("d2d"):
        wide = torch.as_tensor(rng.random((6, 2 * n)).astype(np.float32))
        covs = wide.to(device)[:, :n] if mode == "d2d" else wide[:, :n].contiguous()
    return _on(means, device), _on(mask, device), _on(covs, device), _on(vmap, device)


def _earlier_setup(means, mask, covs, k):
    """The objective's set-up before the lookup form: tiled source columns
    and covariances, the tiled source validity and the pack's padding."""
    P = soa.cols_from_points(means)
    P.repeat(1, k).contiguous()
    if covs is not None:
        soa.sym_cols_from_covs(covs).repeat(1, k).contiguous()
    mask.repeat(k)
    torch.zeros((means.shape[0] * k, 2 if covs is None else 6))


def main():
    offsets = neighbor_offsets("direct7")
    k = len(offsets)
    x = torch.eye(4, device="meta")
    modes = {}
    for mode in cuda_ndt.MODES:
        means, mask, covs, vmap = _inputs(mode)
        obj = make_ndt_objective(means, mask, covs, vmap, offsets)
        freeze = count(lambda: cuda_ndt.ndt_freeze_pack(obj.p, obj.mask, x, vmap, offsets,
                                                        mode))
        setup_new = count(lambda: make_ndt_objective(means, mask, covs, vmap, offsets))
        setup_old = count(lambda: _earlier_setup(means, mask, covs, k))
        modes[mode] = {"freeze_ops": len(freeze), "freeze_op_names": freeze,
                       "setup_ops_earlier": len(setup_old), "setup_ops": len(setup_new)}
    paths = {}
    for path, mode, lins, freezes in PATHS:
        m = modes[mode]
        m_setup = m["setup_ops"] - m["setup_ops_earlier"]
        paths[path] = {"change": -(lins + freezes) * m["freeze_ops"] + m_setup,
                       "freezes_removed": lins + freezes, "setup_change": m_setup}
    print(json.dumps({"modes": modes, "paths": paths}))


if __name__ == "__main__":
    main()
