"""The device ops the class paths of `chip_smoke.py` enqueue besides those
of `gicp_register_fresh`, counted from the code with the counter of
`tests/torch_ndt_freeze_ops.py` (the ops run on tensors of the "meta"
device; each aten operator the dispatcher reaches counts as one device op,
unless it is a view, an allocation or a CPU scalar).

The class paths share `gicp_register_fresh`'s kNN covariances, centroid
frame and LM solve; they differ in the target structure (GICP's row table,
or a hash or grid voxel map), the freeze of each linearization (GICP's 1-NN
search with `nn_search`'s eager packing and its two launches, or the voxel
lookup), the objective's set-up and the class's one read of the result
(`Registration._sync_pending`).  A registration's device ops are predicted
as gicp_register_fresh's measured count (PERF.md section 5: 765.6 at 6
linearizations and 6 LM trials) plus those differences:

    ops = 765.6 + setup + build + lins x (freeze + 2) - 6 x (gicp_freeze + 2)
          + (trials - 6) x 2 + sync

(a linearization: its freeze, one linearize launch and the solve's fill of
the converged flag; a trial: one trial launch and one flag read).  An aten
operator that launches several kernels on the card (torch.sort's radix
passes, three a hash build; cumsum's scan) counts once here.

    python tests/torch_class_ops.py

Prints one JSON line: each piece's ops and names, and for each class path
the constant and the per-linearization and per-trial terms of the model.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from fast_gicp_tpu_torch import device as _device  # noqa: E402
from fast_gicp_tpu_torch.models import gicp, vgicp  # noqa: E402
from fast_gicp_tpu_torch.ops import cuda_kernels, voxelmap  # noqa: E402
from tests.torch_ndt_freeze_ops import count  # noqa: E402

GICP_OPS = 765.6  # gicp_register_fresh, full-size pair (PERF.md section 5)
GICP_LINS = GICP_TRIALS = 6


def _nn_search_on_card(query, target, tmask, qmask=None):
    """The eager ops `cuda_kernels.nn_search` runs on CUDA tensors, and its
    two launches (the chunk boxes and the search) as two ops."""
    torch.cat([query, qmask.to(query.dtype)[:, None]], dim=1).contiguous()
    cuda_kernels._pack_masked(target, tmask)
    torch.zeros(2)  # stands for the two launches
    n = query.shape[0]
    return (torch.zeros(n, dtype=torch.int32, device=query.device),
            torch.zeros(n, device=query.device))


def _sync(res):
    """`Registration._sync_pending`'s device ops (its host copy: 1)."""
    torch.cat([res.transformation.reshape(-1), res.hessian.reshape(-1),
               res.converged.to(torch.float32).reshape(1),
               res.iterations.to(torch.float32).reshape(1)])
    torch.zeros(1)  # stands for the device-to-host copy


def main():
    # meta tensors: the resolution check admits any device here
    _device.resolve = torch.device
    rng = np.random.default_rng(0)
    n = 2048
    dev = "meta"
    pts = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32) * 8.0).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    covs = torch.as_tensor(rng.random((6, n)).astype(np.float32)).to(dev)
    x = torch.eye(4, device=dev)
    dims = (32, 32, 32)
    cfg_hash = vgicp.VGICPConfig()
    cfg_grid = vgicp.VGICPConfig(voxel_accumulation="multiplicative",
                                 neighbor_search_method="direct7", grid_dims=dims)
    gicp.nn_search = _nn_search_on_card
    pieces = {}

    def piece(name, fn):
        # a Python scalar stored by setitem (table[T] = _EMPTY) reaches the
        # dispatcher as scalar_tensor + copy_: one fill on the card
        names = count(fn)
        ops = [op for i, op in enumerate(names)
               if not (op == "scalar_tensor" and names[i + 1:i + 2] == ["copy_"])]
        pieces[name] = {"ops": len(ops), "names": ops}
        return len(ops)

    gicp_setup = piece("gicp objective set-up (row table included)",
                       lambda: gicp.make_gicp_objective(pts, mask, covs, pts, mask, covs,
                                                        gicp.GICPConfig(), with_freeze=True))
    _l, _e, gfreeze, _lf = gicp.make_gicp_objective(pts, mask, covs, pts, mask, covs,
                                                    gicp.GICPConfig(), with_freeze=True)
    gicp_freeze = piece("gicp freeze", lambda: gfreeze(x))
    res = gicp.LsqResult(x, torch.eye(6, device=dev), torch.zeros((), device=dev),
                         torch.zeros((), dtype=torch.bool, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))
    sync = piece("class result read", lambda: _sync(res))
    base = GICP_OPS - GICP_LINS * (gicp_freeze + 2) - GICP_TRIALS * 2 + sync
    out = {"pieces": pieces, "paths": {"fast_gicp_class": {
        "constant": base, "per_linearization": gicp_freeze + 2, "per_trial": 2}}}
    for path, cfg in (("fast_vgicp_hash", cfg_hash), ("fast_vgicp_grid_mult", cfg_grid)):
        offsets = voxelmap.neighbor_offsets(cfg.neighbor_search_method)
        build = piece(f"{path} map build", lambda cfg=cfg: vgicp._build_target_map(
            pts, mask, covs, cfg))
        vmap = vgicp._build_target_map(pts, mask, covs, cfg)
        setup = piece(f"{path} objective set-up", lambda: vgicp.make_vgicp_objective(
            pts, mask, covs, vmap, offsets, cfg))
        _l, _e, freeze, _lf = vgicp.make_vgicp_objective(pts, mask, covs, vmap, offsets, cfg)
        vfreeze = piece(f"{path} freeze", lambda: freeze(x))
        out["paths"][path] = {"constant": base - gicp_setup + setup + build,
                              "per_linearization": vfreeze + 2, "per_trial": 2}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
