"""The device tally of kernel runs (`ops.tally`), on the CPU: each kernel
wrapper's call adds one to its own slot, and a call in a counted form (a
linearize reading rows by index, an NDT lookup) one to the form's slot too
(on CUDA the kernel adds them as it runs, so a graph's replays count too;
on the CPU the wrapper stands for the launch); the plain versions add
nothing."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fast_gicp_tpu_torch.ops import cuda_kernels, cuda_linearize, cuda_ndt, cuda_solver, tally
from fast_gicp_tpu_torch.solver import LsqConfig

N = 256  # one kNN query tile


def _inputs():
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.normal(scale=2.0, size=(N, 3)).astype(np.float32))
    mask = torch.ones(N, dtype=torch.bool)
    center = torch.zeros(3)
    p = pts.T.contiguous()
    ca = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0]).repeat(N, 1).T.contiguous()
    x = torch.eye(4)
    rows = torch.zeros(N, 16)
    rows[:, 0:3] = pts
    rows[:, [3, 7, 11]] = 1.0
    rows[:, 12] = 1.0
    aux = torch.zeros(10, N)
    aux[[0, 3, 5, 6]] = 1.0
    aux[7:10] = p
    cidx = torch.zeros(1, 1, dtype=torch.int32)
    return dict(pts=pts, mask=mask, center=center, p=p, ca=ca, x=x, rows=rows, aux=aux,
                cidx=cidx, valid=torch.ones(N))


def _call(name, a):
    """One CPU call of kernel `name`'s wrapper ("name[form]": in that form)."""
    pts, mask, center = a["pts"], a["mask"], a["center"]
    if name.endswith("[idx]"):
        return getattr(cuda_linearize, name[:-5])(a["p"], a["ca"], a["x"], a["rows"],
                                                  a["valid"], idx=torch.arange(N))
    if name.endswith("[lookup]"):
        from fast_gicp_tpu_torch.ops import voxelmap

        mode = name[4:-8]
        vmap = (voxelmap.build_ndt_raw_grid(pts, mask, 1.0, (8, 8, 8)) if mode.endswith("_raw")
                else voxelmap.build_ndt_grid_compact(pts, mask, 1.0, (8, 8, 8), 512)[0])
        return cuda_ndt.ndt_linearize_lookup(a["p"], a["ca"], mask, a["x"], vmap,
                                             np.zeros((1, 3), np.int32), mode)
    if name == "rbf_moments":
        return cuda_kernels.rbf_moments(pts, mask, pts, mask, center, 1.0, 3.0)
    if name == "nn_search":
        return cuda_kernels.nn_search(pts, pts, mask)
    if name == "knn_moments":
        return cuda_kernels.knn_moments(pts, mask, pts, mask, a["cidx"], 8, cand_tile=256)
    if name == "knn_slab":
        return cuda_kernels.knn_slab(pts, mask, pts, mask, a["cidx"], 8)
    if name == "radius_count":
        return cuda_kernels.radius_count(pts, mask, pts, mask, center, torch.tensor([1.0, 4.0]))
    if name == "radius_window":
        return cuda_kernels.radius_window(pts, mask, pts, mask, center, torch.full((N,), 2.0))
    if name in ("linearize", "linearize_raw"):
        return getattr(cuda_linearize, name)(a["p"], a["ca"], a["x"], a["rows"], a["valid"])
    if name == "error":
        return cuda_linearize.error(a["p"], a["x"], a["aux"])
    if name.startswith("ndt_") and name != "ndt_error":
        return cuda_ndt.ndt_linearize(a["p"], a["ca"], a["x"], a["rows"], 1.0, name[4:])
    if name == "ndt_error":
        return cuda_ndt.ndt_error(a["p"], a["aux"], a["x"], 1.0)
    H, b = torch.eye(6) * 10.0, torch.ones(6)
    if name == "lm_trial":
        return cuda_solver.lm_trial(H, b, torch.ones(1), a["x"])
    state = cuda_solver.lm_state(a["x"])
    return cuda_solver.lm_step(state, H, b, torch.ones(1), a["aux"],
                               cuda_solver.TrialCost(a["p"]), True, LsqConfig())


# what a CPU call of the wrapper also runs through other wrappers: the
# plain LM trial step calls the trial and error wrappers
ALSO = {"lm_step": {"lm_trial": 1, "error": 1}}


@pytest.mark.parametrize("name", tally.KERNELS)
def test_a_wrapper_call_adds_one_to_its_slot(name):
    a = _inputs()
    runs = tally.counts("cpu")
    runs.zero_()
    _call(name, a)
    want = {k: 0 for k in tally.KERNELS}
    want.update({name.split("[")[0]: 1, name: 1, **ALSO.get(name, {})})
    assert tally.read("cpu") == want


def test_plain_versions_add_nothing():
    a = _inputs()
    runs = tally.counts("cpu")
    runs.zero_()
    cuda_linearize.linearize_plain(a["p"], a["ca"], a["x"], a["rows"], a["valid"])
    cuda_kernels.nn_search_plain(a["pts"], a["pts"], a["mask"])
    cuda_solver.lm_trial_plain(torch.eye(6), torch.ones(6), torch.ones(()), a["x"])
    assert int(runs.sum()) == 0
    assert tally.slot("cpu", "lm_step") == runs[tally.KERNELS.index("lm_step"):].data_ptr()
