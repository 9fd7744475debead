"""The device's tally of kernel runs: one int32 slot a kernel wrapper of
`cuda_kernels`, `cuda_linearize`, `cuda_ndt` and `cuda_solver`'s trials.

Each kernel adds one to its slot as it runs (`csrc/launch_count.cuh`), so
the runs of a CUDA graph's replays are counted, which the wrappers' host
counters (`.launches`: one a call that launches, under a capture one an
enqueue into the graph) cannot see.  A CPU call of a wrapper (its plain
version) adds its one here too; the plain versions called directly add
nothing.  The condition kernels keep tallies of their own
(`cuda_solver.loop_counts`, `cuda_pose_graph.pg_counts`, which also counts
the `block_tridiag` kernels).
"""

from __future__ import annotations

import torch

# a form's slot follows its kernel's: "linearize[idx]" counts the runs that
# read rows by index, "ndt_<mode>[lookup]" those that look voxels up
KERNELS = ("rbf_moments", "nn_search", "knn_moments", "knn_slab", "radius_count",
           "radius_window", "linearize", "linearize[idx]", "linearize_raw",
           "linearize_raw[idx]", "error", "ndt_d2d", "ndt_d2d[lookup]", "ndt_p2d",
           "ndt_p2d[lookup]", "ndt_d2d_raw", "ndt_d2d_raw[lookup]", "ndt_p2d_raw",
           "ndt_p2d_raw[lookup]", "ndt_error", "lm_trial", "lm_step")
_counts: dict = {}


def counts(device):
    """The device's (len(KERNELS),) int32 tally.  Made once a device,
    eagerly: first asked for under a capture, it raises (`graphs.prepare`
    makes it).  Zero it with `.zero_()`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _counts:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the kernel tally is made before a capture: call "
                               "graphs.prepare(device) first")
        _counts[device] = torch.zeros(len(KERNELS), dtype=torch.int32, device=device)
    return _counts[device]


def slot(device, name):
    """The address of kernel `name`'s slot (and its form's after it), for
    the kernel to add to."""
    return counts(device)[KERNELS.index(name):].data_ptr()


def add(device, name, form=False):
    """One more run of kernel `name`'s plain version (a CPU call of its
    wrapper, which stands for the launch), in the counted form too with
    `form`."""
    i = KERNELS.index(name)
    counts(device)[i:i + 1 + bool(form)] += 1


def read(device):
    """{kernel: runs} of the device's tally (a read to the host)."""
    return dict(zip(KERNELS, counts(device).tolist()))
