"""Device-resident loops: CUDA graphs whose loops are conditional WHILE
nodes (the counterpart of the JAX package's `lax.while_loop` and of its
one-program `lax.scan`s).

`solver.lsq_solve` takes its device form when a CUDA graph is being
captured on the current stream, or inside `device_loop()`; the pose-graph
solves (`models/pose_graph_sparse.py`, `models/pose_graph.py`) take theirs
with `device_loop=True`, captured once per signature (`replay_cached`).
Their loops go through `while_loop` (and the CG's refresh branch through
`if_then`):

  * under capture, each loop is a conditional WHILE node added to the graph
    being captured (`csrc/device_loop.cu`); its body is captured once, on a
    body stream of its own nesting level, into the node's body graph, and
    its condition is set on the device by `cuda_solver.loop_cond` from the
    LM state, so a replay runs exactly the trips the data asks for and
    reads nothing back to the host;
  * outside a capture, the same bodies run in a host loop over the same
    condition tensor (`LoopOut.flag`): on the CPU that is the device form's
    plain version; on CUDA it is the eager warm-up that `DeviceGraph` runs
    before it captures, on the same body streams, so that every per-stream
    resource (the kernels' reduction scratch, cuBLAS's workspace) exists
    before the capture.  The warm-up runs every loop body and branch once,
    whatever its condition says, and reads no condition.

`DeviceGraph(fn, device)` captures `fn` (which reads and writes static
device buffers, its solves in the device form) once and replays it.  A
conditional node that cannot be built, or a capture that fails, raises:
there is no fallback to the eager loop.

The allocations of a captured body come from a memory pool of the graph's
own (`torch.cuda.use_mem_pool`): torch routes into the graph's pool only
what the capture stream allocates.  The graph's own pool is consulted
first, so the capture stream's allocations still go there.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time

import torch

from . import device as _device
from .ops import _build, cuda_linearize, cuda_pose_graph, cuda_solver

_P = ctypes.c_void_p
_local = threading.local()
_streams: dict = {}
host_reads = 0
"""Condition reads of the host loop on CUDA (the warm-up's; none under
capture and none in a replay)."""


def _get(name, default=0):
    return getattr(_local, name, default)


def capturing(device) -> bool:
    """Whether the current stream of `device` is capturing a CUDA graph."""
    device = torch.device(device)
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def device_form(device) -> bool:
    """Whether `solver.lsq_solve` on `device` takes its device form: under a
    capture of the current stream, or inside `device_loop()`."""
    return _get("depth") > 0 or capturing(device)


@contextlib.contextmanager
def device_loop():
    """Run the solves inside in their device form: under a capture as
    conditional WHILE nodes, otherwise (the CPU, or CUDA's warm-up) as the
    host loop over the same condition tensors."""
    _local.depth = _get("depth") + 1
    try:
        yield
    finally:
        _local.depth -= 1


def body_stream(device, level: int):
    """The side stream on which a loop body of nesting `level` (0: the
    outermost loop) runs on `device`: one a level, made once."""
    device = torch.device(device)
    key = (device.index if device.index is not None else torch.cuda.current_device(), level)
    if key not in _streams:
        _streams[key] = torch.cuda.Stream(device=torch.device("cuda", key[0]))
    return _streams[key]


def capture_stream(device):
    """The stream `DeviceGraph` captures on (one a device)."""
    return body_stream(device, -1)


# the sparse pose-graph solve nests three loops (Gauss-Newton, LM trials,
# CG) and the CG's refresh branch; the LM solve two loops
LEVELS = 4


def prepare(device):
    """Make what the kernels need on every stream a capture uses (the
    library, the loops' counts, the reduction scratch of the capture and
    body streams), eagerly: nothing of it may be made under capture."""
    device = torch.device(device)
    _build.library()
    cuda_solver.loop_counts(device)
    cuda_pose_graph.pg_counts(device)
    for level in range(-1, LEVELS):
        with torch.cuda.stream(body_stream(device, level)):
            cuda_linearize._reduce_scratch(device)


class Condition:
    """A loop's condition: `flag`, the (1,) int32 tensor the condition step
    writes, and under capture `handle`, the conditional handle of the graph
    being captured (0 otherwise)."""

    def __init__(self, flag):
        self.flag = flag
        self.handle = 0
        if capturing(flag.device):
            out = ctypes.c_ulonglong(0)
            fn = _build.function("fgt_cond_handle_create", (_P, _P))
            stream = torch.cuda.current_stream(flag.device).cuda_stream
            _build.check("fgt_cond_handle_create (the conditional handle)",
                         fn(stream, ctypes.byref(out)))
            self.handle = out.value


def while_loop(cond: Condition, body):
    """Run `body()` while the condition holds; the condition is set before
    the call (its step on the current stream) and by `body` itself.

    Under capture: one WHILE node on `cond.handle`, `body` captured once on
    the body stream of this nesting level.  Otherwise the host loop: one
    read of `cond.flag` a trip (on CUDA with the body on the same body
    stream as under capture, ordered against the current stream); in
    `DeviceGraph`'s warm-up, one trip and no read."""
    _conditional(cond, body, "fgt_while_begin", loop=True)


def if_then(cond, body):
    """Run `body()` once if the condition holds (set before the call on the
    current stream).  Under capture: one IF node on `cond.handle`, `body`
    captured on the body stream of this nesting level; otherwise one read of
    `cond.flag` (in `DeviceGraph`'s warm-up, no read: `body` runs)."""
    _conditional(cond, body, "fgt_if_begin", loop=False)


def _conditional(cond, body, begin, loop):
    global host_reads
    device = cond.flag.device
    level = _get("level")
    if device.type == "cpu":
        _local.level = level + 1
        try:
            while int(cond.flag[0]):
                body()
                if not loop:
                    break
        finally:
            _local.level = level
        return
    cur = torch.cuda.current_stream(device)
    side = body_stream(device, level)
    _local.level = level + 1
    try:
        if cond.handle:
            fn = _build.function(begin, (_P, ctypes.c_ulonglong, _P))
            _build.check(f"{begin} (the conditional node)",
                         fn(cur.cuda_stream, cond.handle, side.cuda_stream))
            try:
                with torch.cuda.stream(side):
                    body()
            finally:
                end = _build.function("fgt_while_end", (_P,))
                code = end(side.cuda_stream)
            _build.check("fgt_while_end (the conditional body's capture)", code)
            return
        if capturing(device):
            raise RuntimeError("a conditional node under capture needs the condition's handle")
        warm = _get("warm", False)
        while True:
            if not warm:
                host_reads += 1
                if not int(cond.flag.item()):
                    break
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body()
            cur.wait_stream(side)
            if warm or not loop:
                break
    finally:
        _local.level = level


class DeviceGraph:
    """`fn()` captured once as a CUDA graph and replayed: `fn` reads and
    writes static device buffers (the caller copies new inputs into them
    before `replay()`), and its solves run in the device form, their loops
    conditional WHILE nodes.  `out` is what the capture returned: its
    tensors hold the last replay's results.

    On CUDA the constructor warms `fn` up eagerly on the capture stream
    (the device form's host loop with every loop body and branch run once,
    whatever its condition: enough to make every per-stream resource; it
    also builds every kernel; the device tallies are put back after it),
    then captures it; `warm_s` and `capture_s` are the host seconds of each
    (the warm-up closed by a synchronize, the capture with the graph's
    instantiation).  On the CPU there is no graph:
    `replay()` runs `fn()` under `device_loop()`, the device form's plain
    version.  `captures` counts the graphs captured."""

    captures = 0

    def __init__(self, fn, device="cuda"):
        self.fn = fn
        self.device = _device.resolve(device)
        self.graph = None
        self.out = None
        self.warm_s = self.capture_s = 0.0
        if self.device.type == "cpu":
            return
        t0 = time.perf_counter()
        prepare(self.device)
        # the device tallies count what replays run: the warm-up's steps go
        tallies = (cuda_solver.loop_counts(self.device), cuda_pose_graph.pg_counts(self.device))
        saved = [t.clone() for t in tallies]
        stream = capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        _local.warm = True
        try:
            with torch.cuda.stream(stream), device_loop():
                fn()
        finally:
            _local.warm = False
        torch.cuda.synchronize(self.device)
        for t, v in zip(tallies, saved):
            t.copy_(v)
        t1 = time.perf_counter()
        self.pool = torch.cuda.MemPool()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            with torch.cuda.use_mem_pool(self.pool):
                self.out = fn()
        self.warm_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        DeviceGraph.captures += 1

    def replay(self):
        """One run of the captured work on the current stream (no host
        read); on the CPU one run of `fn` in the device form's plain
        version.  Returns `out`."""
        if self.graph is None:
            with device_loop():
                self.out = self.fn()
        else:
            self.graph.replay()
        return self.out


_programs: collections.OrderedDict = collections.OrderedDict()
PROGRAMS = 32
"""The most captured programs `replay_cached` keeps (the oldest goes).  A
sparse solve's graph at ~500 poses holds 8-12 MiB of the caching
allocator's reserved device memory (`chip_smoke.py --backend`, NVIDIA H100
80GB HBM3, 700 W), so 32 such graphs hold under 0.4 GiB; that run's whole
back-end (17 signatures) evicts none."""


def replay_cached(key, inputs: dict, fn, device):
    """`fn(**inputs)` as one device program: on CUDA captured once per
    `key` (`DeviceGraph` on static copies of `inputs`, a dict of tensors on
    `device`), later calls copying their inputs into those buffers and
    replaying (nothing read to the host); on the CPU `fn(**inputs)` in the
    device form's plain version.  Returns what `fn` returned: on CUDA the
    graph's own buffers, which the next replay of `key` overwrites."""
    device = torch.device(device)
    if device.type == "cpu":
        with device_loop():
            return fn(**inputs)
    entry = _programs.get(key)
    if entry is None:
        static = {k: torch.empty_like(v, memory_format=torch.contiguous_format).copy_(v)
                  for k, v in inputs.items()}
        entry = (static, DeviceGraph(lambda: fn(**static), device))
        _programs[key] = entry
        while len(_programs) > PROGRAMS:
            _programs.popitem(last=False)
    else:
        _programs.move_to_end(key)
        for k, v in inputs.items():
            entry[0][k].copy_(v)
    return entry[1].replay()
