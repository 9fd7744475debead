"""Levenberg-Marquardt trials: the CUDA kernels of `csrc/lm_trial.cu` and
of `csrc/trial_error.cu`'s trial launch, with their plain PyTorch versions
(port of `fast_gicp_tpu.ops.pallas_solver` and of the LM schedule of
`fast_gicp_tpu.solver`).

`lm_trial` is the counterpart of `lm_trial_pallas` (kernel
`_lm_trial_kernel`, `pallas_solver.py:127`): solve (H + lambda I) d = -b
with one refinement step, delta = se3_exp(d), xi = delta x and
denom = d . (lambda d - b).  lambda stays a device tensor, so a trial never
copies it to the host.

`lm_step` is a whole LM trial in one launch: the trial step, the
objective's error at xi (`_error_kernel`, `pallas_linearize.py:633`, or
`_ndt_error_kernel`, `:580`, given as a `TrialCost`) and the LM schedule
(the lambda init, rho, the NaN-safe accept, the convergence test, lambda,
nu, x and the two flags the host reads), on a solve's state buffer
(`lm_state`), which it updates in place.  `lm_step_plain` is the same
trial as eager ops.

`loop_cond` is the condition kernel of the solve's device form
(`csrc/device_loop.cu`, port-only: it replaces the predicates that XLA
evaluates for `lax.while_loop` on the TPU): one thread that reads the
state's flags, keeps the loop's counters in the state and writes the
loop's condition into a conditional WHILE node's handle (`graphs`).
`loop_cond_plain` is the same step as eager ops.

Across the ranks of a mesh (`parallel`), an objective's error is a
`ReducedCost` and each linearization's [err, H, b] one all-reduce of 43
floats (`reduce_normal_eq`).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import se3
from . import _build, cuda_linearize, cuda_ndt, soa
from .cuda_linearize import AUX_ROWS, _check_cuda, _reduce_scratch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TRIAL_ARGS = (_P, _P, _P, _P, _P, _P)
_STEP_ARGS = (_P, _P, _P, _P, _I, _F, _F, _F, _P, _I, _I, _P, _I, _F, _I, _P, _P, _P)
_COND_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_ulonglong, _I, _P)

# A solve's LM state (csrc/lm_step.cuh kState*), float32: the pose, lambda
# (< 0: not yet set), nu, the flags of the last trial (1.0 / 0.0), and that
# trial's xi, delta, d, denom, error and the lambda it ran with.
STATE_X = slice(0, 16)
STATE_LAM = 16
STATE_NU = 17
STATE_DONE = 18
STATE_CONV = 19
STATE_XI = slice(20, 36)
STATE_DELTA = slice(36, 52)
STATE_D = slice(52, 58)
STATE_DENOM = 58
STATE_YI = 59
STATE_LAM_USED = 60
# the device form's loop counters (csrc/device_loop.cu): trials since the
# last linearization, outer iterations run, trials run in the whole solve
STATE_TRIAL = 61
STATE_ITERATION = 62
STATE_TRIALS_RUN = 63
STATE_FLOATS = 64

# loop_cond modes: before the outer loop (the results reset), after a
# linearization's first trial, after each later trial, after the trials of
# a linearization (the outer step: H_out, y, converged, iterations)
LOOP_OUTER_ENTER = 0
LOOP_FIRST_TRIAL = 1
LOOP_AFTER_TRIAL = 2
LOOP_AFTER_INNER = 3


def _check(name, t, numel):
    if t.dtype != torch.float32 or t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} float32 values, got "
                         f"{tuple(t.shape)} {t.dtype}")


def lm_trial(H, b, lam, x):
    """(xi (4, 4), delta (4, 4), d (6,), denom ()) for one trial step.

    H (6, 6), b (6,), lam (a one-element tensor) and x (4, 4), float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check("H", H, 36)
    _check("b", b, 6)
    _check("lam", lam, 1)
    _check("x", x, 16)
    if H.device.type == "cpu":
        return lm_trial_plain(H, b, lam.reshape(()), x)
    for t in (H, b, lam, x):
        if t.device != H.device:
            raise ValueError(f"tensors on several devices: {t.device} vs {H.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    out = torch.empty(39, dtype=torch.float32, device=H.device)
    fn = _build.function("fgt_lm_trial", _TRIAL_ARGS)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _build.check("fgt_lm_trial", fn(
        H.data_ptr(), b.data_ptr(), lam.data_ptr(), x.data_ptr(),
        out.data_ptr(), stream))
    lm_trial.launches += 1
    return out[:16].view(4, 4), out[16:32].view(4, 4), out[32:38], out[38]


lm_trial.launches = 0


def lm_trial_plain(H, b, lam, x):
    """Plain PyTorch version of `lm_trial` (the JAX solver's XLA trial,
    `solver.py:117-119`)."""
    from ..solver import _solve_refined  # solver imports this module

    d = _solve_refined(H + lam * torch.eye(6, dtype=H.dtype, device=H.device), -b)
    delta = se3.se3_exp(d)
    return delta @ x, delta, d, torch.dot(d, lam * d - b)


class TrialCost(NamedTuple):
    """An objective's cost at a trial pose, in the form the trial launch
    reads: the sum over L = offsets * N lanes of w e^T M e against a
    linearization's frozen aux (10, L) [M (6), a, mu (3)], lane k N + i
    reading source column i of p ((3, N), or (3, L) tiled over the offsets,
    of which the first N columns are read).  w is a (GICP, VGICP: the
    linearize's weight) or, with `resolution` set (NDT), the Cauchy weight
    c^2 / (c^2 + |mu - p|^2) * a with c = resolution.  Called as
    `cost(x, aux)`, it is the objective's error function: one launch of
    `cuda_linearize.error` or `cuda_ndt.ndt_error`."""

    p: torch.Tensor
    offsets: int = 1
    resolution: float | None = None

    def __call__(self, x, aux):
        if self.resolution is None:
            return cuda_linearize.error(self.p, x, aux)
        return cuda_ndt.ndt_error(self.p, aux, x, self.resolution, offsets=self.offsets)

    def columns(self, L):
        """(p's first N = L / offsets columns (3, N), N)."""
        if self.resolution is None and self.offsets != 1:
            raise ValueError("the GICP weight takes one offset (lanes = columns of p)")
        if self.offsets < 1 or L % self.offsets:
            raise ValueError(f"offsets={self.offsets} does not divide L={L}")
        N = L // self.offsets
        p = self.p[:, :N] if self.p.dim() == 2 and self.p.shape[-1] == L else self.p
        cuda_linearize._check("p", p, (3, N))
        return p, N

    def plain(self, x, aux):
        """Plain PyTorch version of the cost, both weights in one form."""
        p, _N = self.columns(aux.shape[-1])
        p_t = soa.transform_cols(x, p.repeat(1, self.offsets))
        mu, a = aux[7:10], aux[6]
        if self.resolution is not None:
            a = cuda_ndt._cauchy(cuda_ndt._c_sq(self.resolution), p_t, mu, a)
        return soa.error_cols(p_t, mu, aux[:6], a)


class ReducedCost(NamedTuple):
    """An objective's trial cost summed over the ranks of a mesh:
    `reduce(cost(x, aux))`, `reduce` a sum all-reduce
    (`parallel.mesh.Mesh.reduce`) and `cost` the rank's own `TrialCost` (or
    any callable of (x, aux)).  The trial launch sums only its own lanes in
    its last block, so a solve whose error is a ReducedCost takes the
    unfused trial order of `lm_step_plain` (`solver.lsq_solve`)."""

    cost: Callable
    reduce: Callable

    def __call__(self, x, aux):
        return self.reduce(self.cost(x, aux))


def trial_cost(cost, reduce=None):
    """`cost` itself (reduce None: one device), else its `ReducedCost`."""
    return cost if reduce is None else ReducedCost(cost, reduce)


def reduce_normal_eq(lin, reduce=None):
    """A linearization's (err, H, b, aux) with err, H and b summed over the
    ranks by one all-reduce of the 43 packed floats [err, H (36), b (6)];
    aux stays the rank's own.  With reduce None, `lin` itself."""
    if reduce is None:
        return lin
    err, H, b, aux = lin
    packed = reduce(torch.cat([err.reshape(1), H.reshape(36), b.reshape(6)]))
    return packed[0], packed[1:37].view(6, 6), packed[37:43], aux


def lm_state(x0):
    """A solve's LM state (STATE_FLOATS,) on x0's device: the pose x0 (4, 4)
    and lambda unset; a solve's steps update it in place.  Two ops: a fill
    and a copy, neither of which waits on the host."""
    state = torch.full((STATE_FLOATS,), -1.0, dtype=x0.dtype, device=x0.device)
    state[STATE_X].copy_(x0.reshape(16))
    return state


def _inverse_f32(v):
    """The float32 rounding of 1 / v taken in double: a float32 CUDA tensor
    divided by a Python float v is its product with this (checked on the
    card by chip_smoke.py)."""
    return float(np.float32(1.0 / v))


def lm_step(state, H, b, y0, aux, cost, first, config):
    """One LM trial on `state` (`lm_state`), updated in place: the trial step
    from the state's pose and lambda with H (6, 6), b (6,) and y0 () of the
    last linearization, `cost` (a `TrialCost`) at the trial pose against
    `aux`, then the schedule; `first` marks the first trial after a
    linearization (lambda init, nu = 2).  config: the solve's `LsqConfig`.
    The host then reads state[STATE_DONE] and state[STATE_CONV].

    CPU tensors take the plain version (any callable `cost(x, aux)`); CUDA
    tensors launch the trial kernel, one launch a trial."""
    _check("state", state, STATE_FLOATS)
    _check("H", H, 36)
    _check("b", b, 6)
    _check("y0", y0, 1)
    for t in (H, b, y0) + ((aux,) if isinstance(aux, torch.Tensor) else ()):
        if t.device != state.device:
            raise ValueError(f"tensors on several devices: {t.device} vs {state.device}")
    if state.device.type == "cpu":
        return lm_step_plain(state, H, b, y0, aux, cost, first, config)
    if not isinstance(cost, TrialCost):
        raise ValueError("the trial launch takes the objective's cost as a TrialCost, "
                         f"not {type(cost).__name__}")
    L = aux.shape[-1]
    cuda_linearize._check("aux", aux, (AUX_ROWS, L))
    p, N = cost.columns(L)
    _check_cuda([state, H, b, y0, aux])
    if p.device != state.device or (N > 1 and p.stride(1) != 1):
        raise ValueError("p must lie on the state's device, its columns contiguous")
    partials, ticket, stream = _reduce_scratch(state.device)
    ndt = cost.resolution is not None
    fn = _build.function("fgt_lm_step", _STEP_ARGS)
    _build.check("fgt_lm_step", fn(
        H.data_ptr(), b.data_ptr(), y0.data_ptr(), state.data_ptr(), int(first),
        float(np.float32(config.lm_init_lambda_factor)), _inverse_f32(config.rotation_epsilon),
        _inverse_f32(config.transformation_epsilon), p.data_ptr(), p.stride(0), N,
        aux.data_ptr(), int(ndt), cuda_ndt._c_sq(cost.resolution) if ndt else 0.0, L,
        partials.data_ptr(), ticket.data_ptr(), stream))
    lm_step.launches += 1


lm_step.launches = 0


def lm_step_plain(state, H, b, y0, aux, cost, first, config, trial=lm_trial):
    """Plain PyTorch version of `lm_step`: `trial` (`lm_trial`, the standalone
    kernel on CUDA tensors), `cost(xi, aux)`, then the LM schedule as eager
    device ops, written into `state`."""
    from ..solver import is_converged  # solver imports this module

    x = state[STATE_X].view(4, 4)
    lam = state[STATE_LAM:STATE_LAM + 1]
    nu = state[STATE_NU]
    if first:
        lam = torch.where(
            lam < 0.0,
            config.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(H))),
            lam,
        ).reshape(1)
        nu = torch.full((), 2.0, dtype=state.dtype, device=state.device)
    xi, delta, d, denom = trial(H, b, lam, x)
    yi = cost(xi, aux)
    rho = (y0 - yi) / denom
    # NaN-safe accept: `rho < 0` is False for NaN, which would accept a
    # poisoned pose; only a provably improving finite trial is accepted.
    reject = ~(rho >= 0.0)
    delta_conv = is_converged(delta, config.rotation_epsilon, config.transformation_epsilon)
    conv_reject = reject & delta_conv
    accept = ~reject
    new_lam = torch.where(
        accept,
        lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
        torch.where(conv_reject, lam, nu * lam),
    )
    nu = torch.where(reject & ~conv_reject, 2.0 * nu, nu)
    x_new = torch.where(accept, xi, x)
    state[STATE_XI] = xi.reshape(16)
    state[STATE_DELTA] = delta.reshape(16)
    state[STATE_D] = d
    state[STATE_DENOM] = denom
    state[STATE_YI] = yi
    state[STATE_LAM_USED] = lam[0]
    state[STATE_LAM] = new_lam[0]
    state[STATE_NU] = nu
    state[STATE_X] = x_new.reshape(16)
    state[STATE_DONE] = accept | conv_reject
    state[STATE_CONV] = delta_conv


class LoopOut(NamedTuple):
    """The device form's results, written by `loop_cond`: H_out (6, 6) at
    the last successful linearization, y () the error at the last
    linearization, converged () bool, iterations () int32, and flag (1,)
    int32, the last condition it computed (what the host loop reads)."""

    H_out: torch.Tensor
    y: torch.Tensor
    converged: torch.Tensor
    iterations: torch.Tensor
    flag: torch.Tensor


def loop_out(device, dtype=torch.float32):
    """Uninitialized `LoopOut` buffers on `device` (LOOP_OUTER_ENTER sets
    them)."""
    return LoopOut(torch.empty((6, 6), dtype=dtype, device=device),
                   torch.empty((), dtype=dtype, device=device),
                   torch.empty((), dtype=torch.bool, device=device),
                   torch.empty((), dtype=torch.int32, device=device),
                   torch.empty(1, dtype=torch.int32, device=device))


_loop_counts: dict = {}

LOOP_COUNTS = ("loop_cond", "trials", "iterations", "solves")


def loop_counts(device):
    """The device's (4,) int32 tally of what the device form's loops ran:
    condition launches, LM trials, outer iterations (one linearization each)
    and solves; every `loop_cond` step adds to it on the device (a profiler
    does not see every kernel of a conditional body, so a graph replay's
    launches are read from here).  Made once a device, eagerly: first asked
    for under a capture, it raises (`graphs.prepare` makes it).  Zero it
    with `.zero_()`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _loop_counts:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("loop_counts is made before a capture: call "
                               "graphs.prepare(device) first")
        _loop_counts[device] = torch.zeros(len(LOOP_COUNTS), dtype=torch.int32, device=device)
    return _loop_counts[device]


def loop_cond(state, out, mode, config, H=None, y0=None, handle=0):
    """One step of the device form's loop bookkeeping on `state` and `out`
    (a `LoopOut`), in place; `mode` a LOOP_* constant, config the solve's
    `LsqConfig`, H (6, 6) and y0 () of the current linearization (read by
    LOOP_AFTER_INNER).  The condition it computes goes to out.flag and, for
    a nonzero `handle` (a conditional handle of the graph being captured),
    into the handle: the WHILE node's condition.

    CPU tensors take the plain version; CUDA tensors launch the condition
    kernel, one launch a step."""
    _check("state", state, STATE_FLOATS)
    H = out.H_out if H is None else H
    y0 = out.y if y0 is None else y0
    _check("H", H, 36)
    _check("y0", y0, 1)
    lm = int(config.optimizer == "lm")
    if state.device.type == "cpu":
        if handle:
            raise ValueError("a conditional handle exists only under CUDA graph capture")
        return loop_cond_plain(state, out, mode, config, H, y0)
    _check_cuda([state, H, y0, *out])
    counts = loop_counts(state.device)
    fn = _build.function("fgt_loop_cond", _COND_ARGS)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    _build.check("fgt_loop_cond", fn(
        state.data_ptr(), H.data_ptr(), y0.data_ptr(), out.H_out.data_ptr(), out.y.data_ptr(),
        out.converged.data_ptr(), out.iterations.data_ptr(), out.flag.data_ptr(),
        counts.data_ptr(), int(mode),
        int(config.max_iterations), int(config.lm_max_iterations), lm, int(handle),
        int(handle != 0), stream))
    loop_cond.launches += 1


loop_cond.launches = 0


def loop_cond_plain(state, out, mode, config, H, y0):
    """Plain PyTorch version of `loop_cond` (no handle): the same selects
    and counters as eager ops, on any device."""
    dev = state.device
    one = torch.ones((), dtype=torch.bool, device=dev)
    counts = loop_counts(dev)
    counts[0] += 1
    if mode == LOOP_OUTER_ENTER:
        counts[3] += 1
        state[STATE_ITERATION] = 0.0
        state[STATE_TRIALS_RUN] = 0.0
        out.H_out.copy_(torch.eye(6, dtype=out.H_out.dtype, device=dev))
        out.y.zero_()
        out.converged.zero_()
        out.iterations.zero_()
        cond = one & (config.max_iterations > 0)
    elif mode in (LOOP_FIRST_TRIAL, LOOP_AFTER_TRIAL):
        j = (torch.ones((), dtype=state.dtype, device=dev) if mode == LOOP_FIRST_TRIAL
             else state[STATE_TRIAL] + 1.0)
        state[STATE_TRIAL] = j
        state[STATE_TRIALS_RUN] += 1.0
        counts[1] += 1
        cond = (state[STATE_DONE] == 0.0) & (j < float(config.lm_max_iterations))
    elif mode == LOOP_AFTER_INNER:
        success = state[STATE_DONE] != 0.0 if config.optimizer == "lm" else one
        conv = state[STATE_CONV] != 0.0
        i = state[STATE_ITERATION] + 1.0
        state[STATE_ITERATION] = i
        counts[2] += 1
        out.converged.copy_(conv & success)
        out.iterations.copy_(i.to(torch.int32))
        out.H_out.copy_(torch.where(success, H.reshape(6, 6), out.H_out))
        out.y.copy_(y0.reshape(()))
        cond = success & ~conv & (i < float(config.max_iterations))
    else:
        raise ValueError(f"unknown loop_cond mode {mode}")
    out.flag.copy_(cond.to(torch.int32).reshape(1))
