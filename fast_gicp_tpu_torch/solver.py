"""Gauss-Newton / Levenberg-Marquardt solve over SE(3) (port of
`fast_gicp_tpu.solver`).

The JAX solve is two nested `lax.while_loop`s inside one jit.  Here every
scalar of the LM schedule -- the lambda init, rho, accept, nu, the
convergence test and the Hessian select -- stays on the device in float32
with the JAX package's exact arithmetic, so the iteration path is the
same.  An LM trial is one `cuda_solver.lm_step` on the solve's state
buffer: on the card one launch of the trial kernel (trial step, error,
schedule), on the CPU its plain version.  The loops take one of two forms:

  * eager (a call outside any capture): the loops run in Python and the
    only host reads are the loop exits, the state's two flags per LM trial
    (per outer iteration for GN); `lsq_solve.host_syncs` counts them;
  * the device form (under a CUDA graph capture, or inside
    `graphs.device_loop()`): the same linearize and trial launches in the
    same order, each loop a conditional WHILE node whose condition the
    one-thread `cuda_solver.loop_cond` sets from the LM state on the
    device, so a replay of the graph reads nothing back to the host;
    `converged`, `iterations`, the Hessian and the error are device-side
    selects (`graphs`).  Outside a capture the same steps run in a host
    loop over the condition tensor: on the CPU, the device form's plain
    version, bit for bit the eager solve.

Semantics (lsq_registration_impl.hpp:53-168):
  * lambda init = lm_init_lambda_factor * max|diag H|, carried across
    outer iterations;
  * trial: solve (H + lambda I) d = -b; delta = se3_exp(d); xi = delta x;
    rho = (y0 - yi) / (d . (lambda d - b));
  * NaN-safe accept: reject unless rho >= 0; a rejected step whose delta
    already meets the convergence test stops as converged;
    else lambda *= nu, nu *= 2;
  * accept: x = xi, lambda *= max(1/3, 1 - (2 rho - 1)^3);
  * lm_max_iterations rejected trials in a row end the solve as failed;
  * convergence: max(max|R - I| / rot_eps, max|t| / trans_eps) < 1.

`linearize_fn(x) -> (y0, H, b, aux)` freezes what the error
re-evaluations reuse into `aux`; `error_fn(x, aux)` evaluates the
objective at a trial pose against it.  On the card `error_fn` is the
objective's `cuda_solver.TrialCost`, which the trial launch reads; on the
CPU any callable does.

Across the ranks of a mesh the objective's error is a
`cuda_solver.ReducedCost`: a rank's trial launch would read only its own
lanes' error, so such a solve runs each trial in the unfused order of
`cuda_solver.lm_step_plain`, which is the collective's order and not a
fallback: the standalone trial kernel (`lm_trial`), the error kernel with
the trial off, the all-reduce of the error, then the schedule as eager
device ops.  Every rank reads the same reduced flags, so every rank walks
the same iterations.  On one device that order gives the fused launch's
bits (`chip_smoke.py` holds the two to each other).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import graphs, se3
from .ops import cuda_solver, linalg3


class LsqConfig(NamedTuple):
    """Optimizer settings; defaults match lsq_registration_impl.hpp:11-19."""

    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    optimizer: str = "lm"  # "lm" | "gn"
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    debug_print: bool = False


class LsqResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) final pose
    hessian: torch.Tensor  # (6, 6) H at the last accepted linearization
    error: torch.Tensor  # objective at the last linearization point
    converged: torch.Tensor  # bool
    iterations: torch.Tensor  # int32 outer iterations executed


def _solve_refined(A, rhs):
    """6x6 SPD solve (unrolled Cholesky) plus one iterative-refinement
    step, which recovers ~2 digits lost to f32 cancellation when H is
    ill-conditioned."""
    d = linalg3.cholesky_solve(A, rhs)
    r = rhs - A @ d
    return d + linalg3.cholesky_solve(A, r)


def is_converged(delta, rotation_epsilon, transformation_epsilon):
    """Reference convergence test (lsq_registration_impl.hpp:82-91), as a
    bool tensor on delta's device."""
    R = delta[:3, :3] - torch.eye(3, dtype=delta.dtype, device=delta.device)
    r_delta = torch.max(torch.abs(R)) / rotation_epsilon
    t_delta = torch.max(torch.abs(delta[:3, 3])) / transformation_epsilon
    return torch.maximum(r_delta, t_delta) < 1.0


def _zeros_like_aux(aux):
    if isinstance(aux, torch.Tensor):
        return torch.zeros_like(aux)
    return type(aux)(_zeros_like_aux(a) for a in aux)


def lsq_solve(
    linearize_fn: Callable,
    error_fn: Callable,
    x0: torch.Tensor,
    config: LsqConfig = LsqConfig(),
    with_aux: bool = False,
):
    """Run the GN/LM fixed-point solve from the initial guess `x0` (4x4).

    With `with_aux=True` returns `(LsqResult, aux)`, `aux` being the frozen
    state of the last linearization (zeros of its shape if no iteration
    ran).  Under a CUDA graph capture, or inside `graphs.device_loop()`,
    the solve takes its device form (module docstring)."""
    dtype, device = x0.dtype, x0.device
    if graphs.device_form(device):
        return _lsq_solve_device(linearize_fn, error_fn, x0, config, with_aux)

    def scalar(v, dt=dtype):
        # a fill kernel, not a host-to-device copy (which would synchronise)
        return torch.full((), v, dtype=dt, device=device)

    def read_flags(flags):
        # the loop's one host read a trial (an outer iteration for GN)
        lsq_solve.host_syncs += 1
        return [bool(v) for v in flags.tolist()]

    # the solve's own buffer: the steps update it in place, and x0 (which
    # may be the pose an earlier solve returned) is never written
    state = cuda_solver.lm_state(x0.to(dtype))
    x = state[cuda_solver.STATE_X].view(4, 4)
    H_out = torch.eye(6, dtype=dtype, device=device)
    y = scalar(0.0)
    converged = scalar(False, torch.bool)
    aux = None
    # a cost summed across ranks takes the unfused trial (module docstring)
    step = (cuda_solver.lm_step_plain if isinstance(error_fn, cuda_solver.ReducedCost)
            else cuda_solver.lm_step)
    i = 0
    while i < config.max_iterations:
        y0, H, b, aux = linearize_fn(x)
        if config.optimizer == "lm":
            done, conv = False, False
            for j in range(config.lm_max_iterations):
                step(state, H, b, y0, aux, error_fn, j == 0, config)
                if config.debug_print:
                    yi = state[cuda_solver.STATE_YI]
                    rho = (y0 - yi) / state[cuda_solver.STATE_DENOM]
                    d = state[cuda_solver.STATE_D]
                    print(f"lm trial {j}: y0={float(y0)} yi={float(yi)} "
                          f"rho={float(rho)} "
                          f"lambda={float(state[cuda_solver.STATE_LAM_USED])} "
                          f"|d|={float(torch.linalg.vector_norm(d))}")
                done, conv = read_flags(
                    state[cuda_solver.STATE_DONE:cuda_solver.STATE_CONV + 1])
                if done:
                    break
            success = done
        else:
            xi, delta, _d, _denom = cuda_solver.lm_trial(
                H, b, torch.zeros(1, dtype=dtype, device=device), x
            )
            x = xi
            success = True
            (conv,) = read_flags(is_converged(
                delta, config.rotation_epsilon, config.transformation_epsilon).reshape(1))
        converged = scalar(conv and success, torch.bool)
        # final_hessian_ only updates on a successful step (impl:117, :163).
        if success:
            H_out = H
        y = y0
        i += 1
        if not success or conv:
            break
    res = LsqResult(
        transformation=x,
        hessian=H_out,
        error=y,
        converged=converged,
        iterations=scalar(i, torch.int32),
    )
    if not with_aux:
        return res
    if aux is None:
        aux = _zeros_like_aux(linearize_fn(x0)[3])
    return res, aux


lsq_solve.host_syncs = 0


def _lsq_solve_device(linearize_fn, error_fn, x0, config, with_aux):
    """`lsq_solve`'s device form: the outer loop (linearize, the trials,
    the outer step) and the inner loop (the trials after a linearization's
    first) through `graphs.while_loop`, the conditions set by
    `cuda_solver.loop_cond` on the device.  The launches are the eager
    solve's, in its order; the first trial after a linearization is issued
    before the inner loop, since `lm_step` takes `first` from the host."""
    if config.debug_print:
        raise ValueError("LsqConfig.debug_print reads the trials' floats to the host: "
                         "the device form of the solve cannot print them")
    if config.max_iterations < 1 or (config.optimizer == "lm" and config.lm_max_iterations < 1):
        raise ValueError("the device form runs at least one iteration and one trial: "
                         f"max_iterations={config.max_iterations}, "
                         f"lm_max_iterations={config.lm_max_iterations}")
    dtype, device = x0.dtype, x0.device
    state = cuda_solver.lm_state(x0.to(dtype))
    x = state[cuda_solver.STATE_X].view(4, 4)
    out = cuda_solver.loop_out(device, dtype)
    step = (cuda_solver.lm_step_plain if isinstance(error_fn, cuda_solver.ReducedCost)
            else cuda_solver.lm_step)
    last = {}

    def trials(lin):
        y0, H, b, aux = lin
        step(state, H, b, y0, aux, error_fn, True, config)
        inner = graphs.Condition(out.flag)
        cuda_solver.loop_cond(state, out, cuda_solver.LOOP_FIRST_TRIAL, config,
                              handle=inner.handle)

        def trial():
            step(state, H, b, y0, aux, error_fn, False, config)
            cuda_solver.loop_cond(state, out, cuda_solver.LOOP_AFTER_TRIAL, config,
                                  handle=inner.handle)

        graphs.while_loop(inner, trial)

    def gauss_newton(lin):
        y0, H, b, _aux = lin
        xi, delta, _d, _denom = cuda_solver.lm_trial(
            H, b, torch.zeros(1, dtype=dtype, device=device), x)
        x.copy_(xi)
        state[cuda_solver.STATE_CONV] = is_converged(
            delta, config.rotation_epsilon, config.transformation_epsilon)

    outer = graphs.Condition(out.flag)

    def iteration():
        lin = linearize_fn(x)
        last["aux"] = lin[3]
        (trials if config.optimizer == "lm" else gauss_newton)(lin)
        cuda_solver.loop_cond(state, out, cuda_solver.LOOP_AFTER_INNER, config,
                              H=lin[1], y0=lin[0], handle=outer.handle)

    cuda_solver.loop_cond(state, out, cuda_solver.LOOP_OUTER_ENTER, config, handle=outer.handle)
    graphs.while_loop(outer, iteration)
    res = LsqResult(transformation=x, hessian=out.H_out, error=out.y,
                    converged=out.converged, iterations=out.iterations)
    return (res, last["aux"]) if with_aux else res
