"""Gauss-Newton / Levenberg-Marquardt solve over SE(3) (port of
`fast_gicp_tpu.solver`).

The JAX solve is two nested `lax.while_loop`s inside one jit.  Here the
loops run eagerly in Python, but every scalar of the LM schedule -- the
lambda init, rho, accept, nu, the convergence test and the Hessian select
-- stays on the device in float32 with the JAX package's exact
arithmetic, so the iteration path is the same.  An LM trial is one
`cuda_solver.lm_step` on the solve's state buffer: on the card one launch
of the trial kernel (trial step, error, schedule), on the CPU its plain
version.  The only host reads are the loop exits: the state's two flags
per LM inner trial (per outer iteration for GN).  `lsq_solve.host_syncs`
counts them.

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

from . import se3
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
    ran)."""
    dtype, device = x0.dtype, x0.device

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
