"""Sparse block pose-graph optimization, its edge-sharded form and
sliding-window marginalization (port of
`fast_gicp_tpu.models.pose_graph_sparse`).

  * per-edge 6x12 Jacobians (`torch.func.vmap` of `jacfwd` over each edge's
    two incident poses; never the (E, 6, 6K) whole-graph Jacobian);
  * block-sparse normal equations held as per-edge 6x6 blocks (H_ii, H_ij,
    H_jj), applied by batched products and `index_add_` scatters;
  * a preconditioned conjugate-gradient solve whose preconditioner is the
    block-tridiagonal part along the odometry chain, solved exactly by
    block-Thomas elimination: factored once an LM trial and applied once a
    CG iteration by the kernels of `ops/cuda_pose_graph.py`;
  * `SlidingWindowBA`: a fixed-size keyframe window whose departing pose is
    Schur-reduced into a unary prior on the window head.

Every numeric choice of the JAX solver is kept: the adaptive LM damping
(x10 on a rejected trial, /10 with a floor of 1e-7 on an accepted one), a
non-finite error read as +inf, `converged &= isfinite(err)`, the CG
residual recomputed every 64 iterations, no gauge weight when a prior is
given, the chain super-diagonal from edges in either storage order.  Runs
on the card unless the caller passes device="cpu", in one of two forms:

  * the device form (`device_loop=True`, the default), JAX's one program:
    the Gauss-Newton, LM-trial and PCG loops conditional WHILE nodes and the
    every-64th residual recomputation an IF node of one CUDA graph, captured
    once per signature and replayed, the conditions set on the device by
    `cuda_pose_graph.pg_cond`; the PCG leaves its loop at JAX's tolerance
    test and nothing is read to the host (on the CPU, the host loop over
    the same conditions);
  * the eager form (`device_loop=False`): the CG runs `cg_iterations`
    iterations with an `active` mask that freezes its state once the
    tolerance test fails, and the host reads one flag an LM trial
    (accepted) and one a Gauss-Newton iteration (converged).

The device form's state freezes where the eager form's mask does and its
ops are the eager form's, so both give the same bits (on the card with
deterministic scatter-adds on both sides).

`optimize_pose_graph_sparse_sharded` splits the edges across the ranks of a
mesh (`parallel`): every edge sum (the error, b, the preconditioner's
blocks, each CG product) is completed by a sum all-reduce, and the
replicated prior and gauge terms are added after it.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import device as _device
from .. import graphs, se3
from ..ops import cuda_pose_graph as cpg
from ..ops.cuda_pose_graph import (  # noqa: F401  (_solve6: the JAX module's name)
    _solve6,
    block_tridiag_apply,
    block_tridiag_factor,
)
# the JAX module's block-Thomas solve (`_tridiag_solve`), factor then apply
from ..ops.cuda_pose_graph import block_tridiag_solve as _tridiag_solve  # noqa: F401
from ..precision import f32_matmuls
from .pose_graph import PoseGraphResult, _on, _with_aux, graph_inputs


class SparsePGConfig(NamedTuple):
    max_iterations: int = 20
    # Levenberg damping, adaptive: starts at `damping`, x10 on a rejected
    # step, /10 on acceptance
    damping: float = 1e-4
    lm_max_trials: int = 8
    # moderate against the dense solver's 1e8: the f32 CG sees the gauge
    # block's condition number directly
    gauge_weight: float = 1e6
    convergence_delta: float = 1e-6
    cg_iterations: int = 100
    cg_tolerance: float = 1e-10  # relative to |b|^2


def _edge_res(Ti, Tj, z_inv, d):
    """Residual of edges at the stacked perturbation d = [d_i | d_j]
    (..., 12)."""
    rel = se3.invert_transform(Ti @ se3.se3_exp(d[..., :6])) @ (
        Tj @ se3.se3_exp(d[..., 6:])
    )
    return se3.se3_log(z_inv @ rel)


def _edge_res_and_jac(Ti, Tj, z_inv):
    """(r (E, 6), J (E, 6, 12)) at d = 0, J by jacfwd vmapped over edges."""
    zero = torch.zeros(12, dtype=Ti.dtype, device=Ti.device)

    def one(a, b, z):
        J, r = jacfwd(_with_aux(lambda d: _edge_res(a, b, z, d)), has_aux=True)(zero)
        return r, J

    return vmap(one)(Ti, Tj, z_inv)


def _edge_res_only(Ti, Tj, z_inv):
    """(E, 6) residuals at d = 0, for the LM trials' error evaluations."""
    return _edge_res(Ti, Tj, z_inv, torch.zeros(Ti.shape[:-2] + (12,), dtype=Ti.dtype,
                                                 device=Ti.device))


def _prior_res_and_jac(T0, prior_inv):
    """(r_p (6,), J_p (6, 6)) of the unary prior log(prior_pose^-1 T_0 exp(d))."""
    zero = torch.zeros(6, dtype=T0.dtype, device=T0.device)
    Jp, rp = jacfwd(_with_aux(lambda d: se3.se3_log(prior_inv @ (T0 @ se3.se3_exp(d)))),
                    has_aux=True)(zero)
    return rp, Jp


def _quad(r, W):
    return torch.einsum("ea,eab,eb->", r, W, r)


class _Linearization(NamedTuple):
    """One Gauss-Newton iteration's normal equations: the error (+inf where
    not finite), b (K, 6), the preconditioner's blocks D without lambda
    (K, 6, 6) and U (K, 6, 6), and the per-edge and prior blocks the CG's
    products read."""

    err: torch.Tensor
    b: torch.Tensor
    Pblocks: torch.Tensor
    U: torch.Tensor
    Hii: torch.Tensor
    Hij: torch.Tensor
    HijT: torch.Tensor
    Hjj: torch.Tensor
    Hp: torch.Tensor


class _PoseGraph:
    """The solve's fixed inputs and the steps both forms share (the JAX
    module's closures over them): the linearization, the damped product with
    the system's matrix and the total error.  With `reduce` (the JAX
    package's `axis_name`: a sum all-reduce over the ranks of a mesh) the
    edge tensors are this rank's block, and every edge-indexed sum (the
    error, b, the diagonal and chain blocks, every CG product) is completed
    by it; the replicated prior and gauge terms are added after the sum, so
    they count once."""

    def __init__(self, poses, edge_i, edge_j, z_inv, edge_info, prior_info, prior_pose,
                 gauge_w, reduce=None):
        self.k = k = poses.shape[0]
        self.edge_i, self.edge_j, self.z_inv, self.edge_info = edge_i, edge_j, z_inv, edge_info
        self.prior_info, self.reduce = prior_info, reduce
        self.f32 = f32 = dict(dtype=torch.float32, device=poses.device)
        self.gauge = torch.zeros((k, 6), **f32)
        self.gauge[0].fill_(gauge_w)
        self.gauge_blk = torch.diag_embed(self.gauge)
        self.eye6 = torch.eye(6, **f32)
        self.prior_inv = se3.invert_transform(prior_pose)
        self.inf = torch.full((), float("inf"), **f32)
        is_fwd = edge_j == edge_i + 1
        is_bwd = edge_i == edge_j + 1
        self.up_fwd = torch.where(is_fwd, edge_i, k)
        self.up_bwd = torch.where(is_bwd, edge_j, k)

    def ps(self, v):
        return v if self.reduce is None else self.reduce(v)

    def total_err(self, T):
        r = _edge_res_only(T[self.edge_i], T[self.edge_j], self.z_inv)
        rp = se3.se3_log(self.prior_inv @ T[0])
        e = self.ps(_quad(r, self.edge_info)) + rp @ self.prior_info @ rp
        # poses pushed out of se3_log's domain read as infinitely bad
        return torch.where(torch.isfinite(e), e, self.inf)

    def final_err(self, T):
        r = _edge_res_only(T[self.edge_i], T[self.edge_j], self.z_inv)
        return self.ps(_quad(r, self.edge_info))

    def linearize(self, T) -> _Linearization:
        k, f32, edge_info = self.k, self.f32, self.edge_info
        edge_i, edge_j = self.edge_i, self.edge_j
        r, J = _edge_res_and_jac(T[edge_i], T[edge_j], self.z_inv)  # (E, 6), (E, 6, 12)
        Ji, Jj = J[:, :, :6], J[:, :, 6:]
        WJi = torch.einsum("eab,ebd->ead", edge_info, Ji)
        WJj = torch.einsum("eab,ebd->ead", edge_info, Jj)
        Hii = torch.einsum("ead,eam->edm", Ji, WJi)
        Hij = torch.einsum("ead,eam->edm", Ji, WJj)
        Hjj = torch.einsum("ead,eam->edm", Jj, WJj)
        bi = torch.einsum("ead,ea->ed", WJi, r)
        bj = torch.einsum("ead,ea->ed", WJj, r)
        err = self.ps(_quad(r, edge_info))

        # unary prior on pose 0: r_p(d0) = log(prior_pose^-1 T_0 exp(d0))
        rp, Jp = _prior_res_and_jac(T[0], self.prior_inv)
        WJp = self.prior_info @ Jp
        Hp = Jp.transpose(0, 1) @ WJp
        bp = WJp.transpose(0, 1) @ rp
        err = err + rp @ self.prior_info @ rp
        # a non-finite linearization error would reject every trial; read as
        # infinitely bad, any finite trial is accepted
        err = torch.where(torch.isfinite(err), err, self.inf)

        b = self.ps(torch.zeros((k, 6), **f32).index_add_(0, edge_i, bi).index_add_(0, edge_j, bj))
        b[0].add_(bp)
        # the preconditioner: per-pose diagonal blocks and the odometry
        # chain's super-diagonal, from chain edges in either storage order
        Pblocks = self.ps(torch.zeros((k, 6, 6), **f32).index_add_(0, edge_i, Hii).index_add_(
            0, edge_j, Hjj))
        Pblocks[0].add_(Hp)
        Pblocks = Pblocks + self.gauge_blk
        U = self.ps(torch.zeros((k + 1, 6, 6), **f32).index_add_(0, self.up_fwd, Hij).index_add_(
            0, self.up_bwd, Hij.transpose(-1, -2)))[:k].contiguous()
        return _Linearization(err, b, Pblocks, U, Hii, Hij, Hij.transpose(-1, -2), Hjj, Hp)

    def matvec(self, lin, x, lam):
        """(H + gauge + lam I) x for the linearization's H."""
        xi, xj = x[self.edge_i], x[self.edge_j]
        yi = torch.einsum("edm,em->ed", lin.Hii, xi) + torch.einsum("edm,em->ed", lin.Hij, xj)
        yj = torch.einsum("edm,em->ed", lin.HijT, xi) + torch.einsum("edm,em->ed", lin.Hjj, xj)
        y = self.ps(torch.zeros((self.k, 6), **self.f32).index_add_(0, self.edge_i, yi)
                    .index_add_(0, self.edge_j, yj))
        y[0].add_(lin.Hp @ x[0])
        return y + self.gauge * x + lam * x

    def factor(self, lin, lam, tolerance):
        """The block-Thomas factor of the damped preconditioner, and the
        CG's stopping threshold tolerance max(|b|^2, 1e-30)."""
        Cinv, G = block_tridiag_factor((lin.Pblocks + lam * self.eye6).contiguous(), lin.U)
        return Cinv, G, tolerance * torch.clamp(torch.sum(lin.b * lin.b), min=1e-30)


def _optimize_sparse(poses, edge_i, edge_j, z_inv, edge_info, prior_info, prior_pose,
                     gauge_w: float, config: SparsePGConfig, reduce=None) -> PoseGraphResult:
    """The sparse Gauss-Newton + block-PCG solve on tensors of one device,
    in the eager form: the PCG `cg_iterations` masked iterations, one host
    read an LM trial and one a Gauss-Newton iteration.  With `reduce`, the
    edge-sharded solve (`_PoseGraph`): the poses and the CG state stay
    replicated, so every rank walks the same trajectory."""
    g = _PoseGraph(poses, edge_i, edge_j, z_inv, edge_info, prior_info, prior_pose, gauge_w, reduce)
    dev = poses.device
    stats = optimize_pose_graph_sparse

    T, lam, it, conv = poses, torch.full((), config.damping, **g.f32), 0, False
    conv_t = torch.zeros((), dtype=torch.bool, device=dev)
    while it < config.max_iterations and not conv:
        lin = g.linearize(T)

        def pcg(lam):
            Cinv, G, thresh = g.factor(lin, lam, config.cg_tolerance)
            b = lin.b
            x = torch.zeros_like(b)
            res = b
            z = block_tridiag_apply(Cinv, G, lin.U, res)
            p, rz = z, torch.sum(res * z)
            active = torch.sum(res * res) > thresh
            run = torch.zeros((), dtype=torch.int32, device=dev)
            for i in range(config.cg_iterations):
                run = run + active.to(torch.int32)  # the JAX loop runs iteration i
                Ap = g.matvec(lin, p, lam)
                alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
                x_new = x + alpha * p
                # a residual recomputed every 64 iterations guards f32 drift
                res_new = (b - g.matvec(lin, x_new, lam) if (i + 1) % cpg.CG_REFRESH == 0
                           else res - alpha * Ap)
                z = block_tridiag_apply(Cinv, G, lin.U, res_new)
                rz_new = torch.sum(res_new * z)
                beta = rz_new / torch.clamp(rz, min=1e-30)
                p_new = z + beta * p
                x = torch.where(active, x_new, x)
                res = torch.where(active, res_new, res)
                p = torch.where(active, p_new, p)
                rz = torch.where(active, rz_new, rz)
                active = active & (torch.sum(res * res) > thresh)
            stats.pcgs += 1
            stats.cg_iterations_run = stats.cg_iterations_run + run
            return x

        # Levenberg inner loop: the same linearization with growing damping
        # until a step lowers the total error
        accepted = False
        for _trial in range(config.lm_max_trials):
            delta = -pcg(lam)
            T_try = T @ se3.se3_exp(delta)
            ok = g.total_err(T_try) < lin.err
            lam = torch.where(ok, torch.clamp(lam * 0.1, min=1e-7), lam * 10.0)
            stats.trials += 1
            stats.host_syncs += 1
            if bool(ok):  # the one host read an LM trial
                T, accepted = T_try, True
                break
        it += 1
        if accepted:
            conv_t = torch.max(torch.abs(delta)) < config.convergence_delta
            stats.host_syncs += 1
            conv = bool(conv_t)  # the one host read a Gauss-Newton iteration
        else:
            conv_t = torch.ones((), dtype=torch.bool, device=dev)
            conv = True
    err = g.final_err(T)
    # never report success on a non-finite objective (e.g. NaN inputs)
    return PoseGraphResult(poses=T, error=err,
                           iterations=torch.full((), it, dtype=torch.int32, device=dev),
                           converged=conv_t & torch.isfinite(err))


def _optimize_sparse_device(poses, edge_i, edge_j, z_inv, edge_info, prior_info, prior_pose,
                            gauge_w: float, config: SparsePGConfig) -> PoseGraphResult:
    """The same solve in the device form: JAX's three nested while_loops
    (Gauss-Newton, LM trials, PCG) through `graphs.while_loop` and the CG's
    every-64th residual recomputation through `graphs.if_then`, each
    condition set by `cuda_pose_graph.pg_cond` from device scalars.  The
    state lives in device buffers updated in place; the ops are the eager
    form's in its order, so the PCG stops exactly where the eager form's
    mask freezes it and the results are the eager form's bits.  Under a
    capture the loops are conditional nodes; otherwise the host loop over
    the same conditions (the CPU's plain version, CUDA's warm-up)."""
    g = _PoseGraph(poses, edge_i, edge_j, z_inv, edge_info, prior_info, prior_pose, gauge_w)
    dev = poses.device
    i32 = dict(dtype=torch.int32, device=dev)
    flag = lambda: torch.zeros(1, **i32)  # noqa: E731
    scalar = lambda: torch.zeros((), **g.f32)  # noqa: E731
    # Gauss-Newton state
    T = poses.clone()
    lam = torch.full((), config.damping, **g.f32)
    it = torch.zeros((), **i32)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    # the trials' state
    t = torch.zeros((), **i32)
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    T_new = torch.empty_like(T)
    delta = torch.zeros((g.k, 6), **g.f32)
    # the PCG's state
    i = torch.zeros((), **i32)
    x, res, p = (torch.zeros((g.k, 6), **g.f32) for _ in range(3))
    rz, rr, thresh = scalar(), scalar(), scalar()
    gn_flag, trial_flag, cg_flag, refresh_flag = flag(), flag(), flag(), flag()

    def pcg(lin):
        Cinv, G, th = g.factor(lin, lam, config.cg_tolerance)
        thresh.copy_(th)
        x.zero_()
        res.copy_(lin.b)
        z = block_tridiag_apply(Cinv, G, lin.U, res)
        p.copy_(z)
        rz.copy_(torch.sum(res * z))
        rr.copy_(torch.sum(res * res))
        cg = graphs.Condition(cg_flag)
        cpg.pg_cond(cpg.PG_CG_ENTER, config.cg_iterations, i, cg_flag, rr=rr, thresh=thresh,
                    handle=cg.handle)

        def cg_step():
            Ap = g.matvec(lin, p, lam)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x_new = x + alpha * p
            res_new = res - alpha * Ap
            # a residual recomputed every 64 iterations guards f32 drift: a
            # branch, so that the matvec runs only on those iterations
            refresh = graphs.Condition(refresh_flag)
            cpg.pg_cond(cpg.PG_REFRESH, cpg.CG_REFRESH, i, refresh_flag, handle=refresh.handle)
            graphs.if_then(refresh, lambda: res_new.copy_(lin.b - g.matvec(lin, x_new, lam)))
            z = block_tridiag_apply(Cinv, G, lin.U, res_new)
            rz_new = torch.sum(res_new * z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p_new = z + beta * p
            x.copy_(x_new)
            res.copy_(res_new)
            p.copy_(p_new)
            rz.copy_(rz_new)
            rr.copy_(torch.sum(res * res))
            cpg.pg_cond(cpg.PG_CG_STEP, config.cg_iterations, i, cg_flag, rr=rr,
                        thresh=thresh, handle=cg.handle)

        graphs.while_loop(cg, cg_step)
        return x

    def gn_step():
        lin = g.linearize(T)
        T_new.copy_(T)
        delta.zero_()
        accepted.zero_()
        trials = graphs.Condition(trial_flag)
        cpg.pg_cond(cpg.PG_TRIAL_ENTER, config.lm_max_trials, t, trial_flag, stop=accepted,
                    handle=trials.handle)

        def trial():
            d = -pcg(lin)
            T_try = T @ se3.se3_exp(d)
            ok = g.total_err(T_try) < lin.err
            lam.copy_(torch.where(ok, torch.clamp(lam * 0.1, min=1e-7), lam * 10.0))
            T_new.copy_(torch.where(ok, T_try, T))
            delta.copy_(torch.where(ok, d, torch.zeros_like(d)))
            accepted.copy_(ok)
            cpg.pg_cond(cpg.PG_TRIAL_STEP, config.lm_max_trials, t, trial_flag, stop=accepted,
                        handle=trials.handle)

        graphs.while_loop(trials, trial)
        T.copy_(T_new)
        conv.copy_((torch.max(torch.abs(delta)) < config.convergence_delta) | ~accepted)
        cpg.pg_cond(cpg.PG_GN_STEP, config.max_iterations, it, gn_flag, stop=conv,
                    handle=gn.handle)

    gn = graphs.Condition(gn_flag)
    cpg.pg_cond(cpg.PG_GN_ENTER, config.max_iterations, it, gn_flag, stop=conv, handle=gn.handle)
    graphs.while_loop(gn, gn_step)
    err = g.final_err(T)
    # never report success on a non-finite objective (e.g. NaN inputs)
    return PoseGraphResult(poses=T, error=err, iterations=it,
                           converged=conv & torch.isfinite(err))


def _solve_inputs(poses, edge_i, edge_j, edge_rel, edge_info, prior_info, prior_pose,
                  config, dev):
    """The solve's tensors on `dev` (a prior of zeros and the identity when
    none is given) and the gauge weight: with a marginalization prior, pose 0
    is anchored by the prior itself."""
    poses, edge_i, edge_j, edge_info, z_inv = graph_inputs(
        poses, edge_i, edge_j, edge_rel, edge_info, dev)
    have_prior = prior_info is not None
    if have_prior:
        prior_info = _on(prior_info, torch.float32, dev)
        prior_pose = _on(prior_pose, torch.float32, dev)
    else:
        prior_info = torch.zeros((6, 6), dtype=torch.float32, device=dev)
        prior_pose = torch.eye(4, dtype=torch.float32, device=dev)
    gauge_w = 0.0 if have_prior else config.gauge_weight
    return dict(poses=poses, edge_i=edge_i, edge_j=edge_j, z_inv=z_inv, edge_info=edge_info,
                prior_info=prior_info, prior_pose=prior_pose), gauge_w


@f32_matmuls
def optimize_pose_graph_sparse(poses, edge_i, edge_j, edge_rel, edge_info=None,
                               prior_info=None, prior_pose=None,
                               config: SparsePGConfig = SparsePGConfig(),
                               device="cuda", device_loop: bool = True) -> PoseGraphResult:
    """Gauss-Newton + block-PCG pose-graph solve (scales to thousands of
    keyframes; matches `optimize_pose_graph` on small graphs).

    Args:
      poses: (K, 4, 4) initial absolute poses.
      edge_i, edge_j: (E,) endpoints.
      edge_rel: (E, 4, 4) measured relative poses Z_e (i -> j).
      edge_info: optional (E, 6, 6) information matrices.
      prior_info / prior_pose: optional unary prior on pose 0 (from
        sliding-window marginalization): residual log(prior_pose^-1 T_0)
        weighted by prior_info; it replaces the gauge weight.
      device: where it runs (CUDA unless the caller asks for the CPU).
      device_loop: the device form (the default), the JAX package's one
        program: on CUDA one replay of a CUDA graph captured once per
        signature (K, E, whether a prior is given, the config, the device
        and whether deterministic algorithms are on), its loops conditional
        nodes and the PCG stopping at its tolerance, nothing read to the
        host; on the CPU its plain version.  The result's tensors are the
        caller's own.  A signature's first call also pays a warm-up (each
        loop body once) and the capture: the form pays off where
        signatures repeat (a full sliding window, a graph re-solved at one
        size) or where one solve is long; a graph that changes size every
        call captures every call.  False: the eager form.

    The eager form counts, over its calls, its LM trials (`.trials`), PCG
    runs (`.pcgs`), host reads (`.host_syncs`) and, on the device, the CG
    iterations before each PCG's tolerance test failed
    (`.cg_iterations_run`); the device form counts in
    `cuda_pose_graph.pg_counts(device)` instead."""
    dev = _device.resolve(device)
    inputs, gauge_w = _solve_inputs(poses, edge_i, edge_j, edge_rel, edge_info, prior_info,
                                    prior_pose, config, dev)
    if not device_loop:
        return _optimize_sparse(**inputs, gauge_w=gauge_w, config=config)
    key = ("sparse", inputs["poses"].shape[0], inputs["edge_i"].shape[0], gauge_w, config)
    return graphs.replay_cached(key, inputs, lambda **kw: _optimize_sparse_device(
        **kw, gauge_w=gauge_w, config=config), dev)


@f32_matmuls
def optimize_pose_graph_sparse_sharded(mesh, poses, edge_i, edge_j, edge_rel, edge_info=None,
                                       prior_info=None, prior_pose=None,
                                       config: SparsePGConfig = SparsePGConfig()
                                       ) -> PoseGraphResult:
    """The distributed pose-graph solve: the EDGES split across the ranks of
    `mesh` (`parallel.sharded.make_mesh`), the poses replicated.

    Every rank passes the whole graph and linearizes its contiguous block of
    the edges (residuals, 6x12 Jacobians, 6x6 blocks); the normal equations
    and each CG product are completed by a sum all-reduce of (K, 6) or
    (K, 6, 6) floats, so a graph with millions of edges scales by edge count
    while the pose state stays small.  The same trajectory as
    `optimize_pose_graph_sparse` up to the float32 order of the sums.  Edges
    are padded to a multiple of the mesh size with zero-information
    self-loops on pose 0, which add exactly nothing to any sum.  Runs on the
    mesh's device; the counters are `optimize_pose_graph_sparse`'s."""
    dev = mesh.device
    inp, gauge_w = _solve_inputs(poses, edge_i, edge_j, edge_rel, edge_info, prior_info,
                                 prior_pose, config, dev)
    edge_i, edge_j, z_inv, edge_info = (inp[k] for k in ("edge_i", "edge_j", "z_inv",
                                                          "edge_info"))
    e, d = edge_i.shape[0], mesh.size
    pad = (-e) % d
    if pad:
        zeros = torch.zeros(pad, dtype=edge_i.dtype, device=dev)
        edge_i, edge_j = torch.cat([edge_i, zeros]), torch.cat([edge_j, zeros])
        z_inv = torch.cat([z_inv, torch.eye(4, device=dev).expand(pad, 4, 4)])
        edge_info = torch.cat([edge_info, torch.zeros((pad, 6, 6), device=dev)])
    m = (e + pad) // d
    sl = slice(mesh.rank * m, (mesh.rank + 1) * m)
    return _optimize_sparse(inp["poses"], edge_i[sl], edge_j[sl], z_inv[sl].contiguous(),
                            edge_info[sl].contiguous(), inp["prior_info"], inp["prior_pose"],
                            gauge_w, config, reduce=mesh.reduce)


def reset_stats():
    """Set `optimize_pose_graph_sparse`'s counters to 0."""
    f = optimize_pose_graph_sparse
    f.trials = f.pcgs = f.host_syncs = 0
    f.cg_iterations_run = 0


reset_stats()


class SlidingWindowBA:
    """Fixed-size keyframe window with Schur-complement marginalization.

    Keyframes enter with an odometry edge (relative pose + information);
    loop-closure edges between window members can be added at any time.
    When the window exceeds `window`, the oldest pose is marginalized: its
    odometry edge and unary prior are linearized at the current estimate
    (on `device`) and Schur-reduced onto its successor on the host,
        H' = H11 - H10 H00^-1 H01,   b' = b1 - H10 H00^-1 b0,
    which becomes the new unary prior anchoring the window head.  Loop edges
    attached to the departing pose are dropped with a warning.

    The window's state is host numpy, as in the JAX package: `poses` (a list
    of (4, 4) float32 world poses), `edges` ((i, j, rel, info) with global
    indices), `base` (the global index of poses[0]), `prior_pose`,
    `prior_info`.  `optimize` solves on `device` (CUDA unless the caller
    asks for the CPU), in the device form unless `device_loop` is False:
    one replay of the graph captured for the window's (K, E), reused while
    they stay the same.  Marginalization stays on the host, as in JAX.
    """

    def __init__(self, window: int = 20, config: SparsePGConfig = SparsePGConfig(),
                 device="cuda", device_loop: bool = True):
        self.window = int(window)
        self.config = config
        self.device = _device.resolve(device)
        self.device_loop = device_loop
        self.poses = []
        self.edges = []
        self.base = 0
        self.prior_pose = None
        self.prior_info = None

    def add_keyframe(self, rel, info=None) -> None:
        """Append a keyframe connected to the previous one by `rel` (the
        measured relative pose, previous -> new) with information `info`
        (e.g. the registration Hessian)."""
        rel = np.asarray(rel, np.float32)
        info = np.eye(6, dtype=np.float32) if info is None else np.asarray(info, np.float32)
        if not self.poses:
            self.poses = [np.eye(4, dtype=np.float32)]
            self.prior_pose = np.eye(4, dtype=np.float32)
            self.prior_info = 1e6 * np.eye(6, dtype=np.float32)
        g = self.base + len(self.poses) - 1
        self.poses.append((self.poses[-1] @ rel).astype(np.float32))
        self.edges.append((g, g + 1, rel, info))
        while len(self.poses) > self.window:
            self._marginalize_oldest()

    def add_loop_edge(self, i: int, j: int, rel, info=None) -> None:
        """Add a loop-closure edge between global keyframe indices i, j
        (both must still be inside the window)."""
        end = self.base + len(self.poses)
        if not (self.base <= i < end and self.base <= j < end):
            raise ValueError(
                f"loop edge endpoints ({i}, {j}) outside the window "
                f"[{self.base}, {end})"
            )
        info = np.eye(6, dtype=np.float32) if info is None else np.asarray(info, np.float32)
        self.edges.append((i, j, np.asarray(rel, np.float32), info))

    def _marginalize_oldest(self) -> None:
        old = self.base
        keep, drop = [], []
        for ed in self.edges:
            (drop if (ed[0] == old or ed[1] == old) else keep).append(ed)
        odo, extra = [], []
        for ed in drop:
            (odo if {ed[0], ed[1]} == {old, old + 1} else extra).append(ed)
        if extra:
            warnings.warn(
                f"dropping {len(extra)} loop edge(s) attached to marginalized keyframe"
            )
        # the prior's and the odometry edges' residuals and Jacobians at the
        # current estimate: one jacfwd over (d_old, d_next), one host read
        dev = self.device
        T0 = _device.upload(self.poses[0], dev)
        T1 = _device.upload(self.poses[1], dev)
        prior_inv = se3.invert_transform(_device.upload(self.prior_pose, dev))
        m = len(odo)
        z_inv = se3.invert_transform(_device.upload(
            np.stack([ed[2] for ed in odo]) if m else np.zeros((0, 4, 4), np.float32), dev))

        def residuals(d):
            rp = se3.se3_log(prior_inv @ (T0 @ se3.se3_exp(d[:6])))
            re = _edge_res(T0.expand(m, 4, 4), T1.expand(m, 4, 4), z_inv, d.expand(m, 12))
            return torch.cat([rp, re.reshape(-1)])

        Jac, res = jacfwd(_with_aux(residuals), has_aux=True)(
            torch.zeros(12, dtype=torch.float32, device=dev))
        host = torch.cat([Jac.reshape(-1), res]).cpu().numpy()
        n = 6 * (m + 1)
        Jac, res = host[:n * 12].reshape(n, 12), host[n * 12:]
        H = np.zeros((12, 12), np.float32)
        b = np.zeros(12, np.float32)
        # unary prior on the departing pose
        Jp, rp = np.ascontiguousarray(Jac[:6, :6]), res[:6]
        WJp = self.prior_info @ Jp
        H[:6, :6] += Jp.T @ WJp
        b[:6] += WJp.T @ rp
        for e, (_i, _j, _rel, info) in enumerate(odo):
            J, r = np.ascontiguousarray(Jac[6 + 6 * e:12 + 6 * e]), res[6 + 6 * e:12 + 6 * e]
            WJ = info @ J
            H += J.T @ WJ
            b += WJ.T @ r
        # Schur complement: eliminate the departing pose's 6 dof
        H00 = H[:6, :6] + 1e-6 * np.eye(6, dtype=np.float32)
        H01 = H[:6, 6:]
        H11 = H[6:, 6:]
        sol = np.linalg.solve(H00, H01)
        self.prior_info = (H11 - H01.T @ sol).astype(np.float32)
        # the prior residual at the current estimate is folded into the
        # prior's mean: T1's anchor moves to the Schur-reduced b' (first
        # order), d1* = -(H')^-1 b'
        bp = b[6:] - sol.T @ b[:6]
        info_reg = self.prior_info + 1e-6 * np.eye(6, dtype=np.float32)
        d1 = -np.linalg.solve(info_reg, bp)
        self.prior_pose = (T1 @ se3.se3_exp(_device.upload(np.asarray(d1, np.float32), dev))
                           ).cpu().numpy().astype(np.float32)
        self.poses = self.poses[1:]
        self.edges = keep
        self.base += 1

    def optimize(self):
        """Solve the current window (sparse GN + PCG) in place; None for a
        window of fewer than two poses."""
        if len(self.poses) < 2:
            return None
        res = optimize_pose_graph_sparse(
            np.stack(self.poses),
            np.asarray([i - self.base for (i, _, _, _) in self.edges], np.int64),
            np.asarray([j - self.base for (_, j, _, _) in self.edges], np.int64),
            np.stack([r for (_, _, r, _) in self.edges]),
            np.stack([w for (_, _, _, w) in self.edges]),
            prior_info=self.prior_info, prior_pose=self.prior_pose,
            config=self.config, device=self.device, device_loop=self.device_loop,
        )
        self.poses = [p for p in res.poses.cpu().numpy().astype(np.float32)]
        return res
