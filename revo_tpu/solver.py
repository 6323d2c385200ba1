"""SE(3) Gauss-Newton/Levenberg-Marquardt solver over distance-transform
residuals — the hot path.

Replacement for Optimizer::trackFrames / calcErrorAndBuffers /
calculateWarpUpdate + the lsd_slam::LGS6 accumulators
(optimizer.cpp:74-311, utils/LGSX.h:329-398).  Design (SURVEY.md §7):

- The per-point residual pass is dense fixed-shape vector math over the
  (P, 3) edge cloud: transform, project, bilinear-sample the keyframe's
  (gx, gy, dt) structure, Huber-weight, mask.
- The 6x6 normal equations replace the SSE rank-1 accumulation with one
  matmul: A = (w o J)^T J, g = J^T (w o r), at full f32 (HIGHEST) precision.
- The LM accept/reject schedule (lambda *= 0.5 on success, *= 2^incTry on
  failure, convergence on err/lastErr > eps or |inc|^2 <= stepMin,
  optimizer.cpp:250-307) runs as nested lax.while_loops, entirely on device.

Sign conventions follow the reference exactly: the keyframe structure stores
*negated* central differences (imgpyramidrgbd.cpp:267-274), and the update
solves inc = (A + lambda diag(A))^{-1} (sum w J r / n) which is descent under
that sign (optimizer.cpp:258 ``b = -ls.b``).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from revo_tpu import lie
from revo_tpu.config import CameraConfig, OptimizerConfig
from revo_tpu.ops.backproject import EdgeCloud
from revo_tpu.ops.interp import (
    bilinear_sample,
    bilinear_sample_pair,
    bilinear_sample_taps,
    bilinear_sample_window,
    bilinear_sample_window_ob,
    bilinear_sample_quad,
    bilinear_sample_dtquad,
)

def _row_major(struct):
    """Constrain the sample table to row-major (C minor) before gathering.

    Pins the layout XLA may otherwise transpose inside the tracker step,
    at the cost of one copy (the "*_rm" forms of _BILINEAR)."""
    from jax.experimental.layout import Layout, with_layout_constraint

    return with_layout_constraint(
        struct, Layout(tuple(range(struct.ndim)))
    )


_BILINEAR = {
    "take4": bilinear_sample,
    "taps": bilinear_sample_taps,
    "window": bilinear_sample_window,
    "pair": bilinear_sample_pair,
    "take4_rm": lambda s, u, v: bilinear_sample(_row_major(s), u, v),
    "window_rm": lambda s, u, v: bilinear_sample_window(_row_major(s), u, v),
    "window_ob": bilinear_sample_window_ob,
    "window_ob_rm": lambda s, u, v: bilinear_sample_window_ob(
        _row_major(s), u, v
    ),
}


def _sample_quad(
    s, u, v, h_img: int, w_img: int, batched_take: str = "take", lane=None
):
    """Quad-table bilinear dispatch for the "quad" impl: forms are inferred
    from shape (ops.edt.quad_structure).  Callers that only have the
    (H, W, 3) struct fall back to take4, which computes the identical
    result (tests construct structs directly).  ``lane`` marks the
    pre-folded mode: s is a SHARED (H*W, B*4) lane-folded dt table and
    lane is this sequence's index (see gn_level_fixed's hoisted rule)."""
    if lane is not None:
        return bilinear_sample_dtquad(
            s, u, v, h=h_img, w=w_img, lane=lane
        )
    if s.ndim == 3 and s.shape[-1] != 12:
        return bilinear_sample(s, u, v)
    if s.ndim == 2 and s.shape[-1] == 4:  # dt-only table ("dt4"/"dt4bf")
        return bilinear_sample_dtquad(
            s, u, v, h=h_img, w=w_img, batched_take=batched_take
        )
    return bilinear_sample_quad(
        s, u, v, h=h_img, w=w_img, batched_take=batched_take
    )


def _solve_damped(Ad, g, impl: str):
    if impl == "ldlt":
        return solve6_ldlt(Ad, g)
    return jnp.linalg.solve(Ad, g)

_PREC = jax.lax.Precision.HIGHEST


def _apply_rt_cols(pts, R, t):
    """(R @ p + t) for (P, 3) points, returned as (x, y, z) column vectors.

    Written as nine scalar-broadcast multiply-adds instead of a matmul: the
    result is exact f32 whatever the backend's default matmul precision,
    and the elementwise form fuses into the projection arithmetic around
    it.
    """
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    wx = R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z + t[..., 0]
    wy = R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z + t[..., 1]
    wz = R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z + t[..., 2]
    return wx, wy, wz


def solve6_ldlt(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for symmetric positive-(semi)definite 6x6 A with an
    unrolled LDL^T factorization (no pivoting).

    jnp.linalg.solve runs a general pivoting LU; LM's damped normal matrix
    is SPD (the reference uses Eigen ldlt, optimizer.cpp:263), so the
    pivot-free LDL^T is exact for this use and compiles to straight-line
    scalar code.  Singular/0 pivots
    are guarded to keep dead lanes finite; callers already zero non-finite
    increments.
    """
    n = 6
    # Factor: A = L D L^T with unit-diagonal L.
    cols = [A[:, j] for j in range(n)]  # column views (6,)
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = cols[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k] * d[k]
        dj = jnp.where(jnp.abs(s) < 1e-30, 1e-30, s)
        d[j] = dj
        for i in range(j + 1, n):
            t = cols[j][i]
            for k in range(j):
                t = t - L[i][k] * L[j][k] * d[k]
            L[i][j] = t / dj
    # Forward substitution L y = b.
    y = [None] * n
    for i in range(n):
        t = b[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t
    # Diagonal + back substitution L^T x = y / d.
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i] / d[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t
    return jnp.stack(x)


class ResidualInfo(NamedTuple):
    """Optimizer::ResidualInfo (optimizer.h:118-140)."""

    good: jax.Array  # () int32 goodPtsEdges
    bad: jax.Array  # () int32 badPtsEdges (out of bounds + edge-filtered)
    sum_error_weighted: jax.Array  # () f32
    sum_error_unweighted: jax.Array  # () f32


class LevelSystem(NamedTuple):
    """One evaluation: mean error + normalized 6x6 normal equations."""

    err: jax.Array  # () f32: sumErrorWeighted / good
    A: jax.Array  # (6, 6) = sum(w J J^T) / good
    g: jax.Array  # (6,) = sum(w J r) / good  (the reference's -ls.b/n)
    info: ResidualInfo


def _residual_sums(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R: jax.Array,
    t: jax.Array,
    edge_distance: float,
    huber: float,
    use_edge_filter: bool,
    bilinear_impl: str = "take4",
    lane=None,
):
    """Unnormalized accumulation over (a shard of) the edge cloud.

    Returns (A_sum, g_sum, sum_w, sum_unw, n_good, n_bad) — pure sums, so a
    psum over point shards composes exactly (the distributed 'TP analog' of
    SURVEY.md §2.2: the edge-point dimension of the LGS reduction).
    """
    pts = cloud.points  # (P, 3)
    w_img, h_img = cam.width, cam.height

    px, py, pz = _apply_rt_cols(pts, R, t)  # exact-f32 projection
    pz_safe = jnp.where(pz == 0, 1e-12, pz)
    u = px / pz_safe * cam.fx + cam.cx
    v = py / pz_safe * cam.fy + cam.cy
    # Bounds check incl. NaN rejection via inverse test (optimizer.cpp:100).
    in_bounds = (u > 1.0) & (v > 1.0) & (u < w_img - 2.0) & (v < h_img - 2.0)
    in_bounds = in_bounds & cloud.valid

    if bilinear_impl.startswith("quad"):
        # "quad" / "quad_ob" / "quad_lf" / "quad_lf12": the suffix picks
        # the (vmapped) gather form, see interp._QUAD_TAKES.
        take = {
            "quad": "take",
            "quad_ob": "take_ob",
            "quad_fr": "foldrow",
            "quad_lf": "lanefold",
            "quad_lf12": "lanefold12",
        }
        samp = _sample_quad(
            struct, u, v, h_img, w_img, take[bilinear_impl], lane=lane
        )  # (P, 3)
    else:
        samp = _BILINEAR[bilinear_impl](struct, u, v)  # (P, 3): gx, gy, dt
    r = samp[:, 2]
    gx = cam.fx * samp[:, 0]
    gy = cam.fy * samp[:, 1]

    if use_edge_filter:
        pass_filter = r <= edge_distance  # optimizer.cpp:108
    else:
        pass_filter = jnp.ones_like(r, dtype=bool)
    good = in_bounds & pass_filter
    n_bad = (cloud.valid & ~good).sum().astype(jnp.int32)
    n_good = good.sum().astype(jnp.int32)

    # Huber-style weight (optimizer.h:156-160): w = 1 for r <= huber else
    # huber / r (r is a distance, always >= 0).
    r_safe = jnp.where(r == 0, 1.0, r)
    w_r = jnp.where(r <= huber, 1.0, huber / r_safe)
    gm = good.astype(jnp.float32)
    wg = w_r * gm

    # 6-dof Jacobian per point (optimizer.cpp:216-228, Kerl MSc p.34;
    # fx/fy premultiplied onto the gradient).
    iz = 1.0 / pz_safe
    iz2 = iz * iz
    J = jnp.stack(
        [
            iz * gx,
            iz * gy,
            (-px * iz2) * gx + (-py * iz2) * gy,
            (-px * py * iz2) * gx - (1.0 + py * py * iz2) * gy,
            (1.0 + px * px * iz2) * gx + (px * py * iz2) * gy,
            (-py * iz) * gx + (px * iz) * gy,
        ],
        axis=-1,
    )  # (P, 6)
    A = jnp.einsum("pi,pj->ij", J * wg[:, None], J, precision=_PREC)
    gvec = jnp.einsum("pi,p->i", J, wg * r, precision=_PREC)
    sum_w = jnp.sum(wg * r * r)
    sum_unw = jnp.sum(gm * r * r)
    return A, gvec, sum_w, sum_unw, n_good, n_bad


def _normalize_sums(A, gvec, sum_w, sum_unw, n_good, n_bad) -> LevelSystem:
    n = jnp.maximum(n_good, 1).astype(jnp.float32)
    return LevelSystem(
        err=sum_w / n,
        A=A / n,
        g=gvec / n,
        info=ResidualInfo(
            good=n_good,
            bad=n_bad,
            sum_error_weighted=sum_w,
            sum_error_unweighted=sum_unw,
        ),
    )


def residual_system(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R: jax.Array,
    t: jax.Array,
    edge_distance: float,
    huber: float,
    use_edge_filter: bool,
    bilinear_impl: str = "take4",
    lane=None,
) -> LevelSystem:
    """calcErrorAndBuffers + calculateWarpUpdate fused into one dense pass.

    (optimizer.cpp:74-191, 192-234).  All P lanes compute; masks zero the
    invalid ones so the normal equations match the reference's
    good-points-only accumulation divided by the good count (LGSX.h:320-326).
    """
    return _normalize_sums(
        *_residual_sums(
            struct, cloud, cam, R, t, edge_distance, huber, use_edge_filter,
            bilinear_impl, lane,
        )
    )


def residual_system_point_sharded(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R: jax.Array,
    t: jax.Array,
    edge_distance: float,
    huber: float,
    use_edge_filter: bool,
    mesh: jax.sharding.Mesh,
    axis: str = "pt",
) -> LevelSystem:
    """Edge-point-sharded normal equations: the 'tensor parallel' analog for
    VO (SURVEY.md §2.2 TP row) — each device reduces its point shard, the
    6x6 systems meet in a psum over ``axis``.

    cloud arrays must divide by the axis size (pad with invalid lanes).
    """
    import functools as _ft

    from jax.sharding import PartitionSpec as P

    @_ft.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=P(),
    )
    def run(struct_rep, pts, valid, R_rep, t_rep):
        local = EdgeCloud(
            points=pts, valid=valid, count=valid.sum().astype(jnp.int32)
        )
        sums = _residual_sums(
            struct_rep, local, cam, R_rep, t_rep, edge_distance, huber,
            use_edge_filter,
        )
        return tuple(jax.lax.psum(s, axis) for s in sums)

    sums = run(struct, cloud.points, cloud.valid, R, t)
    return _normalize_sums(*sums)


class _LMState(NamedTuple):
    R: jax.Array
    t: jax.Array
    sys: LevelSystem  # system at the last *evaluated* pose (== last accepted)
    last_err: jax.Array
    lam: jax.Array
    iteration: jax.Array  # int32; set to max_its to terminate early


def lm_level(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R0: jax.Array,
    t0: jax.Array,
    opt: OptimizerConfig,
    lvl: int,
    max_inner: int = 32,
):
    """One pyramid level of LM (Optimizer::trackFrames, optimizer.cpp:235-311).

    Returns (R, t, last_err, info).  ``max_inner`` bounds the reference's
    unbounded inner retry loop (lambda doubles per retry, so the step shrinks
    below stepSizeMin long before 32 tries).
    """
    max_its = opt.max_its_per_lvl[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]

    def evaluate(R, t):
        return residual_system(
            struct, cloud, cam, R, t, edge_dist, opt.huber_edge,
            opt.use_edge_filter, opt.bilinear_impl,
        )

    sys0 = evaluate(R0, t0)
    # Derive scalar carries from the inputs so their varying axes match the
    # loop body outputs under shard_map.
    izero = sys0.info.good * 0
    fzero = sys0.err * 0
    state0 = _LMState(
        R=R0,
        t=t0,
        sys=sys0,
        last_err=sys0.err,
        lam=fzero + opt.lambda_initial[lvl],
        iteration=izero,
    )

    class Inner(NamedTuple):
        state: _LMState
        inc_try: jax.Array
        done: jax.Array

    def outer_cond(st: _LMState):
        return st.iteration < max_its

    def outer_body(st: _LMState):
        A = st.sys.A
        g = st.sys.g

        def inner_cond(inn: Inner):
            return (~inn.done) & (inn.inc_try < max_inner)

        def inner_body(inn: Inner):
            s = inn.state
            # Damped solve: A(i,i) *= 1 + lambda (optimizer.cpp:261-262).
            Ad = A + jnp.diag(jnp.diag(A) * s.lam)
            inc = _solve_damped(Ad, g, opt.solve6_impl)
            inc = jnp.where(jnp.isfinite(inc), inc, 0.0)
            inc_try = inn.inc_try + 1
            dR, dt_ = lie.exp_se3(inc)
            Rn, tn = lie.compose(dR, dt_, s.R, s.t)
            sys_n = evaluate(Rn, tn)
            err = sys_n.err

            accept = err < s.last_err
            # On accept: converged if err/lastErr > eps -> iteration = max.
            converged = err / jnp.maximum(s.last_err, 1e-30) > conv_eps
            it_acc = jnp.where(converged, max_its, s.iteration)
            lam_acc = jnp.where(
                s.lam <= 0.2, 0.0, s.lam * opt.lambda_success_fac
            )
            # On reject: stop level if |inc|^2 <= stepMin, else raise lambda
            # by failFac^incTry (optimizer.cpp:294-303).
            small_step = ~(jnp.sum(inc * inc) > step_min)
            it_rej = jnp.where(small_step, max_its, s.iteration)
            lam_rej = jnp.where(
                s.lam == 0.0,
                0.2,
                s.lam * opt.lambda_fail_fac ** inc_try.astype(jnp.float32),
            )

            new_state = _LMState(
                R=jnp.where(accept, Rn, s.R),
                t=jnp.where(accept, tn, s.t),
                sys=jax.tree.map(
                    lambda a, b: jnp.where(accept, a, b), sys_n, s.sys
                ),
                last_err=jnp.where(accept, err, s.last_err),
                lam=jnp.where(accept, lam_acc, lam_rej),
                iteration=jnp.where(accept, it_acc, it_rej),
            )
            done = accept | small_step
            return Inner(state=new_state, inc_try=inc_try, done=done)

        inn0 = Inner(
            state=st,
            inc_try=st.iteration * 0,
            done=st.last_err < -jnp.inf,  # False, with input-derived sharding
        )
        inn = jax.lax.while_loop(inner_cond, inner_body, inn0)
        s = inn.state
        return _LMState(
            R=s.R,
            t=s.t,
            sys=s.sys,
            last_err=s.last_err,
            lam=s.lam,
            iteration=jnp.minimum(s.iteration + 1, jnp.int32(max_its)),
        )

    final = jax.lax.while_loop(outer_cond, outer_body, state0)
    return final.R, final.t, final.last_err, final.sys.info


def _gn_level_fixed(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R0: jax.Array,
    t0: jax.Array,
    opt: OptimizerConfig,
    lvl: int,
    lane=None,
):
    """Bounded branchless LM (the fixed-iteration path; SURVEY.md §7).

    One fused evaluation per iteration: the candidate pose's system doubles
    as the next iteration's linearization when accepted; on rejection the
    damping quadruples and the old system is kept.  Runs as a while_loop
    bounded by fixed_iters with convergence exits: err/lastErr > eps on
    accept (optimizer.cpp:250-307), and on reject the symmetric test —
    a candidate that is barely WORSE (err/lastErr < 2 - eps) means the
    basin is flat and the level is converged.  The reference's reject exit
    (|inc|^2 <= stepSizeMin = 1e-16) instead needs ~15 lambda escalations
    to trigger, burning a full residual evaluation each.  Rejects that overshoot by
    more than the eps band keep iterating with raised damping (ATE-parity
    gated by test_solver_modes / test_batch).  Under vmap the loop runs to
    the WORST trip count across the batch.
    """
    iters = opt.fixed_iters[lvl]
    edge_dist = opt.edge_distance_lvl[lvl]
    conv_eps = opt.convergence_eps[lvl]
    step_min = opt.step_size_min[lvl]

    def evaluate(R, t):
        return residual_system(
            struct, cloud, cam, R, t, edge_dist, opt.huber_edge,
            opt.use_edge_filter, opt.bilinear_impl, lane,
        )

    # The initial linearization is folded INTO the loop: with a zero
    # system and infinite error, iteration 0's damped solve yields inc=0,
    # so its "candidate" is exactly (R0, t0) and it always accepts —
    # a pure evaluation of the initial pose.  This keeps every residual
    # gather in the while-body (one gather site per level instead of two).
    tie = (R0.sum() + t0.sum()) * 0  # input-derived varying axes
    sys0 = LevelSystem(
        err=tie + jnp.inf,
        A=jnp.zeros((6, 6), jnp.float32) + tie,
        g=jnp.zeros(6, jnp.float32) + tie,
        info=ResidualInfo(
            good=jnp.int32(0) + tie.astype(jnp.int32),
            bad=jnp.int32(0) + tie.astype(jnp.int32),
            sum_error_weighted=tie,
            sum_error_unweighted=tie,
        ),
    )
    lam0 = tie + opt.lambda_initial[lvl] + 1e-5
    i0 = jnp.int32(0) + tie.astype(jnp.int32)
    done0 = tie < -jnp.inf  # False, with input-derived varying axes

    def cond(carry):
        i, inc_try, R, t, sys, lam, done = carry
        return (i < iters + 1) & ~done

    def body(carry):
        i, inc_try, R, t, sys, lam, done = carry
        Ad = sys.A + jnp.diag(jnp.diag(sys.A) * lam)
        inc = _solve_damped(Ad, sys.g, opt.solve6_impl)
        inc = jnp.where(jnp.isfinite(inc), inc, 0.0)
        dR, dt_ = lie.exp_se3(inc)
        Rn, tn = lie.compose(dR, dt_, R, t)
        sys_n = evaluate(Rn, tn)
        accept = sys_n.err < sys.err
        ratio = sys_n.err / jnp.maximum(sys.err, 1e-30)
        converged = ratio > conv_eps
        flat = ratio < (2.0 - conv_eps)
        small_step = ~(jnp.sum(inc * inc) > step_min)
        done = jnp.where(accept, converged, small_step | flat)
        # Iteration 0 is the baseline evaluation: always accepted (err <
        # inf), never converged (ratio 0), and must not decay lambda.
        first = i == 0
        done = done & ~first
        R = jnp.where(accept, Rn, R)
        t = jnp.where(accept, tn, t)
        sys = jax.tree.map(lambda a, b: jnp.where(accept, a, b), sys_n, sys)
        # Reject chains keep the linearization, so each retry only re-damps
        # the same system — escalate lambda like the reference's inner retry
        # loop (optimizer.cpp:294-303): from ~0 jump straight to 0.2, then
        # multiply by failFac^incTry (superexponential).  A constant x4
        # needs ~10 full residual evaluations to climb from 1e-5 to the
        # accepting damping; this schedule gets there in ~4.
        inc_try = jnp.where(accept, 0, inc_try + 1)
        lam_fail = jnp.where(
            lam < 0.2,
            jnp.maximum(lam * opt.lambda_fail_fac, 0.2),
            lam * opt.lambda_fail_fac ** inc_try.astype(jnp.float32),
        )
        lam = jnp.where(
            first, lam, jnp.where(accept, lam * opt.lambda_success_fac, lam_fail)
        )
        return i + 1, inc_try, R, t, sys, lam, done

    _, _, R, t, sys, _, _ = jax.lax.while_loop(
        cond, body, (i0, i0, R0, t0, sys0, lam0, done0)
    )
    return R, t, sys.err, sys.info


def gn_level_fixed(
    struct: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R0: jax.Array,
    t0: jax.Array,
    opt: OptimizerConfig,
    lvl: int,
):
    """_gn_level_fixed with a fold-hoisting batching rule for the lane-fold
    gather form.

    The quad_lf vmap rule folds the B per-sequence dt tables into one
    shared (H*W, B*4) operand so the solver gather keeps the single-row
    2-D form — but when that rule fires INSIDE the solver while-loop body,
    XLA re-materializes the fold's layout copy every iteration, a cost
    that grows ~B^2.

    This wrapper gives the WHOLE level solve a custom batching rule: fold
    the stacked tables ONCE outside the while loop, then vmap the inner
    solve over per-sequence lanes against the shared pre-folded table
    (``lane`` selects each row's 4 components with an exact one-hot).
    Bit-identical to the in-rule fold: same gather, same select, only the
    fold's position in the program changes.
    """
    if not (
        opt.bilinear_impl == "quad_lf"
        and hasattr(struct, "ndim")
        and struct.ndim == 2
        and struct.shape[-1] == 4
    ):
        return _gn_level_fixed(struct, cloud, cam, R0, t0, opt, lvl)

    @jax.custom_batching.custom_vmap
    def run(struct_, pts, valid, count, R0_, t0_):
        return _gn_level_fixed(
            struct_, EdgeCloud(pts, valid, count), cam, R0_, t0_, opt, lvl
        )

    @run.def_vmap
    def _rule(axis_size, in_batched, struct_, pts, valid, count, R0_, t0_):
        if not all(jax.tree.leaves(in_batched)):
            # Mixed batching (e.g. shared frame vs a keyframe ring): the
            # plain vmap of the unhoisted solve is today's behavior.
            axes = tuple(0 if b else None for b in in_batched)

            def prim(s, p, v, n, R, t):
                return _gn_level_fixed(
                    s, EdgeCloud(p, v, n), cam, R, t, opt, lvl
                )

            out = jax.vmap(prim, in_axes=axes)(
                struct_, pts, valid, count, R0_, t0_
            )
            return out, jax.tree.map(lambda _: True, out)
        b = axis_size
        hw, c = struct_.shape[1], struct_.shape[2]
        # The fold, ONCE, outside the while loop (the whole point).
        # lane_select="flat" keeps the same transpose but flattens lane-
        # major to (H*W*B, 4) so the per-point gather row index carries
        # the lane (base*B + lane) and fetches only 4 components;
        # "onehot" keeps the (H*W, B*4) wide-row + one-hot-select form.
        if opt.lane_select == "flat":
            tab = jnp.transpose(struct_, (1, 0, 2)).reshape(hw * b, c)
        elif opt.lane_select == "onehot":
            tab = jnp.transpose(struct_, (1, 0, 2)).reshape(hw, b * c)
        else:
            # A/B knob guard: a typo must not silently run the onehot form.
            raise ValueError(
                f"unknown lane_select {opt.lane_select!r}; "
                "expected 'onehot' or 'flat'"
            )
        lanes = jnp.arange(b, dtype=jnp.int32)

        def one(lane, p, v, n, R, t):
            return _gn_level_fixed(
                tab, EdgeCloud(p, v, n), cam, R, t, opt, lvl, lane=lane
            )

        out = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))(
            lanes, pts, valid, count, R0_, t0_
        )
        return out, jax.tree.map(lambda _: True, out)

    return run(struct, cloud.points, cloud.valid, cloud.count, R0, t0)


def solve_level(struct, cloud, cam, R0, t0, opt, lvl):
    """Dispatch on OptimizerConfig.solver."""
    if opt.solver == "gn_fixed":
        return gn_level_fixed(struct, cloud, cam, R0, t0, opt, lvl)
    return lm_level(struct, cloud, cam, R0, t0, opt, lvl)


def eval_cost(
    dt_img: jax.Array,
    cloud: EdgeCloud,
    cam: CameraConfig,
    R: jax.Array,
    t: jax.Array,
    edge_distance: float,
    use_edge_filter: bool,
    normalized: bool = False,
) -> jax.Array:
    """TrackerNew::evalCostFunction (tracker.cpp:356-393): sum of
    floor-sampled DT values over in-bounds points, with the edge filter.

    ``normalized=True`` divides by the contributing-point count — an
    improvement over the reference, whose raw sum rewards poses that project
    points out of bounds (see TrackerConfig.normalized_init_cost).

    A "penalized mean" variant (clamp far samples to ``edge_distance``,
    charge out-of-bounds points the full penalty, average over ALL valid
    points) was tried and REVERTED: it looks more principled (the
    drop-based metrics score a badly-wrong pose low when most points are
    dropped), but it regressed trajectory accuracy 0.2 -> 11.9 cm ATE on
    the depth-holes suite (test_gn_fixed_with_holes) — the drop-based
    comparison apparently errs toward identity in exactly the frames
    where the motion prior is unreliable."""
    pts = cloud.points
    wx, wy, wz = _apply_rt_cols(pts, R, t)  # exact-f32 projection
    pz = jnp.where(wz == 0, 1e-12, wz)
    u = wx / pz * cam.fx + cam.cx
    v = wy / pz * cam.fy + cam.cy
    inb = (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
    inb = inb & cloud.valid
    ui = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, cam.width - 1)
    vi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, cam.height - 1)
    # Floor-sample via the lane-fold row take: under vmap (batched
    # sequences) a 2-component gather2d becomes a batch-dim gather — the
    # same issue as the solver's quad rows (quad_lf) and the compaction row
    # takes; the fold keeps the single-row 2-D form.
    # Bit-identical: primal is a plain width-1 row take of the same clipped
    # indices, and the batched one-hot select is exact.
    from revo_tpu.ops.interp import _take_rows_lanefold

    res = _take_rows_lanefold(
        dt_img.reshape(-1, 1), vi * cam.width + ui
    )[:, 0]
    if use_edge_filter:
        ok = inb & (res <= edge_distance)
    else:
        ok = inb
    total = jnp.sum(jnp.where(ok, res, 0.0))
    if normalized:
        return total / jnp.maximum(ok.sum(), 1).astype(jnp.float32)
    return total
