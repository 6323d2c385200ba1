"""Windowed multi-frame joint pose optimization ("windowed BA").

The reference declares but never ships this capability (its
``windowedoptimization`` module is commented out of the build,
CMakeLists.txt:152-153, and ``Optimizer::bundleAdjustment`` is declared but
undefined, optimizer.h:164-165).  Here it is, device-first:

A window of W frames is optimized JOINTLY: every ordered pair (i, j) from a
chosen co-visibility set contributes edge-alignment residuals — frame j's
edge cloud projected into frame i's DT structure (the same residual the
tracker minimizes pairwise, solver.py) — and one Gauss-Newton step couples
all 6W pose unknowns through the stacked normal equations

    H[i,i] += Ji^T W Ji,  H[i,j] += Ji^T W Jj,  ... b[i] -= Ji^T W r

with the pair Jacobians chained from the relative-pose Jacobian of the
tracker via the adjoint.  There are no landmark unknowns (edge-DT residuals
marginalize structure by construction), so the system is already the
"reduced camera system" a Schur complement would produce in feature BA.

Distribution (BASELINE.json config 5): pairs are sharded across a mesh axis
with shard_map; each device accumulates its pairs' block contributions and
the (W, W, 6, 6) Hessian is reduced with psum — collectives ride ICI.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from revo_tpu import lie
from revo_tpu.config import CameraConfig, OptimizerConfig
from revo_tpu.ops.interp import bilinear_sample

_PREC = jax.lax.Precision.HIGHEST


class Window(NamedTuple):
    """Fixed-shape window state at ONE pyramid level.

    structs: (W, H, Wd, 3) per-frame DT structures
    points:  (W, P, 3) per-frame edge clouds, valid (W, P)
    poses:   (W, 4, 4) world-from-frame initial poses
    """

    structs: jax.Array
    points: jax.Array
    valid: jax.Array
    poses: jax.Array


def _pair_system(
    struct_i: jax.Array,
    pts_j: jax.Array,
    valid_j: jax.Array,
    T_i: jax.Array,
    T_j: jax.Array,
    cam: CameraConfig,
    huber: float,
    edge_distance: float,
):
    """Residuals of frame j's cloud in frame i's DT + per-pose Jacobians.

    Let T_rel = T_i^-1 T_j (j-frame -> i-frame).  r(p) = DT_i(proj(T_rel p)).
    d r / d xi_rel is the tracker's 6-dof Jacobian (solver.py:150-166).
    With left-multiplicative world updates T_k <- exp(xi_k) T_k:
        d xi_rel / d xi_j =  Ad(T_i^-1),   d xi_rel / d xi_i = -Ad(T_i^-1).
    Returns (Jr (P, 6) w.r.t. xi_rel, Ad (6, 6), r, w, good-mask).
    """
    T_rel = lie.mm(jnp.linalg.inv(T_i), T_j)
    R, t = T_rel[:3, :3], T_rel[:3, 3]
    # Exact-f32 projection via elementwise multiply-adds
    # (solver._apply_rt_cols), whatever the default matmul precision.
    from revo_tpu.solver import _apply_rt_cols

    wx, wy, wz = _apply_rt_cols(pts_j, R, t)
    pz = jnp.where(wz == 0, 1e-12, wz)
    u = wx / pz * cam.fx + cam.cx
    v = wy / pz * cam.fy + cam.cy
    inb = (u > 1.0) & (v > 1.0) & (u < cam.width - 2.0) & (
        v < cam.height - 2.0
    )
    inb = inb & valid_j
    samp = bilinear_sample(struct_i, u, v)
    r = samp[:, 2]
    good = inb & (r <= edge_distance)
    gx = cam.fx * samp[:, 0]
    gy = cam.fy * samp[:, 1]
    r_safe = jnp.where(r == 0, 1.0, r)
    w = jnp.where(r <= huber, 1.0, huber / r_safe) * good

    iz = 1.0 / pz
    iz2 = iz * iz
    px, py = wx, wy
    Jr = jnp.stack(
        [
            iz * gx,
            iz * gy,
            (-px * iz2) * gx + (-py * iz2) * gy,
            (-px * py * iz2) * gx - (1.0 + py * py * iz2) * gy,
            (1.0 + px * px * iz2) * gx + (px * py * iz2) * gy,
            (-py * iz) * gx + (px * iz) * gy,
        ],
        axis=-1,
    )
    Ti_inv = jnp.linalg.inv(T_i)
    Ad = lie.adjoint_se3(Ti_inv[:3, :3], Ti_inv[:3, 3])
    return Jr, Ad, r, w, good


def _accumulate_pairs(
    window: Window,
    pair_i: jax.Array,
    pair_j: jax.Array,
    pair_w: jax.Array,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int,
    n_frames: int,
):
    """Block normal equations over a (possibly sharded) set of pairs."""
    huber = opt.huber_edge
    edge_dist = opt.edge_distance_lvl[lvl]

    def one_pair(pi, pj, pw):
        Jr, Ad, r, w, good = _pair_system(
            window.structs[pi],
            window.points[pj],
            window.valid[pj],
            window.poses[pi],
            window.poses[pj],
            cam,
            huber,
            edge_dist,
        )
        n = jnp.maximum(good.sum(), 1).astype(jnp.float32)
        # Relative-frame system, then chain to world frames via Ad.
        A_rel = jnp.einsum("pi,pj->ij", Jr * w[:, None], Jr, precision=_PREC) / n
        g_rel = jnp.einsum("pi,p->i", Jr, w * r, precision=_PREC) / n
        # J_j = Jr Ad, J_i = -Jr Ad  (w.r.t. world tangents)
        A_blk = lie.mm(lie.mm(Ad.T, A_rel), Ad) * pw  # (6, 6)
        g_blk = lie.mv(Ad.T, g_rel) * pw  # (6,)
        err = jnp.sum(w * r * r) / n * pw
        return A_blk, g_blk, err

    A_blks, g_blks, errs = jax.vmap(one_pair)(pair_i, pair_j, pair_w)

    H = jnp.zeros((n_frames, n_frames, 6, 6), jnp.float32)
    b = jnp.zeros((n_frames, 6), jnp.float32)
    H = H.at[pair_j, pair_j].add(A_blks)
    H = H.at[pair_i, pair_i].add(A_blks)
    H = H.at[pair_i, pair_j].add(-A_blks)
    H = H.at[pair_j, pair_i].add(-A_blks)
    b = b.at[pair_j].add(g_blks)
    b = b.at[pair_i].add(-g_blks)
    return H, b, errs.sum()


def _window_step(poses, H, b, n_frames, lam):
    """Damped joint step: returns (updated poses, stacked tangent xi).

    Gauge freedom is removed by fixing frame 0 (its rows/cols are masked
    and its diagonal pinned), matching standard pose-graph gauge fixing.
    """
    Hd = H.transpose(0, 2, 1, 3).reshape(6 * n_frames, 6 * n_frames)
    bd = b.reshape(6 * n_frames)
    mask = jnp.ones(6 * n_frames).at[:6].set(0.0)  # gauge: fix frame 0
    Hd = Hd * mask[:, None] * mask[None, :]
    # Multiplicative LM damping (A_ii *= 1 + lambda, like the tracker,
    # optimizer.cpp:261-262) — plain GN overshoots on the nonconvex DT
    # surface.
    diag = jnp.diag(Hd)
    Hd = Hd + jnp.diag(
        jnp.where(mask > 0, diag * lam + 1e-9, 1.0)
    )
    bd = bd * mask
    # The tracker's sign convention: g accumulates +J^T w r and the update
    # is exp(+H^-1 g) thanks to the negated DT gradients (solver.py header).
    xi = jnp.linalg.solve(Hd, bd).reshape(n_frames, 6)
    xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
    dR, dt = lie.exp_se3(xi)
    return lie.mm(lie.matrix_from_rt(dR, dt), poses), xi


class _WinLMState(NamedTuple):
    poses: jax.Array  # (W, 4, 4) last ACCEPTED poses
    H: jax.Array  # system at last accepted poses
    b: jax.Array
    err: jax.Array  # () error at last accepted poses
    lam: jax.Array  # () LM damping
    inc_try: jax.Array  # () int32 consecutive rejects
    k: jax.Array  # () int32 iteration
    done: jax.Array  # () bool


def _lm_window(
    poses0,
    accumulate,
    n_frames: int,
    iters: int,
    lam0: float,
    success_fac: float = 0.5,
    fail_fac: float = 2.0,
    conv_eps: float = 0.999,
    step_min: float = 1e-16,
):
    """Accept/reject LM over the window (the tracker's schedule,
    optimizer.cpp:250-307, applied to the joint 6W-dof system): a step is
    kept only if the total windowed error drops; rejected steps restore the
    last accepted poses and re-solve the SAME system with escalated damping
    (lambda * failFac^try).  Exits on relative improvement > conv_eps, a
    sub-step_min rejected step, or ``iters`` evaluations.

    ``accumulate(poses) -> (H, b, err)`` abstracts the residual pass so the
    sharded path can wrap it in psum and share this exact loop.
    """
    H0, b0, e0 = accumulate(poses0)
    fzero = e0 * 0.0  # input-derived zeros: shard_map-safe carries
    izero = fzero.astype(jnp.int32)
    st0 = _WinLMState(
        poses=poses0,
        H=H0,
        b=b0,
        err=e0,
        lam=fzero + lam0,
        inc_try=izero,
        k=izero,
        done=e0 < -jnp.inf,
    )

    def cond(st: _WinLMState):
        return (st.k < iters) & ~st.done

    def body(st: _WinLMState):
        poses_new, xi = _window_step(st.poses, st.H, st.b, n_frames, st.lam)
        Hn, bn, en = accumulate(poses_new)
        accept = en < st.err
        converged = accept & (
            en / jnp.maximum(st.err, 1e-30) > conv_eps
        )
        small_step = (~accept) & ~(jnp.sum(xi * xi) > step_min)
        lam_acc = jnp.where(st.lam <= 0.2, 0.0, st.lam * success_fac)
        lam_rej = jnp.where(
            st.lam == 0.0,
            0.2,
            st.lam * fail_fac ** (st.inc_try + 1).astype(jnp.float32),
        )
        sel = lambda a, b_: jnp.where(accept, a, b_)
        return _WinLMState(
            poses=sel(poses_new, st.poses),
            H=sel(Hn, st.H),
            b=sel(bn, st.b),
            err=sel(en, st.err),
            lam=sel(lam_acc, lam_rej),
            inc_try=jnp.where(accept, izero, st.inc_try + 1),
            k=st.k + 1,
            done=converged | small_step,
        )

    st = jax.lax.while_loop(cond, body, st0)
    return st.poses, st.err, st.lam


def make_pairs(n_frames: int, radius: int = 2):
    """Co-visibility pairs: all ordered (i, j), i != j, |i - j| <= radius."""
    pi, pj = [], []
    for i in range(n_frames):
        for j in range(n_frames):
            if i != j and abs(i - j) <= radius:
                pi.append(i)
                pj.append(j)
    return (
        jnp.asarray(pi, jnp.int32),
        jnp.asarray(pj, jnp.int32),
        jnp.ones(len(pi), jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("cam", "opt", "lvl"))
def measure_overlap(
    window: Window, cam: CameraConfig, opt: OptimizerConfig, lvl: int = 0
) -> jax.Array:
    """(W, W) measured view overlap: fraction of frame j's valid edge
    points that project in-bounds into frame i AND land within frame i's
    edge-distance band — exactly the residual support the joint optimizer
    will use, evaluated at the current pose estimates.  One vmapped
    dispatch over all ordered pairs; diagonal zeroed."""
    n = window.poses.shape[0]
    huber = opt.huber_edge
    edge_distance = opt.edge_distance_lvl[lvl]

    def one(i, j):
        _, _, _, _, good = _pair_system(
            window.structs[i], window.points[j], window.valid[j],
            window.poses[i], window.poses[j], cam, huber, edge_distance,
        )
        denom = jnp.maximum(window.valid[j].sum(), 1)
        return good.sum() / denom

    ii, jj = jnp.meshgrid(jnp.arange(n), jnp.arange(n), indexing="ij")
    O = jax.vmap(jax.vmap(one))(ii, jj)
    return O * (1.0 - jnp.eye(n, dtype=O.dtype))


def make_pairs_overlap(
    window: Window,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    min_overlap: float = 0.25,
    max_pairs: int | None = None,
):
    """Co-visibility pairs from MEASURED view overlap instead of the fixed
    +-radius index ring: any pair whose overlap fraction clears
    ``min_overlap`` contributes, weighted by its overlap — so revisit
    pairs far apart in time (loop closures) enter the window while
    non-overlapping index neighbours drop out.  The reference stubs this
    entire capability (optimizer.h:164-165).

    Falls back to the +-1 ring when nothing clears the threshold (a window
    must stay connected to be solvable).
    """
    import numpy as np

    O = np.asarray(measure_overlap(window, cam, opt, lvl))
    n = O.shape[0]
    cand = sorted(
        ((float(O[i, j]), i, j) for i in range(n) for j in range(n)
         if i != j and O[i, j] >= min_overlap),
        reverse=True,
    )
    if max_pairs is not None:
        cand = cand[:max_pairs]
    if not cand:
        return make_pairs(n, radius=1)
    # Keep the odometry chain connected even if some consecutive pair
    # dipped under the threshold (gauge connectivity).
    have = {(i, j) for _, i, j in cand}
    floor = float(np.median([w for w, _, _ in cand]))
    for k in range(n - 1):
        for (i, j) in ((k, k + 1), (k + 1, k)):
            if (i, j) not in have:
                cand.append((min(floor, max(float(O[i, j]), 0.05)), i, j))
    pw = np.array([w for w, _, _ in cand], np.float32)
    pw *= len(pw) / max(pw.sum(), 1e-6)  # mean weight 1, like the ring
    return (
        jnp.asarray([i for _, i, _ in cand], jnp.int32),
        jnp.asarray([j for _, _, j in cand], jnp.int32),
        jnp.asarray(pw),
    )


@functools.partial(
    jax.jit, static_argnames=("cam", "opt", "lvl", "iters")
)
def _optimize_window_full(
    window: Window,
    pair_i: jax.Array,
    pair_j: jax.Array,
    pair_w: jax.Array,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    iters: int = 10,
    damping=1.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """optimize_window returning (poses, err, final lambda) — the lambda is
    the schedule's adapted damping at exit, which the coarse-to-fine driver
    carries into the next level (optimize_window_pyramid)."""
    n_frames = window.poses.shape[0]

    def accumulate(poses):
        win = window._replace(poses=poses)
        return _accumulate_pairs(
            win, pair_i, pair_j, pair_w, cam, opt, lvl, n_frames
        )

    return _lm_window(window.poses, accumulate, n_frames, iters, damping)


def optimize_window(
    window: Window,
    pair_i: jax.Array,
    pair_j: jax.Array,
    pair_w: jax.Array,
    cam: CameraConfig,
    opt: OptimizerConfig,
    lvl: int = 0,
    iters: int = 10,
    damping=1.0,
) -> Tuple[jax.Array, jax.Array]:
    """Joint LM over the window; returns (refined poses, final error).

    ``iters`` bounds the number of error evaluations; ``damping`` is the
    INITIAL lambda of the accept/reject schedule (see _lm_window).
    """
    poses, err, _ = _optimize_window_full(
        window, pair_i, pair_j, pair_w, cam, opt, lvl=lvl, iters=iters,
        damping=damping,
    )
    return poses, err


def optimize_window_sharded(
    window: Window,
    cam: CameraConfig,
    opt: OptimizerConfig,
    mesh: jax.sharding.Mesh,
    axis: str = "pair",
    lvl: int = 0,
    iters: int = 10,
    radius: int = 2,
    damping: float = 1.0,
) -> jax.Array:
    """Distributed windowed optimization: pairs sharded over ``axis``,
    block Hessians psum-reduced, replicated solve."""
    from jax.sharding import PartitionSpec as P

    n_frames = window.poses.shape[0]
    pi, pj, pw = make_pairs(n_frames, radius)
    n_dev = mesh.shape[axis]
    # Pad pairs to a multiple of the axis size with weight-0 lanes.
    pad = (-len(pi)) % n_dev
    pi = jnp.concatenate([pi, jnp.zeros(pad, jnp.int32)])
    pj = jnp.concatenate([pj, jnp.ones(pad, jnp.int32)])
    pw = jnp.concatenate([pw, jnp.zeros(pad, jnp.float32)])

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis)),
        out_specs=P(),
    )
    def run(win, pi_l, pj_l, pw_l):
        def accumulate(poses):
            w = win._replace(poses=poses)
            H, b, err = _accumulate_pairs(
                w, pi_l, pj_l, pw_l, cam, opt, lvl, n_frames
            )
            # Reduce the block systems across the pair shards; every device
            # then takes identical accept/reject decisions in _lm_window.
            return (
                jax.lax.psum(H, axis),
                jax.lax.psum(b, axis),
                jax.lax.psum(err, axis),
            )

        poses, _, _ = _lm_window(
            win.poses, accumulate, n_frames, iters, damping
        )
        return poses

    return jax.jit(run)(window, pi, pj, pw)


def refine_keyframes(
    keyframes,
    cfg,
    radius: int = 2,
    iters_per_lvl=(6, 4, 4),
    damping: float = 1.0,
    pairs: str = "overlap",
    extra_pairs=None,
    poses0=None,
):
    """Post-run windowed refinement over a keyframe list (the CLI-facing
    entry: run.py --windowed-ba).

    Builds per-level Windows straight from the retained Keyframes (DT
    structs + edge clouds are already device-resident) and runs coarse-to
    -fine joint LM over all keyframe poses, gauge-fixed at the oldest.
    Returns refined world poses (K, 4, 4) as NumPy.  This is the
    capability the reference declares and never ships
    (windowedoptimization, CMakeLists.txt:152-153; optimizer.h:164-165).

    ``pairs``: "overlap" (default) derives the co-visibility set + weights
    from measured view overlap at the coarsest level (revisit pairs enter,
    blind index-neighbours drop; make_pairs_overlap); "ring" keeps the
    fixed +-radius index ring.

    ``extra_pairs``: optional [(i, j, weight), ...] co-visibility edges to
    ADD (both directions) — the hook for verified loop-closure pairs
    (loopclosure.verify_candidates_batched), so a detected revisit enters
    the joint refinement as a first-class residual edge instead of only a
    pose-graph constraint.  ``poses0``: optional (K, 4, 4) initial world
    poses overriding the keyframes' own (e.g. loop-closure-corrected).
    """
    import numpy as _np

    cams = cfg.camera_pyramid()
    n_levels = cfg.pyramid.n_levels
    opt = cfg.tracker.optimizer
    if poses0 is None:
        poses0 = _np.stack(
            [_np.asarray(k.T_w_k) for k in keyframes]
        )
    poses0 = jnp.asarray(_np.asarray(poses0).astype(_np.float32))
    windows = []
    for lvl in range(n_levels):
        windows.append(
            Window(
                structs=jnp.stack([k.structs[lvl] for k in keyframes]),
                points=jnp.stack(
                    [k.frame.levels[lvl].cloud.points for k in keyframes]
                ),
                valid=jnp.stack(
                    [k.frame.levels[lvl].cloud.valid for k in keyframes]
                ),
                poses=poses0,
            )
        )
    if pairs == "overlap":
        lvl_c = n_levels - 1  # coarsest: cheapest, widest basin
        pi, pj, pw = make_pairs_overlap(
            windows[lvl_c], cams[lvl_c], opt, lvl=lvl_c
        )
    else:
        pi, pj, pw = make_pairs(len(keyframes), radius)
    if extra_pairs:
        have = set(
            (int(a), int(b)) for a, b in zip(_np.asarray(pi), _np.asarray(pj))
        )
        ei, ej, ew = [], [], []
        for i, j, w in extra_pairs:
            for a, b in ((int(i), int(j)), (int(j), int(i))):
                if a != b and (a, b) not in have:
                    ei.append(a)
                    ej.append(b)
                    ew.append(float(w))
                    have.add((a, b))
        if ei:
            pi = jnp.concatenate([pi, jnp.asarray(ei, jnp.int32)])
            pj = jnp.concatenate([pj, jnp.asarray(ej, jnp.int32)])
            pw = jnp.concatenate([pw, jnp.asarray(ew, jnp.float32)])
    poses, _ = optimize_window_pyramid(
        tuple(windows),
        pi,
        pj,
        pw,
        tuple(cams[:n_levels]),
        opt,
        iters_per_lvl=iters_per_lvl,
        damping=damping,
    )
    return _np.asarray(poses)


def optimize_window_pyramid(
    windows,
    pair_i: jax.Array,
    pair_j: jax.Array,
    pair_w: jax.Array,
    cams,
    opt: OptimizerConfig,
    iters_per_lvl=(6, 6, 10),
    damping: float = 1.0,
    carry_damping: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Coarse-to-fine windowed optimization.

    ``windows[lvl]``/``cams[lvl]`` index pyramid levels (0 = finest, like
    the tracker); optimization runs from the COARSEST level down to level
    0, each level starting from the previous level's refined poses — the
    same pull-in strategy as the coarse-to-fine tracker (tracker.cpp:
    324-340) applied to the joint window problem.  All levels share the
    pose unknowns, so only the poses are chained.

    ``carry_damping`` (default): each finer level starts from the COARSER
    level's exit lambda instead of resetting to ``damping`` — the schedule
    has already adapted to the window's conditioning (an ill-conditioned
    window that needed lambda escalation at the coarse level would
    otherwise re-diverge-and-recover at every level, burning evaluations;
    a well-conditioned one keeps its earned near-GN damping).  The exit
    lambda can be 0 (repeated-success decay); the floor re-enters the
    schedule's 0 -> 0.2 reject jump safely.
    """
    n_levels = len(windows)
    poses = windows[n_levels - 1].poses
    err = jnp.float32(0.0)
    lam = jnp.float32(damping)
    for lvl in range(n_levels - 1, -1, -1):
        win = windows[lvl]._replace(poses=poses)
        poses, err, lam_out = _optimize_window_full(
            win,
            pair_i,
            pair_j,
            pair_w,
            cams[lvl],
            opt,
            lvl=lvl,
            iters=iters_per_lvl[min(lvl, len(iters_per_lvl) - 1)],
            damping=lam,
        )
        if carry_damping:
            lam = lam_out
    return poses, err
