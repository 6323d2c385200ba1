"""Coarse-to-fine SE(3) tracker + keyframe-selection logic.

Replacement for TrackerNew (system/tracker.cpp): the coarse-to-
fine LM driver (trackFrames, tracker.cpp:294-353), the init-guess sanity
check (checkInitializationValues, tracker.cpp:265-283) and the IROS17
histogram-voting keyframe test (assessTrackingQuality, tracker.cpp:118-201)
as scatter/bincount kernels.  Everything jits; the past-frame ring buffer is
a fixed-shape pytree.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from revo_tpu import lie, solver
from revo_tpu.config import SystemConfig
from revo_tpu.frontend import Frame, Keyframe


class TrackResult(NamedTuple):
    R: jax.Array  # (3, 3) keyframe->current rotation
    t: jax.Array  # (3,)
    error: jax.Array  # () final mean weighted error
    good: jax.Array  # () int32
    bad: jax.Array  # () int32
    new_kf: jax.Array  # () bool: good/bad < 4 (tracker.cpp:351)


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_frames(
    kf: Keyframe, frame: Frame, R0: jax.Array, t0: jax.Array, cfg: SystemConfig
) -> TrackResult:
    """TrackerNew::trackFrames (tracker.cpp:294-353): init check, then LM
    from PYR_MIN_LVL (coarse) down to PYR_MAX_LVL (fine)."""
    pyr = cfg.pyramid
    opt = cfg.tracker.optimizer
    cams = cfg.camera_pyramid()

    R, t = R0, t0
    if cfg.tracker.check_init_values:
        min_lvl = pyr.pyr_min_lvl
        cloud = frame.levels[min_lvl].cloud
        dt_img = kf.structs[min_lvl][..., 2]
        norm = cfg.tracker.normalized_init_cost
        cost_eye = solver.eval_cost(
            dt_img, cloud, cams[min_lvl], jnp.eye(3), jnp.zeros(3),
            opt.edge_distance_lvl[min_lvl], opt.use_edge_filter, norm,
        )
        cost_init = solver.eval_cost(
            dt_img, cloud, cams[min_lvl], R, t,
            opt.edge_distance_lvl[min_lvl], opt.use_edge_filter, norm,
        )
        # "DO NOT INIT WITH PREVIOUS TRANSFORM" (tracker.cpp:277-282) —
        # but only when identity is CLEARLY better (init_check_margin,
        # see TrackerConfig): a noise-level win for identity on aliased
        # structure locks tracking into the wrong basin.
        use_eye = cost_eye < cfg.tracker.init_check_margin * cost_init
        R = jnp.where(use_eye, jnp.eye(3), R)
        t = jnp.where(use_eye, jnp.zeros(3), t)

    err = jnp.float32(jnp.inf)
    info = None
    # All "quad*" impls sample the packed quad table; the suffix only
    # selects the gather form (solver._sample_quad).  An exact-match test
    # here once sent the suffixed variants the (H, W, 3) struct instead,
    # silently measuring the take4 fallback in their A/Bs.
    use_quad = opt.bilinear_impl.startswith("quad")
    for lvl in range(pyr.pyr_min_lvl, pyr.pyr_max_lvl - 1, -1):
        R, t, err, info = solver.solve_level(
            kf.quads[lvl] if use_quad else kf.structs[lvl],
            frame.levels[lvl].cloud,
            cams[lvl],
            R,
            t,
            opt,
            lvl,
        )
    good_f = info.good.astype(jnp.float32)
    bad_f = jnp.maximum(info.bad, 1).astype(jnp.float32)
    new_kf = (good_f / bad_f) < cfg.tracker.good_bad_ratio_new_kf
    return TrackResult(
        R=R, t=t, error=err, good=info.good, bad=info.bad, new_kf=new_kf
    )


def slice_cloud_frame(frame: Frame, buckets) -> Frame:
    """Slice each level's edge cloud to ``buckets[lvl]`` lanes.

    The rank compaction packs valid points into the FIRST ``count`` lanes
    (ops/backproject.py: lane_valid = j < count), so slicing away trailing
    lanes removes only invalid padding whenever count <= bucket — the
    solver gathers fewer indices (its cost is per-index) and the result
    matches to reduction-order rounding (padded lanes are exact zeros,
    but XLA's reduction tree depends on the lane count; gate:
    test_solver_modes).
    """
    levels = tuple(
        lv._replace(
            cloud=lv.cloud._replace(
                points=lv.cloud.points[:b], valid=lv.cloud.valid[:b]
            )
        )
        for lv, b in zip(frame.levels, buckets)
    )
    return frame._replace(levels=levels)


_BUCKET_RATIOS = (0.5, 0.625, 0.75, 0.875, 1.0)


def pick_buckets(counts, capacities, ratios=_BUCKET_RATIOS, quantum=256):
    """Per-frame capacity bucket: one shared fill ratio (the max over
    levels, quantized to ``ratios``) so the number of compiled variants
    stays at len(ratios) instead of len(ratios)**n_levels.

    Returns per-level lane counts (multiples of ``quantum``, capped at the
    configured capacity).  A frame that overflows (fill > 1) uses full
    capacity and degrades to the stride decimation as usual.
    """
    fill = max(
        (c / cap) for c, cap in zip(counts, capacities)
    ) if capacities else 1.0
    ratio = next((r for r in ratios if fill <= r), 1.0)
    return tuple(
        min(int(cap), max(quantum, -(-int(cap * ratio) // quantum) * quantum))
        for cap in capacities
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _track_sliced(kf, frame, R0, t0, cfg):
    return track_frames(kf, frame, R0, t0, cfg)


def track_frames_bucketed(
    kf: Keyframe, frame: Frame, R0, t0, cfg: SystemConfig
) -> TrackResult:
    """track_frames with per-frame capacity bucketing (VERDICT r2 item 3a).

    Host-dispatch deployment mode: reads the frame's per-level edge counts
    (one small device sync), slices the front-packed clouds to the
    smallest quantized bucket that holds them, and dispatches the matching
    compiled variant — ~(1 - mean_fill) of the solver's gather indices are
    never issued.  Scan/batched paths cannot use this (shapes are static
    inside the chain); for them the equivalent lever is the capacity
    margin (autotune).  Results match track_frames to reduction-order
    rounding whenever no frame overflows (test_solver_modes gate).
    """
    counts = [int(lv.cloud.count) for lv in frame.levels]
    caps = [lv.cloud.points.shape[0] for lv in frame.levels]
    buckets = pick_buckets(counts, caps)
    return _track_sliced(kf, slice_cloud_frame(frame, buckets), R0, t0, cfg)


class PastFrames(NamedTuple):
    """Ring buffer of K frames' histogram-level edge clouds + world poses
    (TrackerNew::mPastPcl/mPastWorldPoses, tracker.h:92-94).

    Two instances exist in the system: a ROLLING ring of the newest K
    frames, and the FROZEN voting set.  The reference's deque is trimmed
    only at keyframe promotion (clearUpPastLists, tracker.cpp:248-257) and
    voting always reads .at(0..2) (tracker.cpp:138), so the effective
    voting set is the K frames immediately preceding the LAST PROMOTION
    (or the first K frames before any promotion) — overlap is measured
    against keyframe-era geometry, not the always-overlapping newest
    frames.  On promotion the system copies rolling -> frozen.

    Slot 0 is the oldest.  ``n`` counts valid slots (<= K).
    """

    points: jax.Array  # (K, P, 3) camera-frame points at histogram level
    valid: jax.Array  # (K, P) bool
    poses: jax.Array  # (K, 4, 4) world poses T_w_cam
    n: jax.Array  # () int32


def empty_past(k: int, capacity: int) -> PastFrames:
    return PastFrames(
        points=jnp.zeros((k, capacity, 3), jnp.float32),
        valid=jnp.zeros((k, capacity), bool),
        poses=jnp.tile(jnp.eye(4, dtype=jnp.float32), (k, 1, 1)),
        n=jnp.int32(0),
    )


@jax.jit
def push_past(past: PastFrames, points, valid, pose_w) -> PastFrames:
    """addOldPclAndPose with the clearUpPastLists trim folded in: keep the
    most recent K entries (tracker.cpp:209-223, 248-257 — the reference
    trims only on keyframe switch; bounding always fixes its unbounded
    -memory growth, SURVEY.md §5 'long-context')."""
    k = past.points.shape[0]
    full = past.n >= k
    # When full: shift left (drop oldest); else append at slot n.
    def shifted(arr, new):
        rolled = jnp.roll(arr, -1, axis=0)
        return rolled.at[k - 1].set(new)

    def appended(arr, new):
        return arr.at[jnp.minimum(past.n, k - 1)].set(new)

    points_new = jnp.where(
        full, shifted(past.points, points), appended(past.points, points)
    )
    valid_new = jnp.where(
        full, shifted(past.valid, valid), appended(past.valid, valid)
    )
    poses_new = jnp.where(
        full, shifted(past.poses, pose_w), appended(past.poses, pose_w)
    )
    return PastFrames(
        points=points_new,
        valid=valid_new,
        poses=poses_new,
        n=jnp.minimum(past.n + 1, k),
    )


class KeyframeRing(NamedTuple):
    """Fixed-capacity device ring of recent keyframes' tracking state.

    Device-resident twin of VOSystem.kf_history holding only what tracking
    needs (DT structs, packed quad tables, world poses) so the whole
    relocalization candidate search runs as ONE vmapped dispatch instead of
    a serial host loop over the ring (the reference's TRACKER_STATE_LOST
    dead-ends with no search at all, tracker.h:62-65).

    Slot 0 is the NEWEST keyframe.  With candidates ordered newest-first,
    ``argmin`` over scores reproduces the serial search's tie-break (iterate
    newest->oldest, keep strictly-better error).
    """

    structs: Tuple[jax.Array, ...]  # per level (K, H, W, 3)
    quads: Tuple[jax.Array, ...]  # per level (K, ...) packed quad tables
    T_w_k: jax.Array  # (K, 4, 4) keyframe-to-world poses
    n: jax.Array  # () int32 number of valid slots


def ring_from_keyframe(kf: Keyframe, k: int) -> KeyframeRing:
    """Initial ring: slot 0 holds ``kf``; the rest are inactive copies
    (tiled so every slot has real shape — masked out via ``n``)."""
    return KeyframeRing(
        structs=tuple(jnp.tile(s[None], (k,) + (1,) * s.ndim) for s in kf.structs),
        quads=tuple(jnp.tile(q[None], (k,) + (1,) * q.ndim) for q in kf.quads),
        T_w_k=jnp.tile(jnp.asarray(kf.T_w_k, jnp.float32)[None], (k, 1, 1)),
        n=jnp.int32(1),
    )


@jax.jit
def push_ring(ring: KeyframeRing, kf: Keyframe, T_w_k: jax.Array) -> KeyframeRing:
    """Push a newly promoted keyframe into slot 0 (oldest falls off)."""

    def push(arr, new):
        return jnp.roll(arr, 1, axis=0).at[0].set(new)

    return KeyframeRing(
        structs=tuple(push(a, s) for a, s in zip(ring.structs, kf.structs)),
        quads=tuple(push(a, q) for a, q in zip(ring.quads, kf.quads)),
        T_w_k=push(ring.T_w_k, jnp.asarray(T_w_k, jnp.float32)),
        n=jnp.minimum(ring.n + 1, ring.T_w_k.shape[0]),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_ring(ring: KeyframeRing, frame: Frame, cfg: SystemConfig) -> TrackResult:
    """Track ``frame`` against EVERY ring keyframe from identity in one
    vmapped dispatch — the batched relocalization candidate search.

    Returns a TrackResult whose leading axis is the candidate slot
    (newest-first).  One dispatch + one sync replaces the O(ring) host
    round trips of a serial candidate loop.
    """

    def one(structs, quads):
        kf = Keyframe(structs=structs, quads=quads, frame=frame, T_w_k=jnp.eye(4))
        return track_frames(kf, frame, jnp.eye(3), jnp.zeros(3), cfg)

    return jax.vmap(one)(ring.structs, ring.quads)


@functools.partial(jax.jit, static_argnames=("cfg",))
def select_reloc_candidate(res_all: TrackResult, ring_n: jax.Array, cfg: SystemConfig):
    """Pick the best relocalization candidate on device.

    A candidate is admissible iff its slot is active and it passes the
    lost-detector thresholds (reloc_error_threshold / reloc_min_good).
    Returns (found () bool, idx () int32, selected TrackResult) — idx
    indexes the ring newest-first; ties prefer the newest (argmin's first
    -occurrence rule on the newest-first ordering).
    """
    trk = cfg.tracker
    k = res_all.error.shape[0]
    active = jnp.arange(k) < ring_n
    bad = (
        (res_all.error > trk.reloc_error_threshold)
        | (res_all.good < trk.reloc_min_good)
        | ~active
    )
    score = jnp.where(bad, jnp.inf, res_all.error)
    idx = jnp.argmin(score)
    found = jnp.isfinite(score[idx])
    sel = jax.tree.map(lambda x: x[idx], res_all)
    return found, idx, sel


@functools.partial(jax.jit, static_argnames=("cfg",))
def assess_tracking_quality(
    past: PastFrames,
    est_pose_w: jax.Array,
    frame: Frame,
    cfg: SystemConfig,
) -> jax.Array:
    """IROS17 histogram voting (assessTrackingQuality, tracker.cpp:118-201).

    Projects the last K past edge clouds into the current frame with the
    estimated pose, builds the counting map M = sum_i M_i (M_i binary via a
    max-scatter), then histograms M over valid-depth pixels and compares the
    weighted overlap measure with the zero-overlap count.  Returns new_kf
    bool.
    """
    trk = cfg.tracker
    lvl = trk.histogram_level
    cam = cfg.camera_pyramid()[lvl]
    h, w = cam.height, cam.width
    k = past.points.shape[0]

    inv_est = jnp.linalg.inv(est_pose_w)

    def project_one(slot):
        T = lie.mm(inv_est, past.poses[slot])  # past-cam -> current-cam
        R, t = T[:3, :3], T[:3, 3]
        pts = past.points[slot]
        wxp = jnp.matmul(
            pts, R.T, precision=jax.lax.Precision.HIGHEST
        ) + t
        pz = jnp.where(wxp[:, 2] == 0, 1e-12, wxp[:, 2])
        u = wxp[:, 0] / pz * cam.fx + cam.cx
        v = wxp[:, 1] / pz * cam.fy + cam.cy
        inb = (u >= 0) & (v >= 0) & (u < w) & (v < h) & past.valid[slot]
        # slot must be an active ring entry
        active = slot < past.n
        inb = inb & active
        lin = jnp.floor(v).astype(jnp.int32) * w + jnp.floor(u).astype(
            jnp.int32
        )
        lin = jnp.where(inb, lin, h * w)  # spill OOB marks to a pad slot
        m_i = jnp.zeros(h * w + 1, jnp.int32).at[lin].max(
            jnp.where(inb, 1, 0)
        )
        return m_i[: h * w]

    m = jnp.sum(
        jax.vmap(project_one)(jnp.arange(k)), axis=0
    ).reshape(h, w)  # counting map M, values 0..K

    depth = frame.levels[lvl].depth
    valid_depth = (
        jnp.isfinite(depth)
        & (depth > cfg.pyramid.depth_min)
        & (depth < cfg.pyramid.depth_max)
    )
    edges = frame.levels[lvl].edges_orig  # returnOrigEdges (tracker.cpp:122)

    # bincount over K+1 count levels as a dense one-hot contraction
    # instead of a per-index scatter-add: the (H*W, K+1) 0/1 operands and
    # integer sums < 2^24 make it exact at any matmul precision
    # (accumulated in f32).
    levels = jnp.arange(k + 1, dtype=m.dtype)
    onehot = (m.ravel()[:, None] == levels[None, :]).astype(jnp.float32)
    histogram = jnp.einsum(
        "pk,p->k", onehot, valid_depth.ravel().astype(jnp.float32)
    )
    overlaps = jnp.einsum(
        "pk,p->k", onehot, (valid_depth & edges).ravel().astype(jnp.float32)
    )
    weights = jnp.asarray(trk.hist_weights, jnp.float32)[: k + 1]
    overlap_measure = jnp.sum(overlaps[1:] * weights[1:])
    # New KF iff weighted overlap < zero-overlap count, and only once K past
    # frames exist (histogram.size() < 4 guard, tracker.cpp:184).
    enough = past.n >= k
    new_kf = (overlap_measure < overlaps[0]) & enough
    return new_kf
