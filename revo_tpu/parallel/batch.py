"""Whole-sequence VO as a lax.scan + multi-sequence batching over a mesh.

The throughput path (BASELINE.json config 4): the entire frame loop of
system.py — tracking, histogram-voting keyframe promotion, prev-frame
re-track, motion prior — runs on device as one lax.scan over preloaded
frames, so a whole sequence is a single XLA program with zero host round
-trips.  Multi-sequence data parallelism places one sequence per mesh slot
with shard_map; inside shard_map, lax.cond stays a real branch, so the
keyframe-promotion re-track costs nothing on frames that don't promote.

The host-loop VOSystem (system.py) is the reference-parity twin; both share
the same tracker/solver kernels.  Control flow here is the branchless
re-formulation promised in SURVEY.md §7 ("the 'promote previous frame to
keyframe' re-track becomes a masked second solver call in the scan step").
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from revo_tpu import lie, tracker
from revo_tpu.config import SystemConfig
from revo_tpu.frontend import Frame, Keyframe, build_frame, make_keyframe
from revo_tpu.tracker import PastFrames


class ScanVOState(NamedTuple):
    kf: Keyframe  # current keyframe (structs + embedded frame + T_w_k)
    prev: Frame  # previous frame (promotion candidate)
    prev_T_w: jax.Array  # (4, 4) previous frame's world pose
    past: PastFrames  # rolling ring: newest K frames
    past_voting: PastFrames  # frozen voting set (see tracker.PastFrames)
    R: jax.Array  # (3, 3) init guess T_kf_curr
    t: jax.Array  # (3,)
    T_nm1_n: jax.Array  # (4, 4) frame-to-frame motion prior
    just_added_kf: jax.Array  # () bool
    n_keyframes: jax.Array  # () int32
    # Recent-keyframe ring for in-scan relocalization (None unless
    # cfg.tracker.scan_relocalization — the carry structure is fixed per
    # trace since cfg is static).
    kf_ring: "tracker.KeyframeRing | None" = None


class ScanVOOutput(NamedTuple):
    T_w: jax.Array  # (4, 4) per-frame world pose
    error: jax.Array  # () tracking error
    good: jax.Array  # () int32
    promoted: jax.Array  # () bool: this frame triggered a promotion
    relocalized: jax.Array = None  # () bool: ring reloc re-anchored this frame
    lost: jax.Array = None  # () bool: frame coasted on the motion prior


def _tie_to_input(tree, zero: jax.Array):
    """Add an input-derived zero to every leaf so constant-initialized
    carries acquire the input's varying/manual axes (required when the whole
    scan runs inside shard_map)."""

    def f(x):
        x = jnp.asarray(x)
        if x.dtype == jnp.bool_:
            return x ^ (zero > 0)  # XOR False: value-preserving
        return x + zero.astype(x.dtype)

    return jax.tree.map(f, tree)


def _init_state(frame0: Frame, cfg: SystemConfig) -> ScanVOState:
    eye4 = jnp.eye(4, dtype=jnp.float32)
    kf = make_keyframe(frame0, eye4, cfg)
    lvl = cfg.tracker.histogram_level
    past = tracker.empty_past(
        cfg.tracker.n_frames_histogram_voting,
        cfg.pyramid.edge_capacity[lvl],
    )
    cl = frame0.levels[lvl].cloud
    past = tracker.push_past(past, cl.points, cl.valid, eye4)
    ring = (
        tracker.ring_from_keyframe(kf, cfg.tracker.kf_history_size)
        if cfg.tracker.scan_relocalization
        else None
    )
    return ScanVOState(
        kf=kf,
        prev=frame0,
        prev_T_w=eye4,
        past=past,
        past_voting=past,
        R=jnp.eye(3),
        t=jnp.zeros(3),
        T_nm1_n=eye4,
        just_added_kf=jnp.array(True),
        n_keyframes=jnp.int32(1),
        kf_ring=ring,
    )


def _vo_scan_step(
    state: ScanVOState, inputs, cfg: SystemConfig
) -> Tuple[ScanVOState, ScanVOOutput]:
    gray, depth = inputs
    frame = build_frame(gray, depth, cfg)

    res = tracker.track_frames(state.kf, frame, state.R, state.t, cfg)
    T_kf_n = lie.matrix_from_rt(res.R, res.t)
    T_w_curr = lie.mm(state.kf.T_w_k, T_kf_n)

    if cfg.tracker.check_tracking_results:
        new_kf = tracker.assess_tracking_quality(
            state.past_voting, T_w_curr, frame, cfg
        )
    else:
        new_kf = jnp.array(False)

    trk = cfg.tracker
    # Catastrophic pose-jump gate (host-loop twin: VOSystem._is_jump),
    # evaluated on the INITIAL track like the host loop: a wrong-basin
    # convergence keeps the residual low, so only the motion betrays it.
    d = lie.mm(jnp.linalg.inv(state.prev_T_w), T_w_curr)
    cos_a = jnp.clip((jnp.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    jump = (jnp.linalg.norm(d[:3, 3]) > trk.max_jump_translation) | (
        jnp.arccos(cos_a) > trk.max_jump_rotation
    )
    T_w_coast = lie.mm(state.prev_T_w, state.T_nm1_n)

    if cfg.tracker.scan_relocalization:
        # Host-loop order (VOSystem.process_frame): a lost/jumped frame
        # attempts ring relocalization BEFORE any promotion logic; a lost
        # frame never promotes.
        lost = (
            jump
            | (res.error > trk.reloc_error_threshold)
            | (res.good < trk.reloc_min_good)
        )

        def do_reloc(op):
            ring_, frame_, kf_ = op
            res_all = tracker.track_ring(ring_, frame_, cfg)
            found_, idx, sel_ = tracker.select_reloc_candidate(
                res_all, ring_.n, cfg
            )
            kf_r = Keyframe(
                structs=tuple(s[idx] for s in ring_.structs),
                quads=tuple(q[idx] for q in ring_.quads),
                frame=kf_.frame,  # stale; tracking never reads kf.frame
                T_w_k=ring_.T_w_k[idx],
            )
            kf_r = jax.tree.map(
                lambda a, b: jnp.where(found_, a, b), kf_r, kf_
            )
            return found_, sel_, kf_r

        def no_reloc(op):
            ring_, frame_, kf_ = op
            # Dummy outputs tied to the input so their varying axes match
            # the reloc branch under shard_map (same trick as the scan
            # carries, _tie_to_input docstring).
            zero = frame_.levels[0].gray[0, 0] * 0
            dummy = tracker.TrackResult(
                R=jnp.eye(3),
                t=jnp.zeros(3),
                error=jnp.float32(jnp.inf),
                good=jnp.int32(0),
                bad=jnp.int32(0),
                new_kf=jnp.array(False),
            )
            found_, dummy = _tie_to_input((jnp.array(False), dummy), zero)
            return found_, dummy, kf_

        found, sel, kf_reloc = jax.lax.cond(
            lost, do_reloc, no_reloc, (state.kf_ring, frame, state.kf)
        )
        still_lost = lost & ~found
    else:
        lost = jump
        found = jnp.array(False)
        still_lost = jump
        sel = res  # unused when found is statically False
        kf_reloc = state.kf

    promote = new_kf & ~state.just_added_kf & ~lost

    def promoted_branch(op):
        state_, frame_, res_ = op
        kf_new = make_keyframe(state_.prev, state_.prev_T_w, cfg)
        R0 = state_.T_nm1_n[:3, :3]
        t0 = state_.T_nm1_n[:3, 3]
        res2 = tracker.track_frames(kf_new, frame_, R0, t0, cfg)
        ring = (
            tracker.push_ring(state_.kf_ring, kf_new, state_.prev_T_w)
            if cfg.tracker.scan_relocalization
            else None
        )
        return kf_new, res2, ring

    def normal_branch(op):
        state_, frame_, res_ = op
        return state_.kf, res_, state_.kf_ring

    kf, res, kf_ring = jax.lax.cond(
        promote, promoted_branch, normal_branch, (state, frame, res)
    )
    T_kf_n = lie.matrix_from_rt(res.R, res.t)
    T_w_curr = lie.mm(kf.T_w_k, T_kf_n)

    # Merge the three outcomes: relocalized > coasting > tracked.
    if cfg.tracker.scan_relocalization:
        kf = jax.tree.map(lambda a, b: jnp.where(found, a, b), kf_reloc, kf)
        T_kf_n_r = lie.matrix_from_rt(sel.R, sel.t)
        T_kf_n = jnp.where(found, T_kf_n_r, T_kf_n)
        T_w_curr = jnp.where(found, lie.mm(kf_reloc.T_w_k, T_kf_n_r), T_w_curr)
        res = jax.tree.map(lambda a, b: jnp.where(found, a, b), sel, res)
    T_w_curr = jnp.where(still_lost, T_w_coast, T_w_curr)
    T_kf_n = jnp.where(
        still_lost, lie.mm(jnp.linalg.inv(kf.T_w_k), T_w_coast), T_kf_n
    )

    # On promotion the voting set freezes to the rolling ring's pre-current
    # contents (reference clearUpPastLists semantics, tracker.cpp:248-257);
    # before the first promotion it accumulates the first K frames.
    voting = jax.tree.map(
        lambda a, b: jnp.where(promote, a, b), state.past, state.past_voting
    )
    lvl = cfg.tracker.histogram_level
    cl = frame.levels[lvl].cloud
    past = tracker.push_past(state.past, cl.points, cl.valid, T_w_curr)
    voting_pushed = tracker.push_past(voting, cl.points, cl.valid, T_w_curr)
    k_slots = voting.points.shape[0]
    fill_voting = (~promote) & (voting.n < k_slots)
    voting = jax.tree.map(
        lambda a, b: jnp.where(fill_voting, a, b), voting_pushed, voting
    )
    # A still-lost frame contributes nothing to the rings (host loop
    # returns early before _push_past).
    past = jax.tree.map(
        lambda a, b: jnp.where(still_lost, a, b), state.past, past
    )
    voting = jax.tree.map(
        lambda a, b: jnp.where(still_lost, a, b), state.past_voting, voting
    )

    # Motion prior (system.cpp:267-271).  On a coasted frame
    # T_w_curr = prev_T_w @ T_nm1_n, so the prior is unchanged — constant
    # velocity persists exactly like the host loop's early return.
    T_nm1_n = lie.mm(jnp.linalg.inv(state.prev_T_w), T_w_curr)
    T_init = lie.mm(T_kf_n, T_nm1_n)

    if cfg.init_from_last_pose:
        # Host early return leaves R/t untouched on a still-lost frame.
        R_next = jnp.where(still_lost, state.R, T_init[:3, :3])
        t_next = jnp.where(still_lost, state.t, T_init[:3, 3])
    else:
        R_next, t_next = jnp.eye(3), jnp.zeros(3)

    new_state = ScanVOState(
        kf=kf,
        prev=frame,
        prev_T_w=T_w_curr,
        past=past,
        past_voting=voting,
        R=R_next,
        t=t_next,
        T_nm1_n=T_nm1_n,
        just_added_kf=promote,
        n_keyframes=state.n_keyframes + promote.astype(jnp.int32),
        kf_ring=kf_ring,
    )
    out = ScanVOOutput(
        T_w=T_w_curr,
        error=res.error,
        good=res.good,
        promoted=promote,
        relocalized=found,
        lost=still_lost,
    )
    return new_state, out


def scan_state_template(cfg: SystemConfig) -> ScanVOState:
    """A zero-data ScanVOState with the exact pytree structure/shapes a
    scan under ``cfg`` carries — the restore target for checkpointed scan
    states (checkpoint.load_scan_state)."""
    h, w = cfg.camera.height, cfg.camera.width
    frame0 = build_frame(
        jnp.zeros((h, w), jnp.float32), jnp.zeros((h, w), jnp.float32), cfg
    )
    return _init_state(frame0, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def vo_scan_from_state(
    state: ScanVOState, grays: jax.Array, depths: jax.Array, cfg: SystemConfig
) -> Tuple[jax.Array, ScanVOOutput, ScanVOState]:
    """Continue VO from a carried (or checkpoint-restored) ScanVOState over
    (N, H, W) frames; returns (poses (N,4,4), outputs, final state).

    ``vo_scan(g, d, cfg)`` is exactly ``vo_scan_from_state(init, g[1:],
    d[1:], cfg)`` after frame-0 initialization — resuming from a saved
    final state reproduces the continuous run (gated in test_checkpoint).
    """
    state = _tie_to_input(state, grays[0, 0, 0] * 0)
    step = functools.partial(_vo_scan_step, cfg=cfg)
    final_state, outs = jax.lax.scan(step, state, (grays, depths))
    return outs.T_w, outs, final_state


@functools.partial(jax.jit, static_argnames=("cfg",))
def vo_scan(
    grays: jax.Array, depths: jax.Array, cfg: SystemConfig
) -> Tuple[jax.Array, ScanVOOutput, ScanVOState]:
    """Run full VO over one preloaded sequence ((N,H,W) gray + depth).

    Returns (poses (N,4,4) world-from-camera, per-frame outputs, final
    state).  Frame 0 is the first keyframe with identity pose.
    """
    frame0 = build_frame(grays[0], depths[0], cfg)
    state0 = _tie_to_input(_init_state(frame0, cfg), grays[0, 0, 0] * 0)

    step = functools.partial(_vo_scan_step, cfg=cfg)
    final_state, outs = jax.lax.scan(
        step, state0, (grays[1:], depths[1:])
    )
    eye4 = jnp.eye(4, dtype=jnp.float32)
    poses = jnp.concatenate([eye4[None], outs.T_w], axis=0)
    outs_full = ScanVOOutput(
        T_w=poses,
        error=jnp.concatenate([jnp.zeros(1), outs.error]),
        good=jnp.concatenate([jnp.zeros(1, outs.good.dtype), outs.good]),
        promoted=jnp.concatenate(
            [jnp.zeros(1, bool), outs.promoted]
        ),
        relocalized=jnp.concatenate([jnp.zeros(1, bool), outs.relocalized]),
        lost=jnp.concatenate([jnp.zeros(1, bool), outs.lost]),
    )
    return poses, outs_full, final_state


def vo_scan_batched(
    grays: jax.Array,
    depths: jax.Array,
    cfg: SystemConfig,
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "seq",
):
    """Multi-sequence VO: (B, N, H, W) inputs -> (B, N, 4, 4) poses.

    With ``mesh``, sequences are sharded over ``axis`` via shard_map (one or
    more sequences per device; B must be divisible by the axis size) and the
    per-sequence keyframe promotion stays a true branch.  Without a mesh,
    falls back to vmap (both cond branches execute — fine for small B).
    """
    if mesh is None:
        return jax.jit(
            jax.vmap(lambda g, d: vo_scan(g, d, cfg)[0])
        )(grays, depths)

    from jax.sharding import PartitionSpec as P

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
    )
    def run(g, d):
        # Local batch of B/n_axis sequences: scan each (vmap over the local
        # batch would re-fuse the branches; a local fori over sequences keeps
        # cond intact and the local batch is typically 1).
        def one(i, acc):
            poses, _, _ = vo_scan(g[i], d[i], cfg)
            return acc.at[i].set(poses)

        n_local = g.shape[0]
        acc0 = jnp.zeros((n_local, g.shape[1], 4, 4), jnp.float32)
        acc0 = acc0 + g[0, 0, 0, 0] * 0  # input-derived varying axes
        return jax.lax.fori_loop(0, n_local, one, acc0)

    return jax.jit(run)(grays, depths)
