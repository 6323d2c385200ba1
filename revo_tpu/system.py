"""The VO system driver: frame loop, keyframe promotion, pose graph.

Replacement for REVO::start (system/system.cpp:84-305).  The host
orchestrates; every per-frame computation (pyramid, tracking, voting) is a
jitted device call.  The pose graph is a list of fixed-size records (relative
pose anchored to its keyframe, system.h:89-152) suitable for later
batched/pose-graph optimization.

Control flow mirrors the reference exactly:
- frame 0 becomes the first keyframe (system.cpp:151-175),
- per frame: track against the keyframe, then the histogram-voting quality
  check *overwrites* the tracker's good/bad-ratio status (system.cpp:188-199
  — the ratio only matters inside trackFrames' own return),
- on NEW_KF (and not immediately after a promotion): the *previous* frame is
  promoted to keyframe, the past list trimmed, and the current frame is
  re-tracked against it with the frame-to-frame motion prior
  (system.cpp:203-241),
- motion prior: T_init = T_kf_N * T_{N-1,N} (system.cpp:267-271).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import time
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from revo_tpu import lie, tracker
from revo_tpu.config import SystemConfig
from revo_tpu.frontend import (
    Frame,
    Keyframe,
    build_frame,
    make_keyframe,
    prune_keyframe,
)
from revo_tpu.io.tum import write_tum_trajectory


class TrackerStatus(enum.Enum):
    """TrackerNew::TrackerStatus (tracker.h:61-66)."""

    OK = 0
    LOST = 1  # relocalization unimplemented, as in the reference
    NEW_KF = 2
    UNKNOWN = 3


@dataclasses.dataclass
class PoseNode:
    """REVO::Pose (system.h:89-152): relative pose anchored to a keyframe."""

    T_kf_curr: np.ndarray  # (4, 4)
    T_w_kf: np.ndarray  # parent keyframe world pose at creation/promotion
    timestamp: float
    is_keyframe: bool = False
    kf_ordinal: int = 0  # ordinal of the parent keyframe (loop closure)

    @property
    def T_w_curr(self) -> np.ndarray:
        """getCurrToWorld = T_w_kf * T_kf_curr (system.h:130-133)."""
        return self.T_w_kf @ self.T_kf_curr

    def promote_to_keyframe(self) -> None:
        """setKfFrame (system.h:140-146): node becomes its own keyframe."""
        self.T_w_kf = self.T_w_curr
        self.T_kf_curr = np.eye(4, dtype=np.float32)
        self.is_keyframe = True


@dataclasses.dataclass
class VOReport:
    """End-of-run VO report (system.cpp:292-304).

    Beyond the reference's mean timings, the report carries per-frame
    host-dispatch latency percentiles: the reference is a real-time
    system fed by 30-60 fps sensors (realsensesensor.cpp:39-41), and a
    mean hides the stalls that matter there (keyframe promotion re-track,
    relocalization dispatches)."""

    frames_tracked: int = 0
    keyframes: int = 0
    tracking_lost: int = 0
    mean_dt_time_ms: float = 0.0
    mean_tracking_time_ms: float = 0.0
    latency_ms_p50: float = 0.0
    latency_ms_p95: float = 0.0
    latency_ms_p99: float = 0.0


@functools.partial(jax.jit, static_argnames=("cfg", "check_results"))
def _frame_step(
    gray, depth, undistort_maps, kf, past_voting, R0, t0, cfg, check_results
):
    """One fused device call per frame: pyramid build + coarse-to-fine track
    + histogram voting.  The host loop pays one dispatch + one sync per
    frame instead of four."""
    frame = build_frame(gray, depth, cfg, undistort_maps)
    res = tracker.track_frames(kf, frame, R0, t0, cfg)
    T_kf_n = lie.matrix_from_rt(res.R, res.t)
    T_w_curr = lie.mm(kf.T_w_k, T_kf_n)
    if check_results:
        new_kf = tracker.assess_tracking_quality(
            past_voting, T_w_curr, frame, cfg
        )
    else:
        new_kf = jnp.array(False)
    return frame, res, T_kf_n, T_w_curr, new_kf


class VOSystem:
    """Visual odometry over a stream of (gray, depth, timestamp) frames."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        if cfg.pyramid.undistort:
            from revo_tpu.ops.undistort import build_undistort_maps

            mu, mv = build_undistort_maps(cfg.camera)
            self.undistort_maps = (jnp.asarray(mu), jnp.asarray(mv))
        else:
            self.undistort_maps = None
        self.pose_graph: List[PoseNode] = []
        self.kf: Optional[Keyframe] = None
        self.prev_frame: Optional[Frame] = None
        self.past = tracker.empty_past(  # rolling: newest K frames
            cfg.tracker.n_frames_histogram_voting,
            cfg.pyramid.edge_capacity[cfg.tracker.histogram_level],
        )
        # Frozen voting set: the K frames preceding the last promotion
        # (reference semantics — see PastFrames docstring).
        self.past_voting = self.past
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.T_nm1_n = np.eye(4, dtype=np.float32)
        self.just_added_kf = False
        self.n_frames = 0
        self.n_keyframes = 0
        self.n_tracking_lost = 0
        self.n_relocalized = 0
        # Recent keyframes for relocalization; (ordinal, Keyframe) so a
        # re-anchored node can point at the right parent (loop closure).
        self.kf_history: List[tuple] = []
        # Device-resident twin of kf_history (stacked structs/quads/poses)
        # so relocalization is ONE vmapped dispatch; slot i (newest-first)
        # maps to kf_history[-1 - i].
        self.reloc_ring: Optional[tracker.KeyframeRing] = None
        self.kf_ordinal_current = 0
        self.dt_times: List[float] = []
        self.tracking_times: List[float] = []

    # -- helpers -------------------------------------------------------------

    def _push_past(self, frame: Frame, T_w_curr: np.ndarray) -> None:
        lvl = self.cfg.tracker.histogram_level
        cloud = frame.levels[lvl].cloud
        self.past = tracker.push_past(
            self.past, cloud.points, cloud.valid, jnp.asarray(T_w_curr)
        )
        # Before the first promotion the voting set accumulates the first K
        # frames (the untrimmed deque's front in the reference).
        if int(self.past_voting.n) < self.past_voting.points.shape[0]:
            self.past_voting = tracker.push_past(
                self.past_voting, cloud.points, cloud.valid,
                jnp.asarray(T_w_curr),
            )

    def _make_keyframe(self, frame: Frame, T_w_k: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.kf = make_keyframe(frame, jnp.asarray(T_w_k), self.cfg)
        jax.block_until_ready(self.kf.structs)
        self.dt_times.append((time.perf_counter() - t0) * 1000.0)
        self.n_keyframes += 1
        self.kf_ordinal_current = self.n_keyframes - 1
        # Retained slots carry only what tracking/BA/loop-closure read
        # (structs/quads/clouds/pose) unless images are wanted for export
        # or the live map pane — bounds long-run keyframe memory
        # (prepareKfForStorage analog; see frontend.prune_keyframe).
        kf_store = (
            self.kf
            if self.cfg.tracker.store_kf_images
            else prune_keyframe(self.kf)
        )
        self.kf_history.append((self.kf_ordinal_current, kf_store))
        if len(self.kf_history) > self.cfg.tracker.kf_history_size:
            self.kf_history.pop(0)
        if self.cfg.tracker.enable_relocalization:
            if self.reloc_ring is None:
                self.reloc_ring = tracker.ring_from_keyframe(
                    self.kf, self.cfg.tracker.kf_history_size
                )
            else:
                self.reloc_ring = tracker.push_ring(
                    self.reloc_ring, self.kf, jnp.asarray(T_w_k)
                )

    def _is_jump(self, T_w_curr: np.ndarray) -> bool:
        """Catastrophic frame-to-frame motion gate (TrackerConfig
        max_jump_*): catches wrong-basin convergences whose DT residual
        stays low (repetitive structure), which _is_lost cannot see."""
        if not self.pose_graph:
            return False
        trk = self.cfg.tracker
        d = np.linalg.inv(self.pose_graph[-1].T_w_curr) @ T_w_curr
        if np.linalg.norm(d[:3, 3]) > trk.max_jump_translation:
            return True
        cos_a = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        return bool(np.arccos(cos_a) > trk.max_jump_rotation)

    def _is_lost(self, res) -> bool:
        """Residual-based failure detector.

        Limitation (shared with any residual-only test, and the reference
        has no detector at all): a wrong-basin convergence on repetitive
        structure can yield a low DT residual and go undetected — loss is
        only declared when the residual or inlier count degrades.
        """
        trk = self.cfg.tracker
        return bool(
            float(res.error) > trk.reloc_error_threshold
            or int(res.good) < trk.reloc_min_good
        )

    def _relocalize(self, frame: Frame):
        """Track against the recent-keyframe ring from identity; return
        (ordinal, keyframe, result) of the best candidate or Nones.

        The reference's TRACKER_STATE_LOST dead-ends (tracker.h:62-65);
        this is our implementation of the missing recovery path.  The
        candidate search is ONE vmapped device dispatch over the stacked
        ring (tracker.track_ring) — not a host loop — with the best
        admissible candidate (lowest error, ties to newest) selected on
        device.
        """
        if self.reloc_ring is None:
            return (None, None, None)
        res_all = tracker.track_ring(self.reloc_ring, frame, self.cfg)
        found, idx, sel = tracker.select_reloc_candidate(
            res_all, self.reloc_ring.n, self.cfg
        )
        if not bool(found):
            return (None, None, None)
        ordinal, kf = self.kf_history[len(self.kf_history) - 1 - int(idx)]
        return ordinal, kf, sel

    def _online_loop_closure(self) -> int:
        """Mid-run loop closure (TrackerConfig.online_loop_closure): close
        verified revisits over the retained keyframe ring and propagate the
        correction into the LIVE state — retained keyframes, pose-graph
        anchors, the current keyframe, the past/voting rings (shifted by
        the current keyframe's correction delta, since their recent frames
        anchor to it) and the relocalization ring.  All relative state
        (T_kf_curr, motion prior, solver init) is correction-invariant.
        Returns the number of accepted loop edges."""
        from revo_tpu.loopclosure import close_loops

        if len(self.kf_history) < 3:
            return 0
        kfs = [kf for _, kf in self.kf_history]
        ords = [o for o, _ in self.kf_history]
        corrected, loops = close_loops(
            kfs, self.cfg, radius=self.cfg.tracker.loop_closure_radius
        )
        if not loops:
            return 0
        corr = {}
        for i, (o, kf) in enumerate(self.kf_history):
            self.kf_history[i] = (
                o, kf._replace(T_w_k=jnp.asarray(corrected[i]))
            )
            corr[o] = corrected[i]
        for node in self.pose_graph:
            if node.kf_ordinal in corr:
                node.T_w_kf = corr[node.kf_ordinal]
        if self.kf_ordinal_current in corr:
            old = np.asarray(self.kf.T_w_k)
            new = corr[self.kf_ordinal_current]
            delta = jnp.asarray((new @ np.linalg.inv(old)).astype(np.float32))
            self.kf = self.kf._replace(T_w_k=jnp.asarray(new))
            self.past = self.past._replace(poses=delta @ self.past.poses)
            self.past_voting = self.past_voting._replace(
                poses=delta @ self.past_voting.poses
            )
        if self.reloc_ring is not None:
            k = self.reloc_ring.T_w_k.shape[0]
            Ts = np.asarray(self.reloc_ring.T_w_k).copy()
            for i in range(min(len(self.kf_history), k)):
                Ts[i] = np.asarray(self.kf_history[-1 - i][1].T_w_k)
            self.reloc_ring = self.reloc_ring._replace(T_w_k=jnp.asarray(Ts))
        return len(loops)

    # -- main entry ----------------------------------------------------------

    def process_frame(
        self, gray: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> np.ndarray:
        """Process one frame; returns its estimated world pose (4, 4)."""
        cfg = self.cfg

        if self.n_frames == 0:
            frame = build_frame(
                jnp.asarray(gray), jnp.asarray(depth), cfg,
                self.undistort_maps,
            )
            self._make_keyframe(frame, np.eye(4, dtype=np.float32))
            node = PoseNode(
                T_kf_curr=np.eye(4, dtype=np.float32),
                T_w_kf=np.eye(4, dtype=np.float32),
                timestamp=timestamp,
                is_keyframe=True,
                kf_ordinal=self.kf_ordinal_current,
            )
            self.pose_graph.append(node)
            self._push_past(frame, np.eye(4, dtype=np.float32))
            self.prev_frame = frame
            self.n_frames = 1
            self.just_added_kf = True
            return node.T_w_curr

        t_start = time.perf_counter()
        # One fused device call: build + track + vote (minimizes host<->
        # device round trips; the reference's work split across its IO and
        # tracking threads happens in one XLA program here).
        frame, res, T_kf_n_dev, T_w_curr_dev, new_kf_dev = _frame_step(
            jnp.asarray(gray),
            jnp.asarray(depth),
            self.undistort_maps,
            self.kf,
            self.past_voting,
            self.R,
            self.t,
            cfg,
            cfg.tracker.check_tracking_results,
        )

        if cfg.tracker.enable_relocalization and (
            self._is_lost(res) or self._is_jump(np.asarray(T_w_curr_dev))
        ):
            ord_r, kf_r, res_r = self._relocalize(frame)
            if kf_r is not None:
                self.kf = kf_r
                self.kf_ordinal_current = ord_r
                self.n_relocalized += 1
                res = res_r
                # Recompute poses against the relocalization anchor; skip
                # voting this frame (it was computed against the lost pose).
                T_kf_n_dev = lie.matrix_from_rt(res.R, res.t)
                T_w_curr_dev = lie.mm(self.kf.T_w_k, T_kf_n_dev)
                new_kf_dev = jnp.array(False)
            else:
                # Still lost: constant-velocity propagation, no graph decay.
                self.n_tracking_lost += 1
                T_w_prev = self.pose_graph[-1].T_w_curr
                T_w_curr = (T_w_prev @ self.T_nm1_n).astype(np.float32)
                node = PoseNode(
                    T_kf_curr=np.linalg.inv(np.asarray(self.kf.T_w_k))
                    @ T_w_curr,
                    T_w_kf=np.asarray(self.kf.T_w_k),
                    timestamp=timestamp,
                    kf_ordinal=self.kf_ordinal_current,
                )
                self.pose_graph.append(node)
                self.tracking_times.append(
                    (time.perf_counter() - t_start) * 1000.0
                )
                self.prev_frame = frame
                self.n_frames += 1
                self.just_added_kf = False
                return node.T_w_curr

        T_kf_n = np.asarray(T_kf_n_dev)
        T_w_kf = np.asarray(self.kf.T_w_k)
        T_w_curr = np.asarray(T_w_curr_dev)

        # Histogram-voting quality check overwrites the tracker status
        # (system.cpp:199); computed inside _frame_step.
        new_kf = bool(new_kf_dev)

        if new_kf and not self.just_added_kf:
            # Promote the previous frame to keyframe and re-track
            # (system.cpp:203-241).
            last = self.pose_graph[-1]
            last.promote_to_keyframe()
            self._make_keyframe(self.prev_frame, last.T_w_kf)
            last.kf_ordinal = self.kf_ordinal_current
            # clearUpPastLists (tracker.cpp:248-257): the trimmed deque's
            # front becomes the new voting set = newest K pre-promotion
            # frames, frozen until the next promotion.
            self.past_voting = self.past
            R0 = jnp.asarray(self.T_nm1_n[:3, :3])
            t0 = jnp.asarray(self.T_nm1_n[:3, 3])
            res = tracker.track_frames(self.kf, frame, R0, t0, cfg)
            T_kf_n = np.asarray(lie.matrix_from_rt(res.R, res.t))
            T_w_kf = np.asarray(self.kf.T_w_k)
            T_w_curr = T_w_kf @ T_kf_n
            if cfg.tracker.check_tracking_results:
                tracker.assess_tracking_quality(
                    self.past_voting, jnp.asarray(T_w_curr), frame, cfg
                )  # result intentionally unused, as in system.cpp:230
            self.just_added_kf = True
        else:
            self.just_added_kf = False
        self.tracking_times.append((time.perf_counter() - t_start) * 1000.0)

        node = PoseNode(
            T_kf_curr=T_kf_n,
            T_w_kf=T_w_kf,
            timestamp=timestamp,
            kf_ordinal=self.kf_ordinal_current,
        )
        self.pose_graph.append(node)
        self._push_past(frame, T_w_curr)

        # Motion prior for the next frame (system.cpp:267-271).
        prev_node = self.pose_graph[-2]
        self.T_nm1_n = (
            np.linalg.inv(prev_node.T_w_curr) @ node.T_w_curr
        ).astype(np.float32)
        T_init = node.T_kf_curr @ self.T_nm1_n
        if cfg.init_from_last_pose:
            self.R = jnp.asarray(T_init[:3, :3])
            self.t = jnp.asarray(T_init[:3, 3])
        else:
            self.R = jnp.eye(3)
            self.t = jnp.zeros(3)

        self.prev_frame = frame
        self.n_frames += 1
        if cfg.tracker.online_loop_closure and (
            self.just_added_kf  # promotion: a revisit just became closable
            or self.n_frames % cfg.tracker.loop_closure_every == 0
        ):
            # node.T_w_curr below re-derives from the corrected anchor.
            self._online_loop_closure()
        return node.T_w_curr

    def run(self, frames, pose_file: Optional[str] = None, viewer=None):
        """Run over an iterable of (gray, depth, timestamp); returns
        (poses (N,4,4), timestamps, VOReport).  ``viewer`` is an optional
        live visualizer (viz.live.LiveViewer) fed a snapshot per frame —
        the non-blocking equivalent of the reference's viewer-thread
        hand-off (system.cpp:279-281)."""
        poses, stamps = [], []
        for gray, depth, ts in frames:
            poses.append(self.process_frame(gray, depth, ts))
            stamps.append(ts)
            if viewer is not None:
                viewer.update(
                    self, self.prev_frame, poses[-1], len(poses) - 1
                )
        poses = np.stack(poses) if poses else np.zeros((0, 4, 4))
        if pose_file and self.cfg.do_output_poses:
            qs = np.asarray(
                lie.quaternion_from_matrix(jnp.asarray(poses[:, :3, :3]))
            )
            write_tum_trajectory(pose_file, stamps, poses[:, :3, 3], qs)
        return poses, np.array(stamps), self.report()

    def report(self) -> VOReport:
        lat = (
            np.percentile(self.tracking_times, [50.0, 95.0, 99.0])
            if self.tracking_times
            else np.zeros(3)
        )
        return VOReport(
            frames_tracked=len(self.pose_graph),
            keyframes=self.n_keyframes,
            tracking_lost=self.n_tracking_lost,
            mean_dt_time_ms=float(np.mean(self.dt_times))
            if self.dt_times
            else 0.0,
            mean_tracking_time_ms=float(np.mean(self.tracking_times))
            if self.tracking_times
            else 0.0,
            latency_ms_p50=float(lat[0]),
            latency_ms_p95=float(lat[1]),
            latency_ms_p99=float(lat[2]),
        )
