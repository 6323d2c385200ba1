"""Accuracy gates beyond the single-textured-plane world: occlusion-heavy
box scenes, a full-resolution (640x480) ATE gate, fast-motion envelopes per
scene family, and the end-to-end loop-closure gate (VO run -> drift ->
verified loop edge -> measurable ATE reduction).

The reference's acceptance protocol is ATE/RPE on TUM sequences
(README.md:43-57); with zero egress these rendered scenes with exact
ground truth are the stand-in (BASELINE.md)."""
import dataclasses

import numpy as np
import pytest

from revo_tpu.config import SystemConfig
from revo_tpu.eval import absolute_trajectory_error
from revo_tpu.io.synthetic import (
    box_scene,
    column_scene,
    loop_trajectory,
    render_sequence,
    render_trajectory,
)
from revo_tpu.loopclosure import close_loops
from revo_tpu.system import VOSystem

from test_solver import small_cfg


def _run(cfg, scene, frames_iter):
    vo = VOSystem(cfg)
    est, gt = [], []
    for gray, depth, T, ts in frames_iter:
        est.append(vo.process_frame(gray, depth, ts))
        gt.append(T)
    return np.stack(est), np.stack(gt), vo


class TestBoxScene:
    """Cuboid scenes: true depth discontinuities and view-dependent
    silhouette/occlusion edges — the regime the bounded-panel default
    scene's smooth parallax does not exercise."""

    def test_tracks_through_occlusion(self):
        cfg = small_cfg()
        scene = box_scene()
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=3)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.015, f"box-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_fast_motion_5x_tracks(self):
        """Box-family fast-motion envelope: 5x handheld (~4 cm/frame)
        still tracks (the single-plane family's aliasing breaks earlier);
        the measured break point is between 5x and 7.5x — documented in
        STATUS.md, not asserted (7.5x ATE was 0.36 m)."""
        cfg = small_cfg()
        scene = box_scene()
        traj = scene.trajectory(
            40, seed=6, translation_step=0.04, rotation_step=0.015
        )
        est, gt, vo = _run(
            cfg, scene, render_trajectory(scene, cfg.camera, traj, seed=6)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"5x fast-motion ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_depth_noise_and_holes(self):
        """Kinect-class depth corruption (4 cm noise, 20% holes) on the
        occlusion scene stays within a centimetre-class envelope."""
        cfg = small_cfg()
        scene = box_scene(depth_noise=0.04, depth_hole_frac=0.2)
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=3)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.03, f"noisy box-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0


class TestColumnScene:
    """Cylindrical columns: curved surfaces whose depth varies nonlinearly
    and whose silhouette (occluding contour) slides around the surface as
    the camera moves — unlike boxes, these edges are attached to no fixed
    3-D crease, so the keyframe's edge set genuinely deforms between
    views.  Third scene family of the accuracy envelope."""

    def test_tracks_on_curved_surfaces(self):
        cfg = small_cfg()
        scene = column_scene()
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=4)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.015, f"column-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_fast_motion_5x_tracks(self):
        """Column-family fast-motion envelope: 5x handheld (~4 cm/frame)
        tracks at sub-cm (probed 0.38 cm); the measured break point is
        between 5x and 7.5x (7.5x ATE 0.69 m) — same envelope as the box
        family, documented in STATUS.md."""
        cfg = small_cfg()
        scene = column_scene()
        traj = scene.trajectory(
            40, seed=6, translation_step=0.04, rotation_step=0.015
        )
        est, gt, vo = _run(
            cfg, scene, render_trajectory(scene, cfg.camera, traj, seed=6)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"5x fast-motion ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0


# Combined sensor-artifact profile for the photometric-robustness gates
# (VERDICT r2 item 2): read noise + signal-dependent shot noise + defocus
# blur + per-frame exposure flicker + lens vignette on the intensity
# channel.  Break points per corruption: scripts/probes/photo_break.py
# (results in STATUS.md).
SENSOR_PROFILE = dict(
    image_noise=3.0,
    shot_noise=4.0,
    image_blur=0.5,
    exposure_drift=0.05,
    vignette=0.25,
)


class TestPhotometricRobustness:
    """Noisy-gray gates per scene family: the intensity channel is no
    longer pristine, so the Canny edge set varies frame to frame like a
    real sensor's (the reference consumes real images,
    iowrapperRGBD.cpp:325-327)."""

    def test_box_scene_sensor_profile(self):
        cfg = small_cfg()
        scene = box_scene(**SENSOR_PROFILE)
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=3)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"noisy box-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_column_scene_sensor_profile(self):
        cfg = small_cfg()
        scene = column_scene(**SENSOR_PROFILE)
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=4)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"noisy column-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_plane_scene_sensor_profile(self):
        from revo_tpu.io.synthetic import SyntheticScene

        cfg = small_cfg()
        scene = SyntheticScene(**SENSOR_PROFILE)
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=5)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"noisy plane-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    def test_photometric_and_depth_corruption_combined(self):
        """The full sensor model: noisy gray AND Kinect-class depth
        corruption together on the occlusion scene."""
        cfg = small_cfg()
        scene = box_scene(
            depth_noise=0.04, depth_hole_frac=0.2, **SENSOR_PROFILE
        )
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=3)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.035, f"full-corruption ATE {ate.rmse:.4f} m"


class TestSparseScene:
    """Edge-sparse / low-texture family (VERDICT r4 #5): flat walls +
    flat-faced boxes — only silhouette/crease edges and a few landmark
    discs, the regime BMVC17 edge fill-in exists for
    (imgpyramidrgbd.cpp:111-172).  At 640x480 coarse-level patch occupancy
    drops well below n_percentage, so fill-in actually FIRES end-to-end;
    the same family runs through the reference head-to-head
    (scripts/refbench.py 'sparse')."""

    def test_fill_in_fires_on_sparse_frame_640(self):
        """Mechanism gate at full resolution: occupancy < n_percentage at
        the coarse levels and the fill-in actually modified the edge map
        (edges != edges_orig for lvl > 0)."""
        import jax.numpy as jnp

        from revo_tpu import ops
        from revo_tpu.frontend import build_frame
        from revo_tpu.io.synthetic import render_frame, sparse_scene

        cfg = SystemConfig()
        scene = sparse_scene()
        g, d = render_frame(scene, cfg.camera, np.eye(4), seed=1)
        f = build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
        for lvl in (1, 2):
            lv = f.levels[lvl]
            _, occ = ops.patch_histogram(
                lv.edges_orig, cfg.pyramid.dist_patch_sizes[lvl]
            )
            assert float(occ) < cfg.pyramid.n_percentage, (
                f"lvl{lvl} occupancy {float(occ):.3f} not sparse"
            )
            n_filled = int(lv.edges.sum()) - int(lv.edges_orig.sum())
            assert n_filled > 0, f"lvl{lvl}: fill-in did not fire"

    def test_tracks_on_sparse_scene_160(self):
        """Accuracy on the sparse family at the fast test resolution
        (silhouette/crease edges only; probed ATE ~1.0 cm)."""
        from revo_tpu.io.synthetic import sparse_scene

        cfg = small_cfg()
        scene = sparse_scene()
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 30, seed=3)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.02, f"sparse-scene ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    @pytest.mark.slow  # ~40 s 640x480 end-to-end run
    def test_ate_gate_640x480_sparse_fillin(self):
        """End-to-end 640x480 VO on the edge-sparse scene: fill-in fires
        (mechanism gate above) AND the trajectory stays accurate — the
        ATE gate VERDICT r4 #6 noted was missing for this regime."""
        from revo_tpu.io.synthetic import sparse_scene

        cfg = SystemConfig()
        scene = sparse_scene()
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 22, seed=2)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.005, f"sparse 640x480 ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0


@pytest.mark.slow  # two ~30 s 640x480 end-to-end ATE gates
class TestFullResolution:
    def test_ate_gate_640x480(self):
        """CI-light full-resolution gate (VERDICT round 1 #3): the default
        640x480 operating point on the occlusion scene, 22 frames."""
        cfg = SystemConfig()
        scene = box_scene()
        est, gt, vo = _run(
            cfg, scene, render_sequence(scene, cfg.camera, 22, seed=2)
        )
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.005, f"640x480 ATE {ate.rmse:.4f} m"
        assert vo.n_tracking_lost == 0

    @pytest.mark.parametrize("margin", [0.65, 0.5])
    def test_ate_gate_640x480_decimated(self, margin):
        """The full-resolution gate at decimated capacity operating
        points: 0.65 is the DEFAULT (the accuracy knee of the CPU sweep,
        scripts/probes/pareto_ate.py: stress battery indistinguishable
        from exact-fit), 0.5 the deeper decimation knob (run.py
        --capacity-scale).
        Accuracy must stay inside the SAME gate as the exact-fit run
        (probed r5: 0.60 / 1.01 mm vs 0.59 exact)."""
        from revo_tpu.autotune import calibrate_capacities

        cfg = SystemConfig()
        scene = box_scene()
        frames = list(render_sequence(scene, cfg.camera, 22, seed=2))
        cfg = calibrate_capacities(
            cfg, [frames[0][0]], [frames[0][1]], margin=margin
        )
        est, gt, vo = _run(cfg, scene, frames)
        ate = absolute_trajectory_error(est, gt)
        assert ate.rmse < 0.005, (
            f"margin-{margin} 640x480 ATE {ate.rmse:.4f} m"
        )
        assert vo.n_tracking_lost == 0


@pytest.mark.slow  # four multi-circuit loop-closure scenarios (~60 s)
class TestLoopClosureEndToEnd:
    def test_loop_closure_reduces_ate(self):
        """Full pipeline gate: a closed-loop trajectory with a transient
        depth-scale miscalibration (frames 30-60 at 1.08x — a realistic
        drift source: biased depth biases translation) accumulates real
        drift; the revisit keyframe is found, geometrically verified, and
        the pose-graph correction measurably reduces full-trajectory ATE."""
        cfg = small_cfg()
        cfg = dataclasses.replace(
            cfg,
            tracker=dataclasses.replace(cfg.tracker, kf_history_size=64),
        )
        scene = box_scene()
        traj = loop_trajectory(110, radius=0.75, wobble=0.004, seed=5)
        vo = VOSystem(cfg)
        est = []
        for i, (gray, depth, T, ts) in enumerate(
            render_trajectory(scene, cfg.camera, traj, seed=5)
        ):
            scale = 1.08 if 30 <= i < 60 else 1.0
            est.append(vo.process_frame(gray, depth * scale, ts))
        est = np.stack(est)
        ate_pre = absolute_trajectory_error(est, traj)
        assert ate_pre.rmse > 0.015, (
            f"drift injection too weak ({ate_pre.rmse:.4f} m) - gate vacuous"
        )

        kfs = [kf for _, kf in vo.kf_history]
        ords = [o for o, _ in vo.kf_history]
        corrected, loops = close_loops(kfs, vo.cfg, radius=0.8)
        assert loops, "no verified loop edge on a closed-loop revisit"
        # the verified revisit must span the loop (early kf -> late kf)
        assert any(b - a >= 5 for a, b, _, _ in loops), loops

        all_kf = {o: corrected[i] for i, o in enumerate(ords)}
        full = np.stack(
            [
                all_kf.get(n.kf_ordinal, n.T_w_kf) @ n.T_kf_curr
                for n in vo.pose_graph
            ]
        )
        ate_post = absolute_trajectory_error(full, traj)
        assert ate_post.rmse < 0.75 * ate_pre.rmse, (
            f"loop closure did not reduce ATE: "
            f"{ate_pre.rmse:.4f} -> {ate_post.rmse:.4f} m"
        )

    def test_online_loop_closure_corrects_live_state(self):
        """SLAM-mode: with TrackerConfig.online_loop_closure the revisit is
        closed DURING the run and the correction propagates into the live
        pose graph — the final graph beats the odometry-only run on the
        same drift-injected loop, and tracking survives the in-place
        correction (relative state is correction-invariant)."""
        def run(online):
            cfg = small_cfg()
            cfg = dataclasses.replace(
                cfg,
                tracker=dataclasses.replace(
                    cfg.tracker,
                    kf_history_size=64,
                    online_loop_closure=online,
                    loop_closure_every=20,
                ),
            )
            scene = box_scene()
            traj = loop_trajectory(110, radius=0.75, wobble=0.004, seed=5)
            vo = VOSystem(cfg)
            for i, (gray, depth, T, ts) in enumerate(
                render_trajectory(scene, cfg.camera, traj, seed=5)
            ):
                scale = 1.08 if 30 <= i < 60 else 1.0
                vo.process_frame(gray, depth * scale, ts)
            final = np.stack([n.T_w_curr for n in vo.pose_graph])
            return absolute_trajectory_error(final, traj), vo

        ate_off, _ = run(False)
        ate_on, vo_on = run(True)
        assert vo_on.n_tracking_lost == 0
        assert ate_on.rmse < 0.85 * ate_off.rmse, (
            f"online closure did not help: {ate_off.rmse:.4f} -> "
            f"{ate_on.rmse:.4f} m"
        )

    def test_multi_loop_double_circuit(self):
        """Double-circuit trajectory (every azimuth visited twice): at
        least TWO independent verified loop edges spanning the circuits
        must be found by the one-dispatch batched verifier, and the joint
        pose-graph correction must reduce full-trajectory ATE (VERDICT r2
        item 4)."""
        cfg = small_cfg()
        cfg = dataclasses.replace(
            cfg,
            tracker=dataclasses.replace(cfg.tracker, kf_history_size=64),
        )
        scene = box_scene()
        # radius 0.45 keeps the double circuit at ~3.8 cm/frame (the
        # gated fast-motion envelope tops out near 5x handheld = 4 cm).
        traj = loop_trajectory(150, radius=0.45, wobble=0.004, seed=7,
                               circuits=2)
        vo = VOSystem(cfg)
        est = []
        for i, (gray, depth, T, ts) in enumerate(
            render_trajectory(scene, cfg.camera, traj, seed=7)
        ):
            scale = 1.08 if 25 <= i < 55 else 1.0
            est.append(vo.process_frame(gray, depth * scale, ts))
        est = np.stack(est)
        ate_pre = absolute_trajectory_error(est, traj)
        assert ate_pre.rmse > 0.01, (
            f"drift injection too weak ({ate_pre.rmse:.4f} m) - gate vacuous"
        )

        kfs = [kf for _, kf in vo.kf_history]
        ords = [o for o, _ in vo.kf_history]
        corrected, loops = close_loops(kfs, vo.cfg, radius=0.8)
        spans = sorted({(e.a, e.b) for e in loops if e.b - e.a >= 5})
        assert len(spans) >= 2, (
            f"need >=2 independent verified loops, got {spans}"
        )

        all_kf = {o: corrected[i] for i, o in enumerate(ords)}
        full = np.stack(
            [
                all_kf.get(n.kf_ordinal, n.T_w_kf) @ n.T_kf_curr
                for n in vo.pose_graph
            ]
        )
        ate_post = absolute_trajectory_error(full, traj)
        assert ate_post.rmse < 0.8 * ate_pre.rmse, (
            f"multi-loop closure did not reduce ATE: "
            f"{ate_pre.rmse:.4f} -> {ate_post.rmse:.4f} m"
        )

    def test_false_loops_rejected_on_broken_run(self):
        """On a run whose tracking broke mid-loop (heavy depth corruption),
        candidates between drifted keyframes must NOT be verified — the
        tightened DT-error gate (max_error 0.3; bogus matches measured
        0.4-0.5 vs 0.11-0.13 for true revisits) keeps precision."""
        cfg = small_cfg()
        cfg = dataclasses.replace(
            cfg,
            tracker=dataclasses.replace(cfg.tracker, kf_history_size=64),
        )
        scene = box_scene(depth_noise=0.06, depth_hole_frac=0.3)
        traj = loop_trajectory(110, radius=0.75, wobble=0.006, seed=5)
        vo = VOSystem(cfg)
        for gray, depth, T, ts in render_trajectory(
            scene, cfg.camera, traj, seed=5
        ):
            vo.process_frame(gray, depth, ts)
        kfs = [kf for _, kf in vo.kf_history]
        _, loops = close_loops(kfs, vo.cfg, radius=0.8)
        for e in loops:
            assert e.error < 0.3, e


class TestLiveViewer:
    def test_live_viewer_renders_during_run(self, tmp_path):
        """The headless live viewer (viz.live) renders trajectory +
        reprojection overlay + index.html on its background thread while
        the run progresses — the reference's Pangolin viewer-thread
        pattern (system.cpp:39, Viewer.cc:61-168) without a display."""
        import os

        from revo_tpu.io.synthetic import render_sequence
        from revo_tpu.viz.live import LiveViewer

        import dataclasses

        # --live-view runs keep keyframe images for the colored map pane
        # (run.py sets this; retained slots are pruned otherwise).
        cfg = dataclasses.replace(
            small_cfg(),
            tracker=dataclasses.replace(
                small_cfg().tracker, store_kf_images=True
            ),
        )
        scene = box_scene()
        vo = VOSystem(cfg)
        viewer = LiveViewer(str(tmp_path), every=2)
        for i, (gray, depth, T, ts) in enumerate(
            render_sequence(scene, cfg.camera, 8, seed=1)
        ):
            pose = vo.process_frame(gray, depth, ts)
            viewer.update(vo, vo.prev_frame, pose, i)
        viewer.close()
        live = tmp_path / "live"
        assert (live / "index.html").exists()
        assert (live / "trajectory.png").exists()
        assert (live / "overlay.png").exists()
        # The 3-D map pane (frusta + decimated colored cloud under a
        # camera-follow projection, MapDrawer.cc:48-180 analog).
        assert (live / "map.png").exists()
        assert "map.png" in (live / "index.html").read_text()
        assert not (live / "viewer_errors.log").exists(), (
            (live / "viewer_errors.log").read_text()
        )
