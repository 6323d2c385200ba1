"""Tests for the GN/LM SE(3) solver and coarse-to-fine tracker.

Strategy (SURVEY.md §4): synthetic scenes with exact ground truth — perturb a
pose, check the solver recovers it; then the full two-frame pipeline
(BASELINE.json config 1: 'single-pair Gauss-Newton edge alignment').
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from revo_tpu import lie, ops, solver, tracker
from revo_tpu.config import CameraConfig, OptimizerConfig, SystemConfig
from revo_tpu.frontend import build_frame, make_keyframe
from revo_tpu.io.synthetic import SyntheticScene, render_frame
from revo_tpu.ops.backproject import EdgeCloud

CAM = CameraConfig(fx=150.0, fy=150.0, cx=80.0, cy=60.0, width=160, height=120)


def _wireframe_points(n=600, seed=0):
    """3-D points on a grid of line segments, 1-3 m deep, in the KF camera."""
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(12):  # vertical-ish lines in space
        x = -0.6 + 0.12 * i
        ys = np.linspace(-0.5, 0.5, n // 24)
        z = 1.5 + 0.4 * np.sin(i)
        pts.append(np.stack([np.full_like(ys, x), ys, np.full_like(ys, z)], -1))
    for j in range(12):  # horizontal lines
        y = -0.5 + 0.1 * j
        xs = np.linspace(-0.6, 0.6, n // 24)
        z = 2.0 + 0.3 * np.cos(j)
        pts.append(np.stack([xs, np.full_like(xs, y), np.full_like(xs, z)], -1))
    return np.concatenate(pts).astype(np.float32)


def _rasterize_edges(pts_cam, cam: CameraConfig):
    """Project points and mark their pixels as edges."""
    e = np.zeros((cam.height, cam.width), bool)
    u = pts_cam[:, 0] / pts_cam[:, 2] * cam.fx + cam.cx
    v = pts_cam[:, 1] / pts_cam[:, 2] * cam.fy + cam.cy
    ok = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) & (
        pts_cam[:, 2] > 0
    )
    e[np.floor(v[ok]).astype(int), np.floor(u[ok]).astype(int)] = True
    return e


def _cloud_from_points(pts, capacity=1024):
    n = len(pts)
    p = np.zeros((capacity, 3), np.float32)
    p[:n] = pts[:capacity]
    valid = np.zeros(capacity, bool)
    valid[: min(n, capacity)] = True
    return EdgeCloud(
        points=jnp.asarray(p),
        valid=jnp.asarray(valid),
        count=jnp.int32(min(n, capacity)),
    )


class TestLMLevel:
    @pytest.mark.parametrize(
        "xi_true",
        [
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [0.01, -0.008, 0.012, 0.004, -0.006, 0.005],
            [0.03, 0.02, -0.02, 0.01, 0.015, -0.01],
        ],
    )
    def test_recovers_pose(self, xi_true):
        """Perturbed cloud vs rasterized KF edges -> LM recovers T_kf_curr."""
        pts_kf = _wireframe_points()
        edges = _rasterize_edges(pts_kf, CAM)
        struct = ops.keyframe_structure(jnp.asarray(edges))

        # Current frame sees the same points from a perturbed pose:
        # p_curr = T_curr<-kf p_kf, solver estimates T_kf<-curr.
        R_true, t_true = lie.exp_se3(jnp.asarray(xi_true, jnp.float32))
        Ri, ti = lie.inverse(R_true, t_true)
        pts_curr = np.asarray(pts_kf @ np.asarray(Ri).T + np.asarray(ti))
        cloud = _cloud_from_points(pts_curr)

        opt = OptimizerConfig()
        R, t, err, info = solver.lm_level(
            struct, cloud, CAM, jnp.eye(3), jnp.zeros(3), opt, lvl=0
        )
        # Residual pose error: T_est^-1 T_true ~ identity.
        dR = np.asarray(R).T @ np.asarray(R_true)
        dt = np.asarray(R).T @ (np.asarray(t_true) - np.asarray(t))
        rot_err = np.linalg.norm(
            np.asarray(lie.log_so3(jnp.asarray(dR)))
        )
        # Rasterization quantizes edges to the pixel grid: at fx=150 and
        # z~2m, 0.5 px is ~7 mm, so the recoverable floor is ~1-2 px of
        # equivalent translation for larger perturbations.
        assert np.linalg.norm(dt) < 0.02, f"trans err {np.linalg.norm(dt)}"
        assert rot_err < 0.01, f"rot err {rot_err}"
        assert int(info.good) > 500
        assert float(err) < 0.3

    def test_zero_good_points_is_finite(self):
        """Empty cloud (no valid lanes): solver must not NaN.

        (Points *behind* the camera are not rejected — the reference has no
        cheirality test either, optimizer.cpp:93-105; source clouds always
        have positive depth by construction.)"""
        cloud = _cloud_from_points(np.zeros((0, 3), np.float32))
        struct = ops.keyframe_structure(
            jnp.asarray(_rasterize_edges(_wireframe_points(), CAM))
        )
        R, t, err, info = solver.lm_level(
            struct, cloud, CAM, jnp.eye(3), jnp.zeros(3),
            OptimizerConfig(), lvl=0,
        )
        assert int(info.good) == 0
        assert np.isfinite(np.asarray(R)).all()
        assert np.isfinite(np.asarray(t)).all()

    def test_residual_system_matches_float64_reference(self):
        """A, g, err of the fused residual pass against a float64 NumPy
        transcription of calcErrorAndBuffers + calculateWarpUpdate
        (optimizer.cpp:74-234) at a perturbed pose."""
        pts = _wireframe_points()
        struct = np.asarray(
            ops.keyframe_structure(jnp.asarray(_rasterize_edges(pts, CAM)))
        )
        cloud = _cloud_from_points(pts)
        R, t = lie.exp_se3(jnp.asarray([0.01, -0.006, 0.008, 0.004, 0.003, -0.002]))
        got = solver.residual_system(
            jnp.asarray(struct), cloud, CAM, R, t,
            edge_distance=30.0, huber=0.3, use_edge_filter=True,
        )

        R64, t64 = np.asarray(R, np.float64), np.asarray(t, np.float64)
        p = np.asarray(cloud.points, np.float64) @ R64.T + t64
        u = p[:, 0] / p[:, 2] * CAM.fx + CAM.cx
        v = p[:, 1] / p[:, 2] * CAM.fy + CAM.cy
        ok = (u > 1) & (v > 1) & (u < CAM.width - 2) & (v < CAM.height - 2)
        ok &= np.asarray(cloud.valid)
        ui, vi = np.floor(u[ok]).astype(int), np.floor(v[ok]).astype(int)
        du, dv = (u[ok] - ui)[:, None], (v[ok] - vi)[:, None]
        s = struct.astype(np.float64)
        samp = (du * dv * s[vi + 1, ui + 1] + (dv - du * dv) * s[vi + 1, ui]
                + (du - du * dv) * s[vi, ui + 1]
                + (1 - du - dv + du * dv) * s[vi, ui])
        r = samp[:, 2]
        keep = r <= 30.0
        r, x, y, z = r[keep], *p[ok][keep].T
        gx, gy = CAM.fx * samp[keep, 0], CAM.fy * samp[keep, 1]
        w = np.where(r <= 0.3, 1.0, 0.3 / np.where(r == 0, 1.0, r))
        iz, iz2 = 1.0 / z, 1.0 / (z * z)
        J = np.stack([
            iz * gx, iz * gy, -x * iz2 * gx - y * iz2 * gy,
            -x * y * iz2 * gx - (1 + y * y * iz2) * gy,
            (1 + x * x * iz2) * gx + x * y * iz2 * gy,
            -y * iz * gx + x * iz * gy,
        ], axis=-1)
        n = len(r)
        assert n > 300 and int(got.info.good) == n
        np.testing.assert_allclose(
            np.asarray(got.A), (J * w[:, None]).T @ J / n,
            rtol=1e-4, atol=1e-4 * np.abs((J * w[:, None]).T @ J / n).max(),
        )
        np.testing.assert_allclose(
            np.asarray(got.g), J.T @ (w * r) / n,
            rtol=1e-4, atol=1e-4 * np.abs(J.T @ (w * r) / n).max(),
        )
        assert float(got.err) == pytest.approx(np.sum(w * r * r) / n, rel=1e-5)

    def test_residual_normalization_matches_reference(self):
        """err = sum(w r^2)/good; A,g divided by the same count
        (LGSX.h:320-326)."""
        pts_kf = _wireframe_points()
        edges = _rasterize_edges(pts_kf, CAM)
        struct = ops.keyframe_structure(jnp.asarray(edges))
        cloud = _cloud_from_points(pts_kf)
        sys = solver.residual_system(
            struct, cloud, CAM, jnp.eye(3), jnp.zeros(3),
            edge_distance=30.0, huber=0.3, use_edge_filter=True,
        )
        assert float(sys.err) * int(sys.info.good) == pytest.approx(
            float(sys.info.sum_error_weighted), rel=1e-5
        )
        # self-projection: residual floor is the sub-pixel offset between a
        # point's continuous projection and its rasterized edge pixel (~0.5px)
        assert float(sys.err) < 0.5


class TestEvalCost:
    def test_identity_beats_bad_init(self):
        pts_kf = _wireframe_points()
        edges = _rasterize_edges(pts_kf, CAM)
        dt_img = ops.distance_transform(jnp.asarray(edges))
        cloud = _cloud_from_points(pts_kf)
        cost_eye = solver.eval_cost(
            dt_img, cloud, CAM, jnp.eye(3), jnp.zeros(3), 30.0, True
        )
        R_bad, t_bad = lie.exp_se3(
            jnp.asarray([0.3, 0.2, 0.0, 0.1, 0.0, 0.0], jnp.float32)
        )
        cost_bad = solver.eval_cost(
            dt_img, cloud, CAM, R_bad, t_bad, 30.0, True
        )
        assert float(cost_eye) < float(cost_bad)


def small_cfg():
    """160x120 full config for fast end-to-end tests."""
    return SystemConfig(
        camera=CAM,
        pyramid=dataclasses.replace(
            SystemConfig().pyramid,
            pyr_min_lvl=2,
            pyr_max_lvl=0,
            edge_capacity=(4096, 2048, 1024),
            dist_patch_sizes=(20, 10, 5),
        ),
    )


class TestTwoFrameTracking:
    """BASELINE.json config 1: full two-frame alignment on rendered images."""

    def test_track_rendered_pair(self):
        cfg = small_cfg()
        scene = SyntheticScene()
        T0 = np.eye(4, dtype=np.float32)
        xi = jnp.asarray([0.01, -0.006, 0.008, 0.004, 0.003, -0.002])
        dR, dt_ = lie.exp_se3(xi)
        T1 = T0 @ np.asarray(lie.matrix_from_rt(dR, dt_))

        g0, d0 = render_frame(scene, cfg.camera, T0)
        g1, d1 = render_frame(scene, cfg.camera, T1)

        f0 = build_frame(jnp.asarray(g0), jnp.asarray(d0), cfg)
        f1 = build_frame(jnp.asarray(g1), jnp.asarray(d1), cfg)
        kf = make_keyframe(f0, jnp.eye(4), cfg)

        res = tracker.track_frames(kf, f1, jnp.eye(3), jnp.zeros(3), cfg)
        # Estimated T_kf_curr maps current-frame points into the keyframe;
        # ground truth is T0^-1 T1.
        T_est = np.asarray(lie.matrix_from_rt(res.R, res.t))
        T_true = np.linalg.inv(T0) @ T1
        d = np.linalg.inv(T_est) @ T_true
        trans_err = np.linalg.norm(d[:3, 3])
        rot_err = np.linalg.norm(
            np.asarray(lie.log_so3(jnp.asarray(d[:3, :3])))
        )
        # 160x120 with fx=150: 1 px ~ 2 cm at z=3 m; ~0.35 px equivalent
        # accuracy is the expected floor for DT-based edge alignment here.
        assert trans_err < 0.01, f"trans err {trans_err:.4f}"
        assert rot_err < 0.005, f"rot err {rot_err:.4f}"
        assert not bool(res.new_kf)

    @pytest.mark.slow  # all five gather-form A/Bs against quad (~8 s)
    def test_suffixed_quad_impls_match_quad(self):
        """Every "quad*" bilinear_impl must actually sample the quad table
        (tracker.use_quad once exact-matched "quad", silently sending the
        suffixed gather-form variants the (H, W, 3) struct — their A/Bs
        measured the take4 fallback).  With the same dt4bf table the pose
        must match the plain "quad" impl to float noise."""
        cfg = small_cfg()
        scene = SyntheticScene()
        T0 = np.eye(4, dtype=np.float32)
        xi = jnp.asarray([0.008, -0.004, 0.006, 0.003, 0.002, -0.002])
        dR, dt_ = lie.exp_se3(xi)
        T1 = T0 @ np.asarray(lie.matrix_from_rt(dR, dt_))
        g0, d0 = render_frame(scene, cfg.camera, T0)
        g1, d1 = render_frame(scene, cfg.camera, T1)

        def with_impl(impl):
            return dataclasses.replace(
                cfg,
                tracker=dataclasses.replace(
                    cfg.tracker,
                    optimizer=dataclasses.replace(
                        cfg.tracker.optimizer, bilinear_impl=impl
                    ),
                ),
            )

        results = {}
        for impl in ("quad", "quad_ob", "quad_fr"):
            c = with_impl(impl)
            f0 = build_frame(jnp.asarray(g0), jnp.asarray(d0), c)
            f1 = build_frame(jnp.asarray(g1), jnp.asarray(d1), c)
            kf = make_keyframe(f0, jnp.eye(4), c)
            res = tracker.track_frames(kf, f1, jnp.eye(3), jnp.zeros(3), c)
            results[impl] = np.asarray(lie.matrix_from_rt(res.R, res.t))
        for impl in ("quad_ob", "quad_fr"):
            np.testing.assert_allclose(
                results[impl], results["quad"], atol=1e-6, err_msg=impl
            )

    def test_identity_pair(self):
        """Tracking a frame against itself stays at identity."""
        cfg = small_cfg()
        scene = SyntheticScene()
        g0, d0 = render_frame(scene, cfg.camera, np.eye(4, dtype=np.float32))
        f0 = build_frame(jnp.asarray(g0), jnp.asarray(d0), cfg)
        kf = make_keyframe(f0, jnp.eye(4), cfg)
        res = tracker.track_frames(kf, f0, jnp.eye(3), jnp.zeros(3), cfg)
        assert np.linalg.norm(np.asarray(res.t)) < 1e-3
        assert float(res.error) < 0.05


class TestPastFramesRing:
    def test_push_and_wrap(self):
        past = tracker.empty_past(3, 16)
        for i in range(5):
            pts = np.full((16, 3), float(i), np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = i
            past = tracker.push_past(
                past, jnp.asarray(pts), jnp.ones(16, bool), jnp.asarray(pose)
            )
        assert int(past.n) == 3
        # slots hold frames 2,3,4 (oldest first)
        np.testing.assert_allclose(np.asarray(past.poses)[:, 0, 3], [2, 3, 4])
        np.testing.assert_allclose(np.asarray(past.points)[:, 0, 0], [2, 3, 4])


class TestHistogramVoting:
    def _make(self, cfg, pose_offset):
        scene = SyntheticScene()
        frames, past = [], tracker.empty_past(3, cfg.pyramid.edge_capacity[2])
        lvl = cfg.tracker.histogram_level
        for i in range(3):
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = pose_offset * i
            g, d = render_frame(scene, cfg.camera, T)
            f = build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
            cl = f.levels[lvl].cloud
            past = tracker.push_past(past, cl.points, cl.valid, jnp.asarray(T))
            frames.append((f, T))
        return frames, past

    def test_overlapping_view_keeps_kf(self):
        cfg = small_cfg()
        frames, past = self._make(cfg, pose_offset=0.005)
        f, T = frames[-1]
        new_kf = tracker.assess_tracking_quality(
            past, jnp.asarray(T), f, cfg
        )
        assert not bool(new_kf)

    def test_disjoint_view_requests_kf(self):
        cfg = small_cfg()
        frames, past = self._make(cfg, pose_offset=0.005)
        f, T = frames[-1]
        # Claim the current frame is somewhere far away: past clouds project
        # out of bounds -> zero overlap -> new keyframe.
        T_far = np.eye(4, dtype=np.float32)
        T_far[:3, 3] = [5.0, 5.0, -2.0]
        new_kf = tracker.assess_tracking_quality(
            past, jnp.asarray(T_far), f, cfg
        )
        assert bool(new_kf)

    def test_too_few_past_frames(self):
        cfg = small_cfg()
        past = tracker.empty_past(3, cfg.pyramid.edge_capacity[2])
        scene = SyntheticScene()
        g, d = render_frame(scene, cfg.camera, np.eye(4, dtype=np.float32))
        f = build_frame(jnp.asarray(g), jnp.asarray(d), cfg)
        new_kf = tracker.assess_tracking_quality(
            past, jnp.eye(4), f, cfg
        )
        assert not bool(new_kf)  # histogram.size() < 4 guard


class TestSolve6LDLT:
    def test_matches_numpy_solve_on_spd(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            M = rng.normal(size=(6, 6)).astype(np.float32)
            A = M @ M.T + 1e-3 * np.eye(6, dtype=np.float32)
            b = rng.normal(size=6).astype(np.float32)
            want = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
            got = np.asarray(solver.solve6_ldlt(jnp.asarray(A), jnp.asarray(b)))
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)

    def test_damped_normal_matrix_shape(self):
        # Ill-conditioned but damped like the LM loop uses it.
        rng = np.random.default_rng(1)
        J = rng.normal(size=(100, 6)).astype(np.float32)
        J[:, 3:] *= 1e-3  # poorly scaled rotational block
        A = (J.T @ J / 100).astype(np.float32)
        lam = 0.01
        Ad = A + np.diag(np.diag(A) * lam)
        b = rng.normal(size=6).astype(np.float32)
        want = np.linalg.solve(Ad.astype(np.float64), b.astype(np.float64))
        got = np.asarray(solver.solve6_ldlt(jnp.asarray(Ad), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-4)
