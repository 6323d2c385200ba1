"""Capacity auto-calibration (revo_tpu.autotune): the static shape-bucket
pattern must not change tracking results while frames stay under the
fitted capacities."""
import numpy as np

from revo_tpu.autotune import calibrate_capacities, fit_capacities
from revo_tpu.eval import absolute_trajectory_error
from test_solver import small_cfg
from test_system import run_vo


class TestFitCapacities:
    def test_rounding_and_margin(self):
        caps = fit_capacities([[1000, 1200], [300]], margin=1.15,
                              quantum=256, minimum=512)
        # 1200*1.15=1380 -> 1536; 300*1.15=345 -> min 512
        assert caps == (1536, 512)

    def test_empty_level_uses_minimum(self):
        assert fit_capacities([[]], minimum=1024) == (1024,)


class TestOverflowDegradation:
    def test_undersized_capacity_still_tracks(self):
        """Capacities BELOW the real edge counts trigger the uniform
        stride decimation (ops/backproject.py) — accuracy must degrade
        gracefully, not fall over."""
        import dataclasses

        cfg = small_cfg()
        tight = dataclasses.replace(
            cfg,
            pyramid=dataclasses.replace(
                cfg.pyramid,
                edge_capacity=tuple(
                    max(256, c // 3) for c in cfg.pyramid.edge_capacity
                ),
            ),
        )
        poses, gt, report, _ = run_vo(tight, 15, seed=4)
        ate = absolute_trajectory_error(poses, gt).rmse
        assert report.tracking_lost == 0
        assert ate < 0.03, f"decimated ATE {ate * 100:.2f} cm"

    def test_cap50_operating_point_fast_motion(self):
        """The capacity-0.5 operating point (margin=0.5: deliberate
        uniform decimation — see autotune docstring and
        scripts/probes/cap_{ate,robust}.py) holds up under the
        harshest stress family: 5x-handheld motion on the occlusion scene
        (probed 0.68 cm vs 0.50 exact)."""
        from revo_tpu.io.synthetic import box_scene, render_trajectory
        from revo_tpu.system import VOSystem

        cfg = small_cfg()
        scene = box_scene()
        traj = scene.trajectory(
            30, seed=6, translation_step=0.04, rotation_step=0.015
        )
        frames = list(render_trajectory(scene, cfg.camera, traj, seed=6))
        cfg = calibrate_capacities(
            cfg, [frames[0][0]], [frames[0][1]], margin=0.5
        )
        vo = VOSystem(cfg)
        est = np.stack(
            [vo.process_frame(g, d, ts) for g, d, _, ts in frames]
        )
        gt = np.stack([f[2] for f in frames])
        ate = absolute_trajectory_error(est, gt).rmse
        assert vo.n_tracking_lost == 0
        assert ate < 0.02, f"cap50 5x-motion ATE {ate * 100:.2f} cm"


class TestCalibratedParity:
    def test_vo_matches_uncalibrated(self):
        from revo_tpu.io.synthetic import SyntheticScene, render_sequence

        cfg = small_cfg()
        frames = list(
            render_sequence(SyntheticScene(), cfg.camera, 3, seed=4)
        )
        cal = calibrate_capacities(
            cfg, [f[0] for f in frames], [f[1] for f in frames]
        )
        # Calibration must shrink (or keep) every level's capacity.
        assert all(
            c <= o
            for c, o in zip(cal.pyramid.edge_capacity,
                            cfg.pyramid.edge_capacity)
        )
        poses_a, gt, _, _ = run_vo(cfg, 20, seed=4)
        poses_b, gt2, _, _ = run_vo(cal, 20, seed=4)
        ate_a = absolute_trajectory_error(poses_a, gt).rmse
        ate_b = absolute_trajectory_error(poses_b, gt2).rmse
        # Identical masked work (pad lanes contribute exact zeros); only
        # reduction tiling may reorder float sums.
        assert abs(ate_a - ate_b) < 5e-4, (ate_a, ate_b)
        assert ate_b < 0.02
