"""CLI entry point: ``python -m revo_tpu.run <settings.yaml> <dataset.yaml>``.

Replaces main.cpp:22-48: loads the two-file config, then runs VO over each
dataset listed in the dataset file (the reference loops ``nRuns`` over its
``Datasets`` list), writing ``poses_<dataset>.txt`` in TUM format.

Extra modality for environments without TUM data:
``python -m revo_tpu.run --synthetic N [--out DIR]`` renders an N-frame
synthetic sequence, runs VO, reports ATE/RPE against the exact ground truth.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _run_dataset(
    cfg, dataset: str, out_dir: str, gt_file=None, auto_capacity: int = 0,
    capacity_scale: float = 1.15,
    close_loops_flag: bool = False, live_view: bool = False,
    windowed_ba_flag: bool = False, export_ply: bool = False,
) -> None:
    from revo_tpu.io import native_loader
    from revo_tpu.io.tum import load_associations, load_tum_frame
    from revo_tpu.system import VOSystem

    ds_dir = os.path.join(cfg.dataset.main_folder, dataset)
    if not os.path.exists(
        os.path.join(ds_dir, cfg.dataset.associate_file)
    ) and os.path.exists(os.path.join(ds_dir, "rgb.txt")):
        # Raw TUM download: generate associations in-repo (the reference
        # requires the external associate.py first, README.md:43-57).
        from revo_tpu.io.associate import write_associations

        n = write_associations(ds_dir, out_file=cfg.dataset.associate_file)
        print(f"[revo_tpu] generated {cfg.dataset.associate_file}: {n} pairs")
    assocs = load_associations(
        ds_dir,
        cfg.dataset.associate_file,
        skip_first=cfg.dataset.skip_first_n_frames,
        max_frames=cfg.dataset.read_n_images,
    )
    print(f"[revo_tpu] {dataset}: {len(assocs)} frames")

    if auto_capacity > 0:
        from revo_tpu.autotune import calibrate_capacities

        probe = [
            load_tum_frame(ds_dir, a, cfg.dataset.depth_scale_factor)[:2]
            for a in assocs[:auto_capacity]
        ]
        cfg = calibrate_capacities(
            cfg, [p[0] for p in probe], [p[1] for p in probe],
            margin=capacity_scale,
        )
        print(f"[revo_tpu] calibrated edge_capacity = "
              f"{cfg.pyramid.edge_capacity}")

    if native_loader.native_available():
        # Native threaded prefetch (replaces the reference's IO thread);
        # uint8/uint16 frames go to the device raw and convert there.
        def frames():
            rgb = [os.path.join(ds_dir, a.rgb_path) for a in assocs]
            dep = [os.path.join(ds_dir, a.depth_path) for a in assocs]
            shape = (cfg.camera.height, cfg.camera.width)
            with native_loader.NativePrefetcher(rgb, dep, shape) as pf:
                for i, a in enumerate(assocs):
                    gray_u8, depth_u16 = pf.get(i)
                    yield gray_u8, depth_u16, a.rgb_ts
    else:
        def frames():
            for a in assocs:
                yield load_tum_frame(ds_dir, a, cfg.dataset.depth_scale_factor)

    vo = VOSystem(cfg)
    pose_file = os.path.join(out_dir, f"poses_{dataset}.txt")
    viewer = _maybe_viewer(live_view, out_dir)
    poses, stamps, report = vo.run(frames(), pose_file=pose_file, viewer=viewer)
    if viewer is not None:
        viewer.close()
        print(f"Live view written to {out_dir}/live/index.html")
    _print_report(report, pose_file)
    poses = _post_run_refinement(
        vo, poses, windowed_ba_flag, close_loops_flag
    )
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)
    if gt_file:
        _evaluate_against_gt(poses, stamps, ds_dir, gt_file, out_dir)


def _run_live(
    cfg, input_type: int, out_dir: str, color_dev: str, depth_dev: str,
    replay_color=None, replay_depth=None, max_frames: int = 0,
    close_loops_flag: bool = False, live_view: bool = False,
    windowed_ba_flag: bool = False, export_ply: bool = False,
    record_dir=None,
) -> None:
    """INPUT_TYPE 1/2/3: live-sensor VO through the native V4L2 engine
    (the reference's live modalities, iowrapperRGBD.h:56-102).

    ``replay_color``/``replay_depth`` route the engine at recorded session
    files through the replay shim — the same driver path without hardware
    (field-capture debugging; also how CI drives this)."""
    from revo_tpu.io import sensors
    from revo_tpu.system import VOSystem

    if replay_color:
        mapping = {color_dev: replay_color}
        if replay_depth:
            mapping[depth_dev] = replay_depth
        sensors.use_replay(mapping)
    cam = sensors.open_sensor(
        input_type,
        color_dev=color_dev,
        depth_dev=depth_dev,
        width=cfg.camera.width,
        height=cfg.camera.height,
        warmup=0 if replay_color else None,
    )
    print(f"[revo_tpu] live sensor: {cam.profile.name} "
          f"(INPUT_TYPE={input_type}) {cam.width}x{cam.height}")

    def frames():
        it = iter(cam)
        rec = None
        if record_dir:
            from revo_tpu.io.recorder import TUMRecorder

            rec = TUMRecorder(record_dir)
        try:
            for i, (gray, depth, ts) in enumerate(it):
                if max_frames and i >= max_frames:
                    break
                if rec is not None:
                    rec.add(gray, depth, ts)
                yield gray, depth, ts
        finally:
            if rec is not None:
                rec.close()

    vo = VOSystem(cfg)
    pose_file = os.path.join(out_dir, "poses_live.txt")
    viewer = _maybe_viewer(live_view, out_dir)
    poses, stamps, report = vo.run(frames(), pose_file=pose_file, viewer=viewer)
    if viewer is not None:
        viewer.close()
        print(f"Live view written to {out_dir}/live/index.html")
    cam.close()
    _print_report(report, pose_file)
    poses = _post_run_refinement(
        vo, poses, windowed_ba_flag, close_loops_flag
    )
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)


def _maybe_viewer(live_view: bool, out_dir: str):
    if not live_view:
        return None
    from revo_tpu.viz.live import LiveViewer

    return LiveViewer(out_dir)


def _evaluate_against_gt(poses, stamps, ds_dir, gt_file, out_dir) -> None:
    """In-repo ATE/RPE against a TUM groundtruth.txt (the reference
    delegates this to the external rgbd_benchmark_tools, README.md:57)."""
    import numpy as np

    from revo_tpu.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu.io.associate import associate
    from revo_tpu.io.tum import read_tum_trajectory

    gt_path = gt_file if os.path.isabs(gt_file) else os.path.join(
        ds_dir, gt_file
    )
    gt_ts, gt_poses = read_tum_trajectory(gt_path)
    pairs = associate(
        {t: i for i, t in enumerate(stamps)},
        {t: i for i, t in enumerate(gt_ts)},
    )
    if len(pairs) < 2:
        print("[revo_tpu] too few gt associations; skipping evaluation")
        return
    est_idx = [dict(zip(stamps, range(len(stamps))))[a] for a, _ in pairs]
    gt_idx = [dict(zip(gt_ts, range(len(gt_ts))))[b] for _, b in pairs]
    est = poses[est_idx]
    gt = gt_poses[gt_idx]
    ate = absolute_trajectory_error(est, gt)
    rpe = relative_pose_error(est, gt)
    print(
        f"ATE-RMSE vs GT: {ate.rmse * 100:.2f} cm "
        f"(mean {ate.mean * 100:.2f}, max {ate.max * 100:.2f}) "
        f"over {len(pairs)} frames"
    )
    print(f"RPE vs GT: {rpe.trans_rmse * 1000:.2f} mm / "
          f"{rpe.rot_rmse_deg:.4f} deg per frame")
    try:
        from revo_tpu.viz import plot_error, plot_trajectory

        plot_trajectory(os.path.join(out_dir, "trajectory_vs_gt.png"),
                        est, gt)
        plot_error(os.path.join(out_dir, "ate_error_vs_gt.png"), est, gt)
    except ImportError:
        pass


def _print_report(report, pose_file) -> None:
    # VO report (system.cpp:292-304)
    print("-----VO Report-----")
    print(f"Frames Tracked: {report.frames_tracked}")
    print(f"Keyframes Tracked: {report.keyframes}")
    print(f"Tracking Lost: {report.tracking_lost}")
    print(f"Distance Transform: {report.mean_dt_time_ms:.2f} ms")
    print(f"Mean Tracking Time: {report.mean_tracking_time_ms:.2f} ms")
    print(
        "Tracking Latency p50/p95/p99: "
        f"{report.latency_ms_p50:.2f} / {report.latency_ms_p95:.2f} / "
        f"{report.latency_ms_p99:.2f} ms"
    )
    if pose_file:
        print(f"Poses written to {pose_file}")




def _maybe_export_ply(vo, poses, out_dir):
    """Map model export — the reference viewer's saveModel
    (MapDrawer.h:97-170) without a GUI: edge-sparse colored cloud of every
    retained keyframe (transformed to world), keyframe frusta, and the
    trajectory polyline, all as PLY."""
    import numpy as np

    from revo_tpu.frontend import generate_colored_pcl
    from revo_tpu.viz.ply import (
        export_colored_pcl_ply,
        export_keyframe_frusta_ply,
        export_trajectory_ply,
    )

    pts_all, clr_all = [], []
    for _, kf in vo.kf_history:
        pts, clr = generate_colored_pcl(kf.frame, vo.cfg)
        T = np.asarray(kf.T_w_k)
        pts_all.append(pts @ T[:3, :3].T + T[:3, 3])
        clr_all.append(clr)
    if pts_all:
        export_colored_pcl_ply(
            os.path.join(out_dir, "map_cloud.ply"),
            np.concatenate(pts_all),
            np.concatenate(clr_all),
        )
    export_keyframe_frusta_ply(
        os.path.join(out_dir, "map_keyframes.ply"),
        [np.asarray(kf.T_w_k) for _, kf in vo.kf_history],
    )
    export_trajectory_ply(
        os.path.join(out_dir, "trajectory.ply"), np.asarray(poses)
    )
    print(f"[revo_tpu] PLY model written to {out_dir}/map_cloud.ply, "
          f"map_keyframes.ply, trajectory.ply")


def _maybe_windowed_ba(vo, poses, loop_edges=None, ring_poses0=None):
    """Post-run windowed joint refinement over the retained keyframe ring
    (the BA the reference stubs out); returns re-anchored poses.

    ``loop_edges``/``ring_poses0``: when loop closure ran first, its
    verified revisit edges enter the refinement as first-class residual
    pairs and its corrected ring poses seed the optimization."""
    import numpy as np

    from revo_tpu.parallel.windowed import refine_keyframes

    if len(vo.kf_history) < 2:
        print("[revo_tpu] windowed BA: <2 keyframes retained; skipping")
        return poses
    kfs = [kf for _, kf in vo.kf_history]
    ordinals = [o for o, _ in vo.kf_history]
    extra = [(e.a, e.b, 2.0) for e in (loop_edges or [])]
    refined = refine_keyframes(
        kfs, vo.cfg, extra_pairs=extra, poses0=ring_poses0
    )
    all_kf = {o: refined[i] for i, o in enumerate(ordinals)}
    full = []
    for node in vo.pose_graph:
        T_kf = all_kf.get(node.kf_ordinal, node.T_w_kf)
        full.append(T_kf @ node.T_kf_curr)
    print(f"[revo_tpu] windowed BA: refined {len(kfs)} keyframes "
          f"(coarse-to-fine joint LM"
          + (f", {len(extra)} loop edge(s) as residual pairs" if extra
             else "") + ")")
    return np.stack(full)


def _maybe_close_loops(vo, poses, return_detail: bool = False):
    """Post-run loop closure over the retained keyframe ring (SLAM upgrade
    the reference lacks); returns (possibly corrected) poses — with
    ``return_detail``, also (verified loop edges, corrected ring poses)
    so windowed BA can consume them."""
    from revo_tpu.loopclosure import close_loops

    if vo.n_keyframes < 3 or len(vo.kf_history) < 3:
        print("[revo_tpu] loop closure: <3 keyframes retained; skipping")
        return (poses, [], None) if return_detail else poses
    kfs = [kf for _, kf in vo.kf_history]
    ordinals = [o for o, _ in vo.kf_history]
    corrected, loops = close_loops(kfs, vo.cfg)
    if not loops:
        print("[revo_tpu] loop closure: no verified loop edges")
        return (poses, [], None) if return_detail else poses
    # Map corrected ring poses back to global keyframe ordinals.
    all_kf = {o: corrected[i] for i, o in enumerate(ordinals)}
    full = []
    for node in vo.pose_graph:
        T_kf = all_kf.get(node.kf_ordinal, node.T_w_kf)
        full.append(T_kf @ node.T_kf_curr)
    print(f"[revo_tpu] loop closure: {len(loops)} edge(s) "
          f"{[(e.a, e.b) for e in loops]}")
    out = np.stack(full)
    return (out, loops, corrected) if return_detail else out


def _post_run_refinement(vo, poses, windowed_ba_flag, close_loops_flag):
    """Flag-driven post-run SLAM refinement.  With BOTH flags, loop
    closure runs FIRST and its verified edges + corrected poses feed the
    windowed BA (loop-aware joint refinement) — the combination neither
    subsystem gets alone."""
    loops, ring0 = [], None
    if close_loops_flag:
        poses, loops, ring0 = _maybe_close_loops(vo, poses, return_detail=True)
    if windowed_ba_flag:
        poses = _maybe_windowed_ba(
            vo, poses, loop_edges=loops, ring_poses0=ring0
        )
    return poses

def _run_synthetic(
    cfg, n_frames: int, out_dir: str, seed: int, **flags
) -> int:
    from revo_tpu.io.synthetic import SyntheticScene, render_sequence

    rendered = render_sequence(
        SyntheticScene(), cfg.camera, n_frames, seed=seed
    )
    track_synthetic(cfg, rendered, out_dir, **flags)
    return 0


def track_synthetic(
    cfg, rendered, out_dir: str, close_loops_flag: bool = False,
    live_view: bool = False, windowed_ba_flag: bool = False,
    export_ply: bool = False,
):
    """Run ``VOSystem`` over rendered ``(gray, depth, T_w_c, timestamp)``
    frames, write poses and plots to ``out_dir`` and report ATE/RPE against
    the exact ground truth.  Returns (poses (N, 4, 4), ground truth
    (N, 4, 4), ATE result, RPE result)."""
    from revo_tpu.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu.system import VOSystem

    gt = []

    def frames():
        for gray, depth, T, ts in rendered:
            gt.append(T)
            yield gray, depth, ts

    vo = VOSystem(cfg)
    pose_file = os.path.join(out_dir, "poses_synthetic.txt")
    viewer = _maybe_viewer(live_view, out_dir)
    poses, _, report = vo.run(frames(), pose_file=pose_file, viewer=viewer)
    if viewer is not None:
        viewer.close()
        print(f"Live view written to {out_dir}/live/index.html")
    _print_report(report, pose_file)
    poses = _post_run_refinement(
        vo, poses, windowed_ba_flag, close_loops_flag
    )
    if export_ply:
        _maybe_export_ply(vo, poses, out_dir)
    gt_arr = np.stack(gt)
    try:
        from revo_tpu.viz import plot_error, plot_trajectory

        plot_trajectory(
            os.path.join(out_dir, "trajectory.png"), poses, gt_arr,
            title="synthetic VO",
        )
        plot_error(os.path.join(out_dir, "ate_error.png"), poses, gt_arr)
        print(f"Plots written to {out_dir}/trajectory.png, ate_error.png")
    except ImportError:
        pass
    ate = absolute_trajectory_error(poses, gt_arr)
    rpe = relative_pose_error(poses, gt_arr)
    print(
        f"ATE-RMSE: {ate.rmse * 100:.2f} cm  (mean {ate.mean * 100:.2f}, "
        f"max {ate.max * 100:.2f})"
    )
    print(
        f"RPE: {rpe.trans_rmse * 1000:.2f} mm / {rpe.rot_rmse_deg:.4f} deg "
        f"per frame"
    )
    return poses, gt_arr, ate, rpe


def select_backend(force_cpu: bool = False) -> str:
    """Run on the CPU only when asked (``--cpu`` or ``JAX_PLATFORMS=cpu``);
    otherwise require a GPU.  Returns the platform in use."""
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    cpu_requested = force_cpu or os.environ.get("JAX_PLATFORMS") == "cpu"
    platform = jax.devices()[0].platform
    if platform != "gpu" and not cpu_requested:
        raise SystemExit(
            f"revo_tpu.run: no GPU found (JAX platform {platform!r}); "
            "pass --cpu or set JAX_PLATFORMS=cpu to run on the CPU"
        )
    return platform


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="revo_tpu.run",
        description="Edge-based RGB-D visual odometry",
    )
    parser.add_argument("settings", nargs="?", help="algorithm settings yaml")
    parser.add_argument("dataset", nargs="?", help="dataset settings yaml")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run on an N-frame synthetic sequence")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="out", help="output directory")
    parser.add_argument(
        "--gt", default=None, metavar="FILE",
        help="groundtruth trajectory (TUM format, relative to the dataset "
             "dir) for in-repo ATE/RPE evaluation",
    )
    parser.add_argument(
        "--close-loops", action="store_true",
        help="post-run keyframe loop closure over the retained ring "
             "(revo_tpu.loopclosure; raise KF_HISTORY_SIZE to retain more)",
    )
    parser.add_argument(
        "--auto-capacity", type=int, default=0, metavar="N",
        help="calibrate edge-cloud capacities from the first N frames "
             "(static-shape bucketing; see revo_tpu.autotune)",
    )
    parser.add_argument(
        "--capacity-scale", type=float, default=1.15, metavar="S",
        help="capacity = S * observed max edge count (with --auto-capacity)."
             " S > 1 leaves headroom (exact tracking, the default); S < 1 "
             "deliberately undersizes so the uniform stride decimation "
             "subsamples edges every frame, while accuracy degrades only "
             "fractionally.  0.65 is the accuracy knee of the CPU sweep "
             "(scripts/probes/pareto_ate.py); 0.65 and 0.5 are "
             "accuracy-gated in tests (see revo_tpu.autotune)",
    )
    parser.add_argument(
        "--export-ply", action="store_true",
        help="export the map model as PLY (colored keyframe cloud, "
             "keyframe frusta, trajectory) — the viewer's saveModel "
             "without a GUI",
    )
    parser.add_argument(
        "--windowed-ba", action="store_true",
        help="post-run windowed joint refinement of the retained keyframe "
             "ring (parallel.windowed; raise KF_HISTORY_SIZE to retain "
             "more) — the BA the reference declares but never ships",
    )
    parser.add_argument(
        "--live-view", action="store_true",
        help="render live progress (trajectory + reprojection overlay + "
             "auto-refreshing index.html) to OUT/live/ on a background "
             "thread while the run progresses — the headless equivalent "
             "of the reference's Pangolin viewer thread",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="run on the JAX CPU backend (also JAX_PLATFORMS=cpu); "
             "without it a GPU is required",
    )
    parser.add_argument(
        "--input-type", type=int, default=None, metavar="N",
        help="live-sensor modality override (reference INPUT_TYPE, "
             "iowrapperRGBD.h:56-102): 1 = Orbbec Astra Pro, 2 = RealSense, "
             "3 = Orbbec Astra; default comes from the settings yaml "
             "(INPUT_TYPE, 0 = dataset files)",
    )
    parser.add_argument("--color-dev", default="/dev/video0",
                        help="V4L2 color device (live modes)")
    parser.add_argument("--depth-dev", default="/dev/video1",
                        help="V4L2 depth device (live modes)")
    parser.add_argument(
        "--replay-color", default=None, metavar="FILE",
        help="serve the color device from a recorded session file through "
             "the engine's replay shim (hardware-free live mode)",
    )
    parser.add_argument("--replay-depth", default=None, metavar="FILE",
                        help="session file for the depth device")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop the live run after N frames (0 = until "
                             "the stream ends)")
    parser.add_argument(
        "--record", default=None, metavar="DIR",
        help="record the live stream as a TUM-format capture while "
             "tracking (DO_RECORD_IMAGES, iowrapperRGBD.cpp:181-217)",
    )
    args = parser.parse_args(argv)

    select_backend(args.cpu)
    from revo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from revo_tpu.config import load_config

    cfg = load_config(args.settings, args.dataset)
    if args.export_ply or args.live_view:
        # Colored-map surfaces read keyframe images from the retained
        # history; everything else runs with pruned slots (bounded
        # keyframe memory, frontend.prune_keyframe).
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            tracker=dataclasses.replace(cfg.tracker, store_kf_images=True),
        )
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic > 0:
        if args.auto_capacity > 0:
            from revo_tpu.autotune import calibrate_capacities
            from revo_tpu.io.synthetic import SyntheticScene, render_sequence

            probe = list(render_sequence(
                SyntheticScene(), cfg.camera, args.auto_capacity,
                seed=args.seed,
            ))
            cfg = calibrate_capacities(
                cfg, [f[0] for f in probe], [f[1] for f in probe],
                margin=args.capacity_scale,
            )
            print(f"[revo_tpu] calibrated edge_capacity = "
                  f"{cfg.pyramid.edge_capacity}")
        return _run_synthetic(
            cfg, args.synthetic, args.out, args.seed,
            close_loops_flag=args.close_loops,
            live_view=args.live_view,
            windowed_ba_flag=args.windowed_ba,
            export_ply=args.export_ply,
        )

    input_type = (
        args.input_type
        if args.input_type is not None
        else cfg.dataset.input_type
    )
    if input_type != 0:
        _run_live(
            cfg, input_type, args.out, args.color_dev, args.depth_dev,
            replay_color=args.replay_color, replay_depth=args.replay_depth,
            max_frames=args.max_frames,
            close_loops_flag=args.close_loops, live_view=args.live_view,
            windowed_ba_flag=args.windowed_ba, export_ply=args.export_ply,
            record_dir=args.record,
        )
        return 0

    if not args.dataset:
        parser.error("either provide dataset yaml or --synthetic N")
    if not cfg.dataset.datasets:
        print("[revo_tpu] no datasets listed in config", file=sys.stderr)
        return 1
    for ds in cfg.dataset.datasets:
        _run_dataset(
            cfg, ds, args.out, gt_file=args.gt,
            auto_capacity=args.auto_capacity,
            capacity_scale=args.capacity_scale,
            close_loops_flag=args.close_loops,
            live_view=args.live_view,
            windowed_ba_flag=args.windowed_ba,
            export_ply=args.export_ply,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
