"""Head-to-head against the ACTUAL reference binary on identical frames.

BASELINE.md originally recorded the reference as unbuildable here (no
Eigen/Boost in the image, zero egress).  That fell: Eigen ships inside
tensorflow's bundled headers, OpenCV4 C++ dev headers are installed, and
Sophus is vendored in the reference tree — scripts/build_reference.sh
builds the reference's own sources (patched only mechanically: boost::
filesystem -> std::filesystem, OpenCV3 constant names, C++17 allocator
strictness; the hot loop is untouched, full -O3 -mavx2 -fopenmp) into
/tmp/refbuild OUTSIDE the repo.

This script renders a synthetic 640x480 sequence with exact ground truth,
writes it as a TUM-format dataset (rgb/ + depth/ + associate.txt — the
layout iowrapperRGBD.cpp:70,316-326 consumes), runs the reference binary
on it, and compares:

- reference ATE vs ground truth (its poses_<dataset>.txt output,
  system.cpp:46-79) against revo_tpu's ATE on the SAME pngs (decoded
  back, so both systems see identical 8-bit quantization),
- reference per-frame time: its own VO-report numbers (mean tracking
  time + amortized DT, system.cpp:292-304) AND the wall time of its
  processing loop.

Prints one JSON line.  Run: python scripts/refbench.py [n_frames]
"""
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Force the CPU backend BEFORE any jax use: this is an f32 accuracy
# comparison on the host, identical on every machine.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REF_BIN = os.environ.get("REVO_REF_BIN", "/tmp/refbuild/build/REVO")
WORK = "/tmp/ref_dataset"
SEQ = "synthetic"


def _make_scene(family):
    from revo_tpu.io.synthetic import (
        SyntheticScene,
        box_scene,
        column_scene,
        sparse_scene,
    )

    if family == "plane":
        return SyntheticScene()
    if family == "box":
        return box_scene()
    if family == "column":
        return column_scene()
    if family == "sparse":
        # Edge-sparse / low-texture: flat walls + flat-faced boxes, only
        # silhouette/crease edges — drives BOTH systems' BMVC17 fill-in
        # (imgpyramidrgbd.cpp:111-172) end-to-end.
        return sparse_scene()
    if family == "box_noisy":
        # The photometric sensor profile of the accuracy battery
        # (tests/test_scenes.py SENSOR_PROFILE) plus Kinect-class depth
        # corruption — the regime where both systems see a REAL sensor's
        # frame-to-frame edge instability.
        return box_scene(
            image_noise=3.0, shot_noise=4.0, image_blur=0.5,
            exposure_drift=0.05, vignette=0.25,
            depth_noise=0.04, depth_hole_frac=0.2,
        )
    raise ValueError(family)


FR1_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)


def _distort_captures(grays, depths, dist):
    """Inverse-warp ideal renders through a TUM-fr1-coefficient lens
    (cv2.undistortPoints iterative inversion — independent of
    ops/undistort.py's forward-model maps; same construction as
    tests/test_undistort_recorder.py)."""
    import cv2

    from revo_tpu.config import SystemConfig

    cam = SystemConfig().camera
    K = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64
    )
    u, v = np.meshgrid(
        np.arange(cam.width, dtype=np.float64),
        np.arange(cam.height, dtype=np.float64),
    )
    pts = np.stack([u.ravel(), v.ravel()], -1)[:, None, :]
    und = cv2.undistortPoints(pts, K, np.array(dist, np.float64), P=K)
    mu = und[:, 0, 0].reshape(cam.height, cam.width).astype(np.float32)
    mv = und[:, 0, 1].reshape(cam.height, cam.width).astype(np.float32)
    g_out, d_out = [], []
    for g, d in zip(grays, depths):
        g_out.append(cv2.remap(g.astype(np.float32), mu, mv, cv2.INTER_LINEAR))
        d_out.append(cv2.remap(d.astype(np.float32), mu, mv, cv2.INTER_NEAREST))
    return g_out, d_out


def render(n, family="plane", seed=0):
    cache = (
        f"/tmp/bench_frames_640x480_{n}_s{seed}.npz"
        if family == "plane" and seed == 0
        else f"/tmp/refbench_{family}_640x480_{n}_s{seed}.npz"
    )
    if os.path.exists(cache):
        z = np.load(cache)
        return (
            [z[f"g{i}"] for i in range(n)],
            [z[f"d{i}"] for i in range(n)],
            z["gt"],
        )
    from revo_tpu.config import SystemConfig
    from revo_tpu.io.synthetic import (
        loop_trajectory,
        render_trajectory_parallel,
    )

    cfg = SystemConfig()
    if family == "fastpan":
        # ~4x handheld lateral pan: exercises keyframe promotion in both
        # systems (histogram-voting comparison, not just frame-to-kf).
        scene = _make_scene("box")
        traj = scene.trajectory(
            n, seed=seed, translation_step=0.03, rotation_step=0.01
        )
    elif family == "orbit":
        # Long-run family (VERDICT r4 #3): a full lateral orbit with yaw
        # sweeps — large total excursion, so keyframe promotion fires
        # repeatedly in both systems and drift accumulates over hundreds
        # of frames (the regime where the reference's promotion cadence
        # and unbounded past-cloud list, tracker.cpp:110-223, matter).
        scene = _make_scene("box")
        traj = loop_trajectory(n, radius=0.35, wobble=0.002, seed=seed)
    elif family == "panmix":
        # Long-run mixed pan: ~2.5x handheld random walk on the curved
        # -surface scene — sustained motion with promotions.
        scene = _make_scene("column")
        traj = scene.trajectory(
            n, seed=seed, translation_step=0.02, rotation_step=0.006
        )
    else:
        scene = _make_scene(family)
        traj = scene.trajectory(n, seed=seed)
    frames = render_trajectory_parallel(scene, cfg.camera, traj, seed=seed)
    grays = [f[0] for f in frames]
    depths = [f[1] for f in frames]
    gt = np.stack([f[2] for f in frames])
    arrs = {"n": np.int64(n), "gt": gt}
    for i, (g, d) in enumerate(zip(grays, depths)):
        arrs[f"g{i}"] = g
        arrs[f"d{i}"] = d
    np.savez(cache, **arrs)
    return grays, depths, gt


def write_dataset(grays, depths, gt, dist=None):
    import cv2

    root = os.path.join(WORK, SEQ)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    lines = []
    gt_lines = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        ts = f"{i / 30.0:.6f}"
        rgb = cv2.cvtColor(g.astype(np.uint8), cv2.COLOR_GRAY2BGR)
        cv2.imwrite(os.path.join(root, "rgb", f"{ts}.png"), rgb)
        d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "depth", f"{ts}.png"), d16)
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
        t = gt[i, :3, 3]
        gt_lines.append(f"{ts} {t[0]} {t[1]} {t[2]} 0 0 0 1")
    with open(os.path.join(root, "associate.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")

    # Dataset yaml: the reference's own fr1 operating point (identical to
    # config/dataset_tum1.yaml keys) with our renderer's zero distortion.
    from revo_tpu.config import SystemConfig

    cam = SystemConfig().camera
    with open(os.path.join(WORK, "dataset_synth.yaml"), "w") as f:
        f.write(
            "%YAML:1.0\n"
            f"Camera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n"
            f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
            f"Camera.k1: {dist[0] if dist else 0.0}\n"
            f"Camera.k2: {dist[1] if dist else 0.0}\n"
            f"Camera.p1: {dist[2] if dist else 0.0}\n"
            f"Camera.p2: {dist[3] if dist else 0.0}\n"
            f"Camera.k3: {dist[4] if dist else 0.0}\n"
            f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
            "cannyThreshold1: 150\ncannyThreshold2: 100\n"
            f'MainFolder: "{WORK}/"\n'
            f'Datasets: "{SEQ}"\n'
            'ASSOCIATE: "associate.txt"\n'
            "PYR_MIN_LVL: 2\nPYR_MAX_LVL: 0\n"
            "DEPTH_MIN: 0.1\nDEPTH_MAX: 5.2\n"
            "USE_EDGE_HIST: 1\nnPercentage: 0.3\n"
            "useDepthTimeStamp: 0\nSKIP_FIRST_N_FRAMES: 0\n"
            "READ_N_IMAGES: 10000\nDEPTH_SCALE_FACTOR: 5000.0\n"
            f"DO_RECORD_IMAGES: 0\nDO_UNDISTORT: {1 if dist else 0}\n"
        )
    with open(os.path.join(WORK, "settings.yaml"), "w") as f:
        f.write(
            "%YAML:1.0\n"
            "DO_GENERATE_DENSE_PCL: 0\nDO_SHOW_DEBUG_IMAGE: 0\n"
            "DO_USE_PANGOLIN_VIEWER: 0\nUSE_EDGE_HIST: 1\n"
            "CHECK_TRACKING_RESULTS: 1\nCHECK_INIT_VALUES: 1\n"
            "USE_EDGE_FILTER: 1\nN_FRAMES_HIST_VOTING: 3\n"
            "DO_OUTPUT_POSES: 1\n"
        )
    return root


def run_reference(timeout_s: float = 420.0):
    """Run the reference binary; on its own shutdown race, harvest the
    (complete) pose file anyway.

    The reference DEADLOCKS nondeterministically at end-of-dataset: the
    consumer loop polls isImgPyramidAvailable()/hasMoreImages()
    (system.cpp:125-137, usleep spin), but mHasMoreImages is only updated
    INSIDE getOldestPyramid (iowrapperRGBD.cpp:350) — if the consumer
    drains the queue before the producer sets mAllImagesRead, no further
    getOldestPyramid call ever happens and the main thread spins forever
    (observed: 5 threads all in nanosleep/futex, 12 s CPU over 11 min,
    poses file complete).  writePose flushes per frame (std::endl), so on
    timeout the pose file is still the full tracked trajectory; only the
    end-of-run VO report is lost."""
    pose_file = os.path.join(WORK, f"poses_{SEQ}.txt")
    if os.path.exists(pose_file):
        os.remove(pose_file)  # never parse a previous family's output
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [REF_BIN, os.path.join(WORK, "settings.yaml"),
             os.path.join(WORK, "dataset_synth.yaml")],
            cwd=WORK, capture_output=True, text=True, timeout=timeout_s,
        )
        out = r.stdout + r.stderr
        rc = r.returncode
    except subprocess.TimeoutExpired as e:
        out = "".join(
            s.decode(errors="replace") if isinstance(s, bytes) else s
            for s in (e.stdout or "", e.stderr or "")
        )
        rc = "timeout_shutdown_race"
    wall = time.perf_counter() - t0
    report = {}
    for key, pat in [
        ("frames", r"Frames Tracked:\s*([0-9.]+)"),
        ("keyframes", r"Keyframes Tracked:\s*([0-9.]+)"),
        ("lost", r"Tracking Lost:\s*([0-9.]+)"),
        ("dt_ms", r"Distance Transform:\s*([0-9.eE+-]+)"),
        ("track_ms", r"Mean Tracking Time:\s*([0-9.eE+-]+)"),
    ]:
        m = re.search(pat, out)
        report[key] = float(m.group(1)) if m else None
    poses, idxs = [], []
    if os.path.exists(pose_file):
        for line in open(pose_file):
            v = line.split()
            if len(v) >= 8:
                # writePose format: ts tx ty tz qx qy qz qw
                # (system.cpp:76-79); rebuild the full SE(3) so RPE (the
                # TUM protocol's second metric) is computable.
                t = np.array([float(x) for x in v[1:4]])
                qx, qy, qz, qw = (float(x) for x in v[4:8])
                T = np.eye(4)
                T[:3, :3] = _quat_to_R(qx, qy, qz, qw)
                T[:3, 3] = t
                poses.append(T)
                idxs.append(int(round(float(v[0]) * 30.0)))
    return report, np.array(poses), np.array(idxs, int), wall, rc


def _quat_to_R(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def run_ours(root, n, dist=None):
    """Our system on the SAME pngs (decode back like the reference does)."""
    import cv2
    import dataclasses

    from revo_tpu.config import SystemConfig
    from revo_tpu.system import VOSystem

    cfg = SystemConfig()
    if dist is not None:
        cfg = dataclasses.replace(
            cfg,
            camera=dataclasses.replace(cfg.camera, distortion=tuple(dist)),
            pyramid=dataclasses.replace(cfg.pyramid, undistort=True),
        )
    vo = VOSystem(cfg)

    def frames():
        for i in range(n):
            ts = f"{i / 30.0:.6f}"
            g = cv2.imread(
                os.path.join(root, "rgb", f"{ts}.png"), cv2.IMREAD_GRAYSCALE
            ).astype(np.float32)
            d = cv2.imread(
                os.path.join(root, "depth", f"{ts}.png"), cv2.IMREAD_UNCHANGED
            ).astype(np.float32) / 5000.0
            yield g, d, float(ts)

    poses, _, rep = vo.run(frames())
    return poses, rep.keyframes


def ate_rmse(est_t, gt):
    gt_t = gt[: est_t.shape[0], :3, 3]
    return float(np.sqrt(np.mean(np.sum((est_t - gt_t) ** 2, axis=-1))))


def _metrics(est_poses, gt, idxs=None):
    """TUM-protocol metrics (README.md:57 requires ATE AND RPE): Horn
    -aligned translational ATE RMSE, plus per-frame (delta=1) and
    per-second (delta=30 at the 30 Hz timestamp convention) RPE.  ``idxs``
    associates estimated rows with ground-truth frame indices (the
    reference emits one pose per processed frame, timestamped i/30)."""
    from revo_tpu.eval import absolute_trajectory_error, relative_pose_error

    if idxs is None:
        idxs = np.arange(len(est_poses))
    gt_assoc = gt[idxs]
    ate = absolute_trajectory_error(est_poses, gt_assoc)
    rpe1 = relative_pose_error(est_poses, gt_assoc, delta=1)
    d30 = min(30, max(len(est_poses) - 1, 1))
    rpe30 = relative_pose_error(est_poses, gt_assoc, delta=d30)
    return {
        "ate_m": round(ate.rmse, 5),
        "ate_raw_m": round(ate_rmse(est_poses[:, :3, 3], gt_assoc), 5),
        "rpe1_m": round(rpe1.trans_rmse, 6),
        "rpe1_deg": round(rpe1.rot_rmse_deg, 4),
        "rpe30_m": round(rpe30.trans_rmse, 5),
        "rpe30_deg": round(rpe30.rot_rmse_deg, 3),
    }


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    family = sys.argv[2] if len(sys.argv) > 2 else "plane"
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    if not os.path.exists(REF_BIN):
        print(json.dumps({"error": f"reference binary missing: {REF_BIN}; "
                          "run scripts/build_reference.sh"}))
        return
    dist = None
    if family == "distorted":
        grays, depths, gt = render(n, "plane", seed)
        dist = FR1_DIST
        grays, depths = _distort_captures(grays, depths, dist)
    else:
        grays, depths, gt = render(n, family, seed)
    root = write_dataset(grays, depths, gt, dist)
    report, ref_poses, ref_idxs, wall, rc = run_reference()
    ref_m = _metrics(ref_poses, gt, ref_idxs) if len(ref_poses) else None
    ours, ours_kfs = run_ours(root, n, dist)
    ours_m = _metrics(ours, gt)
    # Per-frame reference cost by its own report: tracking + DT amortized
    # over frames (DT is per-keyframe).  Wall includes PNG decode+startup.
    per_frame_ms = None
    if report["track_ms"] is not None:
        dt_total = (report["dt_ms"] or 0.0) * max(report["keyframes"] or 1, 1)
        per_frame_ms = report["track_ms"] + dt_total / max(
            report["frames"] or n, 1
        )
    print(json.dumps({
        "metric": "reference_binary_headtohead_640x480",
        "family": family,
        "seed": seed,
        "n_frames": n,
        "ref_returncode": rc,
        "ref_report": report,
        "ref_fps_own_report": (
            round(1000.0 / per_frame_ms, 2) if per_frame_ms else None
        ),
        "ref_wall_s": round(wall, 2),
        "ref_metrics": ref_m,
        "ref_ate_m": ref_m["ate_m"] if ref_m else None,
        "ours_metrics": ours_m,
        "ours_ate_m_same_pngs": ours_m["ate_m"],
        "ref_keyframes": report.get("keyframes"),
        "ours_keyframes": ours_kfs,
    }))


if __name__ == "__main__":
    main()
