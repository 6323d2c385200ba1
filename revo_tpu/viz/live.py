"""Incremental during-run visualization — the live-viewer substitute.

The reference spawns a Pangolin viewer thread that renders the map,
trajectory and current camera at ~30 fps while tracking runs
(gui/Viewer.cc:61-168, thread spawned system.cpp:39).  An accelerator host
is usually headless, so the equivalent here renders to files on a
background thread while the run progresses: a trajectory plot, the current
reprojection-residual overlay (DO_SHOW_DEBUG_IMAGE equivalent), a rolling
metrics line, and an auto-refreshing index.html — open it in any browser
(or watch the PNGs) to follow the run live.

Decoupling mirrors the reference's design: the tracking thread only
enqueues lightweight snapshots (never blocks, drops frames when the
renderer is behind — like a real viewer), and a daemon thread does all
matplotlib/IO work.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np

_INDEX_HTML = """<!DOCTYPE html>
<html><head><meta http-equiv="refresh" content="1">
<title>revo_tpu live</title>
<style>body{{background:#111;color:#ddd;font-family:monospace}}
img{{max-width:48%;border:1px solid #444;margin:4px}}</style></head>
<body>
<h3>revo_tpu live viewer</h3>
<pre id="status">{status}</pre>
<img src="trajectory.png?ts={ts}"><img src="overlay.png?ts={ts}">
<img src="map.png?ts={ts}">
</body></html>
"""


class LiveViewer:
    """Background renderer of run progress.

    Usage::

        viewer = LiveViewer(out_dir, every=5)
        ...
        viewer.update(vo, frame, pose, frame_idx)   # cheap, non-blocking
        ...
        viewer.close()
    """

    def __init__(self, out_dir: str, every: int = 5):
        self.dir = os.path.join(out_dir, "live")
        os.makedirs(self.dir, exist_ok=True)
        self.every = max(1, every)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        # Per-keyframe decimated colored clouds in CAMERA frame, keyed by
        # ordinal (computed once per keyframe on the render thread; world
        # placement re-applies the CURRENT ring pose each render so loop
        # -closure corrections move the map).  Evicted keyframes keep
        # their last-known pose — the accumulated map a MapDrawer shows.
        self._cloud_cache: dict = {}
        self._kf_pose_cache: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer side (tracking thread) ----------------------------------

    def update(self, vo, frame, pose: np.ndarray, frame_idx: int) -> None:
        """Enqueue a snapshot every ``every`` frames; never blocks.

        ``vo`` is the VOSystem (pose graph + current keyframe read here,
        on the tracking thread, so the render thread touches no live
        state), ``frame`` the just-built device Frame.
        """
        if frame_idx % self.every:
            return
        snap = {
            "poses": np.stack([n.T_w_curr for n in vo.pose_graph])
            if vo.pose_graph
            else np.eye(4)[None],
            "kf": vo.kf,
            "frame": frame,
            "pose": np.asarray(pose),
            "cfg": vo.cfg,
            "idx": frame_idx,
            "n_kf": vo.n_keyframes,
            "n_lost": vo.n_tracking_lost,
            # (ordinal, Keyframe) refs for the 3-D map pane; cloud
            # extraction happens on the render thread.
            "kf_ring": list(vo.kf_history),
        }
        try:
            self._q.put_nowait(snap)
        except queue.Full:
            pass  # renderer is behind: drop, like a real viewer

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    # -- render side (daemon thread) ---------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                snap = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._render(snap)
            except Exception as e:  # viewer must never kill the run
                with open(os.path.join(self.dir, "viewer_errors.log"), "a") as f:
                    f.write(f"frame {snap.get('idx')}: {e!r}\n")

    def _render(self, snap) -> None:
        from revo_tpu.viz.debug import reprojection_overlay
        from revo_tpu.viz.plot import plot_trajectory

        plot_trajectory(
            os.path.join(self.dir, "trajectory.png"),
            snap["poses"],
            title=f"frame {snap['idx']}",
        )
        kf, frame = snap["kf"], snap["frame"]
        if kf is not None and frame is not None:
            T_kf_cur = np.linalg.inv(np.asarray(kf.T_w_k)) @ snap["pose"]
            reprojection_overlay(
                kf,
                frame,
                T_kf_cur[:3, :3],
                T_kf_cur[:3, 3],
                snap["cfg"],
                out_png=os.path.join(self.dir, "overlay.png"),
            )
        self._render_map(snap)
        status = (
            f"frame {snap['idx']}  keyframes {snap['n_kf']}  "
            f"lost {snap['n_lost']}  "
            f"t = {np.round(snap['pose'][:3, 3], 4).tolist()}"
        )
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write(_INDEX_HTML.format(status=status, ts=snap["idx"]))

    def _render_map(self, snap) -> None:
        """The 3-D map pane: keyframe frusta + decimated colored cloud
        under a camera-follow projection (MapDrawer.cc:48-180 analog)."""
        from revo_tpu.frontend import generate_colored_pcl
        from revo_tpu.viz.map3d import render_map_png

        for ordinal, kf in snap.get("kf_ring", []):
            if ordinal not in self._cloud_cache:
                lvl = min(1, len(kf.frame.levels) - 1)  # half-res: plenty
                pts, cols = generate_colored_pcl(kf.frame, snap["cfg"], lvl)
                step = max(1, len(pts) // 1500)  # decimate for the pane
                self._cloud_cache[ordinal] = (
                    pts[::step].astype(np.float32),
                    cols[::step].astype(np.float32),
                )
                # Bound the accumulated map (oldest evicted first).
                while len(self._cloud_cache) > 64:
                    self._cloud_cache.pop(min(self._cloud_cache))
                    self._kf_pose_cache.pop(
                        min(self._kf_pose_cache), None
                    )
            self._kf_pose_cache[ordinal] = np.asarray(kf.T_w_k, np.float64)
        clouds = []
        kf_poses = []
        for ordinal, (pts_cam, cols) in self._cloud_cache.items():
            T = self._kf_pose_cache.get(ordinal)
            if T is None:
                continue
            kf_poses.append(T)
            clouds.append((pts_cam @ T[:3, :3].T + T[:3, 3], cols))
        render_map_png(
            os.path.join(self.dir, "map.png"),
            clouds,
            np.stack(kf_poses) if kf_poses else np.eye(4)[None],
            snap["poses"],
            snap["pose"].astype(np.float64),
            title=f"map @ frame {snap['idx']} ({len(kf_poses)} keyframes)",
        )
