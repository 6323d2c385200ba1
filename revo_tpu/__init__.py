"""revo_tpu — an edge-based RGB-D visual-odometry / SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
fabianschenk/REVO (Robust Edge-based Visual Odometry, BMVC17/IROS17): RGB-D
image pyramids, Canny edge extraction, Euclidean distance-transform keyframes,
coarse-to-fine Gauss-Newton/LM SE(3) frame-to-keyframe alignment, histogram
-voting keyframe selection, pose-graph trajectory output — plus capabilities
the reference lacks: batched multi-sequence tracking, device-mesh sharding and
pose-graph/windowed bundle adjustment over XLA collectives.
"""

from revo_tpu import lie
from revo_tpu.config import (
    CameraConfig,
    DatasetConfig,
    OptimizerConfig,
    PyramidConfig,
    SystemConfig,
    TrackerConfig,
    load_config,
)

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import revo_tpu` light; the heavy modules
    pull in jax compilation machinery)."""
    lazy = {
        "VOSystem": ("revo_tpu.system", "VOSystem"),
        "build_frame": ("revo_tpu.frontend", "build_frame"),
        "make_keyframe": ("revo_tpu.frontend", "make_keyframe"),
        "track_frames": ("revo_tpu.tracker", "track_frames"),
        "vo_scan": ("revo_tpu.parallel.batch", "vo_scan"),
        "vo_scan_batched": ("revo_tpu.parallel.batch", "vo_scan_batched"),
        "track_long_sequence": (
            "revo_tpu.parallel.segments", "track_long_sequence"
        ),
        "pipeline_replay": ("revo_tpu.parallel.pipeline", "pipeline_replay"),
        "close_loops": ("revo_tpu.loopclosure", "close_loops"),
        "calibrate_capacities": (
            "revo_tpu.autotune", "calibrate_capacities"
        ),
        "absolute_trajectory_error": (
            "revo_tpu.eval", "absolute_trajectory_error"
        ),
        "relative_pose_error": ("revo_tpu.eval", "relative_pose_error"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'revo_tpu' has no attribute {name!r}")


__all__ = [
    "lie",
    "CameraConfig",
    "DatasetConfig",
    "OptimizerConfig",
    "PyramidConfig",
    "SystemConfig",
    "TrackerConfig",
    "load_config",
    "VOSystem",
    "build_frame",
    "make_keyframe",
    "track_frames",
    "vo_scan",
    "vo_scan_batched",
    "track_long_sequence",
    "pipeline_replay",
    "close_loops",
    "calibrate_capacities",
    "absolute_trajectory_error",
    "relative_pose_error",
    "__version__",
]
