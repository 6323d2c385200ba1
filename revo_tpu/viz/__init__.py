"""Offline visualization & model export (replaces the Pangolin GUI layer).

The reference's live viewer (gui/Viewer.cc, MapDrawer.cc) is OpenGL and out
of scope for the device core; its durable outputs — colored point-cloud PLY and
keyframe-frusta PLY (MapDrawer.h saveModel :97-170) — are reproduced here as
host-side exporters, plus a trajectory exporter.
"""

from revo_tpu.viz.ply import (
    export_colored_pcl_ply,
    export_keyframe_frusta_ply,
    export_trajectory_ply,
)
from revo_tpu.viz.plot import plot_error, plot_trajectory
from revo_tpu.viz.debug import reprojection_overlay

__all__ = [
    "export_colored_pcl_ply",
    "export_keyframe_frusta_ply",
    "export_trajectory_ply",
    "plot_error",
    "plot_trajectory",
    "reprojection_overlay",
]
