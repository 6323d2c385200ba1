"""Per-frame front end: RGB-D -> pyramid of gray/depth/edges/edge clouds.

Replacement for ImgPyramidRGBD (imgpyramidrgbd.cpp:43-229): one
jitted function turns a full-resolution RGB(-D) pair into a fixed-shape
``Frame`` pytree.  Per level (addLevelEdge): Canny edges, BMVC17 fill-in when
patch occupancy is low, and back-projection of edge pixels with valid depth
into a fixed-capacity 3-D cloud.  Levels >0 come from pyrDown gray + valid
-pixel depth subsampling (imgpyramidrgbd.cpp:75-92).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from revo_tpu import ops
from revo_tpu.config import SystemConfig
from revo_tpu.ops.backproject import EdgeCloud


class FrameLevel(NamedTuple):
    """Per-pyramid-level data of one frame."""

    gray: jax.Array  # (H, W) float32, uint8-valued
    depth: jax.Array  # (H, W) float32 metres, 0 = invalid
    edges: jax.Array  # (H, W) bool, after fill-in (edgesPyr)
    edges_orig: jax.Array  # (H, W) bool, before fill-in (edgesOrigPyr)
    cloud: EdgeCloud  # fixed-capacity 3-D edge points (camera frame)


class Frame(NamedTuple):
    levels: Tuple[FrameLevel, ...]
    timestamp: jax.Array  # () float64-as-float32 pair not needed; host keeps ts


def rgb_to_gray(rgb: jax.Array) -> jax.Array:
    """OpenCV BGR(A)2GRAY weights (imgpyramidrgbd.cpp:53), RGB channel order
    input: Y = 0.299 R + 0.587 G + 0.114 B, rounded to uint8 levels."""
    r = rgb[..., 0].astype(jnp.float32)
    g = rgb[..., 1].astype(jnp.float32)
    b = rgb[..., 2].astype(jnp.float32)
    return jnp.round(0.299 * r + 0.587 * g + 0.114 * b)


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_frame(
    gray: jax.Array,
    depth: jax.Array,
    cfg: SystemConfig,
    undistort_maps=None,
) -> Frame:
    """Build the full pyramid from full-res gray (uint8-valued f32) + depth.

    Mirrors the ImgPyramidRGBD ctor (imgpyramidrgbd.cpp:43-96) with static
    shapes; ``cfg`` is a hashable static argument so each config compiles
    once.

    Accepts compact transfer dtypes and converts on device (the host->device
    link is the streaming bottleneck): uint8 gray, and uint16 raw depth
    scaled by 1/DEPTH_SCALE_FACTOR like the reference's convertTo
    (iowrapperRGBD.cpp:326-327).
    """
    if gray.dtype != jnp.float32:
        gray = gray.astype(jnp.float32)
    if depth.dtype == jnp.uint16:
        depth = depth.astype(jnp.float32) * (
            1.0 / cfg.dataset.depth_scale_factor
        )
    elif depth.dtype != jnp.float32:
        depth = depth.astype(jnp.float32)
    if undistort_maps is not None:
        # cv::remap CV_INTER_LINEAR on gray AND depth, like the reference
        # (imgpyramidrgbd.cpp:57-65).
        from revo_tpu.ops.undistort import remap_bilinear

        map_u, map_v = undistort_maps
        gray = jnp.round(remap_bilinear(gray, map_u, map_v))
        depth = remap_bilinear(depth, map_u, map_v)
    pyr = cfg.pyramid
    cams = cfg.camera_pyramid()
    levels = []
    g, d = gray, depth
    prev_edges = None
    for lvl in range(pyr.n_levels):
        cam = cams[lvl]
        if pyr.gaussian_before_canny:
            canny_in = ops.gaussian_blur(g)
        else:
            canny_in = g
        edges = ops.canny(canny_in, pyr.canny_threshold1, pyr.canny_threshold2)
        edges_orig = edges
        patch = pyr.dist_patch_sizes[lvl]
        counts, occupancy = ops.patch_histogram(edges, patch)
        if pyr.use_edge_hist and lvl > 0:
            # Fill-in is itself data-dependent (occupancy < nPercentage,
            # imgpyramidrgbd.cpp:188-196); keep it branchless with where.
            filled = ops.fill_in_edges(
                edges,
                prev_edges,
                counts,
                patch,
                pyr.dist_patch_sizes[lvl - 1],
            )
            edges = jnp.where(occupancy < pyr.n_percentage, filled, edges)
        cloud = ops.backproject_edges(
            edges,
            d,
            cam.fx,
            cam.fy,
            cam.cx,
            cam.cy,
            pyr.depth_min,
            pyr.depth_max,
            pyr.edge_capacity[lvl],
            compaction=pyr.compaction,
        )
        levels.append(
            FrameLevel(
                gray=g, depth=d, edges=edges, edges_orig=edges_orig, cloud=cloud
            )
        )
        prev_edges = edges
        if lvl + 1 < pyr.n_levels:
            g = ops.pyr_down(g)
            d = ops.subsample_depth_with_holes(d)
    # Timestamp is host-side metadata; derive the placeholder from the input
    # so its sharding axes match when frames flow through shard_map carries.
    return Frame(levels=tuple(levels), timestamp=gray[0, 0] * 0)


class Keyframe(NamedTuple):
    """Keyframe = frame + per-level DT/gradient structures + world pose.

    Mirrors makeKeyframe (imgpyramidrgbd.cpp:231-252) + setTwf
    (imgpyramidrgbd.h:126-137).
    """

    structs: Tuple[jax.Array, ...]  # per level (H, W, 3): (gx, gy, dt)
    quads: Tuple[jax.Array, ...]  # per level (H, W, 12) packed 2x2 table
    frame: Frame
    T_w_k: jax.Array  # (4, 4) keyframe-to-world


def generate_colored_pcl(
    frame: Frame,
    cfg: SystemConfig,
    lvl: int = 0,
    dense: bool = False,
    rgb01: "jax.Array | None" = None,
):
    """Colored point cloud (XYZ + RGB in [0,1]) for export/visualization.

    Mirrors ImgPyramidRGBD::generateColoredPcl (imgpyramidrgbd.cpp:279-327):
    dense (all valid-depth pixels) or edge-sparse.  Colors come from
    ``rgb01`` (H, W, 3) if given, else the gray level is replicated.
    Returns (points (M, 3), colors (M, 3)) as NumPy arrays (host-side
    export path; M is data-dependent).
    """
    import numpy as np

    lv = frame.levels[lvl]
    cam = cfg.camera_pyramid()[lvl]
    depth = np.asarray(lv.depth)
    gray = np.asarray(lv.gray)
    edges = np.asarray(lv.edges)
    ok = (
        np.isfinite(depth)
        & (depth > cfg.pyramid.depth_min)
        & (depth < cfg.pyramid.depth_max)
    )
    if not dense:
        ok &= edges
    ys, xs = np.nonzero(ok)
    z = depth[ys, xs]
    pts = np.stack(
        [z * (xs - cam.cx) / cam.fx, z * (ys - cam.cy) / cam.fy, z], axis=-1
    ).astype(np.float32)
    if rgb01 is not None:
        clr = np.asarray(rgb01)[ys, xs].astype(np.float32)
    else:
        g01 = (gray[ys, xs] / 255.0).astype(np.float32)
        clr = np.stack([g01, g01, g01], axis=-1)
    return pts, clr


def prune_keyframe(kf: Keyframe) -> Keyframe:
    """Shrink a keyframe for RETENTION: drop the per-level image tensors
    (gray/depth/edges) that tracking never reads from a stored keyframe —
    relocalization, loop-closure verification and windowed BA consume only
    ``structs``/``quads``/per-level ``cloud``/``T_w_k`` (track_frames body;
    windowed.measure_overlap).  The reference sketches the same idea as
    ``prepareKfForStorage`` (imgpyramidrgbd.h:156-169, disabled there).

    Dropped tensors become (1, 1) placeholders so the pytree structure is
    unchanged (history slots stay stackable for the one-dispatch batched
    loop-closure verify).  At 640x480 x 3 levels this removes ~4.0 MB of
    the ~12.3 MB slot (measured in test_soak); colored-PCL export and the
    live viewer's map pane need the images — keep
    ``TrackerConfig.store_kf_images=True`` for those (run.py does, for
    --export-ply / --live-view)."""
    levels = tuple(
        lv._replace(
            gray=jnp.zeros((1, 1), lv.gray.dtype),
            depth=jnp.zeros((1, 1), lv.depth.dtype),
            edges=jnp.zeros((1, 1), lv.edges.dtype),
            edges_orig=jnp.zeros((1, 1), lv.edges_orig.dtype),
        )
        for lv in kf.frame.levels
    )
    return kf._replace(frame=kf.frame._replace(levels=levels))


@functools.partial(jax.jit, static_argnames=("cfg",))
def make_keyframe(frame: Frame, T_w_k: jax.Array, cfg: SystemConfig) -> Keyframe:
    structs = tuple(
        ops.keyframe_structure(lv.edges) for lv in frame.levels
    )
    quads = tuple(
        ops.quad_structure(s, cfg.tracker.optimizer.quad_form)
        for s in structs
    )
    return Keyframe(structs=structs, quads=quads, frame=frame, T_w_k=T_w_k)
