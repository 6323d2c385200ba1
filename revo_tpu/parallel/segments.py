"""Segment-parallel tracking of long sequences with overlap stitching.

The sequence-parallel / context-parallel analog for video (SURVEY.md §5
"long-context"): a long sequence is split into S segments that overlap by
one frame; each segment is tracked independently (one segment per mesh slot
via shard_map, or vmapped), producing segment-local trajectories anchored at
the segment's first frame.  Stitching composes the segment-anchor poses by a
prefix product over SE(3) (an associative scan — log-depth on device), then
an optional pose-graph relaxation over the boundary constraints distributes
residual misalignment.

Scaling: wall-clock ~ T/S while ATE degrades only by the boundary-stitching
error, which the pose-graph pass absorbs.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from revo_tpu import lie
from revo_tpu.config import SystemConfig
from revo_tpu.parallel.batch import vo_scan_batched
from revo_tpu.parallel.posegraph import (
    PoseGraphEdges,
    optimize_pose_graph,
)


def split_segments(
    grays: jax.Array, depths: jax.Array, n_segments: int
) -> Tuple[jax.Array, jax.Array]:
    """(N, H, W) -> (S, L, H, W) with one-frame overlap between segments.

    Segment s covers frames [s*step, s*step + L) where L = step + 1, so
    segment s's last frame == segment s+1's first frame.  N-1 must be
    divisible by S.
    """
    n = grays.shape[0]
    assert (n - 1) % n_segments == 0, (
        f"need (N-1) % S == 0, got N={n}, S={n_segments}"
    )
    step = (n - 1) // n_segments
    length = step + 1
    idx = (
        jnp.arange(n_segments)[:, None] * step + jnp.arange(length)[None, :]
    )
    return grays[idx], depths[idx]


def track_segments(
    seg_grays: jax.Array,
    seg_depths: jax.Array,
    cfg: SystemConfig,
    mesh: jax.sharding.Mesh | None = None,
    axis: str = "seq",
) -> jax.Array:
    """Track each (S, L, H, W) segment independently; returns segment-local
    poses (S, L, 4, 4) anchored at identity per segment (segments are
    sequences to ``vo_scan_batched``)."""
    return vo_scan_batched(seg_grays, seg_depths, cfg, mesh=mesh, axis=axis)


@jax.jit
def stitch_segments(seg_poses: jax.Array) -> jax.Array:
    """Compose segment-local trajectories into one global trajectory.

    Segment s's anchor pose is the composition of all previous segments'
    end poses: A_0 = I, A_{s+1} = A_s @ P_s[-1].  Computed as an associative
    scan over 4x4 matrix products (log-depth).  Returns (N, 4, 4) where
    N = S * (L - 1) + 1, dropping each segment's duplicated first frame.
    """
    s, l = seg_poses.shape[0], seg_poses.shape[1]
    ends = seg_poses[:, -1]  # (S, 4, 4)
    prefix = jax.lax.associative_scan(lie.mm, ends, axis=0)  # inclusive
    eye = jnp.broadcast_to(jnp.eye(4, dtype=seg_poses.dtype), (1, 4, 4))
    anchors = jnp.concatenate([eye, prefix[:-1]], axis=0)  # (S, 4, 4)
    glob = lie.mm(anchors[:, None], seg_poses)  # (S, L, 4, 4)
    # Drop duplicated overlap frames: keep segment 0 fully, others from 1.
    first = glob[0]
    rest = glob[1:, 1:].reshape(-1, 4, 4)
    return jnp.concatenate([first, rest], axis=0)


def track_long_sequence(
    grays: jax.Array,
    depths: jax.Array,
    cfg: SystemConfig,
    n_segments: int,
    mesh: jax.sharding.Mesh | None = None,
    refine: bool = False,
) -> jax.Array:
    """End-to-end segment-parallel VO: split -> track (parallel) -> stitch
    (-> optional pose-graph relaxation over consecutive-frame edges)."""
    sg, sd = split_segments(grays, depths, n_segments)
    seg_poses = track_segments(sg, sd, cfg, mesh=mesh)
    return stitch_trajectory(seg_poses, refine=refine)


def stitch_trajectory(seg_poses: jax.Array, refine: bool = False) -> jax.Array:
    """Segment-local poses (S, L, 4, 4) -> one global trajectory, with an
    optional pose-graph relaxation over consecutive-frame edges."""
    poses = stitch_segments(seg_poses)
    if refine:
        n = poses.shape[0]
        i = jnp.arange(n - 1, dtype=jnp.int32)
        edges = PoseGraphEdges(
            i=i,
            j=i + 1,
            T_meas=lie.mm(jnp.linalg.inv(poses[:-1]), poses[1:]),
            weight=jnp.ones(n - 1, jnp.float32),
        )
        poses = optimize_pose_graph(poses, edges, iters=5)
    return poses
