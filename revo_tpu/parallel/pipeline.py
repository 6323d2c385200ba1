"""Stage-parallel (pipeline-parallel) replay over two devices.

The reference's only concurrency is a 3-thread pipeline: an IO/pyramid
-builder thread feeding a tracking thread through a locked queue
(SURVEY.md §1; iowrapperRGBD.cpp:341-352).  This is the device analog
promised in SURVEY.md §2.2 (PP row): the per-frame work splits into a
frame-build stage (pyramid + Canny + back-projection) on one device and a
solve stage (coarse-to-fine GN over the keyframe's DT) on another, with
device-to-device hand-off of the built Frame pytree (NVLink between
cards).  JAX's async dispatch overlaps the stages automatically: while
device B solves frame t, device A is already building frame t+1.

Throughput gain is bounded by max(stage)/sum(stage) vs one device; on a
single chip the split is not profitable (both stages share the chip), so
this path targets multi-chip replay where sequences outnumber devices by
less than 2x — otherwise prefer one whole sequence per device
(parallel.batch.vo_scan_batched).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from revo_tpu import tracker
from revo_tpu.config import SystemConfig
from revo_tpu.frontend import build_frame, make_keyframe


def pipeline_replay(
    grays,
    depths,
    cfg: SystemConfig,
    devices: Optional[Sequence] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Track a preloaded sequence against its first frame's keyframe with
    the build stage on ``devices[0]`` and the solve stage on ``devices[1]``.

    Returns (T_kf_cam (N, 4, 4), errors (N,)).  Frame 0 is the keyframe
    (identity).  Equality with the single-device step is exact (same
    kernels, same order); gated by tests/test_pipeline.py.
    """
    if devices is None:
        devices = jax.devices()
    dev_build = devices[0]
    dev_solve = devices[1] if len(devices) > 1 else devices[0]

    # Placement follows the committed inputs (device_put below), so each
    # stage executes on its own device without jit device arguments.
    build_fn = jax.jit(functools.partial(build_frame, cfg=cfg))
    track_fn = jax.jit(functools.partial(tracker.track_frames, cfg=cfg))

    n = len(grays)
    g0 = jax.device_put(jnp.asarray(grays[0]), dev_solve)
    d0 = jax.device_put(jnp.asarray(depths[0]), dev_solve)
    kf = make_keyframe(build_frame(g0, d0, cfg), jnp.eye(4), cfg)

    R = jax.device_put(jnp.eye(3), dev_solve)
    t = jax.device_put(jnp.zeros(3), dev_solve)

    # Software pipeline: build(i+1) is dispatched on device A before
    # track(i) is dispatched on device B, so the two run concurrently
    # (async dispatch; no blocking between dispatches).
    def build(i):
        g = jax.device_put(jnp.asarray(grays[i]), dev_build)
        d = jax.device_put(jnp.asarray(depths[i]), dev_build)
        return build_fn(g, d)

    poses = [jnp.eye(4)]
    errors = [jnp.float32(0.0)]
    in_flight = build(1) if n > 1 else None
    for i in range(1, n):
        frame_b = jax.device_put(in_flight, dev_solve)  # A -> B hand-off
        if i + 1 < n:
            in_flight = build(i + 1)  # overlaps with the solve below
        res = track_fn(kf, frame_b, R, t)
        R, t = res.R, res.t
        T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
        poses.append(T)
        errors.append(res.error)
    return jnp.stack(poses), jnp.stack(errors)
