"""Replay-latency gate on the card: the 30 fps real-time envelope of the
per-frame step must hold as a test — p99 per-frame latency < 33 ms at
640x480, fetch-synced (a live consumer reads the pose every frame), against
the reference's 30 fps sensor streams (realsensesensor.cpp:39-41).

Marked ``gpu``: skips without a GPU.  Run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/``.
"""
import functools
import time

import numpy as np
import pytest

FRAME_PERIOD_MS = 1000.0 / 30.0


@pytest.mark.gpu
def test_replay_latency_p99_under_33ms(gpu):
    import jax
    import jax.numpy as jnp

    from revo_tpu import tracker
    from revo_tpu.config import SystemConfig
    from revo_tpu.frontend import build_frame, make_keyframe
    from revo_tpu.io.synthetic import SyntheticScene, render_sequence

    cfg = SystemConfig()
    frames = list(render_sequence(SyntheticScene(), cfg.camera, 8, seed=0))
    g_dev = [jax.device_put(f[0].astype(np.uint8), gpu) for f in frames]
    d_dev = [
        jax.device_put(
            (f[1] * cfg.dataset.depth_scale_factor).astype(np.uint16), gpu
        )
        for f in frames
    ]

    @functools.partial(jax.jit, static_argnames=("c",))
    def vo_step(g, d, kf, R0, t0, c):
        return tracker.track_frames(kf, build_frame(g, d, c), R0, t0, c)

    kf = make_keyframe(build_frame(g_dev[0], d_dev[0], cfg), jnp.eye(4), cfg)
    R = jax.device_put(jnp.eye(3), gpu)
    t = jax.device_put(jnp.zeros(3), gpu)
    res = vo_step(g_dev[1], d_dev[1], kf, R, t, cfg)
    lat = []
    for i in range(-4, 32):  # 4 warm-up frames: compiles stay out of p99
        t0 = time.perf_counter()
        res = vo_step(
            g_dev[1 + i % 7], d_dev[1 + i % 7], kf, res.R, res.t, cfg
        )
        np.asarray(res.R)  # the pose leaves the device every frame
        if i >= 0:
            lat.append((time.perf_counter() - t0) * 1000.0)
    p50, p99 = np.percentile(lat, [50.0, 99.0])
    assert np.isfinite(np.asarray(res.t)).all()
    assert p99 < FRAME_PERIOD_MS, (
        f"replay p99 {p99:.2f} ms breaches the 30 fps envelope "
        f"(p50 {p50:.2f} ms)"
    )
