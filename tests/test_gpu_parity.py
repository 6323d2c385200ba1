"""The front end on the card against the same jnp code on the CPU backend,
at 640x480: Canny edge maps and the keyframe distance transform.

Marked ``gpu``: skips without a GPU.  Run on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu -n 0 tests/``.
"""
import numpy as np
import pytest


def _rendered(n=2):
    from revo_tpu.config import CameraConfig
    from revo_tpu.io.synthetic import SyntheticScene, render_sequence

    return list(render_sequence(SyntheticScene(), CameraConfig(), n, seed=1))


@pytest.mark.gpu
def test_build_frame_edges_match_cpu(gpu, cpu):
    import jax

    from revo_tpu.config import SystemConfig
    from revo_tpu.frontend import build_frame

    cfg = SystemConfig()
    for gray, depth, _, _ in _rendered():
        out = {}
        for dev in (gpu, cpu):
            with jax.default_device(dev):
                out[dev.platform] = jax.device_get(build_frame(
                    jax.device_put(gray, dev), jax.device_put(depth, dev),
                    cfg,
                ))
        for lg, lc in zip(out["gpu"].levels, out["cpu"].levels):
            # Integer Sobel and fixed-point sector compares: any difference
            # is a real divergence, so the bound is 0.1% of the pixels.
            bound = 1e-3 * lc.edges.size
            assert np.sum(lg.edges_orig != lc.edges_orig) <= bound
            assert np.sum(lg.edges != lc.edges) <= bound


@pytest.mark.gpu
def test_keyframe_structure_matches_cpu(gpu, cpu):
    import jax

    from revo_tpu import ops
    from revo_tpu.config import SystemConfig
    from revo_tpu.frontend import build_frame

    cfg = SystemConfig()
    gray, depth, _, _ = _rendered(1)[0]
    with jax.default_device(cpu):
        frame = jax.device_get(build_frame(gray, depth, cfg))
    for lv in frame.levels:
        s_gpu = jax.device_get(
            ops.keyframe_structure(jax.device_put(lv.edges, gpu))
        )
        with jax.default_device(cpu):
            s_cpu = jax.device_get(ops.keyframe_structure(lv.edges))
        assert np.abs(s_gpu - s_cpu).max() <= 1e-4
