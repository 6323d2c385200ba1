"""Tests: point-sharded normal equations (the LGSX reduction over a mesh)."""
import jax
import jax.numpy as jnp
import numpy as np

from revo_tpu import ops, solver

from test_solver import CAM, _wireframe_points, _rasterize_edges, _cloud_from_points


def _setup():
    pts = _wireframe_points()
    edges = _rasterize_edges(pts, CAM)
    struct = ops.keyframe_structure(jnp.asarray(edges))
    cloud = _cloud_from_points(pts, capacity=1024)
    return struct, cloud


class TestPointSharded:
    def test_matches_single_device(self):
        struct, cloud = _setup()
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("pt",))
        a = solver.residual_system(
            struct, cloud, CAM, jnp.eye(3), jnp.zeros(3), 30.0, 0.3, True
        )
        b = solver.residual_system_point_sharded(
            struct, cloud, CAM, jnp.eye(3), jnp.zeros(3), 30.0, 0.3, True,
            mesh=mesh,
        )
        np.testing.assert_allclose(
            np.asarray(a.A), np.asarray(b.A), rtol=1e-4, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(a.g), np.asarray(b.g), rtol=1e-4, atol=1e-6
        )
        assert int(a.info.good) == int(b.info.good)
        assert int(a.info.bad) == int(b.info.bad)
