"""Property tests for revo_tpu.lie, mirroring the Sophus Lie-group test
harness design (reference: thirdparty/Sophus/test/core/tests.hpp:40-417,
instantiated with curated tangent vectors in test/core/test_se3.cpp:19-41)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from revo_tpu import lie

# Curated tangent vectors in the spirit of test_se3.cpp:19-41: identity,
# small, generic, and near-pi rotations.
SE3_TANGENTS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [1e-9, 2e-9, -1e-9, 1e-10, -1e-10, 2e-10],
        [0.1, -0.2, 0.3, 0.01, 0.02, -0.03],
        [1.0, 2.0, -1.0, 0.5, -0.7, 0.1],
        [-0.2, 0.1, 4.0, 0.0, 0.0, 3.1],  # near-pi about z
        [0.3, 0.5, 0.1, 3.14159, 0.0, 0.0],  # ~pi about x
        [0.0, 0.0, 0.5, 2.0, 1.0, -1.5],
    ],
    dtype=np.float32,
)


def _random_tangents(n=64, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= 0.9  # keep |omega| < pi
    return xi


ALL_TANGENTS = np.concatenate([SE3_TANGENTS, _random_tangents()])


class TestSO3:
    def test_exp_is_rotation(self):
        R = lie.exp_so3(jnp.asarray(ALL_TANGENTS[:, 3:]))
        RtR = np.einsum("nij,nkj->nik", np.asarray(R), np.asarray(R))
        np.testing.assert_allclose(
            RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5
        )
        det = np.linalg.det(np.asarray(R))
        np.testing.assert_allclose(det, 1.0, atol=1e-5)

    def test_exp_log_roundtrip(self):
        """tests.hpp expLogTest."""
        omega = jnp.asarray(ALL_TANGENTS[:, 3:])
        R = lie.exp_so3(omega)
        omega2 = lie.log_so3(R)
        R2 = lie.exp_so3(omega2)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-4)

    def test_log_near_pi(self):
        axis = np.array([1.0, 2.0, -0.5])
        axis = axis / np.linalg.norm(axis)
        for theta in [np.pi - 1e-4, np.pi - 1e-6]:
            omega = (theta * axis).astype(np.float32)
            R = lie.exp_so3(jnp.asarray(omega))
            back = np.asarray(lie.log_so3(R))
            R2 = np.asarray(lie.exp_so3(jnp.asarray(back)))
            np.testing.assert_allclose(np.asarray(R), R2, atol=2e-3)

    def test_hat_vee(self):
        """tests.hpp veeHatTest."""
        omega = jnp.asarray(ALL_TANGENTS[:, 3:])
        np.testing.assert_allclose(
            np.asarray(lie.vee_so3(lie.hat_so3(omega))), np.asarray(omega),
            atol=1e-7,
        )

    def test_hat_action(self):
        """hat(w) @ v == cross(w, v)."""
        rng = np.random.default_rng(1)
        w = rng.normal(size=(10, 3)).astype(np.float32)
        v = rng.normal(size=(10, 3)).astype(np.float32)
        got = np.einsum("nij,nj->ni", np.asarray(lie.hat_so3(jnp.asarray(w))), v)
        np.testing.assert_allclose(got, np.cross(w, v), atol=1e-5)


class TestSE3:
    def test_exp_log_roundtrip(self):
        xi = jnp.asarray(ALL_TANGENTS)
        R, t = lie.exp_se3(xi)
        xi2 = lie.log_se3(R, t)
        R2, t2 = lie.exp_se3(xi2)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t2), atol=1e-4)

    def test_group_action(self):
        """tests.hpp groupActionTest: T(p) == matrix @ p."""
        xi = jnp.asarray(SE3_TANGENTS)
        R, t = lie.exp_se3(xi)
        pts = jnp.asarray(
            np.random.default_rng(2).normal(size=(7, 5, 3)).astype(np.float32)
        )
        got = lie.transform_points(R, t, pts)
        T = np.asarray(lie.matrix_from_rt(R, t))
        ph = np.concatenate(
            [np.asarray(pts), np.ones((7, 5, 1), np.float32)], axis=-1
        )
        want = np.einsum("nij,npj->npi", T, ph)[..., :3]
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)

    def test_compose_inverse(self):
        xi = jnp.asarray(SE3_TANGENTS)
        R, t = lie.exp_se3(xi)
        Ri, ti = lie.inverse(R, t)
        Re, te = lie.compose(R, t, Ri, ti)
        np.testing.assert_allclose(
            np.asarray(Re), np.broadcast_to(np.eye(3), Re.shape), atol=1e-5
        )
        np.testing.assert_allclose(np.asarray(te), 0.0, atol=1e-5)

    def test_adjoint(self):
        """tests.hpp adjointTest: exp(Ad_T xi) == T exp(xi) T^-1."""
        xi_T = jnp.asarray(SE3_TANGENTS[3])
        RT, tT = lie.exp_se3(xi_T)
        Ad = lie.adjoint_se3(RT, tT)
        for xi_np in _random_tangents(8, seed=3) * 0.1:
            xi = jnp.asarray(xi_np)
            lhsR, lhst = lie.exp_se3(Ad @ xi)
            Rx, tx = lie.exp_se3(xi)
            Ri, ti = lie.inverse(RT, tT)
            m1R, m1t = lie.compose(RT, tT, Rx, tx)
            rhsR, rhst = lie.compose(m1R, m1t, Ri, ti)
            np.testing.assert_allclose(
                np.asarray(lhsR), np.asarray(rhsR), atol=1e-4
            )
            np.testing.assert_allclose(
                np.asarray(lhst), np.asarray(rhst), atol=1e-4
            )

    def test_matrix_roundtrip(self):
        xi = jnp.asarray(SE3_TANGENTS)
        R, t = lie.exp_se3(xi)
        T = lie.matrix_from_rt(R, t)
        R2, t2 = lie.rt_from_matrix(T)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2))
        np.testing.assert_allclose(np.asarray(t), np.asarray(t2))
        assert np.allclose(np.asarray(T)[:, 3], [0, 0, 0, 1])

    def test_jit_vmap(self):
        """All ops must be jittable and vmappable (device-first requirement)."""
        xi = jnp.asarray(ALL_TANGENTS)
        f = jax.jit(jax.vmap(lambda x: lie.log_se3(*lie.exp_se3(x))))
        out = f(xi)
        assert out.shape == xi.shape
        assert np.isfinite(np.asarray(out)).all()


class TestLieBracket:
    """tests.hpp lieBracketTest (:40-417) for so(3) and se(3)."""

    def test_so3_bracket_is_hat_commutator(self):
        for a_np in _random_tangents(8, seed=4)[:, 3:]:
            for b_np in _random_tangents(3, seed=5)[:, 3:]:
                a, b = jnp.asarray(a_np), jnp.asarray(b_np)
                got = lie.lie_bracket_so3(a, b)
                ha, hb = lie.hat_so3(a), lie.hat_so3(b)
                want = lie.vee_so3(ha @ hb - hb @ ha)
                np.testing.assert_allclose(
                    np.asarray(got), np.asarray(want), atol=1e-5
                )

    def test_se3_bracket_is_hat_commutator(self):
        for a_np in _random_tangents(8, seed=6):
            for b_np in _random_tangents(3, seed=7):
                a, b = jnp.asarray(a_np), jnp.asarray(b_np)
                got = lie.lie_bracket_se3(a, b)
                ha, hb = lie.hat_se3(a), lie.hat_se3(b)
                want = lie.vee_se3(ha @ hb - hb @ ha)
                np.testing.assert_allclose(
                    np.asarray(got), np.asarray(want), atol=1e-5
                )

    def test_se3_hat_vee_roundtrip(self):
        xi = jnp.asarray(ALL_TANGENTS)
        np.testing.assert_allclose(
            np.asarray(lie.vee_se3(lie.hat_se3(xi))), ALL_TANGENTS, atol=1e-7
        )

    def test_antisymmetry_and_jacobi(self):
        a, b, c = (jnp.asarray(x) for x in _random_tangents(3, seed=8))
        ab = lie.lie_bracket_se3(a, b)
        ba = lie.lie_bracket_se3(b, a)
        np.testing.assert_allclose(np.asarray(ab), -np.asarray(ba), atol=1e-6)
        jacobi = (
            np.asarray(lie.lie_bracket_se3(a, lie.lie_bracket_se3(b, c)))
            + np.asarray(lie.lie_bracket_se3(b, lie.lie_bracket_se3(c, a)))
            + np.asarray(lie.lie_bracket_se3(c, lie.lie_bracket_se3(a, b)))
        )
        np.testing.assert_allclose(jacobi, 0.0, atol=1e-5)

    def test_adjoint_differential(self):
        """d/dt Ad(exp(t a)) b |_0 = [a, b] — the derivative form Sophus's
        lieBracketTest exercises (finite difference here)."""
        a, b = (jnp.asarray(x * 0.5) for x in _random_tangents(2, seed=9))
        eps = 1e-3
        Rp, tp = lie.exp_se3(eps * a)
        Rm, tm = lie.exp_se3(-eps * a)
        fd = (lie.adjoint_se3(Rp, tp) @ b - lie.adjoint_se3(Rm, tm) @ b) / (
            2 * eps
        )
        np.testing.assert_allclose(
            np.asarray(fd), np.asarray(lie.lie_bracket_se3(a, b)), atol=5e-3
        )


class TestInterpolateAndMean:
    """tests.hpp interpolateAndMeanTest via sophus/interpolate.hpp and
    sophus/average.hpp semantics."""

    def test_interpolate_endpoints(self):
        Ra, ta = lie.exp_se3(jnp.asarray(SE3_TANGENTS[3]))
        Rb, tb = lie.exp_se3(jnp.asarray(SE3_TANGENTS[6]))
        for alpha, (Rw, tw) in [(0.0, (Ra, ta)), (1.0, (Rb, tb))]:
            Rg, tg = lie.interpolate_se3(Ra, ta, Rb, tb, alpha)
            np.testing.assert_allclose(
                np.asarray(Rg), np.asarray(Rw), atol=1e-5
            )
            np.testing.assert_allclose(
                np.asarray(tg), np.asarray(tw), atol=1e-5
            )

    def test_interpolate_is_geodesic(self):
        """log(a^-1 interp(a,b,alpha)) == alpha * log(a^-1 b)."""
        Ra, ta = lie.exp_se3(jnp.asarray(SE3_TANGENTS[2]))
        Rb, tb = lie.exp_se3(jnp.asarray(SE3_TANGENTS[3]))
        Ri, ti = lie.inverse(Ra, ta)
        full = np.asarray(lie.log_se3(*lie.compose(Ri, ti, Rb, tb)))
        for alpha in [0.25, 0.5, 0.75]:
            Rg, tg = lie.interpolate_se3(Ra, ta, Rb, tb, alpha)
            part = np.asarray(lie.log_se3(*lie.compose(Ri, ti, Rg, tg)))
            np.testing.assert_allclose(part, alpha * full, atol=1e-5)

    def test_interpolate_left_equivariance(self):
        """interp(g a, g b, alpha) == g interp(a, b, alpha)."""
        Rg, tg = lie.exp_se3(jnp.asarray(SE3_TANGENTS[4]))
        Ra, ta = lie.exp_se3(jnp.asarray(SE3_TANGENTS[2]))
        Rb, tb = lie.exp_se3(jnp.asarray(SE3_TANGENTS[3]))
        lhs = lie.interpolate_se3(
            *lie.compose(Rg, tg, Ra, ta), *lie.compose(Rg, tg, Rb, tb), 0.3
        )
        rhs = lie.compose(Rg, tg, *lie.interpolate_se3(Ra, ta, Rb, tb, 0.3))
        np.testing.assert_allclose(
            np.asarray(lhs[0]), np.asarray(rhs[0]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(lhs[1]), np.asarray(rhs[1]), atol=1e-5
        )

    def test_mean_fixed_point(self):
        """The iterative mean M satisfies sum_i log(M^-1 T_i) == 0
        (average.hpp's defining property)."""
        rng = np.random.default_rng(10)
        base = lie.exp_se3(jnp.asarray(SE3_TANGENTS[3]))
        xi = jnp.asarray(rng.normal(scale=0.1, size=(12, 6)), jnp.float32)
        dR, dt = lie.exp_se3(xi)
        R, t = lie.compose(base[0][None], base[1][None], dR, dt)
        Rm, tm = lie.average_se3(R, t)
        Ri, ti = lie.inverse(Rm, tm)
        logs = np.asarray(lie.log_se3(*lie.compose(Ri[None], ti[None], R, t)))
        np.testing.assert_allclose(logs.mean(axis=0), 0.0, atol=1e-5)

    def test_mean_of_identical_poses(self):
        R, t = lie.exp_se3(jnp.asarray(SE3_TANGENTS[3]))
        Rs = jnp.broadcast_to(R, (5, 3, 3))
        ts = jnp.broadcast_to(t, (5, 3))
        Rm, tm = lie.average_se3(Rs, ts)
        np.testing.assert_allclose(np.asarray(Rm), np.asarray(R), atol=1e-6)
        np.testing.assert_allclose(np.asarray(tm), np.asarray(t), atol=1e-6)


@pytest.fixture
def x64():
    """Scoped f64 (this jax has no jax.experimental.enable_x64)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


class TestFloat64:
    """f64 pass over the suite's core identities (Sophus instantiates the
    test harness per scalar type, test_se3.cpp)."""

    def test_exp_log_roundtrip_f64(self, x64):
        xi = jnp.asarray(ALL_TANGENTS, jnp.float64)
        R, t = lie.exp_se3(xi)
        xi2 = lie.log_se3(R, t)
        R2, t2 = lie.exp_se3(xi2)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-12)
        np.testing.assert_allclose(np.asarray(t), np.asarray(t2), atol=1e-12)

    def test_bracket_and_adjoint_f64(self, x64):
        a, b = (
            jnp.asarray(x, jnp.float64) for x in _random_tangents(2, seed=11)
        )
        ha, hb = lie.hat_se3(a), lie.hat_se3(b)
        np.testing.assert_allclose(
            np.asarray(lie.lie_bracket_se3(a, b)),
            np.asarray(lie.vee_se3(ha @ hb - hb @ ha)),
            atol=1e-14,
        )


class TestQuaternion:
    def test_matrix_quaternion_roundtrip(self):
        omega = jnp.asarray(ALL_TANGENTS[:, 3:])
        R = lie.exp_so3(omega)
        q = lie.quaternion_from_matrix(R)
        R2 = lie.matrix_from_quaternion(q)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-4)

    def test_unit_norm(self):
        R = lie.exp_so3(jnp.asarray(ALL_TANGENTS[:, 3:]))
        q = np.asarray(lie.quaternion_from_matrix(R))
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)

    def test_against_scipy_convention(self):
        """x,y,z,w ordering matches the TUM pose-file convention."""
        # 90 degrees about z: q = (0, 0, sin45, cos45)
        R = lie.exp_so3(jnp.asarray([0.0, 0.0, np.pi / 2], dtype=jnp.float32))
        q = np.asarray(lie.quaternion_from_matrix(R))
        np.testing.assert_allclose(
            q, [0.0, 0.0, np.sqrt(0.5), np.sqrt(0.5)], atol=1e-6
        )
