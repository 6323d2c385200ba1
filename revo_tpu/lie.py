"""Pure-JAX Lie-group operations for SO(3) and SE(3).

Replacement for the Sophus library used by the reference
(/root/reference/thirdparty/Sophus/sophus/so3.hpp, se3.hpp).  The reference's
runtime uses only ``SE3f(R,t)``, ``SE3f::exp`` (se3.hpp:723-767), ``SE3f::log``
(se3.hpp:201-229) and accessors; here we provide the full group API (exp, log,
hat, vee, adjoint, inverse, compose) as jit/vmap-friendly functions over plain
arrays, in float32 by default (float64 works when x64 is enabled).

Tangent-vector convention matches Sophus: ``xi = [upsilon, omega]`` with the
translational part first (se3.hpp:723).  Poses are represented either as a
``(R, t)`` tuple or as a 4x4 homogeneous matrix; helpers convert between them.

All functions are elementwise-safe near the identity (Taylor expansions) and
near the pi-rotation singularity of log.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Pose products ask for full f32 precision explicitly: at default
# precision an accelerator may run an f32 matmul in TF32 (GPU, 10 mantissa
# bits) or bf16, a ~1e-3 relative error on rotations and translations that
# accumulates as drift along a pose chain.  Each product stays ONE einsum
# (one HLO op) rather than an unrolled elementwise form.
_MM_PREC = jax.lax.Precision.HIGHEST


def mm(a, b):
    """(..., n, k) @ (..., k, m) at exact-f32 precision, one HLO op."""
    return jnp.einsum("...ik,...kj->...ij", a, b, precision=_MM_PREC)


def mv(a, v):
    """(..., n, k) @ (..., k) at exact-f32 precision, one HLO op."""
    return jnp.einsum("...ij,...j->...i", a, v, precision=_MM_PREC)


# Small-angle switch point.  For float32, theta^4 < eps means the Taylor
# expansion is exact to machine precision.
_EPS = 1e-8


def hat_so3(omega: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector (so3.hpp ``SO3::hat``)."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee_so3(Omega: jax.Array) -> jax.Array:
    """Inverse of :func:`hat_so3` (so3.hpp ``SO3::vee``)."""
    return jnp.stack(
        [Omega[..., 2, 1], Omega[..., 0, 2], Omega[..., 1, 0]], axis=-1
    )


def exp_so3(omega: jax.Array) -> jax.Array:
    """Rodrigues' formula with Taylor fallback (so3.hpp ``SO3::exp``, :522).

    R = I + sin(t)/t * W + (1-cos(t))/t^2 * W^2,  W = hat(omega), t = |omega|
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < _EPS
    # Guard against 0/0; where() keeps gradients clean.
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta_safe) / theta_safe)
    b = jnp.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - jnp.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    W = hat_so3(omega)
    W2 = mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation-matrix logarithm (so3.hpp ``SO3::log``).

    Stable near the identity (Taylor) and near theta = pi (uses the diagonal
    of R to recover the axis instead of the vanishing skew part).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)

    # Generic branch: omega = theta/(2 sin theta) * vee(R - R^T).
    # theta from atan2(sin, cos) — much better conditioned than arccos for
    # float32 (arccos loses ~sqrt(eps) digits near +-1).
    skew = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = 0.5 * jnp.linalg.norm(skew, axis=-1)
    theta = jnp.arctan2(sin_theta, cos_theta)
    theta_sq = theta * theta
    near_zero = theta_sq < _EPS
    near_pi = (jnp.pi - theta) < 1e-3

    # factor theta / (2 sin theta), Taylor 0.5 + theta^2/12 near 0.
    sin_safe = jnp.where(sin_theta == 0, jnp.ones_like(sin_theta), sin_theta)
    factor = jnp.where(
        near_zero, 0.5 + theta_sq / 12.0, theta / (2.0 * sin_safe)
    )
    omega_generic = factor[..., None] * skew

    # Near pi: axis from the diagonal of R ~= I + (2/theta^2-ish) ww^T - I.
    # R = I + sin t W + (1 - cos t) W^2;  at t=pi: R = I + 2 W^2 = I + 2(ww^T - I)
    # => ww^T = (R + I)/2.  Pick the column with the largest diagonal.
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)
    RI = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    col = jnp.take_along_axis(
        RI, k[..., None, None].repeat(3, axis=-2), axis=-1
    )[..., 0]
    col_norm = jnp.linalg.norm(col, axis=-1, keepdims=True)
    col_safe = col / jnp.where(col_norm == 0, 1.0, col_norm)
    # Fix the sign using the skew part (skew = 2 sin t * w, tiny but signed).
    sign = jnp.where(
        jnp.sum(col_safe * skew, axis=-1, keepdims=True) < 0, -1.0, 1.0
    )
    omega_pi = theta[..., None] * col_safe * sign

    return jnp.where(near_pi[..., None], omega_pi, omega_generic)


def _so3_left_jacobian_terms(omega: jax.Array):
    """Coefficients (b, c) of V = I + b W + c W^2 (se3.hpp:741-766).

    b = (1 - cos t)/t^2,  c = (t - sin t)/t^3.
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < _EPS
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    b = jnp.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - jnp.cos(theta_safe)) / (theta_safe * theta_safe),
    )
    c = jnp.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta_safe - jnp.sin(theta_safe)) / (theta_safe * theta_safe * theta_safe),
    )
    return b, c


def exp_se3(xi: jax.Array):
    """SE(3) exponential map (se3.hpp ``SE3::exp``, :723-767).

    xi = [upsilon, omega]; returns ``(R, t)`` with R = exp_so3(omega),
    t = V @ upsilon, where V is the left Jacobian of SO(3).
    """
    upsilon = xi[..., :3]
    omega = xi[..., 3:]
    R = exp_so3(omega)
    b, c = _so3_left_jacobian_terms(omega)
    W = hat_so3(omega)
    W2 = mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = mv(V, upsilon)
    return R, t


def log_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """SE(3) logarithm (se3.hpp ``SE3::log``, :201-229)."""
    omega = log_so3(R)
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < _EPS
    theta_safe = jnp.where(small, jnp.ones_like(theta), theta)
    half = theta_safe * 0.5
    # V^{-1} = I - 0.5 W + e W^2 with
    # e = (1 - 0.5 t cos(t/2)/sin(t/2)) / t^2, Taylor 1/12 + t^2/720 near 0.
    e = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.sin(half)) / theta_sq,
    )
    W = hat_so3(omega)
    W2 = mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    Vinv = eye - 0.5 * W + e[..., None, None] * W2
    upsilon = mv(Vinv, t)
    return jnp.concatenate([upsilon, omega], axis=-1)


def compose(R1, t1, R2, t2):
    """(R1,t1) * (R2,t2): first apply 2, then 1."""
    return mm(R1, R2), mv(R1, t2) + t1


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -mv(Rt, t)


def transform_points(R, t, pts):
    """Apply (R,t) to points of shape (..., N, 3)."""
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=_MM_PREC) + t[..., None, :]


def adjoint_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    """6x6 adjoint matrix Ad(T) mapping tangent vectors: se3.hpp ``Adj``.

    With the [upsilon, omega] convention:
        Ad = [[R, hat(t) R], [0, R]]
    """
    tR = mm(hat_so3(t), R)
    top = jnp.concatenate([R, tR], axis=-1)
    zeros = jnp.zeros_like(R)
    bottom = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def hat_se3(xi: jax.Array) -> jax.Array:
    """4x4 matrix form of a twist (se3.hpp ``SE3::hat``).

    With xi = [upsilon, omega]: [[hat(omega), upsilon], [0, 0]].
    """
    W = hat_so3(xi[..., 3:])
    top = jnp.concatenate([W, xi[..., :3, None]], axis=-1)
    bottom = jnp.zeros(top.shape[:-2] + (1, 4), dtype=xi.dtype)
    return jnp.concatenate([top, bottom], axis=-2)


def vee_se3(X: jax.Array) -> jax.Array:
    """Inverse of :func:`hat_se3` (se3.hpp ``SE3::vee``)."""
    return jnp.concatenate([X[..., :3, 3], vee_so3(X[..., :3, :3])], axis=-1)


def lie_bracket_so3(a: jax.Array, b: jax.Array) -> jax.Array:
    """so(3) Lie bracket [a, b] = a x b (so3.hpp ``SO3::lieBracket``)."""
    return jnp.cross(a, b)


def lie_bracket_se3(a: jax.Array, b: jax.Array) -> jax.Array:
    """se(3) Lie bracket (se3.hpp ``SE3::lieBracket``):

    [a, b] = [omega_a x ups_b + ups_a x omega_b, omega_a x omega_b]
    (equals vee(hat(a) hat(b) - hat(b) hat(a)), the property the Sophus
    suite checks, tests.hpp lieBracketTest).
    """
    ups_a, om_a = a[..., :3], a[..., 3:]
    ups_b, om_b = b[..., :3], b[..., 3:]
    return jnp.concatenate(
        [jnp.cross(om_a, ups_b) + jnp.cross(ups_a, om_b),
         jnp.cross(om_a, om_b)],
        axis=-1,
    )


def interpolate_se3(Ra, ta, Rb, tb, alpha):
    """Geodesic interpolation foo * exp(alpha * log(foo^-1 * bar))
    (sophus/interpolate.hpp:28-38).  alpha may be batched."""
    Ri, ti = inverse(Ra, ta)
    xi = log_se3(*compose(Ri, ti, Rb, tb))
    dR, dt = exp_se3(jnp.asarray(alpha)[..., None] * xi)
    return compose(Ra, ta, dR, dt)


def average_se3(R: jax.Array, t: jax.Array, iters: int = 20):
    """Iterative bi-invariant mean of a set of poses (sophus/average.hpp
    ``iterativeMean``): X <- X * exp(mean_i log(X^-1 * T_i)), fixed
    iteration count for jit friendliness (Sophus runs max 20).

    R: (N, 3, 3), t: (N, 3).  Returns (R_mean, t_mean).
    """

    def body(_, Xt):
        Rm, tm = Xt
        Ri, ti = inverse(Rm, tm)
        xi = log_se3(*compose(Ri[None], ti[None], R, t)).mean(axis=0)
        dR, dt = exp_se3(xi)
        return compose(Rm, tm, dR, dt)

    return jax.lax.fori_loop(0, iters, body, (R[0], t[0]))


def matrix_from_rt(R: jax.Array, t: jax.Array) -> jax.Array:
    """4x4 homogeneous matrix from (R, t) (system.h transformFromRT :181-187)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def rt_from_matrix(T: jax.Array):
    return T[..., :3, :3], T[..., :3, 3]


def quaternion_from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion (x, y, z, w), TUM pose-file order.

    Mirrors Eigen::Quaternionf(R) as used by the reference pose writer
    (system.cpp:76-80).  Branch-free implementation via the four Shepperd
    candidates, selecting the numerically largest.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions (unnormalized), one per Shepperd branch.
    qw0 = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    qx0 = jnp.stack(
        [1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1
    )
    qy0 = jnp.stack(
        [m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1
    )
    qz0 = jnp.stack(
        [m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1
    )
    cands = jnp.stack([qw0, qx0, qy0, qz0], axis=-2)  # (..., 4, 4)
    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(
        cands, best[..., None, None].repeat(4, axis=-1), axis=-2
    )[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    # Canonical sign: w >= 0 (Eigen does not enforce this, but evaluation is
    # sign-invariant; a fixed sign makes tests deterministic).
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def matrix_from_quaternion(q: jax.Array) -> jax.Array:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = jnp.where(n == 0, jnp.zeros_like(n), 2.0 / n)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )
