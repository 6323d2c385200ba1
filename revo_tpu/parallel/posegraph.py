"""Pose-graph Gauss-Newton optimization, single-device and sharded.

A capability the reference lacks (its ``windowedoptimization`` module is
commented out, CMakeLists.txt:152-153, and ``Optimizer::bundleAdjustment`` is
declared but never defined, optimizer.h:164-165).  Used for loop-closure-free
trajectory refinement, segment stitching, and windowed BA over keyframes.

Formulation: nodes are world poses T_i (world-from-node); an edge (i, j)
carries a measured relative pose M_ij ~ T_i^-1 T_j.  We minimize

    sum_e w_e || log( M_e^-1  T_i(e)^-1 T_j(e) ) ||^2

over left-multiplicative updates T_i <- exp(xi_i) T_i, with node 0 fixed
(gauge).  With E_e = M^-1 Ti^-1 Tj and the small-residual approximation
J_r^-1(log E) ~ I, the edge Jacobians are

    d r / d xi_j = +Ad(T_j^-1),      d r / d xi_i = -Ad(T_j^-1)

The normal equations assemble as (6N, 6N) dense — keyframe graphs are
hundreds of nodes, so a dense Cholesky on device is fast and mesh-friendly.
The sharded variant splits *edges* across a mesh axis and reduces the
(6N, 6N)+(6N,) system with psum — the BASELINE.json config-5 pattern (block
Hessians over collectives).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from revo_tpu import lie


class PoseGraphEdges(NamedTuple):
    """Fixed-shape edge list.  Pad with valid=False lanes for static shapes."""

    i: jax.Array  # (E,) int32 source node
    j: jax.Array  # (E,) int32 target node
    T_meas: jax.Array  # (E, 4, 4) measured T_i^-1 T_j
    weight: jax.Array  # (E,) float32 information weight (0 for padding)


def pose_graph_residuals(
    poses: jax.Array, edges: PoseGraphEdges
) -> jax.Array:
    """Per-edge 6-vector residuals log(M^-1 Ti^-1 Tj); (E, 6)."""
    Ti = poses[edges.i]
    Tj = poses[edges.j]
    E = lie.mm(lie.mm(jnp.linalg.inv(edges.T_meas), jnp.linalg.inv(Ti)), Tj)
    return lie.log_se3(E[..., :3, :3], E[..., :3, 3])


def _assemble(poses: jax.Array, edges: PoseGraphEdges, n: int):
    """Dense (6n, 6n) H and (6n,) b from the edge set (one GN step)."""
    r = pose_graph_residuals(poses, edges)  # (E, 6)
    Tj = poses[edges.j]
    Tj_inv = jnp.linalg.inv(Tj)
    Ad = lie.adjoint_se3(Tj_inv[..., :3, :3], Tj_inv[..., :3, 3])  # (E, 6, 6)
    w = edges.weight[:, None, None]

    # Block contributions: Jj = +Ad, Ji = -Ad.
    AtA = jnp.einsum(
        "eki,ekj->eij", Ad, Ad, precision=jax.lax.Precision.HIGHEST
    ) * w  # (E, 6, 6) = Ad^T Ad
    Atr = jnp.einsum(
        "eki,ek->ei", Ad, r, precision=jax.lax.Precision.HIGHEST
    ) * edges.weight[:, None]  # (E, 6)

    H = jnp.zeros((n, n, 6, 6), poses.dtype)
    b = jnp.zeros((n, 6), poses.dtype)
    H = H.at[edges.j, edges.j].add(AtA)
    H = H.at[edges.i, edges.i].add(AtA)
    H = H.at[edges.i, edges.j].add(-AtA)
    H = H.at[edges.j, edges.i].add(-AtA)
    b = b.at[edges.j].add(-Atr)
    b = b.at[edges.i].add(Atr)
    return H, b


def _solve_and_update(
    poses: jax.Array, H: jax.Array, b: jax.Array, n: int, damping: float
):
    """Fix node 0 (gauge), solve the damped system, retract."""
    Hd = H.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    bd = b.reshape(6 * n)
    # Gauge fixing: pin node 0 by zeroing its rows/cols and setting identity.
    mask = jnp.ones(6 * n).at[:6].set(0.0)
    Hd = Hd * mask[:, None] * mask[None, :]
    # Pinned rows get an identity diagonal (so xi_0 = 0 exactly); free rows
    # get light Tikhonov damping.
    Hd = Hd + jnp.diag(jnp.where(mask > 0, damping, 1.0))
    bd = bd * mask
    xi = jnp.linalg.solve(Hd, bd).reshape(n, 6)
    dR, dt = lie.exp_se3(xi)
    dT = lie.matrix_from_rt(dR, dt)
    return lie.mm(dT, poses)


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(
    poses: jax.Array,
    edges: PoseGraphEdges,
    iters: int = 10,
    damping: float = 1e-6,
) -> jax.Array:
    """GN pose-graph optimization; returns refined (N, 4, 4) poses."""
    n = poses.shape[0]

    def body(_, P):
        H, b = _assemble(P, edges, n)
        return _solve_and_update(P, H, b, n, damping)

    return jax.lax.fori_loop(0, iters, body, poses)


def optimize_pose_graph_sharded(
    poses: jax.Array,
    edges: PoseGraphEdges,
    mesh: jax.sharding.Mesh,
    axis: str = "edge",
    iters: int = 10,
    damping: float = 1e-6,
) -> jax.Array:
    """Distributed GN: edges sharded over ``axis``; per-shard block normal
    equations reduced with psum, replicated solve (BASELINE.json config 5).

    ``edges`` arrays must be shardable (E divisible by the mesh axis size;
    pad with weight-0 lanes).  Poses are replicated.
    """
    from jax.sharding import PartitionSpec as P

    n = poses.shape[0]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
    )
    def run(poses_rep, ei, ej, em, ew):
        local = PoseGraphEdges(i=ei, j=ej, T_meas=em, weight=ew)

        def body(_, Pcur):
            H, b = _assemble(Pcur, local, n)
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)
            return _solve_and_update(Pcur, H, b, n, damping)

        return jax.lax.fori_loop(0, iters, body, poses_rep)

    return run(poses, edges.i, edges.j, edges.T_meas, edges.weight)


def trajectory_to_edges(
    poses: jax.Array, noise_free: bool = True
) -> PoseGraphEdges:
    """Consecutive-frame odometry edges from a trajectory (testing helper)."""
    n = poses.shape[0]
    i = jnp.arange(n - 1, dtype=jnp.int32)
    j = i + 1
    T_meas = lie.mm(jnp.linalg.inv(poses[:-1]), poses[1:])
    return PoseGraphEdges(
        i=i, j=j, T_meas=T_meas, weight=jnp.ones(n - 1, jnp.float32)
    )
