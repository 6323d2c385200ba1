"""Exact Euclidean distance transform, fused with the gradient structure.

Replacement for cv::distanceTransform(255-edges, CV_DIST_L2,
CV_DIST_MASK_PRECISE) + ImgPyramidRGBD::buildOptimizationStructure
(imgpyramidrgbd.cpp:241,255-276).  The keyframe "optimization structure" is
an (H, W, 3) tensor with channels (gx, gy, dt) where

    gx = 0.5 * (dt[y, x-1] - dt[y, x+1])   # NOTE: negated central difference,
    gy = 0.5 * (dt[y-1, x] - dt[y+1, x])   # exactly as the reference computes
    dt = Euclidean distance to nearest edge pixel.

(The reference's sign convention is the negative gradient; the GN solver's
update sign compensates — see optimizer.cpp:258 `b = -ls.b`.)

Algorithm (exact, banded, elementwise — no sequential lower-envelope stack):

1. Column pass: per-column nearest-edge distance via log-doubling min-plus
   relaxations.  O(H*W*log H).
2. Chamfer bound pass: B(x) = min_j (|x-j| + g(j)) along rows, the same
   doubling trick with a linear kernel.  B(x) >= D(x) (triangle inequality),
   so the winning source for x lies within |x-i| <= max(B).  O(H*W*log W).
3. Row pass: exact 1-D squared EDT per row, D(x) = min_i ((x-i)^2 + g(i)^2),
   evaluated only over the offset band |x-i| <= R = ceil(max B) via a
   lax.while_loop over offset chunks.  Typical Canny keyframes have
   R ~ 30-120 at 640x480, a 3-10x cut vs the previous dense O(H*W*W) sweep
   (VERDICT round-1 item 4); worst case (nearly edge-free image) degrades
   to 2x the dense sweep.  Batched inputs share ONE scalar R (max across
   the batch) so the while_loop slices stay unbatched — vmap routes here
   through a custom_vmap rule.

This matches the exact EDT (and cv's MASK_PRECISE) to float tolerance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 1e9


def _column_distances(edges: jax.Array) -> jax.Array:
    """Per-pixel vertical distance to the nearest edge in the same column.

    Log-depth doubling instead of a sequential row scan: after step k,
    d[y] = min distance to an edge within the last 2^k rows, via
    d <- min(d, shift_down(d, s) + s) with s doubling.  ceil(log2 H)
    fully-vectorized passes per direction replace a 2x H-step lax.scan
    whose per-iteration latency would dominate keyframe cost.  Exact: any vertical displacement decomposes into a subset
    of the doubling shifts in one direction, and no shift path
    undercounts.  Works on (..., H, W); _BIG where a column has no edge.
    """
    h = edges.shape[-2]
    e = edges.astype(jnp.bool_)
    init = jnp.where(e, 0.0, jnp.float32(_BIG))
    nd = init.ndim

    def direction(d, down: bool):
        s = 1
        while s < h:
            pw = [(0, 0)] * nd
            if down:  # shifted[y] = d[y - s]
                pw[-2] = (s, 0)
                shifted = jnp.pad(d, pw, constant_values=_BIG)[..., :-s, :]
            else:  # shifted[y] = d[y + s]
                pw[-2] = (0, s)
                shifted = jnp.pad(d, pw, constant_values=_BIG)[..., s:, :]
            d = jnp.minimum(d, shifted + s)
            s *= 2
        return d

    return jnp.minimum(direction(init, True), direction(init, False))


def _row_linear_bound(g: jax.Array) -> jax.Array:
    """Exact B = min_j (|x-j| + g(..., j)) along the last axis (doubling).

    Both shift directions are relaxed per doubling step; exactness holds
    because the one-direction binary-decomposition path always exists and
    mixed-direction paths only overcount (|net shift| <= sum of shifts).
    """
    w = g.shape[-1]
    nd = g.ndim
    d = g
    s = 1
    while s < w:
        pw_l = [(0, 0)] * nd
        pw_l[-1] = (s, 0)
        left = jnp.pad(d, pw_l, constant_values=_BIG)[..., :-s]
        pw_r = [(0, 0)] * nd
        pw_r[-1] = (0, s)
        right = jnp.pad(d, pw_r, constant_values=_BIG)[..., s:]
        d = jnp.minimum(d, jnp.minimum(left, right) + s)
        s *= 2
    return d


def _row_edt_sq_banded(gsq: jax.Array, r: jax.Array, chunk: int = 64) -> jax.Array:
    """Exact 1-D squared EDT along rows restricted to the offset band |x-i|<=R.

    gsq: (N, W) independent rows.  r: scalar int32 band radius (any winning
    source satisfies |x-i| <= r; caller guarantees this via the chamfer
    bound).  while_loop over offset chunks; chunk c covers offsets
    [c*chunk+1, (c+1)*chunk] on both sides via two traced-start
    dynamic_slices + static sub-slices, so the loop body is pure
    shift+add+min elementwise work with no gathers.
    """
    n, w = gsq.shape
    npad = w + chunk
    padded = jnp.pad(gsq, ((0, 0), (npad, npad)), constant_values=_BIG)
    offs = jnp.arange(chunk, dtype=jnp.int32)

    def cond(state):
        c, _ = state
        return c * chunk < r

    def body(state):
        c, acc = state
        base = c * chunk + 1
        off2 = ((base + offs) * (base + offs)).astype(jnp.float32)
        # left sources i = x - o: cand_k[x] = padded[npad + x - base - k]
        seg_l = jax.lax.dynamic_slice(
            padded, (0, npad - base - (chunk - 1)), (n, w + chunk - 1)
        )
        # right sources i = x + o: cand_k[x] = padded[npad + x + base + k]
        seg_r = jax.lax.dynamic_slice(padded, (0, npad + base), (n, w + chunk - 1))
        for k in range(chunk):
            o2 = off2[k]
            acc = jnp.minimum(acc, seg_l[:, chunk - 1 - k : chunk - 1 - k + w] + o2)
            acc = jnp.minimum(acc, seg_r[:, k : k + w] + o2)
        return c + 1, acc

    # Carry inits derived from the input so varying axes match under shard_map.
    c0 = (gsq[0, 0] * 0).astype(jnp.int32)
    _, acc = jax.lax.while_loop(cond, body, (c0, gsq))
    return acc


def _distance_transform_batched(edges: jax.Array) -> jax.Array:
    """(B, H, W) exact EDT sharing one band radius across the batch."""
    b, h, w = edges.shape
    g = _column_distances(edges)
    bound = jnp.minimum(_row_linear_bound(g), _BIG)
    r = jnp.minimum(jnp.ceil(bound.max()), w).astype(jnp.int32)
    gsq = jnp.minimum(g * g, _BIG)
    dsq = _row_edt_sq_banded(gsq.reshape(b * h, w), r)
    return jnp.sqrt(dsq).reshape(b, h, w)


@jax.custom_batching.custom_vmap
def distance_transform(edges: jax.Array) -> jax.Array:
    """Exact Euclidean distance (float32, (H, W)) to the nearest edge pixel.

    Matches cv::distanceTransform(255-edges, DIST_L2, DIST_MASK_PRECISE)
    (imgpyramidrgbd.cpp:241) to float precision; distance is 0 on edges.
    If the image has no edges at all, returns sqrt(_BIG)-scale values.
    """
    return _distance_transform_batched(edges[None])[0]


@distance_transform.def_vmap
def _distance_transform_vmap(axis_size, in_batched, edges):
    if not in_batched[0]:
        edges = jnp.broadcast_to(edges, (axis_size,) + edges.shape)
    return _distance_transform_batched(edges), True


def build_optimization_structure(dt: jax.Array) -> jax.Array:
    """(H, W) distance transform -> (H, W, 3) tensor (gx, gy, dt).

    Mirrors buildOptimizationStructure (imgpyramidrgbd.cpp:255-276): negated
    central differences; border rows/cols use clamped neighbors (the
    reference leaves the first/last row undefined and excludes a 2-px border
    in the solver, so borders never contribute).
    """
    left = jnp.pad(dt, ((0, 0), (1, 0)), mode="edge")[:, :-1]
    right = jnp.pad(dt, ((0, 0), (0, 1)), mode="edge")[:, 1:]
    up = jnp.pad(dt, ((1, 0), (0, 0)), mode="edge")[:-1, :]
    down = jnp.pad(dt, ((0, 1), (0, 0)), mode="edge")[1:, :]
    gx = 0.5 * (left - right)
    gy = 0.5 * (up - down)
    return jnp.stack([gx, gy, dt], axis=-1)


def keyframe_structure(edges: jax.Array) -> jax.Array:
    """Fused DT + gradients: the per-level keyframe tensor (makeKeyframe,
    imgpyramidrgbd.cpp:231-252)."""
    return build_optimization_structure(distance_transform(edges))


def quad_structure(struct: jax.Array, form: str = "hw12") -> jax.Array:
    """(H, W, 3) structure -> packed 2x2-neighborhood quad table for
    1-gather bilinear sampling.

    Q[y, x] = concat(S[y, x], S[y, x+1], S[y+1, x], S[y+1, x+1]) — the full
    2x2 bilinear neighborhood packed contiguously, so the solver's sample
    needs ONE row gather per pass instead of four (a gather's cost is
    largely per index, not per byte).
    Built once per keyframe level.  The last row/column are edge-padded;
    they are unreachable because sample coords are clipped to (w-2, h-2).

    ``form`` picks the storage layout (OptimizerConfig.quad_form): "hw12" = (H, W, 12),
    "flat" = (H*W, 12), "t" = (12, H*W), "flat16" = (H*W, 16) with each
    tap padded to 4 lanes (64-byte aligned rows), "flatbf" = (H*W, 12)
    bfloat16 (half the row bytes; samples upcast after the gather).

    "dt4" / "dt4bf" = (H*W, 4) dt-only taps (f32 / bf16): the solver
    derives the Jacobian gradient from the bilinear dt surface itself
    (interp.bilinear_sample_dtquad) instead of the interpolated central
    differences, cutting the gathered row to 16 / 8 bytes.  Residuals are
    bit-identical to the 12-component forms; only the gradient source
    differs (ATE-parity gated, tests/test_solver_modes.py).
    """
    if form in ("dt4", "dt4bf"):
        struct = struct[..., 2:3]  # dt channel only
    right = jnp.pad(struct, ((0, 0), (0, 1), (0, 0)), mode="edge")[:, 1:]
    down = jnp.pad(struct, ((0, 1), (0, 0), (0, 0)), mode="edge")[1:]
    downright = jnp.pad(down, ((0, 0), (0, 1), (0, 0)), mode="edge")[:, 1:]
    taps = [struct, right, down, downright]
    if form == "flat16":
        pad = jnp.zeros_like(struct[..., :1])
        taps = [jnp.concatenate([tp, pad], axis=-1) for tp in taps]
    q = jnp.concatenate(taps, axis=-1)
    if form in ("flatbf", "dt4bf"):
        q = q.astype(jnp.bfloat16)
    if form == "hw12":
        return q
    flat = q.reshape(-1, q.shape[-1])
    if form in ("flat", "flat16", "flatbf", "dt4", "dt4bf"):
        return flat
    if form == "t":
        return flat.T
    raise ValueError(f"unknown quad form: {form!r}")
