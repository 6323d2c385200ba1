"""Bilinear multi-channel sampling at float coordinates.

Replaces Optimizer::getInterpolatedElement43 (optimizer.h:173-185): sample an
(H, W, C) tensor at (u, v) with weights computed from the fractional parts,
using the reference's exact 4-tap formula.  Coordinates are truncated (C-style
int cast) like the reference; callers guarantee in-bounds coordinates
(1 < u < W-2, 1 < v < H-2 — optimizer.cpp:100), out-of-bounds lanes must be
masked by the caller (indices are clamped here only to stay memory-safe).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_sample(img: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Sample (H, W, C) ``img`` at float pixel coords (u, v) of shape (N,).

    Returns (N, C).  Weighting matches optimizer.h:173-185:
        out = dxdy*I[iy+1,ix+1] + (dy-dxdy)*I[iy+1,ix]
            + (dx-dxdy)*I[iy,ix+1] + (1-dx-dy+dxdy)*I[iy,ix]
    """
    h, w = img.shape[0], img.shape[1]
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = u - ix.astype(u.dtype)
    dy = v - iy.astype(v.dtype)
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)

    flat = img.reshape(h * w, -1)
    base = iy * w + ix
    i00 = jnp.take(flat, base, axis=0)
    i01 = jnp.take(flat, base + 1, axis=0)
    i10 = jnp.take(flat, base + w, axis=0)
    i11 = jnp.take(flat, base + w + 1, axis=0)

    dxdy = (dx * dy)[:, None]
    dxe = dx[:, None]
    dye = dy[:, None]
    return (
        dxdy * i11
        + (dye - dxdy) * i10
        + (dxe - dxdy) * i01
        + (1.0 - dxe - dye + dxdy) * i00
    )


def bilinear_sample_quad(
    quad: jax.Array,
    u: jax.Array,
    v: jax.Array,
    h: int | None = None,
    w: int | None = None,
    batched_take: str = "take",
) -> jax.Array:
    """bilinear_sample against a packed 2x2-neighborhood quad table
    (ops.edt.quad_structure): ONE row take fetches the whole 2x2xC
    neighborhood in one index instead of four.

    The table form is inferred from the shape (the storage layout is a
    knob, see OptimizerConfig.quad_form):
      - (H, W, 4*C): 3-D table, reshaped to rows here.
      - (H*W, 4*C): pre-flattened rows ("flat"; needs h, w).
      - (4*C, H*W): transposed ("t"; needs h, w) — the minormost-index
        layout a batched gather may otherwise copy into.
    Bit-identical weights/formula to bilinear_sample.
    """
    if quad.ndim == 3:
        h, w = quad.shape[0], quad.shape[1]
        flat = quad.reshape(h * w, quad.shape[2])
        transposed = False
    elif quad.shape[0] < quad.shape[1]:  # (4*C, H*W)
        flat = quad
        transposed = True
    else:  # (H*W, 4*C)
        flat = quad
        transposed = False
    c = (flat.shape[1] if not transposed else flat.shape[0]) // 4
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    base = iy * w + ix
    if transposed:
        q = jnp.take(flat, base, axis=1).T  # (N, 4*C)
    else:
        # Under vmap the plain take becomes a batch-dim gather; the
        # lane-folded custom_vmap forms above restore the 2-D form.
        q = _QUAD_TAKES[batched_take](flat, base)  # (N, 4*C)
    if q.dtype != u.dtype:
        q = q.astype(u.dtype)  # "flatbf" bf16 storage upcasts post-gather
    i00 = q[:, 0 * c : 1 * c]
    i01 = q[:, 1 * c : 2 * c]
    i10 = q[:, 2 * c : 3 * c]
    i11 = q[:, 3 * c : 4 * c]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )


def bilinear_sample_dtquad(
    quad: jax.Array,
    u: jax.Array,
    v: jax.Array,
    h: int,
    w: int,
    batched_take: str = "take",
    lane: jax.Array | None = None,
) -> jax.Array:
    """(gx, gy, dt) sampling from a dt-only (H*W, 4) quad table
    (ops.edt.quad_structure forms "dt4"/"dt4bf").

    The dt value is the same bilinear formula as bilinear_sample (bit-
    identical residuals); the gradients are the analytic derivatives of
    that bilinear surface, negated to the keyframe-structure sign
    convention (imgpyramidrgbd.cpp:267-274 stores negated central
    differences):

        gx = -(d dt_s / du) = -(dy (i11-i10) + (1-dy)(i01-i00))
        gy = -(d dt_s / dv) = -(dx (i11-i01) + (1-dx)(i10-i00))

    This is the exact Gauss-Newton linearization of the sampled
    interpolant (the reference instead interpolates precomputed central
    differences — a smoother, 4x4-support gradient); the gathered row
    shrinks from 12 to 4 components.  ATE-parity gated.

    ``lane`` (pre-folded mode): ``quad`` is a SHARED pre-folded table
    holding all B sequences' rows, in one of two layouts inferred from
    ``quad.shape[0]`` (set by OptimizerConfig.lane_select at the fold
    site, solver.gn_level_fixed): "onehot" = (H*W, B*4) lane-minor wide
    rows — the take fetches the full (1, B*4) row (a single-index 2-D
    gather — the same gather the _take_rows_lanefold vmap rule emits)
    and an exact one-hot select keeps this lane's 4 components; "flat" =
    (H*W*B, 4) lane-major — the lane rides the gather index (row =
    base*B + lane), no select at all.  The point of either: the FOLD
    happened in the caller, outside any while_loop — the in-rule fold is
    re-materialized as a layout copy in EVERY solver iteration, growing
    superlinearly with B.  See
    solver.gn_level_fixed's hoisted batching rule.
    """
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    base = iy * w + ix
    if lane is not None:
        if quad.shape[0] != h * w:
            # Flat lane-major fold (H*W*B, 4): the lane rides the gather
            # index (row = base*B + lane), so each point fetches exactly
            # its own 4 components — no wide row, no select intermediate
            # (OptimizerConfig.lane_select="flat").
            if quad.shape[0] % (h * w) != 0:
                raise ValueError(
                    f"lane-folded quad table rows {quad.shape[0]} not a "
                    f"multiple of h*w={h * w}: wrong table for this level"
                )
            nb = quad.shape[0] // (h * w)
            q = _take_rows(quad, base * nb + lane)
        else:
            rows = _take_rows(quad, base)  # (N, B*4): shared pre-folded tab
            nb = quad.shape[1] // 4
            sel = (
                jnp.arange(nb, dtype=jnp.int32) == lane
            ).astype(rows.dtype)  # (B,) one-hot
            q = (
                rows.reshape(rows.shape[0], nb, 4) * sel[None, :, None]
            ).sum(axis=1)  # (N, 4)
    else:
        q = _QUAD_TAKES[batched_take](quad, base)  # (N, 4)
    if q.dtype != u.dtype:
        q = q.astype(u.dtype)
    i00, i01, i10, i11 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    dxdy = dx * dy
    dt_s = (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )
    gx = -(dy * (i11 - i10) + (1.0 - dy) * (i01 - i00))
    gy = -(dx * (i11 - i01) + (1.0 - dx) * (i10 - i00))
    return jnp.concatenate([gx, gy, dt_s], axis=-1)


def _take_rows(flat: jax.Array, base: jax.Array) -> jax.Array:
    """jnp.take(flat, base, axis=0) used by the quad sampler; split out so
    the lane-folded batching rule below can wrap exactly this op."""
    return jnp.take(flat, base, axis=0)


def _take_rows_ob(flat: jax.Array, base: jax.Array) -> jax.Array:
    """_take_rows with optimization_barriers isolating the gather from its
    producers/consumers, so the gather is emitted standalone rather than
    fused with the frame-build producers.

    Its speed has no valid measurement yet (ROADMAP Y3)."""
    flat_b, base_b = jax.lax.optimization_barrier((flat, base))
    return jax.lax.optimization_barrier(jnp.take(flat_b, base_b, axis=0))


@jax.custom_batching.custom_vmap
def _take_rows_lanefold(flat: jax.Array, base: jax.Array) -> jax.Array:
    return _take_rows(flat, base)


@_take_rows_lanefold.def_vmap
def _take_rows_lanefold_vmap(axis_size, in_batched, flat, base):
    """Batched quad-row gather without gather batching dims.

    A batched gather (operand (B, HW, 12) + 2 start components) can cost
    more per index than the plain 2-D single-sequence form.  This rule
    folds the B per-sequence tables
    along LANES into one shared (HW, B*12) operand so the per-evaluation
    gather is again a single-row-index 2-D gather; each output row then
    keeps its own sequence's 12 lanes via a one-hot multiply-reduce.

    Kept (with the lf12 variant) as A/B forms of this gather; their GPU
    verdict is open (ROADMAP Y3).
    """
    flat_b, base_b = in_batched
    if not (flat_b and base_b):
        # Shared table or shared indices: the plain take batches fine.
        out = jax.vmap(
            _take_rows,
            in_axes=(0 if flat_b else None, 0 if base_b else None),
        )(flat, base)
        return out, True
    b = axis_size
    hw, c = flat.shape[1], flat.shape[2]
    p = base.shape[1]
    tab = jnp.transpose(flat, (1, 0, 2)).reshape(hw, b * c)
    rows = base.reshape(-1, 1)  # (B*P, 1)
    win = jax.lax.gather(
        tab,
        rows,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,),
            collapsed_slice_dims=(0,),
            start_index_map=(0,),
        ),
        slice_sizes=(1, b * c),
        mode="clip",
    )  # (B*P, B*c)
    win = win.reshape(b, p, b, c)
    sel = jnp.eye(b, dtype=win.dtype)[:, None, :, None]  # (B, 1, B, 1)
    out = (win * sel).sum(axis=2)  # (B, P, c)
    return out, True


@jax.custom_batching.custom_vmap
def _take_rows_lanefold12(flat: jax.Array, base: jax.Array) -> jax.Array:
    return _take_rows(flat, base)


@_take_rows_lanefold12.def_vmap
def _take_rows_lanefold12_vmap(axis_size, in_batched, flat, base):
    """Lane-folded batched gather, (1, 12)-slice variant: same shared
    (HW, B*12) operand but two start components (row, lane=12*b) and
    slice_sizes (1, c) — gathers 1/B the bytes of the (1, B*c) form at
    the cost of a second index component."""
    flat_b, base_b = in_batched
    if not (flat_b and base_b):
        out = jax.vmap(
            _take_rows,
            in_axes=(0 if flat_b else None, 0 if base_b else None),
        )(flat, base)
        return out, True
    b = axis_size
    hw, c = flat.shape[1], flat.shape[2]
    p = base.shape[1]
    tab = jnp.transpose(flat, (1, 0, 2)).reshape(hw, b * c)
    rows = base.reshape(-1)  # (B*P,)
    lanes = jnp.repeat(jnp.arange(b, dtype=base.dtype) * c, p)
    starts = jnp.stack([rows, lanes], axis=-1)  # (B*P, 2)
    out = jax.lax.gather(
        tab,
        starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,),
            collapsed_slice_dims=(0,),
            start_index_map=(0, 1),
        ),
        slice_sizes=(1, c),
        mode="clip",
    )  # (B*P, c)
    return out.reshape(b, p, c), True


@jax.custom_batching.custom_vmap
def _take_rows_foldrow(flat: jax.Array, base: jax.Array) -> jax.Array:
    return _take_rows(flat, base)


@_take_rows_foldrow.def_vmap
def _take_rows_foldrow_vmap(axis_size, in_batched, flat, base):
    """Batched row take with the batch folded into the ROW index: the
    (B, HW, C) stacked tables reshape (free) to one (B*HW, C) operand and
    the per-sequence bases get a b*HW offset, so the gather is the plain
    single-index 2-D form instead of the batch-dim form.  Its GPU verdict
    is open (ROADMAP Y3)."""
    flat_b, base_b = in_batched
    if not (flat_b and base_b):
        out = jax.vmap(
            _take_rows,
            in_axes=(0 if flat_b else None, 0 if base_b else None),
        )(flat, base)
        return out, True
    b, hw, c = flat.shape
    p = base.shape[1]
    tab = flat.reshape(b * hw, c)
    offs = jnp.arange(b, dtype=base.dtype)[:, None] * hw
    out = _take_rows(tab, (base + offs).reshape(-1))
    return out.reshape(b, p, c), True


_QUAD_TAKES = {
    "take": _take_rows,
    "take_ob": _take_rows_ob,
    "foldrow": _take_rows_foldrow,
    "lanefold": _take_rows_lanefold,
    "lanefold12": _take_rows_lanefold12,
}


def gather2d(img: jax.Array, iy: jax.Array, ix: jax.Array) -> jax.Array:
    """img[iy, ix] for (N,) int32 indices via a windowed lax.gather.

    (H, W) -> (N,); (H, W, C) -> (N, C).  Advanced integer indexing (and
    jnp.take on a flattened image) may lower to a scalarized gather; the
    explicit (1, 1[, C]) slice gather states the windowed form.  Start
    indices are clipped
    (mode="clip"), matching jnp.take's default clamp.
    """
    starts = jnp.stack([iy, ix], axis=-1)  # (N, 2)
    if img.ndim == 2:
        out = jax.lax.gather(
            img,
            starts,
            jax.lax.GatherDimensionNumbers(
                offset_dims=(),
                collapsed_slice_dims=(0, 1),
                start_index_map=(0, 1),
            ),
            slice_sizes=(1, 1),
            mode="clip",
        )
        return out
    return jax.lax.gather(
        img,
        starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,),
            collapsed_slice_dims=(0, 1),
            start_index_map=(0, 1),
        ),
        slice_sizes=(1, 1, img.shape[2]),
        mode="clip",
    )


def bilinear_sample_taps(
    img: jax.Array, u: jax.Array, v: jax.Array
) -> jax.Array:
    """bilinear_sample via four gather2d (1, 1, C)-slice gathers.

    A third gather emission for in-context A/B against the 4-take and
    windowed forms."""
    h, w = img.shape[0], img.shape[1]
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    i00 = gather2d(img, iy, ix)
    i01 = gather2d(img, iy, ix + 1)
    i10 = gather2d(img, iy + 1, ix)
    i11 = gather2d(img, iy + 1, ix + 1)
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )


def bilinear_sample_pair(
    img: jax.Array, u: jax.Array, v: jax.Array
) -> jax.Array:
    """bilinear_sample via TWO (2, C)-slice gathers on the flattened image.

    In row-major (H*W, C) layout the taps (iy,ix)/(iy,ix+1) are adjacent
    rows, as are (iy+1,ix)/(iy+1,ix+1): one slice gather per row pair
    fetches both, halving the gather count vs the 4-take form.
    """
    h, w = img.shape[0], img.shape[1]
    c = img.shape[2]
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    flat = img.reshape(h * w, c)
    base = (iy * w + ix)[:, None]  # (N, 1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2),
        collapsed_slice_dims=(),
        start_index_map=(0,),
    )
    top = jax.lax.gather(flat, base, dn, slice_sizes=(2, c), mode="clip")
    bot = jax.lax.gather(flat, base + w, dn, slice_sizes=(2, c), mode="clip")
    i00, i01 = top[:, 0], top[:, 1]
    i10, i11 = bot[:, 0], bot[:, 1]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )


def bilinear_sample_window_ob(
    img: jax.Array, u: jax.Array, v: jax.Array
) -> jax.Array:
    """bilinear_sample_window with an optimization_barrier isolating the
    gather from its producers/consumers.

    The barrier keeps the gather standalone (unfused with its producers)
    inside large fused steps."""
    h, w = img.shape[0], img.shape[1]
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    starts = jnp.stack([iy, ix], axis=-1)  # (N, 2)
    img_b, starts_b = jax.lax.optimization_barrier((img, starts))
    win = jax.lax.gather(
        img_b,
        starts_b,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3),
            collapsed_slice_dims=(),
            start_index_map=(0, 1),
        ),
        slice_sizes=(2, 2, img.shape[2]),
        mode="clip",
    )  # (N, 2, 2, C)
    win = jax.lax.optimization_barrier(win)
    dxdy = dx * dy
    return (
        dxdy * win[:, 1, 1]
        + (dy - dxdy) * win[:, 1, 0]
        + (dx - dxdy) * win[:, 0, 1]
        + (1.0 - dx - dy + dxdy) * win[:, 0, 0]
    )


def bilinear_sample_window(
    img: jax.Array, u: jax.Array, v: jax.Array
) -> jax.Array:
    """Same math as bilinear_sample via ONE lax.gather of (2, 2, C) windows.

    Each point fetches its whole 2x2xC neighborhood in a single gather
    slice instead of four row gathers.
    """
    h, w = img.shape[0], img.shape[1]
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    dx = (u - ix.astype(u.dtype))[:, None]
    dy = (v - iy.astype(v.dtype))[:, None]
    ix = jnp.clip(ix, 0, w - 2)
    iy = jnp.clip(iy, 0, h - 2)
    starts = jnp.stack([iy, ix], axis=-1)  # (N, 2)
    win = jax.lax.gather(
        img,
        starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3),
            collapsed_slice_dims=(),
            start_index_map=(0, 1),
        ),
        slice_sizes=(2, 2, img.shape[2]),
        mode="clip",
    )  # (N, 2, 2, C)
    dxdy = dx * dy
    return (
        dxdy * win[:, 1, 1]
        + (dy - dxdy) * win[:, 1, 0]
        + (dx - dxdy) * win[:, 0, 1]
        + (1.0 - dx - dy + dxdy) * win[:, 0, 0]
    )
