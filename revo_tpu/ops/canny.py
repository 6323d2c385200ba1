"""Canny edge detector as vectorized XLA ops.

Replacement for cv::Canny(gray, t1, t2, apertureSize=3,
L2gradient=true) as called by the reference (imgpyramidrgbd.cpp:105-108,184).
Follows OpenCV's algorithm:

- 3x3 Sobel gradients (integer-exact for integer-valued gray input),
- squared-L2 magnitude compared against squared thresholds (OpenCV squares
  the thresholds when L2gradient=true),
- sector-quantized non-maximum suppression with OpenCV's exact comparison
  rules (strict vs non-strict per sector, OpenCV's fixed-point tan 22.5 deg
  sector boundaries),
- hysteresis by iterative dilation of strong edges through the weak mask
  (the parallel fixed-point formulation of OpenCV's BFS; identical result).

The propagation loop is a lax.while_loop that stops when the reachable set
stops growing, so the whole operator jits and vmaps (under vmap it runs
until every batch element converges).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from revo_tpu.ops.filters import sobel

# OpenCV's fixed-point tan(22.5 deg): round(tan(pi/8) * 2**15).
_CANNY_SHIFT = 15
_TG22 = 13573


def _shift(x: jax.Array, dy: int, dx: int) -> jax.Array:
    """Shift with zero fill: out[y, x] = x[y + dy, x + dx]."""
    h, w = x.shape
    out = jnp.zeros_like(x)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


def _dilate8(mask: jax.Array) -> jax.Array:
    """8-connected binary dilation via a 3x3 OR window (one fused op)."""
    return jax.lax.reduce_window(
        mask, False, jax.lax.bitwise_or, (3, 3), (1, 1), "SAME"
    )


def canny_candidates(
    gray: jax.Array, threshold1: float = 150.0, threshold2: float = 100.0
):
    """Sobel + L2 magnitude + sector NMS + double threshold of an (H, W)
    integer-valued gray image; returns (candidates, strong) bool masks.

    ``threshold1``/``threshold2`` follow cv::Canny's argument order: the
    smaller is the low (hysteresis) threshold, the larger the high one —
    the reference passes (150, 100) (camerapyr.h:40-41).
    """
    low = float(min(threshold1, threshold2))
    high = float(max(threshold1, threshold2))
    low_sq, high_sq = low * low, high * high

    gx, gy = sobel(gray, border="replicate")  # cv::Canny's Sobel border
    mag = gx * gx + gy * gy  # squared L2, integer-exact in f32

    # Neighbor magnitudes (zero outside the image, like OpenCV's zero border
    # around its magnitude rows).
    m_l = _shift(mag, 0, -1)
    m_r = _shift(mag, 0, 1)
    m_u = _shift(mag, -1, 0)
    m_d = _shift(mag, 1, 0)
    m_ul = _shift(mag, -1, -1)
    m_ur = _shift(mag, -1, 1)
    m_dl = _shift(mag, 1, -1)
    m_dr = _shift(mag, 1, 1)

    # Sector selection in OpenCV's fixed-point form (canny.cpp): with
    # x = |gx|, y = |gy| << 15 and tg22x = x * TG22, the pixel is
    # horizontal if y < tg22x, vertical if y > tg22x + (x << 16), else
    # diagonal with s = sign(gx * gy).  Integer arithmetic keeps the
    # compare exact on every backend (no FMA contraction can flip it).
    ax = jnp.abs(gx).astype(jnp.int32)
    ay = jnp.abs(gy).astype(jnp.int32) << _CANNY_SHIFT
    tg22x = ax * _TG22
    horiz = ay < tg22x
    vert = ay > tg22x + (ax << (_CANNY_SHIFT + 1))
    s_pos = (gx * gy) >= 0  # s = +1 when gradients share sign

    # OpenCV comparisons: horizontal (m > left && m >= right),
    # vertical (m > up && m >= down), diagonal strict both.
    keep_h = (mag > m_l) & (mag >= m_r)
    keep_v = (mag > m_u) & (mag >= m_d)
    # s=+1: compare (prev_row, x-1) and (next_row, x+1)  ("\" diagonal)
    keep_d_pos = (mag > m_ul) & (mag > m_dr)
    # s=-1: compare (prev_row, x+1) and (next_row, x-1)  ("/" diagonal)
    keep_d_neg = (mag > m_ur) & (mag > m_dl)

    keep = jnp.where(
        horiz, keep_h,
        jnp.where(vert, keep_v, jnp.where(s_pos, keep_d_pos, keep_d_neg)),
    )

    cand = keep & (mag > low_sq)  # weak + strong candidates
    strong = cand & (mag > high_sq)
    return cand, strong


def hysteresis(cand: jax.Array, strong: jax.Array) -> jax.Array:
    """Grow ``strong`` through ``cand`` (8-connectivity) to the fixpoint.

    Each while iteration applies UNROLL dilations back-to-back; the
    fixpoint check still makes the result exact (identical to OpenCV's
    BFS): the output is every candidate 8-connected to a strong pixel.
    The guard of h*w dilations never binds: every dilation short of the
    fixpoint adds a pixel (the Triton kernel's relaunch loop has the
    same guard).
    """
    h, w = cand.shape
    UNROLL = 8

    def cond(state):
        reach, prev_count, it = state
        return (reach.sum() != prev_count) & (it < h * w)

    def body(state):
        reach, _, it = state
        grown = reach
        for _ in range(UNROLL):
            grown = (cand & _dilate8(grown)) | grown
        return grown, reach.sum(), it + UNROLL

    # Scalar carries are derived from the input so their sharding/varying
    # axes match the loop outputs (required under shard_map).
    zero = strong.sum() * 0
    with jax.named_scope("canny_hysteresis"):
        reach, _, _ = jax.lax.while_loop(cond, body, (strong, zero - 1, zero))
    return reach


def canny(
    gray: jax.Array, threshold1: float = 150.0, threshold2: float = 100.0
) -> jax.Array:
    """Boolean edge map of an (H, W) integer-valued gray image
    (cv::Canny(gray, t1, t2, 3, L2gradient=true)).

    The hysteresis fixpoint is picked per lowering platform: on a GPU the
    Pallas/Triton tile kernel (ops.hysteresis_triton), which beat the XLA
    while loop end to end on the H100 (PERF.md); elsewhere the XLA form.
    Both give the identical edge map.
    """
    with jax.named_scope("canny_nms"):
        cand, strong = canny_candidates(gray, threshold1, threshold2)
    from revo_tpu.ops.hysteresis_triton import hysteresis_triton

    return jax.lax.platform_dependent(
        cand, strong, cuda=hysteresis_triton, default=hysteresis
    )
