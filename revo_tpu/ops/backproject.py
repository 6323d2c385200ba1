"""Edge back-projection into fixed-capacity 3-D point clouds.

Replaces the dynamic-size edge cloud of ImgPyramidRGBD::addLevelEdge
(imgpyramidrgbd.cpp:199-226): every edge pixel with valid depth becomes a 3-D
point X = Z*(x-cx)/fx, Y = Z*(y-cy)/fy, Z.  Jitted code needs static shapes, so
the cloud is a (P, 3) array with a validity mask; compaction uses
jnp.nonzero(size=P), which pads with index 0 (masked out downstream).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class EdgeCloud(NamedTuple):
    """Fixed-capacity edge point cloud for one pyramid level."""

    points: jax.Array  # (P, 3) float32 camera-frame points
    valid: jax.Array  # (P,) bool
    count: jax.Array  # () int32 number of real points (may exceed P if clipped)


_BLK = 128  # rank-select block; all level sizes (307200/76800/19200) divide


def _cumsum_rows_matmul(x: jax.Array) -> jax.Array:
    """Inclusive cumsum of (L, C) float32 rows along axis 0 via 128-chunk
    ones-triangle matmuls at HIGHEST precision.  Exact for integer-valued
    f32 inputs."""
    L, c = x.shape
    pad = (-L) % _BLK
    m = (L + pad) // _BLK
    xm = jnp.pad(x, ((0, pad), (0, 0))).reshape(m, _BLK, c)
    tri = jnp.triu(jnp.ones((_BLK, _BLK), jnp.float32))
    within = jnp.einsum(
        "ij,mjc->mic", tri.T, xm, precision=jax.lax.Precision.HIGHEST
    )  # inclusive within-chunk cumsum
    chunk = within[:, -1, :]  # (m, c) chunk totals
    offs = jnp.cumsum(chunk, axis=0) - chunk  # exclusive chunk offsets
    return (within + offs[:, None, :]).reshape(m * _BLK, c)[:L]


def _compact_scatter(valid_px: jax.Array, capacity: int):
    """Stream compaction as one exclusive scan + one scatter.

    When the cloud fits, slots are the exact ascending compaction (matching
    the reference's dynamic leftCols order, imgpyramidrgbd.cpp:226).  On
    overflow the reference keeps everything (dynamic size); with a fixed
    capacity something must be dropped, and a uniform stride decimation
    (slot = floor(pos * capacity / count)) keeps full-image spatial
    coverage instead of truncating away the bottom of the frame.  The
    scatter writes flat_index+1 with max-combine so unwritten slots read
    0 == invalid — one scatter yields both indices and lane validity.
    """
    count = valid_px.sum().astype(jnp.int32)
    flat = valid_px.ravel()
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
    over = count > capacity
    scale = capacity / jnp.maximum(count, capacity).astype(jnp.float32)
    slot = jnp.where(
        over,
        jnp.floor(pos.astype(jnp.float32) * scale).astype(jnp.int32),
        pos,
    )
    tgt = jnp.where(flat & (slot < capacity), slot, capacity)
    idxp = (
        jnp.zeros(capacity + 1, jnp.int32)
        .at[tgt]
        .max(jnp.arange(1, flat.shape[0] + 1, dtype=jnp.int32), mode="drop")
    )[:capacity]
    lane_valid = idxp > 0
    idx = jnp.maximum(idxp - 1, 0)
    return idx, lane_valid, count


def _compact_rank(
    valid_px: jax.Array, capacity: int, aux=None, table_impl: str = "reduce"
):
    """Gather-form stream compaction: identical output to _compact_scatter,
    computed per OUTPUT slot instead of per pixel.

    A scatter touches every one of the H*W pixels per index; this form
    replaces it with dense compare-reduces.  Each output slot j knows its target edge rank q_j in
    closed form (q_j = j, or the inverse of the decimation map on
    overflow); the q_j-th edge is located with a two-level rank structure:
    per-128-pixel-block counts locate the block (one (cap, nblocks)
    compare-reduce), and a per-block rank->offset table (one
    (nblocks, 128, 128) compare-reduce) gives the position inside it.
    The only per-index op left is one (capacity,)-index gather.

    ``aux`` (optional (H, W) float32, e.g. depth) rides the same rank
    structure: its per-(block, rank) value joins the offset table so the
    final take fetches (offset, aux) rows together — the caller's
    separate per-point aux gather disappears.  Returns (idx, lane_valid, count[, aux_at_idx]).
    """
    n = valid_px.size
    pad = (-n) % _BLK  # invalid padding cannot change any rank
    nb = (n + pad) // _BLK
    v = jnp.pad(valid_px.ravel().astype(jnp.float32), (0, pad)).reshape(
        nb, _BLK
    )
    # In-block inclusive rank as a triangular matmul: the (nb, 128) @
    # (128, 128) ones-triangle has 0/1 operands and integer sums <= 128, so
    # it is exact at any matmul precision (accumulated in f32).
    tri = jnp.triu(jnp.ones((_BLK, _BLK), jnp.float32))
    C = jax.lax.dot_general(
        v, tri, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (nb, BLK) f32, integer-valued
    blockcount = C[:, -1].astype(jnp.int32)
    blockcum = jnp.cumsum(blockcount)
    count = blockcum[-1]

    j = jnp.arange(capacity, dtype=jnp.int32)
    over = count > capacity
    scale = capacity / jnp.maximum(count, capacity).astype(jnp.float32)

    # Inverse of the forward decimation slot = floor(pos * scale): the
    # largest pos mapping to j (the scatter's max-combine winner), with a
    # +-1 correction so the f32 rounding matches the forward map exactly.
    def fwd(p):
        return jnp.floor(p.astype(jnp.float32) * scale).astype(jnp.int32)

    cand = jnp.ceil((j + 1).astype(jnp.float32) / scale).astype(jnp.int32) - 1
    cand = jnp.where(fwd(cand) > j, cand - 1, cand)
    cand = jnp.where(fwd(cand + 1) <= j, cand + 1, cand)
    cand = jnp.minimum(cand, count - 1)
    q = jnp.where(over, cand, j)  # global edge rank wanted by slot j

    # Locate q's block: block_of[j] = #{b: blockcum[b] <= q_j}.  Because
    # q_j is the LARGEST rank with fwd(rank) <= j (fwd monotone), the
    # integer condition blockcum[b] <= q_j is equivalent to
    # fwd(blockcum[b]) <= j — so instead of an O(cap x nb) compare-reduce
    # both block_of and the edges-before count come from one tiny
    # scatter-bincount of the nb block summaries followed by a cumsum over
    # slots (ones-triangle matmul).
    # Blocks at-or-after the last edge (blockcum == count) precede no valid
    # slot (q <= count-1 always when over; when not over they only affect
    # j >= count lanes, which are zeroed as invalid) — pin them to the
    # dropped pad row.
    s_b = jnp.where(
        blockcum == count, capacity, jnp.clip(fwd(blockcum), 0, capacity)
    )  # (nb,) first slot each block's summary applies to
    tab = (
        jnp.zeros((capacity + 1, 2), jnp.float32)
        .at[s_b]
        .add(
            jnp.stack(
                [jnp.ones_like(blockcount), blockcount], axis=-1
            ).astype(jnp.float32),
            mode="drop",
        )
    )
    cum = _cumsum_rows_matmul(tab)[:capacity]  # (cap, 2)
    block_of = cum[:, 0].astype(jnp.int32)
    prev = cum[:, 1].astype(jnp.int32)
    k = q - prev  # in-block rank

    # inpos[b, r] = offset of the (r+1)-th edge inside block b.
    bo = jnp.minimum(block_of, nb - 1)
    kc = jnp.clip(k, 0, _BLK - 1)
    lane_valid = over | (j < count)
    i_idx = jnp.arange(_BLK, dtype=jnp.float32)

    if aux is not None:
        a = jnp.pad(
            aux.ravel().astype(jnp.float32), (0, pad)
        ).reshape(nb, _BLK)
        # Non-finite aux entries sit on invalid pixels (never selected),
        # but 0 * NaN = NaN would poison the reduce form — sanitize.
        a = jnp.where(jnp.isfinite(a), a, 0.0)

    if table_impl == "sort":
        # Lane sort: key = in-block rank for valid lanes (C is the
        # inclusive cumsum, so valid lanes carry distinct keys 1..count),
        # BLK+2 for invalid ones.  Ascending sort puts the rank-(r+1)
        # edge's lane index (and aux) at column r — the same table as the
        # one-hot contraction below in O(BLK log^2 BLK) compare-exchange
        # passes instead of O(BLK^2) multiply-reduces per block.
        keys = jnp.where(v > 0, C, jnp.float32(_BLK + 2))
        ib = jnp.broadcast_to(i_idx, (nb, _BLK))
        if aux is None:
            _, inpos_f = jax.lax.sort_key_val(keys, ib, dimension=1)
        else:
            _, inpos_f, auxpos = jax.lax.sort(
                (keys, ib, a), dimension=1, num_keys=1
            )
    elif table_impl == "sort_packed":
        # One-operand-fewer variant of "sort": the lane index rides the
        # key's low byte (key' = key*256 + lane; values <= 130*256+127 <
        # 2^24, exact in f32) instead of travelling as a sort payload, and
        # is recovered with a mod after the sort.  Valid lanes' keys are
        # distinct (inclusive cumsum), so ordering — and the table — are
        # bit-identical to "sort"; only the compare-exchange network
        # shrinks by one carried array (two when aux is absent).
        keys = jnp.where(v > 0, C, jnp.float32(_BLK + 2))
        packed = keys * 256.0 + i_idx[None, :]
        if aux is None:
            sp = jax.lax.sort(packed, dimension=1)
            inpos_f = jnp.mod(sp, 256.0)
        else:
            sp, auxpos = jax.lax.sort((packed, a), dimension=1, num_keys=1)
            inpos_f = jnp.mod(sp, 256.0)
    else:
        r1 = jnp.arange(1, _BLK + 1, dtype=jnp.float32)
        hit = (C[:, None, :] == r1[None, :, None]) & (v[:, None, :] > 0)
        hitf = hit.astype(jnp.float32)
        inpos_f = (hitf * i_idx[None, None, :]).sum(axis=2)
        if aux is not None:
            auxpos = (hitf * a[:, None, :]).sum(axis=2)  # (nb, BLK)

    # Final row take via the lane-fold custom_vmap form: under vmap a
    # plain take becomes a batch-dim gather; the fold keeps the
    # single-row 2-D gather by stacking the B tables along lanes
    # ((nb*BLK, B*2) at B=8 = 16-lane rows), same trick as the solver's
    # quad_lf.  Bit-identical: the primal is the plain take and the
    # batched one-hot select is exact (single nonzero term per row).
    from revo_tpu.ops.interp import _take_rows_lanefold

    if aux is None:
        flatpos = _take_rows_lanefold(
            inpos_f.reshape(-1, 1), bo * _BLK + kc
        )[:, 0].astype(jnp.int32)
        idx = bo * _BLK + flatpos
        return jnp.where(lane_valid, idx, 0), lane_valid, count
    table = jnp.stack([inpos_f, auxpos], axis=-1).reshape(nb * _BLK, 2)
    rows = _take_rows_lanefold(table, bo * _BLK + kc)  # (cap, 2)
    flatpos = rows[:, 0].astype(jnp.int32)
    idx = bo * _BLK + flatpos
    return jnp.where(lane_valid, idx, 0), lane_valid, count, rows[:, 1]


def backproject_edges(
    edges: jax.Array,
    depth: jax.Array,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    depth_min: float,
    depth_max: float,
    capacity: int,
    compaction: str = "rank",
) -> EdgeCloud:
    """Edge pixels with finite depth in (depth_min, depth_max) -> EdgeCloud.

    Validity predicate mirrors isPointOkEdgePyr (imgpyramidrgbd.h:176-180):
    edge > 0 and isfinite(Z) and DEPTH_MIN < Z < DEPTH_MAX (strict).
    """
    h, w = edges.shape
    valid_px = (
        (edges > 0)
        & jnp.isfinite(depth)
        & (depth > depth_min)
        & (depth < depth_max)
    )
    if compaction.startswith("rank"):
        # Depth rides the rank structure: one fused (offset, z) row take
        # replaces the separate per-point depth gather.  "rank_sort" builds
        # the in-block rank tables with a lane sort instead of the one-hot
        # contraction (identical output; see _compact_rank).
        idx, lane_valid, count, z = _compact_rank(
            valid_px, capacity, depth,
            table_impl={
                "rank_sort": "sort",
                "rank_sort2": "sort_packed",
            }.get(compaction, "reduce"),
        )
        yi = idx // w
        xi = idx % w
    else:
        idx, lane_valid, count = _compact_scatter(valid_px, capacity)
        yi = idx // w
        xi = idx % w
        from revo_tpu.ops.interp import gather2d

        z = gather2d(depth, yi, xi)
    yy = yi.astype(jnp.float32)
    xx = xi.astype(jnp.float32)
    x3 = z * (xx - cx) / fx
    y3 = z * (yy - cy) / fy
    pts = jnp.stack([x3, y3, z], axis=-1)
    pts = jnp.where(lane_valid[:, None], pts, 0.0)
    return EdgeCloud(points=pts, valid=lane_valid, count=count)
