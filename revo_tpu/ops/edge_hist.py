"""BMVC17 edge-histogram fill-in.

Replaces ImgPyramidRGBD::generateDistHistogram / fillInEdges
(imgpyramidrgbd.cpp:111-172): a per-patch edge-count map decides whether a
coarse pyramid level is too sparsely covered; if so, edges from the finer
parent level are copied down into the empty patches.

Deviation from the reference (documented): patch counts use int32 instead of
the reference's uint8 (which silently wraps at 256 for 20x20 patches,
imgpyramidrgbd.cpp:148-154) — wrap-around could make a dense patch look
empty; we keep exact counts.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=64)
def _block_indicator(n: int, block: int, nb: int) -> np.ndarray:
    """(nb, n) 0/1 matrix: row k selects elements k*block..k*block+block-1."""
    m = np.zeros((nb, n), np.float32)
    for k in range(nb):
        m[k, k * block : (k + 1) * block] = 1.0
    return m


def patch_histogram(edges: jax.Array, patch_size: int):
    """Edge count per (patch_size x patch_size) patch + occupancy fraction.

    Returns (counts (Hp, Wp) int32, occupancy scalar float) where occupancy =
    fraction of patches with >= 1 edge pixel (generateDistHistogram's
    nDist/total, imgpyramidrgbd.cpp:159-167).  Image dims are truncated to
    whole patches like the integer division in the reference.

    Block pooling is expressed as two small matmuls with static 0/1
    indicator matrices (counts = Ih @ E @ Iw^T) instead of a
    reshape-to-4D reduce.  Counts are < 2^24, so the f32 matmul at HIGHEST
    precision is exact.
    """
    h, w = edges.shape
    hp, wp = h // patch_size, w // patch_size
    ih = jnp.asarray(_block_indicator(h, patch_size, hp))
    iw = jnp.asarray(_block_indicator(w, patch_size, wp))
    e = (edges > 0).astype(jnp.float32)
    counts_f = _PREC_DOT(ih, _PREC_DOT(e, iw.T))
    counts = counts_f.astype(jnp.int32)
    occupancy = (counts > 0).mean(dtype=jnp.float32)
    return counts, occupancy


def _PREC_DOT(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=64)
def _odd_selector(n_child: int, n_parent: int) -> np.ndarray:
    """(n_child, n_parent) 0/1 matrix: row y selects parent index 2y+1 when
    in range (zero row otherwise — the fillInEdges in_par mask)."""
    m = np.zeros((n_child, n_parent), np.float32)
    for y in range(n_child):
        j = 2 * y + 1
        if j < n_parent:
            m[y, j] = 1.0
    return m


@functools.lru_cache(maxsize=64)
def _count_upsample(n_child: int, parent_patch: int, n_counts: int) -> np.ndarray:
    """(n_child, n_counts) 0/1 matrix: row y selects count bin
    min((2y+1) // parent_patch, n_counts - 1) — the exact (clamped) patch
    lookup of imgpyramidrgbd.cpp:133."""
    m = np.zeros((n_child, n_counts), np.float32)
    for y in range(n_child):
        m[y, min((2 * y + 1) // parent_patch, n_counts - 1)] = 1.0
    return m


def fill_in_edges(
    edges: jax.Array,
    parent_edges: jax.Array,
    counts: jax.Array,
    patch_size: int,
    parent_patch_size: int,
) -> jax.Array:
    """Copy parent-level edges down into sparsely covered patches.

    Mirrors fillInEdges (imgpyramidrgbd.cpp:130-140): for parent pixels at
    odd coordinates (yy%2==1, xx%2==1) whose patch count (indexed by parent
    coords / parent patch size) is below patch_size^2 * 0.05, an edge in the
    parent sets edges[yy//2, xx//2].
    """
    h, w = edges.shape
    ph, pw = parent_edges.shape
    thresh = patch_size * patch_size * 0.05

    # Child pixel (y, x) receives parent pixel (2y+1, 2x+1) when in range,
    # gated by the patch count at parent coords // parent_patch_size with
    # the reference's index clamp (imgpyramidrgbd.cpp:130-140).  Both the
    # odd-coordinate selection and the count-grid upsample are expressed as
    # static 0/1 selector matmuls (at HIGHEST precision) rather than
    # strided slices / index gathers.
    so_h = jnp.asarray(_odd_selector(h, ph))
    so_w = jnp.asarray(_odd_selector(w, pw))
    par = (
        _PREC_DOT(_PREC_DOT(so_h, parent_edges.astype(jnp.float32)), so_w.T)
        > 0.5
    )  # zero rows of the selector encode the in_par out-of-range mask

    hc, wc = counts.shape
    up_h = jnp.asarray(_count_upsample(h, parent_patch_size, hc))
    up_w = jnp.asarray(_count_upsample(w, parent_patch_size, wc))
    sparse_small = (counts < thresh).astype(jnp.float32)
    sparse = _PREC_DOT(_PREC_DOT(up_h, sparse_small), up_w.T) > 0.5

    return edges | (sparse & par)
