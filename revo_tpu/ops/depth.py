"""Valid-pixel depth downsampling ("subsample with holes").

Replaces ImgPyramidRGBD::FilterSubsampleWithHoles (imgpyramidrgbd.h:218-249,
InfiniTAM-derived): each output pixel is the mean of the >0 pixels of its
2x2 source block; 0 if the whole block is invalid.

The 2x2 block sums are expressed as indicator matmuls (row/col pair
selectors, at HIGHEST precision) instead of a 4-D reshape reduce.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_DOT = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=32)
def _pair_selector(n: int) -> np.ndarray:
    """(n//2, n) 0/1 matrix: row i sums source elements 2i and 2i+1."""
    m = np.zeros((n // 2, n), np.float32)
    for i in range(n // 2):
        m[i, 2 * i] = 1.0
        m[i, 2 * i + 1] = 1.0
    return m


def subsample_depth_with_holes(depth: jax.Array) -> jax.Array:
    """(H, W) float depth -> (H//2, W//2), averaging only valid (>0) pixels.

    The reference truncates odd sizes (out = in/2, imgpyramidrgbd.h:220);
    the selectors ignore the last row/col when odd.
    """
    h, w = depth.shape
    sh = jnp.asarray(_pair_selector(h))
    sw = jnp.asarray(_pair_selector(w))
    valid = (depth > 0.0).astype(jnp.float32)
    total = _DOT(_DOT(sh, jnp.where(depth > 0.0, depth, 0.0)), sw.T)
    count = _DOT(_DOT(sh, valid), sw.T)
    return jnp.where(count > 0, total / jnp.maximum(count, 1.0), 0.0)
