"""Separable filters: Gaussian blur, pyramid downsampling, Sobel.

Replacements for cv::GaussianBlur / cv::pyrDown / cv::Sobel used
by the reference pyramid builder (imgpyramidrgbd.cpp:82,101-108) and Canny.
All filters are expressed as small separable convolutions that XLA fuses
into elementwise kernels; borders default to REFLECT_101 (OpenCV's default
BORDER_REFLECT_101) via jnp.pad(mode="reflect").
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _sep_filter(
    img: jax.Array, kx: jax.Array, ky: jax.Array, pad_mode: str = "reflect"
) -> jax.Array:
    """Separable 2-D correlation on an (H, W) image, borders by
    ``jnp.pad(mode=pad_mode)``: "reflect" is OpenCV's BORDER_REFLECT_101,
    "edge" its BORDER_REPLICATE.

    Implemented as shifted adds over the padded array, which XLA fuses
    into one elementwise kernel (the image has no channel dimension for a
    convolution to use).
    """
    nx = kx.shape[0]
    ny = ky.shape[0]
    rx = nx // 2
    ry = ny // 2
    x = jnp.pad(img, ((ry, ry), (rx, rx)), mode=pad_mode)
    h, w = img.shape
    # Rows (axis 1) with kx, then cols (axis 0) with ky.  Kernel lengths are
    # static (shape info), taps may be traced scalars — XLA constant-folds
    # the usual literal-kernel case.
    row = None
    for j in range(nx):
        term = x[:, j:j + w] * kx[j]
        row = term if row is None else row + term
    out = None
    for i in range(ny):
        term = row[i:i + h, :] * ky[i]
        out = term if out is None else out + term
    return out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel: sampled Gaussian, normalized to sum 1."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(
    img: jax.Array, ksize: int = 7, sigma: float = 2.0, quantize: bool = True
) -> jax.Array:
    """cv::GaussianBlur(gray, 7x7, 2) as used before Canny
    (imgpyramidrgbd.cpp:101-108).  ``quantize`` rounds to integer levels to
    mirror uint8 semantics of the reference pipeline."""
    k = jnp.asarray(gaussian_kernel(ksize, sigma))
    out = _sep_filter(img.astype(jnp.float32), k, k)
    if quantize:
        out = jnp.round(out)
    return out


# cv::pyrDown kernel: outer([1,4,6,4,1]/16).
_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=32)
def _pyr_band(n: int) -> np.ndarray:
    """((n+1)//2, n) banded matrix: 5-tap [1,4,6,4,1]/16 correlation with
    REFLECT_101 borders, evaluated at even coordinates.

    Row i sums kernel taps at source columns 2i-2..2i+2 with out-of-range
    columns reflected (|j| for j<0, 2n-2-j for j>n-1) — exactly
    cv::pyrDown's blur+decimate along one axis, as one matrix so the whole
    pyrDown is two matmuls at HIGHEST precision rather than a strided-slice
    decimation."""
    m = (n + 1) // 2
    band = np.zeros((m, n), np.float32)
    for i in range(m):
        for t in range(-2, 3):
            j = 2 * i + t
            if j < 0:
                j = -j
            elif j > n - 1:
                j = 2 * (n - 1) - j
            band[i, j] += _PYR_K[t + 2]
    return band


def pyr_down(img: jax.Array, quantize: bool = True) -> jax.Array:
    """cv::pyrDown: 5-tap Gaussian blur + 2x decimation (imgpyramidrgbd.cpp:82).

    Output size is (H+1)//2 x (W+1)//2, samples taken at even coordinates.
    ``quantize`` reproduces uint8 rounding of the reference gray pyramid.
    Implemented as two banded matmuls (see _pyr_band).
    """
    h, w = img.shape
    bh = jnp.asarray(_pyr_band(h))
    bw = jnp.asarray(_pyr_band(w))
    x = img.astype(jnp.float32)
    out = jnp.dot(
        jnp.dot(bh, x, precision=jax.lax.Precision.HIGHEST),
        bw.T,
        precision=jax.lax.Precision.HIGHEST,
    )
    if quantize:
        out = jnp.round(out)
    return out


# Sobel aperture-3 kernels (x-derivative; y is the transpose). OpenCV's
# convention: Sx = [[-1,0,1],[-2,0,2],[-1,0,1]] as a correlation.
_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)


def sobel(img: jax.Array, border: str = "reflect101"):
    """3x3 Sobel derivatives (gx, gy).

    Matches cv::Sobel(src, CV_16S, 1|0, 0|1, ksize=3) exactly for integer
    -valued inputs, with OpenCV's default BORDER_REFLECT_101 or, with
    ``border="replicate"``, BORDER_REPLICATE (what cv::Canny uses).
    """
    mode = {"reflect101": "reflect", "replicate": "edge"}[border]
    x = img.astype(jnp.float32)
    gx = _sep_filter(x, jnp.asarray(_SOBEL_D), jnp.asarray(_SOBEL_S), mode)
    gy = _sep_filter(x, jnp.asarray(_SOBEL_S), jnp.asarray(_SOBEL_D), mode)
    return gx, gy
