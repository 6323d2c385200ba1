"""Batched, fixed-shape image/geometry ops of the VO pipeline.

Each module replaces a native (C++/OpenCV/SSE) component of the reference
with a jit/vmap-friendly JAX implementation (SURVEY.md §2.3):

- filters: Gaussian blur, pyrDown, Sobel      (cv::GaussianBlur/pyrDown/Sobel)
- depth: valid-pixel depth subsampling        (FilterSubsampleWithHoles)
- canny: Canny edge detector                  (cv::Canny, aperture 3, L2)
- edt: exact Euclidean distance transform     (cv::distanceTransform L2/PRECISE)
         fused with the (gx, gy, dt) gradient structure
- interp: bilinear multi-channel sampling     (getInterpolatedElement43)
- backproject: fixed-capacity edge clouds     (addLevelEdge back-projection)
- edge_hist: BMVC17 edge fill-in              (generateDistHistogram/fillInEdges)
"""

from revo_tpu.ops.filters import gaussian_blur, pyr_down, sobel
from revo_tpu.ops.depth import subsample_depth_with_holes
from revo_tpu.ops.canny import canny, canny_candidates, hysteresis
from revo_tpu.ops.edt import (
    distance_transform,
    build_optimization_structure,
    keyframe_structure,
    quad_structure,
)
from revo_tpu.ops.interp import bilinear_sample
from revo_tpu.ops.backproject import backproject_edges
from revo_tpu.ops.edge_hist import patch_histogram, fill_in_edges

__all__ = [
    "gaussian_blur",
    "pyr_down",
    "sobel",
    "subsample_depth_with_holes",
    "canny",
    "canny_candidates",
    "hysteresis",
    "distance_transform",
    "build_optimization_structure",
    "keyframe_structure",
    "quad_structure",
    "bilinear_sample",
    "backproject_edges",
    "patch_histogram",
    "fill_in_edges",
]
