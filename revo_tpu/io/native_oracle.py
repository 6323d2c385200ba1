"""ctypes binding for the single-core C++ oracle (native/revo_oracle.cpp).

The oracle is a from-scratch C++ implementation of the reference hot loop
(cv::Canny/pyrDown/distanceTransform preprocessing + the LM tracker of
optimizer.cpp:74-312 with LGSX.h-style vectorized normal-equation
accumulation) and is bench.py's HONEST ``vs_baseline`` denominator: it
stands in for the reference's single-core C++/SSE speed, which cannot be
built here (no Eigen/Boost in the image, zero egress — BASELINE.md).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from revo_tpu.io.native_build import load_native

_lib: Optional[ctypes.CDLL] = None


class _Params(ctypes.Structure):
    _fields_ = [
        ("fx", ctypes.c_float),
        ("fy", ctypes.c_float),
        ("cx", ctypes.c_float),
        ("cy", ctypes.c_float),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("canny_t1", ctypes.c_float),
        ("canny_t2", ctypes.c_float),
        ("depth_min", ctypes.c_float),
        ("depth_max", ctypes.c_float),
        ("pyr_min_lvl", ctypes.c_int32),
        ("pyr_max_lvl", ctypes.c_int32),
        ("max_its", ctypes.c_int32),
        ("edge_distance_lvl", ctypes.c_float * 6),
        ("huber_edge", ctypes.c_float),
        ("lambda_success_fac", ctypes.c_float),
        ("lambda_fail_fac", ctypes.c_float),
        ("convergence_eps", ctypes.c_float),
        ("step_size_min", ctypes.c_float),
        ("max_inc_try", ctypes.c_int32),
    ]


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("librevo_oracle.so")
    if lib is None:
        return None
    lib.revo_oracle_run.restype = ctypes.c_double
    lib.revo_oracle_run.argtypes = [
        ctypes.c_void_p,  # grays
        ctypes.c_void_p,  # depths
        ctypes.c_int,     # n
        ctypes.c_int,     # H
        ctypes.c_int,     # W
        ctypes.POINTER(_Params),
        ctypes.c_void_p,  # out_secs
        ctypes.c_void_p,  # out_poses
        ctypes.c_void_p,  # out_errs
    ]
    _lib = lib
    return lib


def oracle_available() -> bool:
    return _load_lib() is not None


def _params_from_cfg(cfg) -> _Params:
    cam = cfg.camera
    pyr = cfg.pyramid
    opt = cfg.tracker.optimizer
    p = _Params()
    p.fx, p.fy, p.cx, p.cy = cam.fx, cam.fy, cam.cx, cam.cy
    p.width, p.height = cam.width, cam.height
    p.canny_t1 = pyr.canny_threshold1
    p.canny_t2 = pyr.canny_threshold2
    p.depth_min, p.depth_max = pyr.depth_min, pyr.depth_max
    p.pyr_min_lvl, p.pyr_max_lvl = pyr.pyr_min_lvl, pyr.pyr_max_lvl
    p.max_its = int(opt.max_its_per_lvl[0])
    for i in range(6):
        p.edge_distance_lvl[i] = float(opt.edge_distance_lvl[i])
    p.huber_edge = opt.huber_edge
    p.lambda_success_fac = opt.lambda_success_fac
    p.lambda_fail_fac = opt.lambda_fail_fac
    p.convergence_eps = float(opt.convergence_eps[0])
    p.step_size_min = float(opt.step_size_min[0])
    p.max_inc_try = opt.max_inc_try
    return p


def oracle_run(cfg, grays, depths):
    """Run the C++ oracle VO over pre-rendered frames.

    ``grays``: list/array of (H, W) images (uint8-valued), ``depths``:
    (H, W) float32 metres. Keyframe = frame 0; frames 1..n-1 are built and
    tracked sequentially (the bench protocol).

    Returns ``(min_frame_seconds, per_frame_seconds, poses, errors)`` where
    ``poses`` is (n-1, 4, 4) float32 T (tracked camera-from-keyframe) and
    ``errors`` the final per-frame residuals.
    """
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native oracle library unavailable")
    g = np.ascontiguousarray(
        np.stack([np.asarray(x) for x in grays]).astype(np.uint8)
    )
    d = np.ascontiguousarray(
        np.stack([np.asarray(x) for x in depths]).astype(np.float32)
    )
    n, H, W = g.shape
    p = _params_from_cfg(cfg)
    secs = np.zeros(n - 1, np.float64)
    poses_raw = np.zeros((n - 1, 12), np.float32)
    errs = np.zeros(n - 1, np.float32)
    best = lib.revo_oracle_run(
        g.ctypes.data, d.ctypes.data, n, H, W, ctypes.byref(p),
        secs.ctypes.data, poses_raw.ctypes.data, errs.ctypes.data,
    )
    poses = np.tile(np.eye(4, dtype=np.float32), (n - 1, 1, 1))
    poses[:, :3, :3] = poses_raw[:, :9].reshape(-1, 3, 3)
    poses[:, :3, 3] = poses_raw[:, 9:]
    return float(best), secs, poses, errs
