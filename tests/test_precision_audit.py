"""Precision audit: every dot_general on the tracking path asks for
Precision.HIGHEST.

At default precision a GPU may run an f32 matmul in TF32 (10 mantissa
bits), which turns pose chains and normal equations into drift.  The only
exceptions are contractions that are exact at any precision: 0/1 operands
with integer sums below 2^24, accumulated in f32.
"""
import functools
import os

import jax
import jax.numpy as jnp
import pytest
from jax._src import source_info_util
from jax.extend import core as jex_core

from test_solver import small_cfg

# (file, function) of the exact 0/1 contractions.
ALLOWED = {
    ("backproject.py", "_compact_rank"),  # ones-triangle rank, counts <= 128
    ("tracker.py", "assess_tracking_quality"),  # one-hot voting histogram
}


def _subjaxprs(params):
    for v in params.values():
        vs = v if isinstance(v, (tuple, list)) else (v,)
        for x in vs:
            if isinstance(x, jex_core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex_core.Jaxpr):
                yield x


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in _subjaxprs(eqn.params):
            yield from _dots(sub)


def _site(eqn):
    frame = source_info_util.user_frame(eqn.source_info.traceback)
    if frame is None:
        return ("?", "?", 0)
    return (os.path.basename(frame.file_name), frame.function_name,
            frame.start_line)


def _audit(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = list(_dots(jaxpr))
    bad = []
    for eqn in dots:
        prec = eqn.params.get("precision")
        highest = prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        )
        site = _site(eqn)
        if not highest and site[:2] not in ALLOWED:
            bad.append(site)
    return dots, bad


def _inputs(cfg, n=None):
    shape = (cfg.camera.height, cfg.camera.width)
    if n is not None:
        shape = (n,) + shape
    return (jax.ShapeDtypeStruct(shape, jnp.float32),
            jax.ShapeDtypeStruct(shape, jnp.float32))


def _frame_and_keyframe(cfg):
    from revo_tpu.frontend import build_frame, make_keyframe

    g, d = _inputs(cfg)
    frame = jax.eval_shape(functools.partial(build_frame, cfg=cfg), g, d)
    kf = jax.eval_shape(
        functools.partial(make_keyframe, cfg=cfg), frame,
        jax.ShapeDtypeStruct((4, 4), jnp.float32),
    )
    return frame, kf


def _build_frame(cfg):
    from revo_tpu.frontend import build_frame

    return functools.partial(build_frame, cfg=cfg), _inputs(cfg)


def _track_frames(cfg):
    from revo_tpu import tracker

    frame, kf = _frame_and_keyframe(cfg)
    fn = functools.partial(tracker.track_frames, cfg=cfg)
    return fn, (kf, frame, jax.ShapeDtypeStruct((3, 3), jnp.float32),
                jax.ShapeDtypeStruct((3,), jnp.float32))


def _vo_scan(cfg):
    from revo_tpu.parallel.batch import vo_scan

    return functools.partial(vo_scan, cfg=cfg), _inputs(cfg, n=3)


def _stitching(cfg):
    from revo_tpu.parallel.segments import stitch_trajectory

    fn = functools.partial(stitch_trajectory, refine=True)
    return fn, (jax.ShapeDtypeStruct((4, 5, 4, 4), jnp.float32),)


@pytest.mark.parametrize(
    "path", [_build_frame, _track_frames, _vo_scan, _stitching],
    ids=["build_frame", "track_frames", "vo_scan", "stitching"],
)
def test_every_dot_is_highest(path):
    fn, args = path(small_cfg())
    dots, bad = _audit(fn, *args)
    assert dots, "no dot_general traced: the audit walked nothing"
    assert not bad, f"dot_general below HIGHEST at {sorted(set(bad))}"
