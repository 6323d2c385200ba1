"""Capacity auto-calibration: size the fixed edge-cloud shapes to the scene.

The reference keeps dynamically-sized edge clouds (imgpyramidrgbd.cpp:226);
jitted shapes are static, so `PyramidConfig.edge_capacity` pads every level
to a fixed lane count and the solver gathers (and masks) all of them.
Calibrating capacity to the scene's measured edge counts (plus margin)
removes the padded gather indices with identical tracking results as long
as no frame overflows (overflow degrades gracefully to the uniform stride
decimation, ops/backproject.py).

This is the "shape bucket" pattern: probe the data, pick a static shape,
jit once.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

from revo_tpu.config import SystemConfig


def fit_capacities(
    counts_per_level: Sequence[Sequence[int]],
    margin: float = 1.15,
    quantum: int = 256,
    minimum: int = 1024,
) -> Tuple[int, ...]:
    """Pick per-level capacities from observed per-frame edge counts.

    capacity = round_up(max_count * margin, quantum), at least ``minimum``.
    ``counts_per_level[lvl]`` is an iterable of observed counts for that
    pyramid level.

    ``margin`` doubles as the throughput/accuracy knob: margin > 1 leaves
    headroom so no frame ever decimates (tracking results bit-identical to
    unbounded capacity); margin < 1 deliberately undersizes the cloud so
    the rank compaction's uniform stride decimation subsamples the edge
    set every frame.  Solver gather cost is per-index, so time scales
    ~linearly with capacity (measured: margin 0.5 doubled batched
    aggregate fps, 1083 -> 2208 at B=8 640x480) while the accuracy gates
    degrade only fractionally (640x480 box ATE 0.059 -> 0.101 cm; all
    stress families sub-centimetre, scripts/probes/cap_{ate,robust}.py).
    The 0.5 operating point is accuracy-gated in tests/test_scenes.py and
    tests/test_autotune.py.
    """
    caps = []
    for counts in counts_per_level:
        counts = list(counts)
        if counts:
            want = max(minimum, int(max(int(c) for c in counts) * margin))
        else:
            want = minimum
        caps.append(-(-want // quantum) * quantum)
    return tuple(caps)


def probe_counts(cfg: SystemConfig, gray, depth):
    """Per-level valid-edge-point counts of one frame: the pyramid front
    end (canny + fill-in + validity predicate) WITHOUT the cloud
    compaction — a much smaller jit than build_frame, so calibration does
    not pay the full step compile twice."""
    import functools

    import jax
    import jax.numpy as jnp

    from revo_tpu import ops

    @functools.partial(jax.jit, static_argnames=("c",))
    def counts_fn(gray, depth, c):
        if gray.dtype != jnp.float32:
            gray = gray.astype(jnp.float32)
        if depth.dtype == jnp.uint16:
            depth = depth.astype(jnp.float32) * (
                1.0 / c.dataset.depth_scale_factor
            )
        pyr = c.pyramid
        out = []
        g, d = gray, depth
        prev = None
        for lvl in range(pyr.n_levels):
            src = ops.gaussian_blur(g) if pyr.gaussian_before_canny else g
            edges = ops.canny(src, pyr.canny_threshold1, pyr.canny_threshold2)
            patch = pyr.dist_patch_sizes[lvl]
            cnts, occ = ops.patch_histogram(edges, patch)
            if pyr.use_edge_hist and lvl > 0:
                filled = ops.fill_in_edges(
                    edges, prev, cnts, patch, pyr.dist_patch_sizes[lvl - 1]
                )
                edges = jnp.where(occ < pyr.n_percentage, filled, edges)
            valid = (
                edges
                & jnp.isfinite(d)
                & (d > pyr.depth_min)
                & (d < pyr.depth_max)
            )
            out.append(valid.sum().astype(jnp.int32))
            prev = edges
            if lvl + 1 < pyr.n_levels:
                g = ops.pyr_down(g)
                d = ops.subsample_depth_with_holes(d)
        return tuple(out)

    return [int(c) for c in counts_fn(jnp.asarray(gray), jnp.asarray(depth), cfg)]


def calibrate_capacities(
    cfg: SystemConfig,
    grays: Iterable,
    depths: Iterable,
    margin: float = 1.15,
    quantum: int = 256,
) -> SystemConfig:
    """Probe a few frames with ``cfg`` and return a config whose
    ``edge_capacity`` is fitted to the observed counts.

    Tracking output is unchanged whenever subsequent frames stay under the
    fitted capacities (masked pad lanes contribute exact zeros to the
    normal equations); frames that exceed them fall back to the stride
    decimation.  Pass 2-5 representative frames.
    """
    n_levels = cfg.pyramid.n_levels
    counts = [[] for _ in range(n_levels)]
    for g, d in zip(grays, depths):
        per = probe_counts(cfg, g, d)
        for lvl in range(n_levels):
            counts[lvl].append(per[lvl])
    caps = fit_capacities(counts, margin=margin, quantum=quantum)
    return dataclasses.replace(
        cfg, pyramid=dataclasses.replace(cfg.pyramid, edge_capacity=caps)
    )
