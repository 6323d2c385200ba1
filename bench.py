"""Benchmark: tracked frames/s of the flagship 640x480 tracking step.

Runs on a GPU and fails when JAX finds none (there is no CPU fallback).
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} with
the device (platform, device_kind, count) and the card's name and power
limit beside the numbers.

Protocol
- Render N synthetic 640x480 RGB-D frames (host, NumPy, in parallel) along
  a smooth trajectory with exact ground truth; build frames + a keyframe
  on device.
- Steady-state timing of the full per-frame tracking work (pyramid build +
  coarse-to-fine LM track) over the rendered inputs, after warmup.
- Every scan chain starts from the identity pose (deterministic per call)
  and the chain's final tracking error is asserted bounded, so a diverged
  run cannot post a number; the chain consumes a DIFFERENT frame per step
  (a loop-invariant frame lets XLA hoist the frame build and the solver
  re-track a converged pose).

Headline
- ``value`` is the default operating point: capacities at HEADLINE_MARGIN
  (the accuracy knee of the CPU sweep, scripts/probes/pareto_ate.py),
  batch of 8 sequences, scan-chained aggregate.  The exact-fit margin-1.10
  point is reported in labeled exactfit_* fields.  Both operating points
  carry their ATE in the JSON (ate_default_m / ate_exactfit_m), plus RPE
  and n=2 repeat spreads.

Baseline denominator
- ``vs_baseline`` divides by the single-core C++ oracle
  (native/revo_oracle.cpp): cv::Canny / cv::pyrDown /
  cv::distanceTransform(DIST_MASK_PRECISE) preprocessing + the reference
  LM tracker (optimizer.cpp:74-312) with LGSX.h-style vectorized
  accumulation, compiled -O3 — the stand-in for the reference's
  single-core C++/SSE speed (BASELINE.md).  The NumPy/OpenCV oracle is kept
  as a labeled secondary field.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


N_FRAMES = 8
N_TIMED = 24  # timed tracking calls (cycled over pre-built frames)
# The DEFAULT operating point: autotune margin at the knee of the CPU
# capacity-vs-ATE sweep (scripts/probes/pareto_ate.py) — capacity
# decimation is a free spatial subsampler until the edge set starves.  The
# exact-fit margin-1.10 accuracy-max point stays as labeled exactfit_*
# fields.
HEADLINE_MARGIN = float(os.environ.get("REVO_BENCH_MARGIN", "0.65"))
EXACTFIT_MARGIN = 1.10
# Soft budget: OPTIONAL metrics are skipped past this.  The headline
# section (knee-margin batch8 chained + its ATE) runs FIRST and is never
# budget-gated, so a cold compile can never cost the headline.
MAX_SECONDS = float(os.environ.get("REVO_BENCH_BUDGET", "470"))
MAX_CHAIN_ERROR = 5.0  # divergence guard on every timed chain (errors ~0.1)
_T_START = time.perf_counter()


def _budget_left() -> float:
    return MAX_SECONDS - (time.perf_counter() - _T_START)


def _build_inputs(cfg):
    """Render N synthetic frames (seed 0) in parallel on the host."""
    from revo_tpu.io.synthetic import SyntheticScene, render_trajectory_parallel

    scene = SyntheticScene()
    rendered = render_trajectory_parallel(
        scene, cfg.camera, scene.trajectory(N_FRAMES, seed=0), seed=0,
        workers=max(1, min(8, (os.cpu_count() or 2) - 1)),
    )
    grays = [r[0] for r in rendered]
    depths = [r[1] for r in rendered]
    gt_poses = np.stack([r[2] for r in rendered])  # (N, 4, 4) T_w_c, T0 = I
    return grays, depths, gt_poses


# --------------------------------------------------------------------------
# Shared chain scaffolding (used by the headline and exactfit sections and by
# scripts/probes/ab_table.py — the honest-chaining protocol lives HERE once).


def phase_stack(xs, B: int, chain: int):
    """(chain, B, H, W) stack where sequence b consumes frame (b+s) % N at
    scan step s: every sequence walks the real trajectory from its own
    phase, so no frame is loop-invariant under the scan."""
    import jax.numpy as jnp

    n = len(xs)
    return jnp.stack(
        [jnp.stack([xs[(b + s) % n] for b in range(B)]) for s in range(chain)]
    )


def chain_of(step):
    """jit a lax.scan chain of ``step(g, d, kf, R, t) -> TrackResult`` over
    per-step frames; outputs per-step (error, R, t) for ATE/divergence
    checks."""
    import jax

    @jax.jit
    def chained(gs, ds, k, R, t):
        def body(carry, gd):
            r = step(gd[0], gd[1], k, carry[0], carry[1])
            return (r.R, r.t), (r.error, r.R, r.t)

        return jax.lax.scan(body, (R, t), (gs, ds))

    return chained


def _check_chain(r, label: str):
    """Divergence guard: a chain whose final error is non-finite or huge
    must not post a throughput number (ADVICE r2)."""
    err = np.asarray(r[1][0])
    final = float(err.reshape(err.shape[0], -1)[-1].max())
    if not np.isfinite(final) or final > MAX_CHAIN_ERROR:
        raise RuntimeError(f"{label} chain diverged: final error {final}")


def _ate_m(r, gt_poses, lane: int | None = None) -> float:
    """RMSE translational ATE of a chain's tracked poses against ground
    truth.  The tracker returns T_keyframe<-current; the keyframe is frame
    0 with T_w_c0 = I, so tracked t compares directly with the ground-truth
    camera positions.  For a batched chain pass ``lane=0``: phase_stack
    gives lane 0 frames (0+s) % N = the plain trajectory, so its tracked
    poses align with gt_poses exactly like the single-sequence chain —
    the headline batch dispatch certifies its own accuracy."""
    ts = np.asarray(r[1][2])  # (chain, 3) or (chain, B, 3)
    if lane is not None:
        ts = ts[:, lane]
    gt = gt_poses[: ts.shape[0], :3, 3]
    return float(np.sqrt(np.mean(np.sum((ts - gt) ** 2, axis=-1))))


# Per-call spread of the most recent _time_chain, in ms/frame (half the
# max-min range across its timing calls) — the noise bar a reader needs to
# tell noise from a real change.
_LAST_SPREAD_MS: dict = {}


def _rpe_m(r, gt_poses, lane: int | None = None, delta: int = 1):
    """Translational RPE RMSE (m) of a chain's tracked poses — the second
    half of the reference's own acceptance protocol (TUM evaluate_rpe.py;
    the reference README.md:57), embedded in the artifact alongside ATE."""
    from revo_tpu.eval import relative_pose_error

    Rs = np.asarray(r[1][1])  # (chain, 3, 3) or (chain, B, 3, 3)
    ts = np.asarray(r[1][2])
    if lane is not None:
        Rs, ts = Rs[:, lane], ts[:, lane]
    n = Rs.shape[0]
    est = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    est[:, :3, :3] = Rs
    est[:, :3, 3] = ts
    res = relative_pose_error(est, gt_poses[:n].astype(np.float64), delta=delta)
    return res.trans_rmse


def _time_chain(chained, args, n_calls: int, frames_per_call: int, label: str):
    """Warm up, then time n_calls identical chain dispatches, each starting
    from the identity pose (deterministic work per call; ADVICE r2: no
    end-of-chain pose feedback that could silently early-exit the solver).
    Returns (fps, warmup_result); per-call spread lands in _LAST_SPREAD_MS.
    Each block of calls ends in block_until_ready."""
    import jax

    r = chained(*args)
    jax.block_until_ready(r)
    _check_chain(r, label)
    block_ms = []  # ms/frame per repeat block (pipelined inside a block)
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            r2 = chained(*args)
        jax.block_until_ready(r2)
        block_ms.append(
            (time.perf_counter() - t0) * 1000.0 / (n_calls * frames_per_call)
        )
    fps = 1000.0 / min(block_ms)  # best block
    _check_chain(r2, label)
    _LAST_SPREAD_MS[label] = round(abs(block_ms[0] - block_ms[1]) / 2.0, 3)
    return fps, r


# --------------------------------------------------------------------------


def _device_fps(cfg, grays, depths, gt_poses):
    """Default-operating-point measurements, HEADLINE FIRST: chained batch-8 (the
    operating point, with its lane-0 ATE), then chained single, then the
    cheap per-call/streaming sections.  ONE fused jit per frame step
    (pyramid build + coarse-to-fine track), frames shipped as uint8 gray +
    uint16 raw depth.  Only the trailing sections are budget-gated — a
    cold compile may eat the budget but never the headline."""
    import functools

    import jax
    import jax.numpy as jnp

    from revo_tpu import tracker
    from revo_tpu.frontend import build_frame, make_keyframe

    @functools.partial(jax.jit, static_argnames=("c",))
    def vo_step(gray_u8, depth_u16, kf, R0, t0, c):
        f = build_frame(gray_u8, depth_u16, c)
        return tracker.track_frames(kf, f, R0, t0, c)

    g_u8 = [g.astype(np.uint8) for g in grays]
    d_u16 = [
        (d * cfg.dataset.depth_scale_factor).astype(np.uint16) for d in depths
    ]

    f0 = build_frame(
        jax.device_put(g_u8[0]), jax.device_put(d_u16[0]), cfg
    )
    kf = make_keyframe(f0, jnp.eye(4), cfg)
    jax.block_until_ready(kf.structs)

    out = {"streaming_fps": None, "percall_fps": None, "scan_fps": None,
           "batch_fps": None, "batch_percall_fps": None, "ate_m": None,
           "ate_batch8_m": None, "latency_ms_p50": None,
           "latency_ms_p95": None, "latency_ms_p99": None,
           "rpe1_m": None, "rpe30_proxy_m": None,
           "batch_spread_ms": None, "single_spread_ms": None}

    g_dev = [jax.device_put(x) for x in g_u8]
    d_dev = [jax.device_put(x) for x in d_u16]
    jax.block_until_ready((g_dev, d_dev))

    # ---- HEADLINE: scan-chained batch-8 at the knee-margin capacities.  B
    # independent sequences stepped together under vmap, N steps per
    # dispatch (vo_scan_batched deployment mode); chaining amortizes the
    # per-dispatch overhead and measures the device's sustained rate.  Lane 0 of the phase-stacked chain walks the plain trajectory,
    # so the SAME dispatch that posts the number certifies its ATE.
    cfg_b = _batched_cfg(cfg)
    B = 8
    kfb = jax.tree.map(lambda x: jnp.stack([x] * B), kf)
    Rb = jnp.stack([jnp.eye(3)] * B)
    tb = jnp.stack([jnp.zeros(3)] * B)
    xb_g = phase_stack(g_dev, B, N_FRAMES)
    xb_d = phase_stack(d_dev, B, N_FRAMES)
    batched = chain_of(
        jax.vmap(lambda g, d, k, R, t: vo_step(g, d, k, R, t, cfg_b))
    )
    fps, r = _time_chain(
        batched, (xb_g, xb_d, kfb, Rb, tb), 3, B * N_FRAMES, "batch8"
    )
    out["batch_fps"] = fps
    out["ate_batch8_m"] = _ate_m(r, gt_poses, lane=0)
    out["batch_spread_ms"] = _LAST_SPREAD_MS.get("batch8")

    # ---- Scan-chained single sequence (replay mode, default LM solver):
    # its ATE is the reference-protocol accuracy of the default config.
    if _budget_left() > 100.0:
        xs_g = jnp.stack(g_dev)  # (CHAIN, H, W): the rendered trajectory
        xs_d = jnp.stack(d_dev)
        single = chain_of(lambda g, d, k, R, t: vo_step(g, d, k, R, t, cfg))
        n_calls = max(N_TIMED // N_FRAMES, 2)
        fps, r = _time_chain(
            single, (xs_g, xs_d, kf, jnp.eye(3), jnp.zeros(3)),
            n_calls, N_FRAMES, "single",
        )
        out["scan_fps"] = fps
        out["ate_m"] = _ate_m(r, gt_poses)
        out["single_spread_ms"] = _LAST_SPREAD_MS.get("single")
        # RPE (TUM protocol's second metric): per-frame delta, plus the
        # largest delta this 8-frame chain supports as the per-second
        # proxy (a true delta=30 needs the long refbench sequences —
        # REFBENCH.json carries those for both systems).
        out["rpe1_m"] = _rpe_m(r, gt_poses, delta=1)
        out["rpe30_proxy_m"] = _rpe_m(
            r, gt_poses, delta=min(N_FRAMES - 1, 30)
        )

    # ---- Per-call single sequence (host-dispatch mode), device-resident
    # frames.  Reuses the single vo_step executable compiled above (or
    # compiles it here if the single-chain section was skipped).
    if _budget_left() > 80.0:
        res = vo_step(g_dev[1], d_dev[1], kf, jnp.eye(3), jnp.zeros(3), cfg)
        jax.block_until_ready(res)
        t_start = time.perf_counter()
        for i in range(N_TIMED):
            res = vo_step(
                g_dev[i % N_FRAMES], d_dev[i % N_FRAMES], kf, res.R, res.t,
                cfg,
            )
        jax.block_until_ready(res)
        out["percall_fps"] = N_TIMED / (time.perf_counter() - t_start)

        # Streaming THROUGHPUT: host->device transfer every frame,
        # pipelined (one final sync).
        t_start = time.perf_counter()
        for i in range(N_TIMED):
            gg = jax.device_put(g_u8[i % N_FRAMES])
            dd = jax.device_put(d_u16[i % N_FRAMES])
            res = vo_step(gg, dd, kf, res.R, res.t, cfg)
        jax.block_until_ready(res)
        out["streaming_fps"] = N_TIMED / (time.perf_counter() - t_start)

        # Streaming LATENCY: fetch-synced each frame (the deployment
        # semantics: a live consumer needs the pose NOW) — honest
        # single-frame latencies, deliberately not pipelined.
        lat = []
        for i in range(12):
            t_f = time.perf_counter()
            gg = jax.device_put(g_u8[i % N_FRAMES])
            dd = jax.device_put(d_u16[i % N_FRAMES])
            res = vo_step(gg, dd, kf, res.R, res.t, cfg)
            jax.block_until_ready(res)
            lat.append((time.perf_counter() - t_f) * 1000.0)
        p = np.percentile(lat, [50.0, 95.0, 99.0])
        out["latency_ms_p50"], out["latency_ms_p95"], out["latency_ms_p99"] = (
            float(p[0]), float(p[1]), float(p[2]),
        )

    # ---- Batched per-call (one vmapped step per dispatch).
    if _budget_left() > 70.0:
        vstep = jax.jit(
            jax.vmap(lambda g, d, k, R, t: vo_step(g, d, k, R, t, cfg_b)),
        )
        gb = jnp.stack([g_dev[i % N_FRAMES] for i in range(B)])
        db = jnp.stack([d_dev[i % N_FRAMES] for i in range(B)])
        resb = vstep(gb, db, kfb, Rb, tb)
        jax.block_until_ready(resb)
        n_batch_steps = 8
        t_start = time.perf_counter()
        for _ in range(n_batch_steps):
            resb = vstep(gb, db, kfb, resb.R, resb.t)
        jax.block_until_ready(resb)
        out["batch_percall_fps"] = (
            B * n_batch_steps / (time.perf_counter() - t_start)
        )
    return out


def _batched_cfg(cfg):
    """Under vmap the reference LM's data-dependent while_loops run to the
    worst trip count across the batch, so batched paths use the
    fixed-iteration solver (ATE-parity gated in tests/test_solver_modes)."""
    import dataclasses

    return dataclasses.replace(
        cfg,
        tracker=dataclasses.replace(
            cfg.tracker,
            optimizer=dataclasses.replace(
                cfg.tracker.optimizer, solver="gn_fixed"
            ),
        ),
    )


def _margin_fps(cfg, grays, depths, gt_poses, margin: float):
    """A secondary labeled operating point at ``margin`` (the exact-fit
    accuracy-max point, margin 1.10).  Measures the single chain (default
    LM solver; gn_fixed is only required for the vmapped batch path), the
    batched chain, and the chain ATE."""
    import functools

    import jax
    import jax.numpy as jnp

    from revo_tpu import tracker
    from revo_tpu.autotune import calibrate_capacities
    from revo_tpu.frontend import build_frame, make_keyframe

    cfg = calibrate_capacities(cfg, grays[:2], depths[:2], margin=margin)

    @functools.partial(jax.jit, static_argnames=("c",))
    def vo_step(gray_u8, depth_u16, kf, R0, t0, c):
        f = build_frame(gray_u8, depth_u16, c)
        return tracker.track_frames(kf, f, R0, t0, c)

    g_u8 = [np.asarray(g, np.uint8) for g in grays]
    d_u16 = [
        (d * cfg.dataset.depth_scale_factor).astype(np.uint16) for d in depths
    ]
    f0 = build_frame(jax.device_put(g_u8[0]), jax.device_put(d_u16[0]), cfg)
    kf = make_keyframe(f0, jnp.eye(4), cfg)
    jax.block_until_ready(kf.structs)
    g_dev = [jax.device_put(x) for x in g_u8]
    d_dev = [jax.device_put(x) for x in d_u16]

    single = chain_of(lambda g, d, k, R, t: vo_step(g, d, k, R, t, cfg))
    xs_g = jnp.stack(g_dev)
    xs_d = jnp.stack(d_dev)
    n = max(N_TIMED // N_FRAMES, 2)
    single_fps, r = _time_chain(
        single, (xs_g, xs_d, kf, jnp.eye(3), jnp.zeros(3)),
        n, N_FRAMES, "secondary_single",
    )
    ate = _ate_m(r, gt_poses)

    if _budget_left() < 75.0:
        return single_fps, None, ate
    B = 8
    cfg_b = _batched_cfg(cfg)
    batched = chain_of(
        jax.vmap(lambda g, d, k, R, t: vo_step(g, d, k, R, t, cfg_b))
    )
    xb_g = phase_stack(g_dev, B, N_FRAMES)
    xb_d = phase_stack(d_dev, B, N_FRAMES)
    kfb = jax.tree.map(lambda x: jnp.stack([x] * B), kf)
    batch_fps, _ = _time_chain(
        batched,
        (xb_g, xb_d, kfb, jnp.stack([jnp.eye(3)] * B),
         jnp.stack([jnp.zeros(3)] * B)),
        3, B * N_FRAMES, "secondary_batch8",
    )
    return single_fps, batch_fps, ate


def _cpp_oracle_fps(cfg, grays, depths):
    """The honest baseline: single-core C++ oracle of the reference hot
    loop (native/revo_oracle.cpp; see module docstring).  Min per-frame
    time (the uncontended per-core speed — it shares the host with the
    thread that drives the device)."""
    from revo_tpu.io.native_oracle import oracle_available, oracle_run

    if not oracle_available():
        return None
    best, _, _, errs = oracle_run(cfg, grays, depths)
    if not np.all(np.isfinite(errs)) or float(errs.max()) > MAX_CHAIN_ERROR:
        return None  # oracle diverged; don't divide by a broken run
    return 1.0 / best


def _cpu_oracle_fps(cfg, grays, depths) -> float:
    """OpenCV + NumPy single-process implementation of the same per-frame
    pipeline (the round-1/2 denominator, kept as a labeled secondary)."""
    import cv2

    pyr = cfg.pyramid
    cams = cfg.camera_pyramid()

    def build(gray, depth):
        levels = []
        g, d = gray.astype(np.uint8), depth
        for lvl in range(pyr.n_levels):
            e = cv2.Canny(
                g, int(pyr.canny_threshold1), int(pyr.canny_threshold2),
                apertureSize=3, L2gradient=True,
            )
            cam = cams[lvl]
            ys, xs = np.nonzero(
                (e > 0) & (d > pyr.depth_min) & (d < pyr.depth_max)
            )
            z = d[ys, xs]
            pts = np.stack(
                [z * (xs - cam.cx) / cam.fx, z * (ys - cam.cy) / cam.fy, z], 1
            ).astype(np.float32)
            levels.append((e, pts))
            if lvl + 1 < pyr.n_levels:
                g = cv2.pyrDown(g)
                dd = d[: d.shape[0] // 2 * 2, : d.shape[1] // 2 * 2]
                blocks = dd.reshape(
                    dd.shape[0] // 2, 2, dd.shape[1] // 2, 2
                )
                cnt = (blocks > 0).sum((1, 3))
                tot = np.where(blocks > 0, blocks, 0).sum((1, 3))
                d = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0).astype(
                    np.float32
                )
        return levels

    def make_kf(levels):
        structs = []
        for e, _ in levels:
            dt = cv2.distanceTransform(
                255 - e, cv2.DIST_L2, cv2.DIST_MASK_PRECISE
            )
            gx = 0.5 * (np.roll(dt, 1, 1) - np.roll(dt, -1, 1))
            gy = 0.5 * (np.roll(dt, 1, 0) - np.roll(dt, -1, 0))
            structs.append(np.stack([gx, gy, dt], -1))
        return structs

    def track(structs, levels):
        opt = cfg.tracker.optimizer
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, dtype=np.float32)
        from revo_tpu import lie  # exp on host via jax cpu — negligible cost
        import jax.numpy as jnp

        for lvl in range(pyr.pyr_min_lvl, pyr.pyr_max_lvl - 1, -1):
            s = structs[lvl]
            pts = levels[lvl][1]
            cam = cams[lvl]
            last_err = np.inf
            for _ in range(opt.max_its_per_lvl[lvl]):
                w = pts @ R.T + t
                u = w[:, 0] / w[:, 2] * cam.fx + cam.cx
                v = w[:, 1] / w[:, 2] * cam.fy + cam.cy
                ok = (u > 1) & (v > 1) & (u < cam.width - 2) & (
                    v < cam.height - 2
                )
                ui, vi = u[ok].astype(int), v[ok].astype(int)
                du, dv = u[ok] - ui, v[ok] - vi
                s00 = s[vi, ui]
                s01 = s[vi, ui + 1]
                s10 = s[vi + 1, ui]
                s11 = s[vi + 1, ui + 1]
                samp = (
                    (du * dv)[:, None] * s11
                    + (dv - du * dv)[:, None] * s10
                    + (du - du * dv)[:, None] * s01
                    + (1 - du - dv + du * dv)[:, None] * s00
                )
                r = samp[:, 2]
                keep = r <= opt.edge_distance_lvl[lvl]
                r = r[keep]
                gx = cam.fx * samp[keep, 0]
                gy = cam.fy * samp[keep, 1]
                wk = w[ok][keep]
                wr = np.where(r <= opt.huber_edge, 1.0, opt.huber_edge / np.maximum(r, 1e-12))
                iz = 1.0 / wk[:, 2]
                iz2 = iz * iz
                J = np.stack(
                    [
                        iz * gx,
                        iz * gy,
                        -wk[:, 0] * iz2 * gx - wk[:, 1] * iz2 * gy,
                        -wk[:, 0] * wk[:, 1] * iz2 * gx
                        - (1 + wk[:, 1] ** 2 * iz2) * gy,
                        (1 + wk[:, 0] ** 2 * iz2) * gx
                        + wk[:, 0] * wk[:, 1] * iz2 * gy,
                        -wk[:, 1] * iz * gx + wk[:, 0] * iz * gy,
                    ],
                    1,
                )
                n = max(len(r), 1)
                A = (J * wr[:, None]).T @ J / n
                g = J.T @ (wr * r) / n
                err = float((wr * r * r).sum() / n)
                inc = np.linalg.solve(A + 1e-9 * np.eye(6), g)
                dR, dt_ = lie.exp_se3(jnp.asarray(inc, jnp.float32))
                Rn = np.asarray(dR) @ R
                tn = np.asarray(dR) @ t + np.asarray(dt_)
                if err >= last_err * 0.999:
                    break
                R, t, last_err = Rn, tn, err
        return R, t

    kf_levels = build(grays[0], depths[0])
    structs = make_kf(kf_levels)
    n = min(6, len(grays) - 1)
    # Per-frame MIN time: the oracle thread shares the host (and the GIL)
    # with the device-driving main thread, and contention only ever slows
    # it down — the fastest single frame is the uncontended per-core speed.
    best = np.inf
    for i in range(1, 1 + n):
        t0 = time.perf_counter()
        levels = build(grays[i], depths[i])
        track(structs, levels)
        best = min(best, time.perf_counter() - t0)
    return 1.0 / best


def main():
    import jax

    from chip_smoke import card_facts, require_gpu
    from revo_tpu.config import SystemConfig
    from revo_tpu.utils.compile_cache import enable_compile_cache

    device = require_gpu(jax.devices())  # no CPU fallback
    card = card_facts()
    print(f"[bench] {device}; card: {card}", flush=True)
    enable_compile_cache()

    cfg = SystemConfig()
    grays, depths, gt_poses = _build_inputs(cfg)

    # The C++ oracle runs first, single-threaded and uncontended (it takes
    # well under a second for 7 frames once built).
    cpp_fps = _cpp_oracle_fps(cfg, grays, depths)

    # Shape bucketing: size the fixed edge-cloud capacities to the scene
    # (revo_tpu.autotune) at the headline margin.  The deployment path
    # exposes this as --auto-capacity/--capacity-scale.
    from revo_tpu.autotune import calibrate_capacities

    cfg_base = cfg
    cfg = calibrate_capacities(
        cfg, grays[:2], depths[:2], margin=HEADLINE_MARGIN
    )

    # The NumPy oracle (secondary baseline) runs concurrently with the
    # device compiles, overlapping host time with the compile-bound cold
    # section.
    import threading

    oracle_out = {}

    def _oracle():
        try:
            oracle_out["fps"] = _cpu_oracle_fps(cfg, grays, depths)
        except ImportError:  # no OpenCV on this host: no secondary baseline
            oracle_out["fps"] = None

    th = threading.Thread(target=_oracle)
    th.start()
    exact = _device_fps(cfg, grays, depths, gt_poses)
    # The EXACT-FIT accuracy-max point (margin 1.10) as labeled secondary
    # fields — the round-1..4 headline operating point, kept measured now
    # that the default sits at the Pareto knee (see _margin_fps).
    ef_single_fps, ef_batch_fps, ate_exactfit = (None, None, None)
    if _budget_left() > 95.0:
        ef_single_fps, ef_batch_fps, ate_exactfit = _margin_fps(
            cfg_base, grays, depths, gt_poses, EXACTFIT_MARGIN
        )

    th.join()
    numpy_fps = oracle_out["fps"]

    # Headline = the DEFAULT operating point: Pareto-knee capacities,
    # batch8 chained aggregate (falling back to the knee single chain /
    # per-call when the budget cut the batch section).
    mtag = f"margin{HEADLINE_MARGIN:g}"
    if exact["batch_fps"] is not None:
        value, best_config = exact["batch_fps"], f"batch8_agg_{mtag}"
    elif exact["scan_fps"] is not None:
        value, best_config = exact["scan_fps"], f"single_seq_scan_{mtag}"
    else:
        value, best_config = exact["percall_fps"], "single_seq_percall"
    baseline_fps = cpp_fps if cpp_fps is not None else numpy_fps

    def _r(x):
        return round(x, 2) if x is not None else None

    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_s_640x480",
                "platform": device["platform"],
                "device_kind": device["kind"],
                "device_count": device["count"],
                "card": card,
                "value": _r(value),
                "unit": "frames/s",
                "best_config": best_config,
                "vs_baseline": (
                    _r(value / baseline_fps) if baseline_fps else None
                ),
                "baseline_cpp_fps": _r(cpp_fps),
                "baseline_numpy_oracle_fps": _r(numpy_fps),
                # ate_default_m: the default-solver single chain's ATE;
                # when that section was budget-skipped, lane 0 of the
                # headline batch chain (gn_fixed, ATE-parity gated) stands
                # in so the artifact always carries an accuracy number.
                "ate_default_m": (
                    round(exact["ate_m"], 5)
                    if exact["ate_m"] is not None
                    else (
                        round(exact["ate_batch8_m"], 5)
                        if exact["ate_batch8_m"] is not None
                        else None
                    )
                ),
                "ate_batch8_m": (
                    round(exact["ate_batch8_m"], 5)
                    if exact["ate_batch8_m"] is not None
                    else None
                ),
                "ate_exactfit_m": (
                    round(ate_exactfit, 5)
                    if ate_exactfit is not None else None
                ),
                # TUM protocol's second metric: per-frame
                # RPE of the default single chain; long-delta RPE for both
                # systems lives in REFBENCH.json (300-500-frame runs).
                "rpe1_default_m": (
                    round(exact["rpe1_m"], 6)
                    if exact["rpe1_m"] is not None else None
                ),
                "rpe7_default_m": (
                    round(exact["rpe30_proxy_m"], 6)
                    if exact["rpe30_proxy_m"] is not None else None
                ),
                "headline_margin": HEADLINE_MARGIN,
                "edge_capacity": list(cfg.pyramid.edge_capacity),
                "single_seq_fps": _r(exact["percall_fps"]),
                "single_seq_scan_fps": _r(exact["scan_fps"]),
                "batch8_agg_fps": _r(exact["batch_fps"]),
                "batch8_percall_fps": _r(exact["batch_percall_fps"]),
                "streaming_fps": _r(exact["streaming_fps"]),
                # Per-frame latency with the pose fetched every frame (the
                # live-consumer semantics); promotion / reloc frames
                # surface in p99.
                "latency_ms_p50": _r(exact["latency_ms_p50"]),
                "latency_ms_p95": _r(exact["latency_ms_p95"]),
                "latency_ms_p99": _r(exact["latency_ms_p99"]),
                # Real-time envelope vs the reference's 30 fps sensors
                # (realsensesensor.cpp:39-41): one frame per 33 ms,
                # including the host-to-device copy of each frame.
                "latency_p99_under_33ms": (
                    bool(exact["latency_ms_p99"] < 33.0)
                    if exact["latency_ms_p99"] is not None
                    else None
                ),
                # The replay deployment mode (device-resident scan): the
                # 30 fps real-time envelope on the sustained per-frame time.
                "replay_ms_per_frame": (
                    _r(1000.0 / exact["scan_fps"])
                    if exact["scan_fps"] is not None
                    else None
                ),
                "replay_under_33ms": (
                    bool(1000.0 / exact["scan_fps"] < 33.0)
                    if exact["scan_fps"] is not None
                    else None
                ),
                "exactfit_single_seq_scan_fps": _r(ef_single_fps),
                "exactfit_batch8_agg_fps": _r(ef_batch_fps),
                # Noise bars: n=2 repeat spread per chained section
                # (ms/frame, half the block range).
                "batch8_spread_ms": exact["batch_spread_ms"],
                "single_spread_ms": exact["single_spread_ms"],
            }
        )
    )


if __name__ == "__main__":
    main()
