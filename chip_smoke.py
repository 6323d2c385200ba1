#!/usr/bin/env python3
"""Smoke test of the VO main path on a GPU, at full width (640x480, TUM fr1
calibration, 3 pyramid levels, default capacities).

    python chip_smoke.py             # one GPU: every single-card phase
    python chip_smoke.py --chips 4   # four GPUs: the multi-device paths only

Phases (one GPU):
  1 device      require a GPU (no CPU fallback); print card and JAX facts
  2 inputs      render a seeded 16-frame 640x480 synthetic sequence
  3 host loop   VOSystem through run.track_synthetic (the --synthetic path)
  4 scan        vo_scan on the same frames, vo_scan_batched at B=8 (vmap)
  5 reference   the same jnp code on the CPU backend, compared per stage
  6 gpu tests   ``pytest -m gpu -n 0 tests/`` in its own process, with
                JAX_PLATFORMS=cuda,cpu
  7 report      memory analysis, compile time, steady per-frame times

With ``--chips 4`` only the multi-device paths run, each against its
single-card result: vo_scan_batched over a ("seq",) mesh,
track_long_sequence with four segments, and pipeline_replay on two cards.
That phase runs with XLA's GEMM autotuning off (MULTI_XLA_FLAGS), so that
both sides of each comparison use the same algorithms.

The parent process never imports JAX: each phase group runs in a child
process, one after another, so one process holds the card at a time.  Any
failed phase makes the script exit non-zero without printing a result.
The last line of standard output is the JSON result.

``check_main`` and ``check_multichip`` hold the phases' work for any
configuration and device; tests/test_chip_smoke.py runs them on the CPU at
160x120.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 16  # rendered frames of the single-card phases
N_FRAMES_MULTI = 17  # (N - 1) divisible by the four segments
BATCH = 8

# Phase 5 tolerances (GPU against the CPU backend, f32 both).
EDGE_FRAC_MAX = 1e-3  # differing edge pixels per level
DT_MAX_PX = 1e-4  # keyframe DT / gradient tables from the same edges
SYSTEM_RTOL = 1e-4  # 6x6 normal equations, max|delta| / max|ref|
POSE_T_MAX_M = 1e-3  # tracked translation per frame
POSE_R_MAX_DEG = 0.05  # tracked rotation per frame
ATE_SLACK_M = 5e-4  # GPU ATE <= CPU ATE + slack
HOST_SCAN_ATOL = 5e-4  # host loop against the scan twin (tests/test_batch)
MULTI_POSE_MAX_M = 1e-6  # multi-card against single-card translations
# XLA's autotuner picks GEMM algorithms by timing them at compile time, and
# that choice alone moves a 14-frame scan's poses by up to ~4e-6 m on the
# H100 (PERF.md); the multi-card phase fixes it so that it compares the
# sharding alone.
MULTI_XLA_FLAGS = "--xla_gpu_autotune_level=0"


def card_facts() -> str:
    """``name, power.limit`` of every card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def require_gpu(devices) -> dict:
    """The device facts of ``devices`` (``jax.devices()``); raises
    SystemExit unless they are GPUs."""
    d0 = devices[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {d0.platform!r}, "
            f"kind {d0.device_kind!r}); refusing to run on it"
        )
    return {
        "platform": d0.platform,
        "kind": d0.device_kind,
        "count": len(devices),
    }


# --------------------------------------------------------------------------
# Child-process phases (these import JAX).


def _setup() -> None:
    """Phase 1: device check (a GPU or SystemExit) and compile cache."""
    import jax

    from revo_tpu.utils.compile_cache import enable_compile_cache

    dev = require_gpu(jax.devices())
    cache = enable_compile_cache()
    print(f"[device] card: {card_facts()}")
    print(f"[device] platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} jax={jax.__version__}")
    print(f"[device] compile cache: {cache}; XLA_FLAGS: "
          f"{os.environ.get('XLA_FLAGS') or '(none)'}")
    print(f"[device] default matmul precision: "
          f"{jax.config.jax_default_matmul_precision or 'default'} "
          "(pose, solver and selector dots ask for HIGHEST explicitly)")
    print("@@device " + json.dumps(dev), flush=True)


def _render(cfg, n: int, workers: int | None = None):
    """Phase 2: a seeded synthetic sequence rendered in parallel."""
    import numpy as np

    from revo_tpu.io.synthetic import SyntheticScene, render_trajectory_parallel

    t0 = time.perf_counter()
    scene = SyntheticScene()
    traj = scene.trajectory(n, seed=0)
    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 1))
    rendered = render_trajectory_parallel(
        scene, cfg.camera, traj, seed=0, workers=workers
    )
    grays = np.stack([r[0] for r in rendered])
    depths = np.stack([r[1] for r in rendered])
    gt = np.stack([r[2] for r in rendered])
    print(f"[inputs] {n} frames {grays.shape[2]}x{grays.shape[1]} rendered "
          f"in {time.perf_counter() - t0:.1f} s ({workers} workers)")
    return rendered, grays, depths, gt


def _check(label: str, value: float, bound: float, failures: list,
           fmt: str = ".3e") -> None:
    ok = bool(value <= bound)
    print(f"[{label}] {value:{fmt}} <= {bound:{fmt}} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(label)


def _rot_deg(Ra, Rb):
    import numpy as np

    # Chord form, exact for small angles: |Ra - Rb|_F = 2 sqrt(2) sin(a/2).
    chord = np.linalg.norm(
        np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1)
    )
    return np.degrees(2.0 * np.arcsin(np.clip(chord / np.sqrt(8.0), 0, 1)))


def _vo_step_fn():
    import functools

    import jax

    from revo_tpu import tracker
    from revo_tpu.frontend import build_frame

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def vo_step(gray, depth, kf, R0, t0, cfg):
        return tracker.track_frames(kf, build_frame(gray, depth, cfg), R0, t0,
                                    cfg)

    return vo_step


def check_main(cfg, out_dir: str, workers: int | None = None) -> list:
    """Phases 2-5 and 7 under ``cfg`` on ``jax.devices()[0]``, against the
    CPU backend; returns the names of the failed checks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from revo_tpu import ops, solver
    from revo_tpu.eval import absolute_trajectory_error, relative_pose_error
    from revo_tpu.frontend import build_frame, make_keyframe
    from revo_tpu.parallel.batch import vo_scan, vo_scan_batched
    from revo_tpu.run import track_synthetic

    failures: list = []
    rendered, grays, depths, gt = _render(cfg, N_FRAMES, workers)

    # -- 3: host loop through the CLI's synthetic path.
    t0 = time.perf_counter()
    poses_host, _, ate, rpe = track_synthetic(cfg, rendered, out_dir)
    print(f"[host] {len(poses_host)} frames in "
          f"{time.perf_counter() - t0:.1f} s (compiles included); "
          f"ATE {ate.rmse * 1000:.3f} mm, RPE {rpe.trans_rmse * 1000:.3f} mm"
          f" / {rpe.rot_rmse_deg:.4f} deg per frame")
    if not np.all(np.isfinite(poses_host)):
        failures.append("host_finite")
    _check("host ATE m", ate.rmse, 0.02, failures)

    # -- 4: scan twin and batched scan.
    g_dev, d_dev = jnp.asarray(grays), jnp.asarray(depths)
    poses_scan = np.asarray(vo_scan(g_dev, d_dev, cfg)[0])
    _check("scan vs host max|dT|", float(np.abs(poses_scan - poses_host).max()),
           HOST_SCAN_ATOL, failures)
    length = N_FRAMES - BATCH + 1  # phase-shifted windows, no wrap-around
    gb = jnp.stack([g_dev[b:b + length] for b in range(BATCH)])
    db = jnp.stack([d_dev[b:b + length] for b in range(BATCH)])
    poses_b = np.asarray(vo_scan_batched(gb, db, cfg))
    if poses_b.shape != (BATCH, length, 4, 4) or not np.all(
        np.isfinite(poses_b)
    ):
        failures.append("batch_shape")
    _check("batch lane 0 vs scan max|dT|",
           float(np.abs(poses_b[0] - poses_scan[:length]).max()),
           HOST_SCAN_ATOL, failures)
    lane_ate = [
        absolute_trajectory_error(
            poses_b[b], np.linalg.inv(gt[b]) @ gt[b:b + length]
        ).rmse
        for b in range(BATCH)
    ]
    print(f"[batch] B={BATCH} x {length} frames, lane ATE mm "
          f"{[round(a * 1000, 3) for a in lane_ate]}")
    _check("batch worst lane ATE m", max(lane_ate), 0.02, failures)

    # -- 5: against the same jnp code on the CPU backend.
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    vo_step = _vo_step_fn()

    def run_on(dev, fn, *args, **kw):
        with jax.default_device(dev):
            args = jax.device_put(args, dev)
            return jax.device_get(fn(*args, **kw))

    frames = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        frames[name] = [
            run_on(dev, build_frame, grays[i], depths[i], cfg=cfg)
            for i in range(4)
        ]
    worst_frac = 0.0
    for lvl in range(cfg.pyramid.n_levels):
        for key in ("edges_orig", "edges"):
            diffs = [
                int(np.sum(getattr(frames["gpu"][i].levels[lvl], key)
                           != getattr(frames["cpu"][i].levels[lvl], key)))
                for i in range(4)
            ]
            npx = frames["cpu"][0].levels[lvl].edges.size
            frac = max(diffs) / npx
            worst_frac = max(worst_frac, frac)
            print(f"[ref] level {lvl} {key}: differing pixels per frame "
                  f"{diffs} of {npx}")
    _check("ref edge pixel fraction", worst_frac, EDGE_FRAC_MAX, failures)

    worst_dt = 0.0
    for lvl in range(cfg.pyramid.n_levels):
        edges = frames["cpu"][0].levels[lvl].edges
        s_g = run_on(gpu, ops.keyframe_structure, edges)
        s_c = run_on(cpu, ops.keyframe_structure, edges)
        worst_dt = max(worst_dt, float(np.abs(s_g - s_c).max()))
    _check("ref DT/gradient max|d| px", worst_dt, DT_MAX_PX, failures)

    opt = cfg.tracker.optimizer
    cam0 = cfg.camera_pyramid()[0]
    struct = np.asarray(run_on(cpu, ops.keyframe_structure,
                               frames["cpu"][0].levels[0].edges))
    quad = run_on(cpu, ops.quad_structure, struct, form=opt.quad_form)
    cloud = frames["cpu"][1].levels[0].cloud
    T01 = np.linalg.inv(gt[0]) @ gt[1]
    R1 = np.asarray(T01[:3, :3], np.float32)
    t1 = np.asarray(T01[:3, 3], np.float32)

    def system(q, c, R, t):
        return solver.residual_system(
            q, c, cam0, R, t, opt.edge_distance_lvl[0], opt.huber_edge,
            opt.use_edge_filter, bilinear_impl=opt.bilinear_impl,
        )

    sys_g = run_on(gpu, jax.jit(system), quad, cloud, R1, t1)
    sys_c = run_on(cpu, jax.jit(system), quad, cloud, R1, t1)
    for name in ("A", "g"):
        a, b = getattr(sys_g, name), getattr(sys_c, name)
        _check(f"ref normal equations {name} max|d|/max|ref|",
               float(np.abs(a - b).max() / np.abs(b).max()), SYSTEM_RTOL,
               failures)

    est = {}
    for name, dev in (("gpu", gpu), ("cpu", cpu)):
        kf = run_on(dev, make_keyframe, frames[name][0],
                    np.eye(4, dtype=np.float32), cfg=cfg)
        R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        out = [np.eye(4)]
        for i in range(1, 4):
            res = run_on(dev, vo_step, grays[i], depths[i], kf, R, t, cfg=cfg)
            R, t = res.R, res.t
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, t
            out.append(T)
        est[name] = np.stack(out)
    dt_m = np.linalg.norm(est["gpu"][:, :3, 3] - est["cpu"][:, :3, 3], axis=-1)
    dr = _rot_deg(est["gpu"][:, :3, :3], est["cpu"][:, :3, :3])
    print(f"[ref] per-frame pose |dt| mm {np.round(dt_m * 1000, 6).tolist()}"
          f", |dR| deg {np.round(dr, 6).tolist()}")
    _check("ref pose translation m", float(dt_m.max()), POSE_T_MAX_M, failures)
    _check("ref pose rotation deg", float(dr.max()), POSE_R_MAX_DEG, failures)
    ate_g = absolute_trajectory_error(est["gpu"], gt[:4]).rmse
    ate_c = absolute_trajectory_error(est["cpu"], gt[:4]).rmse
    print(f"[ref] ATE frames 0-3: gpu {ate_g * 1000:.4f} mm, "
          f"cpu {ate_c * 1000:.4f} mm")
    _check("ref ATE gpu - cpu m", ate_g - ate_c, ATE_SLACK_M, failures)

    # -- 7: report.
    _report(cfg, grays, depths, vo_step)
    return failures


def phase_main(out_dir: str) -> int:
    from revo_tpu.config import SystemConfig

    _setup()
    failures = check_main(SystemConfig(), out_dir)
    if failures:
        print(f"[main] FAILED: {failures}")
        return 1
    return 0


def _time_calls(fn, n: int):
    import jax

    out = fn()
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) * 1000.0)
    return ts


def _report(cfg, grays, depths, vo_step):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from revo_tpu.frontend import build_frame, make_keyframe

    card = card_facts()
    g = jnp.asarray(grays.astype(np.uint8))
    d = jnp.asarray(
        (depths * cfg.dataset.depth_scale_factor).astype(np.uint16)
    )
    kf = make_keyframe(build_frame(g[0], d[0], cfg), jnp.eye(4), cfg)
    R0, t0 = jnp.eye(3), jnp.zeros(3)
    t_c = time.perf_counter()
    lowered = vo_step.lower(g[1], d[1], kf, R0, t0, cfg=cfg)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t_c
    mem = compiled.memory_analysis()
    print(f"[report] card: {card}")
    print(f"[report] per-frame step (uint8 gray + uint16 depth -> pose) "
          f"compile {compile_s:.2f} s")
    if mem is not None:
        print(f"[report] memory: arguments {mem.argument_size_in_bytes} B, "
              f"outputs {mem.output_size_in_bytes} B, temporaries "
              f"{mem.temp_size_in_bytes} B, generated code "
              f"{mem.generated_code_size_in_bytes} B")
    n = len(grays)
    i = [1]

    def one():
        i[0] = i[0] % (n - 1) + 1
        return compiled(g[i[0]], d[i[0]], kf, R0, t0)

    ms1 = _time_calls(one, 2 * n)
    vstep = jax.jit(jax.vmap(
        lambda gg, dd, k, R, t: vo_step(gg, dd, k, R, t, cfg=cfg)
    ))
    kfb = jax.tree.map(lambda x: jnp.stack([x] * BATCH), kf)
    gb = jnp.stack([g[1 + b % (n - 1)] for b in range(BATCH)])
    db = jnp.stack([d[1 + b % (n - 1)] for b in range(BATCH)])
    Rb = jnp.stack([R0] * BATCH)
    tb = jnp.stack([t0] * BATCH)
    ms8 = _time_calls(lambda: vstep(gb, db, kfb, Rb, tb), 12)
    p1 = np.percentile(ms1, [50, 99])
    p8 = np.percentile(ms8, [50, 99])
    print(f"[report] B=1 per-frame step ms p50 {p1[0]:.3f} p99 {p1[1]:.3f} "
          f"(n={len(ms1)}; {card})")
    print(f"[report] B={BATCH} batched step ms p50 {p8[0]:.3f} p99 "
          f"{p8[1]:.3f}, per frame {p8[0] / BATCH:.3f} (n={len(ms8)}; {card})")


def check_multichip(cfg, devs, workers: int | None = None) -> list:
    """The multi-device paths under ``cfg`` on four devices ``devs``, each
    against its one-device result; returns the names of the failed
    checks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from revo_tpu.parallel.batch import vo_scan_batched
    from revo_tpu.parallel.mesh import make_mesh
    from revo_tpu.parallel.pipeline import pipeline_replay
    from revo_tpu.parallel.segments import track_long_sequence

    failures: list = []
    _, grays, depths, _ = _render(cfg, N_FRAMES_MULTI, workers)
    d0 = devs[0]
    mesh = make_mesh(("seq",), devices=devs)
    one_card = make_mesh(("seq",), devices=[d0])

    def tdiff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.abs(a[..., :3, 3] - b[..., :3, 3]).max(axis=(-2, -1))

    # vo_scan_batched: one sequence per card vs the same program on a
    # one-card mesh (the four sequences in turn on card 0).
    length = N_FRAMES_MULTI - 4 + 1
    gb = np.stack([grays[b:b + length] for b in range(4)])
    db = np.stack([depths[b:b + length] for b in range(4)])
    sharded = vo_scan_batched(jnp.asarray(gb), jnp.asarray(db), cfg, mesh=mesh)
    with jax.default_device(d0):
        single = vo_scan_batched(
            jax.device_put(gb, d0), jax.device_put(db, d0), cfg,
            mesh=one_card,
        )
    per_seq = tdiff(sharded, single)
    print(f"[multi] vo_scan_batched per-sequence max|dt| m "
          f"{per_seq.tolist()}")
    _check("multi vo_scan_batched mesh vs 1 card m", float(per_seq.max()),
           MULTI_POSE_MAX_M, failures)

    # track_long_sequence: four segments on four cards vs the same program
    # on a one-card mesh (all four segments in turn on card 0).
    g_all, d_all = jnp.asarray(grays), jnp.asarray(depths)
    seg_mesh = track_long_sequence(g_all, d_all, cfg, n_segments=4, mesh=mesh)
    with jax.default_device(d0):
        seg_one = track_long_sequence(
            jax.device_put(grays, d0), jax.device_put(depths, d0), cfg,
            n_segments=4, mesh=one_card,
        )
    _check("multi track_long_sequence mesh vs 1 card m",
           float(tdiff(seg_mesh, seg_one)), MULTI_POSE_MAX_M, failures)

    # pipeline_replay: build on card 0, solve on card 1 vs both on card 0.
    p2, _ = pipeline_replay(grays, depths, cfg, devices=devs[:2])
    p1, _ = pipeline_replay(grays, depths, cfg, devices=[d0])
    _check("multi pipeline_replay 2 cards vs 1 card m",
           float(tdiff(p2, p1).max()), MULTI_POSE_MAX_M, failures)
    return failures


def phase_multichip() -> int:
    import jax

    from revo_tpu.config import SystemConfig

    _setup()
    devs = jax.devices()[:4]
    if len(devs) < 4:
        print(f"[multi] need 4 devices, found {len(devs)}")
        return 1
    failures = check_multichip(SystemConfig(), devs)
    if failures:
        print(f"[multi] FAILED: {failures}")
        return 1
    return 0


# --------------------------------------------------------------------------
# Parent process (no JAX).


def _run_child(argv, env=None) -> tuple:
    """Run a child, relay its output; returns (returncode, device dict)."""
    dev = None
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=None, text=True, cwd=HERE,
        env=env,
    )
    for line in proc.stdout:
        if line.startswith("@@device "):
            dev = json.loads(line[len("@@device "):])
            continue
        sys.stdout.write(line)
        sys.stdout.flush()
    return proc.wait(), dev


def _gpu_tests() -> int:
    """Phase 6: the card-only tests, one process, no xdist workers."""
    import tempfile
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
        rc, _ = _run_child(
            [sys.executable, "-m", "pytest", "-m", "gpu", "-n", "0",
             "-q", "-p", "no:cacheprovider", f"--junitxml={xml}", "tests/"],
            env=env,
        )
        try:
            suite = ET.parse(xml).getroot()
            suite = suite if suite.tag == "testsuite" else suite[0]
            n = int(suite.get("tests", 0))
            bad = int(suite.get("failures", 0)) + int(suite.get("errors", 0))
            skipped = int(suite.get("skipped", 0))
        except (OSError, ET.ParseError, IndexError):
            print("[gpu tests] no junit report")
            return 1
    passed = n - bad - skipped
    print(f"[gpu tests] passed {passed}, failed {bad}, skipped {skipped} "
          f"(pytest rc {rc})")
    return 0 if (rc == 0 and bad == 0 and passed > 0) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--phase", choices=("main", "multichip"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(HERE, "runs", "chip_smoke"),
                    help="directory for the host loop's poses and plots")
    args = ap.parse_args(argv)

    if args.phase:  # child process
        os.makedirs(args.out, exist_ok=True)
        if args.phase == "main":
            return phase_main(args.out)
        return phase_multichip()

    t_start = time.perf_counter()
    child = [sys.executable, os.path.abspath(__file__), "--out", args.out]
    phase = "multichip" if args.chips == 4 else "main"
    env = None
    if phase == "multichip":
        flags = os.environ.get("XLA_FLAGS", "")
        env = dict(os.environ, XLA_FLAGS=f"{flags} {MULTI_XLA_FLAGS}".strip())
    rc, dev = _run_child(child + ["--phase", phase], env=env)
    if rc != 0 or dev is None:
        print(f"chip_smoke: phase {phase} failed (exit {rc})")
        return rc or 1
    if args.chips == 1 and _gpu_tests() != 0:
        print("chip_smoke: gpu tests failed")
        return 1
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.0f} s")
    print(f"card: {card_facts()}")
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
