#!/usr/bin/env python3
"""Where the per-frame front end spends its device time on a GPU.

Times ``build_frame`` (pyramid + Canny + fill-in + edge clouds) and the
build + track step at 640x480 for B=1 and B=8 (vmap), each with the Canny
hysteresis as the Triton tile kernel (what ``ops.canny`` runs on a GPU) and
as the XLA while loop (``ops.hysteresis``, the baseline), in turns; times
Canny alone per pyramid level with both; and reads the hysteresis' share of
``build_frame``'s device time from a ``jax.profiler`` trace.  Device events
are attributed to name scopes through the ``op_name`` metadata of the
compiled HLO (``canny_hysteresis`` and ``canny_nms`` are set in
``ops/canny.py``).

    python scripts/frontend_profile.py [--out runs/frontend]

Prints one line per measurement with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_facts, require_gpu  # noqa: E402


def _median_ms(fn, n: int = 20) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(ts))


_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = (.*)$")
_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)[ (].*\{\s*$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"(?:calls|body|condition|to_apply)=%?([\w.\-]+)")


def op_names(hlo_text: str) -> dict:
    """Instruction name -> the op_name metadata it carries, joined with
    the op_names inside any computation it calls (a fusion's fused ops),
    of a compiled HLO module."""
    own, calls, comp_ops = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and not line.startswith(" "):
            comp = m.group(1)
            comp_ops.setdefault(comp, [])
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, rest = m.groups()
        meta = _OPNAME.search(rest)
        own[name] = meta.group(1) if meta else ""
        calls[name] = _CALLS.findall(rest)
        if comp is not None and meta:
            comp_ops[comp].append(meta.group(1))
    return {
        n: " ".join(
            [own[n]] + [o for c in calls[n] for o in comp_ops.get(c, [])]
        )
        for n in own
    }


def device_time_by_scope(trace_dir: str, names: dict, scopes) -> dict:
    """Sum device event durations (ns) of one traced module by name scope.

    ``names`` maps HLO instruction names to their op_name metadata; an
    event counts toward the first scope its op_names contain (so a fused
    kernel that holds any hysteresis op counts as hysteresis), else
    ``other``; a Pallas kernel counts toward the scope its name carries.
    Events without an ``hlo_op`` stat (copies, memsets) count
    as ``unattributed``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    # Kernels launched from a CUDA graph carry hlo_op "command_buffer";
    # their event name is the fusion's name with "." and "-" as "_".
    by_kernel = {re.sub(r"[.\-]", "_", n): m for n, m in names.items()}
    totals = {s: 0 for s in scopes}
    totals.update(other=0, library=0, unattributed=0, events=0, busy=0)
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                dur = int(ev.duration_ns)
                spans.append((int(ev.start_ns), int(ev.start_ns) + dur))
                totals["events"] += 1
                if op is None:
                    totals["unattributed"] += dur
                    continue
                meta = names.get(op) if op != "command_buffer" else None
                if meta is None:
                    meta = by_kernel.get(ev.name)
                if meta is None:  # a named Pallas kernel, else a library one
                    meta = next((sc for sc in scopes if sc in ev.name), None)
                if meta is None:  # cuBLAS / CUTLASS and other library kernels
                    totals["library"] += dur
                    continue
                for s in scopes:
                    if s in meta:
                        totals[s] += dur
                        break
                else:
                    totals["other"] += dur
    end = 0
    for a, b in sorted(spans):  # union of busy intervals
        if b > end:
            totals["busy"] += b - max(a, end)
            end = b
    return totals


@contextlib.contextmanager
def hysteresis_impl(impl: str):
    """Trace ``ops.canny`` with its hysteresis as ``impl``: "triton" (the
    tile kernel it picks on a GPU) or "xla" (the ``ops.hysteresis`` while
    loop, the baseline the kernel has to beat).  Caches are cleared on
    entry and exit so no trace of the other form is reused."""
    import jax

    from revo_tpu import ops
    from revo_tpu.ops import hysteresis_triton as kernel

    saved = kernel.hysteresis_triton
    if impl == "xla":
        kernel.hysteresis_triton = ops.hysteresis
    jax.clear_caches()
    try:
        yield
    finally:
        kernel.hysteresis_triton = saved
        jax.clear_caches()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "frontend"),
                    help="directory for the traces and compiled HLO")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from revo_tpu import ops, tracker
    from revo_tpu.config import SystemConfig
    from revo_tpu.frontend import build_frame, make_keyframe
    from revo_tpu.io.synthetic import SyntheticScene, render_trajectory_parallel
    from revo_tpu.ops.hysteresis_triton import hysteresis_triton
    from revo_tpu.utils.compile_cache import enable_compile_cache

    require_gpu(jax.devices())
    enable_compile_cache()
    card = card_facts()
    print(f"card: {card}; jax {jax.__version__}")
    cfg = SystemConfig()
    scene = SyntheticScene()
    rendered = render_trajectory_parallel(
        scene, cfg.camera, scene.trajectory(9, seed=0), seed=0,
        workers=min(8, os.cpu_count() or 1),
    )
    g = jnp.asarray(np.stack([r[0] for r in rendered]).astype(np.uint8))
    d = jnp.asarray(
        (np.stack([r[1] for r in rendered])
         * cfg.dataset.depth_scale_factor).astype(np.uint16)
    )
    kf = make_keyframe(build_frame(g[0], d[0], cfg), jnp.eye(4), cfg)
    kfb = jax.tree.map(lambda a: jnp.stack([a] * 8), kf)

    def vo_step(gg, dd, k):
        f = build_frame(gg, dd, cfg)
        return tracker.track_frames(k, f, jnp.eye(3), jnp.zeros(3), cfg)

    scopes = ("canny_hysteresis", "canny_nms")
    edges_first = {}
    traced = set()
    # Interleaved (xla, triton, triton, xla) so drift in the card's clocks
    # falls on both forms alike.
    for impl in ("xla", "triton", "triton", "xla"):
        with hysteresis_impl(impl):
            for b in (1, 8):
                if b == 1:
                    fn = jax.jit(lambda gg, dd: build_frame(gg, dd, cfg))
                    step = jax.jit(vo_step)
                    x, xs = (g[0], d[0]), (g[1], d[1], kf)
                else:
                    fn = jax.jit(jax.vmap(
                        lambda gg, dd: build_frame(gg, dd, cfg)
                    ))
                    step = jax.jit(jax.vmap(vo_step))
                    x, xs = (g[:b], d[:b]), (g[1:b + 1], d[1:b + 1], kfb)
                compiled = fn.lower(*x).compile()
                hlo = compiled.as_text()
                if ("canny_hysteresis_tile" in hlo) != (impl == "triton"):
                    raise SystemExit(f"{impl}: wrong hysteresis lowered")
                edges = [np.asarray(lv.edges) for lv in compiled(*x).levels]
                ref = edges_first.setdefault(b, edges)
                ndiff = [int((e != r).sum()) for e, r in zip(edges, ref)]
                ms = _median_ms(lambda: compiled(*x))
                ms_step = _median_ms(lambda: step(*xs))
                print(f"[{impl}] B={b}: build_frame {ms:.4f} ms per call "
                      f"({ms / b:.4f} ms/frame), build+track step (frames "
                      f"1..{b} against keyframe 0) {ms_step:.4f} ms per "
                      f"call; edge pixels differing from the first run per "
                      f"level {ndiff} ({card})")
                if (impl, b) in traced:
                    continue
                traced.add((impl, b))
                tdir = os.path.join(args.out, f"trace_{impl}_b{b}")
                with jax.profiler.trace(tdir):
                    for _ in range(5):
                        jax.block_until_ready(compiled(*x))
                with open(os.path.join(tdir, "build_frame.hlo.txt"), "w") as f:
                    f.write(hlo)
                tot = device_time_by_scope(tdir, op_names(hlo), scopes)
                dev_ns = sum(tot[k] for k in scopes) + tot["other"] + tot[
                    "library"] + tot["unattributed"]
                share = tot["canny_hysteresis"] / max(dev_ns, 1)
                print(f"[{impl}] build_frame B={b} trace (5 calls): device "
                      f"{dev_ns / 5e6:.4f} ms/call over {tot['events']} "
                      f"events, busy {tot['busy'] / 5e6:.4f} ms/call; "
                      f"hysteresis {tot['canny_hysteresis'] / 5e6:.4f} ms "
                      f"({share:.1%}), nms {tot['canny_nms'] / 5e6:.4f} ms, "
                      f"library (cuBLAS) {tot['library'] / 5e6:.4f} ms, "
                      f"other {tot['other'] / 5e6:.4f} ms, unattributed "
                      f"{tot['unattributed'] / 5e6:.4f} ms ({card})")

    # Canny alone per pyramid level (pyramid images from build_frame), with
    # each hysteresis form called directly.
    fr = build_frame(g[0], d[0], cfg)
    nms = jax.jit(lambda a: ops.canny_candidates(a, 150.0, 100.0))
    forms = {"xla": ops.hysteresis, "triton": hysteresis_triton}
    for lvl, lv in enumerate(fr.levels):
        img = lv.gray
        imgs = jnp.stack([img] * 8)
        cells = [f"nms only {_median_ms(lambda: nms(img)):.4f} ms"]
        for impl, hyst in forms.items():
            def one(a, hyst=hyst):
                return hyst(*ops.canny_candidates(a, 150.0, 100.0))

            f1, f8 = jax.jit(one), jax.jit(jax.vmap(one))
            cells.append(f"{impl} B=1 {_median_ms(lambda: f1(img)):.4f} ms, "
                         f"B=8 {_median_ms(lambda: f8(imgs)):.4f} ms")
        print(f"canny level {lvl} {img.shape[1]}x{img.shape[0]}: "
              f"{'; '.join(cells)} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
