"""Probe: ATE vs deliberate capacity decimation.

The rank compaction decimates uniformly when edge count > capacity
(ops/backproject.py), and solver gather cost is per-index — so capacity
below the fitted count is a free spatial subsampler.  Measure how far we
can push it before the accuracy gates notice.

Runs on the CPU backend (pinned below).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))

from revo_tpu.autotune import calibrate_capacities
from revo_tpu.config import SystemConfig
from revo_tpu.eval import absolute_trajectory_error
from revo_tpu.io.synthetic import (
    SyntheticScene,
    box_scene,
    render_sequence,
)
from revo_tpu.system import VOSystem


def run(cfg, frames):
    vo = VOSystem(cfg)
    est, gt = [], []
    for gray, depth, T, ts in frames:
        est.append(vo.process_frame(gray, depth, ts))
        gt.append(T)
    ate = absolute_trajectory_error(np.stack(est), np.stack(gt))
    return ate.rmse, vo.n_tracking_lost


def main():
    scales = [1.10, 0.75, 0.50, 0.35, 0.25]
    # --- full-res gate scene (the 640x480 CI gate) ---
    base = SystemConfig()
    scene = box_scene()
    frames = list(render_sequence(scene, base.camera, 22, seed=2))
    grays = [f[0] for f in frames[:2]]
    depths = [f[1] for f in frames[:2]]
    for s in scales:
        cfg = calibrate_capacities(base, grays, depths, margin=s)
        t0 = time.time()
        rmse, lost = run(cfg, frames)
        print(
            f"640x480 box  scale={s:.2f} caps={cfg.pyramid.edge_capacity} "
            f"ATE={rmse*100:.3f} cm lost={lost} ({time.time()-t0:.0f}s)",
            flush=True,
        )
    # --- small multi-seed plane family ---
    from test_solver import small_cfg

    sb = small_cfg()
    scn = SyntheticScene()
    for s in scales:
        rmses = []
        lost_tot = 0
        for seed in range(4):
            frames = list(render_sequence(scn, sb.camera, 40, seed=seed))
            cfg = calibrate_capacities(
                sb, [frames[0][0]], [frames[0][1]], margin=s
            )
            rmse, lost = run(cfg, frames)
            rmses.append(rmse)
            lost_tot += lost
        print(
            f"160x120 plane scale={s:.2f} ATE cm "
            f"{[round(r*100,3) for r in rmses]} lost={lost_tot}",
            flush=True,
        )


if __name__ == "__main__":
    main()
