"""Probe: robustness of capacity decimation on the stress families —
fast motion (5x handheld), depth noise + holes, curved surfaces.

Pairs with cap_ate.py.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "tests"))

from revo_tpu.autotune import calibrate_capacities
from revo_tpu.eval import absolute_trajectory_error
from revo_tpu.io.synthetic import (
    box_scene,
    column_scene,
    render_sequence,
    render_trajectory,
)
from revo_tpu.system import VOSystem

from test_solver import small_cfg


def run(cfg, frames):
    vo = VOSystem(cfg)
    est, gt = [], []
    for gray, depth, T, ts in frames:
        est.append(vo.process_frame(gray, depth, ts))
        gt.append(T)
    ate = absolute_trajectory_error(np.stack(est), np.stack(gt))
    return ate.rmse, vo.n_tracking_lost


def cases():
    base = small_cfg()
    box = box_scene()
    traj5 = box.trajectory(40, seed=6, translation_step=0.04, rotation_step=0.015)
    yield "box-5x", base, box, list(
        render_trajectory(box, base.camera, traj5, seed=6)
    )
    noisy = box_scene(depth_noise=0.04, depth_hole_frac=0.2)
    yield "box-noise", base, noisy, list(
        render_sequence(noisy, base.camera, 30, seed=3)
    )
    col = column_scene()
    yield "columns", base, col, list(
        render_sequence(col, base.camera, 30, seed=4)
    )
    traj5c = col.trajectory(40, seed=6, translation_step=0.04, rotation_step=0.015)
    yield "col-5x", base, col, list(
        render_trajectory(col, base.camera, traj5c, seed=6)
    )


def main():
    for name, base, scene, frames in cases():
        for s in [1.10, 0.50, 0.35]:
            cfg = calibrate_capacities(
                base, [frames[0][0]], [frames[0][1]], margin=s
            )
            rmse, lost = run(cfg, frames)
            print(
                f"{name:10s} scale={s:.2f} caps={cfg.pyramid.edge_capacity} "
                f"ATE={rmse*100:.3f} cm lost={lost}",
                flush=True,
            )


if __name__ == "__main__":
    main()
