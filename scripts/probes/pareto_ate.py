"""Pareto probe (accuracy side): capacity margin vs ATE across the full
stress battery.

For each autotune margin in {1.10, 0.80, 0.65, 0.50, 0.35}, runs the
accuracy families the CI gates cover: the four 160x120 scene families
(plane / box / column / box+depth-corruption), fast-pan, the combined
photometric sensor profile, the edge-sparse fill-in family, and the
640x480 full-resolution gate scene.  Frames render ONCE per family and
are reused across margins (capacity only changes the compiled caps).

Prints one JSON line per (margin, family).  CPU job:

    timeout 3000 python scripts/probes/pareto_ate.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), "..", "..", "tests")
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from revo_tpu.autotune import calibrate_capacities  # noqa: E402
from revo_tpu.config import SystemConfig  # noqa: E402
from revo_tpu.eval import absolute_trajectory_error  # noqa: E402
from revo_tpu.io.synthetic import (  # noqa: E402
    SyntheticScene,
    box_scene,
    column_scene,
    render_sequence,
    render_trajectory,
    sparse_scene,
)
from revo_tpu.system import VOSystem  # noqa: E402

MARGINS = [float(x) for x in (
    os.environ.get("PARETO_MARGINS") or "1.10 0.80 0.65 0.50 0.35"
).split()]

SENSOR_PROFILE = dict(
    image_noise=3.0, shot_noise=4.0, image_blur=0.5,
    exposure_drift=0.05, vignette=0.25,
)


def _families(small, full):
    """(name, cfg, frames) per family; frames rendered once, reused for
    every margin.  Mirrors the tests/test_scenes.py gate scenes."""
    fams = []

    def seq(scene, cfg, n, seed):
        return list(render_sequence(scene, cfg.camera, n, seed=seed))

    fams.append(("plane", small, seq(SyntheticScene(), small, 30, 5)))
    fams.append(("box", small, seq(box_scene(), small, 30, 3)))
    fams.append(("column", small, seq(column_scene(), small, 30, 4)))
    fams.append((
        "box_depth", small,
        seq(box_scene(depth_noise=0.04, depth_hole_frac=0.2), small, 30, 3),
    ))
    scene = box_scene()
    traj = scene.trajectory(30, seed=6, translation_step=0.03,
                            rotation_step=0.01)
    fams.append((
        "fastpan375", small,
        list(render_trajectory(scene, small.camera, traj, seed=6)),
    ))
    fams.append((
        "photometric", small,
        seq(box_scene(depth_noise=0.04, depth_hole_frac=0.2,
                      **SENSOR_PROFILE), small, 30, 3),
    ))
    fams.append(("sparse", small, seq(sparse_scene(), small, 30, 3)))
    fams.append(("full_640", full, seq(box_scene(), full, 22, 2)))
    return fams


def main():
    from test_solver import small_cfg

    fams = _families(small_cfg(), SystemConfig())
    for margin in MARGINS:
        for name, base, frames in fams:
            cfg = calibrate_capacities(
                base, [frames[0][0]], [frames[0][1]], margin=margin
            )
            vo = VOSystem(cfg)
            t0 = time.time()
            est, gt = [], []
            for gray, depth, T, ts in frames:
                est.append(vo.process_frame(gray, depth, ts))
                gt.append(T)
            ate = absolute_trajectory_error(np.stack(est), np.stack(gt))
            print(json.dumps({
                "margin": margin,
                "family": name,
                "caps": list(cfg.pyramid.edge_capacity),
                "ate_m": round(ate.rmse, 6),
                "lost": vo.n_tracking_lost,
                "keyframes": vo.n_keyframes,
                "run_s": round(time.time() - t0, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
