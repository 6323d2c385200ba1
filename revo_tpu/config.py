"""Configuration dataclasses of the REVO re-implementation.

Mirrors the reference's two-file YAML config split (algorithm settings +
dataset/sensor settings) parsed by ``REVOConfig`` (system.h:32-83),
``TrackerSettings`` (tracker.h:31-55), ``ImgPyramidSettings``
(camerapyr.h:27-89), ``IOWrapperSettings`` (iowrapperRGBD.h:41-153) and
``OptimizerSettings`` (optimizer.h:42-112), with per-key defaults identical to
the reference.  Everything is a frozen dataclass so configs hash cleanly as
jit static arguments; array-valued derived quantities live in separate pytrees.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics of the full-resolution camera (camerapyr.h:90-111)."""

    fx: float = 517.306408  # defaults: TUM freiburg1 (config/dataset_tum1.yaml)
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    width: int = 640
    height: int = 480
    # Radial/tangential distortion (k1, k2, p1, p2, k3); used only when
    # undistort=True (camerapyr.h:125-137).
    distortion: Tuple[float, float, float, float, float] = (0.0,) * 5

    def level(self, lvl: int) -> "CameraConfig":
        """Per-level intrinsics: scale = 2**-lvl (camerapyr.h:140-144).

        Note the reference scales cx,cy by the plain factor (no half-pixel
        shift), and truncates width/height.
        """
        s = 1.0 / (2 ** lvl)
        return dataclasses.replace(
            self,
            fx=self.fx * s,
            fy=self.fy * s,
            cx=self.cx * s,
            cy=self.cy * s,
            width=int(self.width * s),
            height=int(self.height * s),
        )


@dataclass(frozen=True)
class PyramidConfig:
    """Pyramid + edge-extraction settings (ImgPyramidSettings, camerapyr.h:27-89)."""

    canny_threshold1: float = 150.0  # camerapyr.h:40
    canny_threshold2: float = 100.0  # camerapyr.h:41
    gaussian_before_canny: bool = False  # DO_GAUSSIAN_SMOOTHING_BEFORE_CANNY
    depth_min: float = 0.1  # camerapyr.h:43
    depth_max: float = 5.2  # camerapyr.h:44
    pyr_min_lvl: int = 2  # coarsest level tracked (camerapyr.h:45)
    pyr_max_lvl: int = 0  # finest level tracked (camerapyr.h:46)
    undistort: bool = False
    use_edge_hist: bool = True  # BMVC17 edge fill-in (camerapyr.h:62)
    # Edge-cloud stream compaction: "scatter" = cumsum + per-pixel
    # scatter; "rank" = per-slot rank-select (block summaries located by a
    # scatter-bincount + ones-triangle matmul cumsum, depth fused into the
    # final (capacity,)-row take); "rank_sort" replaces the in-block
    # rank->position contraction with a lane sort keyed on the in-block
    # cumsum; "rank_sort2" packs the lane index into the sort key's low
    # byte (key*256 + lane, < 2^24 so f32-exact).  All four forms are
    # bit-identical (fuzz-gated in test_ops).  The default was chosen on a
    # previous accelerator; its GPU verdict is open (ROADMAP Y4).
    compaction: str = "rank_sort2"
    n_percentage: float = 0.3  # occupancy threshold for fill-in
    # Patch sizes of the per-level edge-occupancy histogram; "chosen in a way
    # that we always get 32x24 patches for 3 levels starting from 640x480"
    # (imgpyramidrgbd.cpp:50).
    dist_patch_sizes: Tuple[int, ...] = (20, 10, 5)
    # Fixed capacity of the per-level edge point cloud (static shapes;
    # replaces the dynamic leftCols() of imgpyramidrgbd.cpp:226).
    edge_capacity: Tuple[int, ...] = (16384, 8192, 4096)

    @property
    def n_levels(self) -> int:
        return self.pyr_min_lvl - self.pyr_max_lvl + 1  # camerapyr.h:68-71


@dataclass(frozen=True)
class OptimizerConfig:
    """LM/GN schedule (OptimizerSettings, optimizer.h:42-112)."""

    lambda_success_fac: float = 0.5  # optimizer.h:53
    lambda_fail_fac: float = 2.0  # optimizer.h:54
    lambda_initial: Tuple[float, ...] = (0.0,) * 6  # optimizer.h:63
    step_size_min: Tuple[float, ...] = (1e-16,) * 6  # optimizer.h:55
    convergence_eps: Tuple[float, ...] = (0.999,) * 6  # optimizer.h:65
    max_its_per_lvl: Tuple[int, ...] = (100,) * 6  # optimizer.h:56
    edge_distance_lvl: Tuple[float, ...] = (30, 20, 10, 5, 5, 5)  # optimizer.h:59
    max_inc_try: int = 10  # optimizer.h:69
    huber_edge: float = 0.3  # optimizer.h:75
    use_edge_filter: bool = True  # revo_settings.yaml USE_EDGE_FILTER
    # Solver implementation: "lm" reproduces the reference's data-dependent
    # accept/reject schedule (optimizer.cpp:250-307) with nested while_loops;
    # "gn_fixed" is the bounded fixed-iteration variant (SURVEY.md §7
    # design stance): one evaluation per iteration, where-gated accept, LM
    # damping halved/escalated — same fixed point, fewer device loop
    # iterations.  ATE parity is gated in tests/test_solver_modes.py.
    solver: str = "lm"
    # Per-level gn_fixed iteration counts, index 0 = finest.  The solve is
    # coarse-to-fine, so by the finest (most expensive) level the pose is
    # nearly converged: 6 iterations at L0 track as accurately as 12 on the
    # CPU ATE gates while saving the most costly evaluations.  Gated by the
    # gn-vs-lm parity battery (test_solver_modes).
    fixed_iters: Tuple[int, ...] = (6, 10, 12, 12, 12, 12)  # per level
    # Bilinear-sampling gather formulation for the residual pass: "quad"
    # (ONE row take from the keyframe's packed 2x2-neighborhood table),
    # "take4" (four row takes), "taps"/"window"/"pair" (lax.gather slice
    # forms); "quad_lf" routes the same quad sample through the lane-fold
    # custom_vmap take (interp._take_rows_lanefold), bit-identical to
    # "quad" (gated in test_ops).  The forms were tuned to a previous
    # accelerator's gather emitter; their GPU verdict is open (ROADMAP Y3).
    bilinear_impl: str = "quad_lf"
    # Storage layout of the packed quad table (ops.edt.quad_structure):
    # "hw12" (H, W, 12), "flat" (H*W, 12), "t" (12, H*W), "flat16"
    # (H*W, 16) padded, "flatbf" (H*W, 12) bfloat16, "dt4"/"dt4bf"
    # (H*W, 4) dt-only taps with the Jacobian gradient derived from the
    # bilinear dt surface (interp.bilinear_sample_dtquad).  Narrower rows
    # make the per-point gather cheaper.  Residuals are bit-identical
    # across forms (modulo bf16 rounding); dt4's surface gradient is the
    # exact GN linearization of the sampled interpolant and is ATE-parity
    # gated (test_solver_modes, test_ops).  "flatbf" remains the reference
    # central-difference-gradient form; f32 "flat" for exact-reference
    # numerics.
    quad_form: str = "dt4bf"
    # Lane-select form for the fold-hoisted batched solve (solver.
    # gn_level_fixed): with the B per-sequence dt4 tables pre-folded into
    # one shared operand outside the while loop, each vmapped lane must
    # pick its own sequence's 4 components per gathered row.  "onehot"
    # keeps the full (H*W, B*4) row per gather and selects with an exact
    # one-hot multiply-reduce (the row and the (N, B, 4) select grow with
    # B).  "flat" folds the lane into the gather index instead: table
    # reshaped (H*W*B, 4) outside the loop, row index = base*B + lane — one
    # 4-component row per point, no select.  Bit-identical (gated in
    # test_solver_modes); the GPU verdict is open (ROADMAP Y3, S4).
    lane_select: str = "onehot"
    # 6x6 damped-normal-equation solve: "ldlt" = unrolled pivot-free LDL^T
    # (straight-line code), "linalg" = jnp.linalg.solve (a general LU with
    # a pivoting loop).
    solve6_impl: str = "ldlt"


@dataclass(frozen=True)
class TrackerConfig:
    """Tracker settings (TrackerSettings, tracker.h:31-55)."""

    check_init_values: bool = True  # tracker.h:43
    # Improvement over the reference: evalCostFunction (tracker.cpp:356-393)
    # compares raw DT sums, so a pose that throws points out of bounds gets a
    # spuriously low cost; normalizing by the contributing-point count fixes
    # the bias.  Set False for exact reference parity.
    normalized_init_cost: bool = True
    # Improvement over the reference: checkInitializationValues discards the
    # motion prior whenever cost(identity) < cost(prior) — a RAW comparison
    # (tracker.cpp:277-282).  On quasi-periodic structure the two can sit
    # within noise of each other (measured failure: costs 0.5589 vs 0.5615,
    # true pose 0.5529 — the identity reset locked tracking into an aliased
    # basin 15 cm off for the rest of the sequence).  Require identity to be
    # CLEARLY better: use_eye iff cost_eye < margin * cost_prior.  A truly
    # broken prior loses by far more than 10%; 1.0 = exact reference
    # behavior.  ATE-gated in tests/test_system.py (seed-9 long run).
    init_check_margin: float = 0.9
    check_tracking_results: bool = True  # tracker.h:45
    n_frames_histogram_voting: int = 3  # tracker.h:44,47
    histogram_level: int = 2  # tracker.cpp:229
    # Weighted-overlap weights for counting levels 0..3 (tracker.cpp:230-234).
    hist_weights: Tuple[float, ...] = (0.0, 1.0, 1.25, 1.5)
    # Final good/bad ratio below which a new keyframe is requested
    # (tracker.cpp:351).
    good_bad_ratio_new_kf: float = 4.0
    # Relocalization — the reference declares TRACKER_STATE_LOST but leaves
    # relocalization unimplemented (tracker.h:62-65); we implement it: when
    # the final mean weighted error exceeds the threshold (or too few good
    # points survive), the frame is re-tracked against the recent-keyframe
    # ring from identity and the best result re-anchors tracking.
    enable_relocalization: bool = True
    # Catastrophic pose-jump gate (improvement over the reference, which
    # has no failure detection at all): a frame-to-frame motion beyond
    # these bounds is treated as lost — the residual alone cannot catch a
    # wrong-basin convergence on repetitive structure (it stays low
    # there), but a 0.5 m / 0.8 rad jump at 30 fps is not physical for
    # the handheld/robot regimes this targets.  Recovery = the existing
    # lost path (relocalization ring, else constant-velocity coasting).
    max_jump_translation: float = 0.5  # metres per frame
    max_jump_rotation: float = 0.8  # radians per frame
    reloc_error_threshold: float = 2.0  # mean weighted DT error (px)
    reloc_min_good: int = 100
    kf_history_size: int = 5
    # Keep full image tensors (gray/depth/edges) on RETAINED keyframes.
    # False (default) stores pruned slots — tracking, relocalization,
    # loop closure and windowed BA only read structs/quads/clouds/pose
    # (frontend.prune_keyframe; ~4 MB/slot saved at 640x480).  run.py
    # turns this on for --export-ply / --live-view, which color the map
    # from keyframe images.
    store_kf_images: bool = False
    # Online (mid-run) loop closure: every ``loop_closure_every`` frames
    # the retained keyframe ring is searched for verified revisits and the
    # pose graph + live tracking state are corrected in place (the offline
    # equivalent is run.py --close-loops).  Off by default — odometry
    # parity with the reference; enable for SLAM-mode runs.
    online_loop_closure: bool = False
    # Closure runs on every keyframe promotion (the natural SLAM trigger —
    # a revisit only becomes closable once its keyframe exists) plus a
    # periodic fallback every N frames.
    loop_closure_every: int = 30
    loop_closure_radius: float = 0.8  # candidate search radius (m)
    # Ring relocalization inside the device-resident scan twin
    # (parallel/batch.py).  Default OFF: under plain vmap both lax.cond
    # branches execute every step, so an always-on reloc branch would cost
    # kf_history_size extra tracks per frame in the batched-throughput
    # path.  Enable for shard_map-per-device runs (cond stays a real
    # branch there — zero cost on healthy frames) or host-loop-parity
    # robustness runs.
    scan_relocalization: bool = False
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset / IO settings (IOWrapperSettings, iowrapperRGBD.h:41-153)."""

    main_folder: str = ""
    datasets: Tuple[str, ...] = ()
    associate_file: str = "associate.txt"
    depth_scale_factor: float = 5000.0  # TUM (iowrapperRGBD.cpp:326-327)
    skip_first_n_frames: int = 0  # iowrapperRGBD.h:108
    read_n_images: int = 100000  # iowrapperRGBD.h:109
    use_depth_timestamp: bool = False
    # 0 = dataset files, 1 = Orbbec Astra Pro, 2 = RealSense, 3 = Orbbec
    # Astra (iowrapperRGBD.h:57; live sensors via io/sensors.py).
    input_type: int = 0


@dataclass(frozen=True)
class SystemConfig:
    """Top-level config (REVOConfig, system.h:32-83)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    init_from_last_pose: bool = True  # system.h:54 INIT_FROM_LAST_POSE
    do_output_poses: bool = True
    output_folder: str = "out"

    def camera_pyramid(self) -> Tuple[CameraConfig, ...]:
        """Per-level intrinsics for levels 0..n_levels-1 (camerapyr.h:139-144)."""
        return tuple(
            self.camera.level(lvl) for lvl in range(self.pyramid.n_levels)
        )


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    if isinstance(default, bool):
        return bool(v)
    if isinstance(default, int) and not isinstance(default, bool):
        return int(v)
    if isinstance(default, float):
        return float(v)
    return v


def load_config(
    settings_file: Optional[str] = None, dataset_file: Optional[str] = None
) -> SystemConfig:
    """Load the two-file YAML config, mirroring the reference split.

    ``settings_file`` = algorithm settings (config/revo_settings.yaml),
    ``dataset_file`` = camera/dataset settings (config/dataset_tum1.yaml).
    Missing keys fall back to the reference defaults listed above.  The
    reference parses OpenCV FileStorage YAML ("%YAML:1.0" + "key: value");
    we accept both plain YAML and the FileStorage dialect.
    """
    algo: dict = {}
    data: dict = {}
    if settings_file:
        algo = _load_yaml(settings_file)
    if dataset_file:
        data = _load_yaml(dataset_file)

    cam = CameraConfig(
        fx=_get(data, "Camera.fx", 517.306408),
        fy=_get(data, "Camera.fy", 516.469215),
        cx=_get(data, "Camera.cx", 318.643040),
        cy=_get(data, "Camera.cy", 255.313989),
        width=_get(data, "Camera.width", 640),
        height=_get(data, "Camera.height", 480),
        distortion=(
            _get(data, "Camera.k1", 0.0),
            _get(data, "Camera.k2", 0.0),
            _get(data, "Camera.p1", 0.0),
            _get(data, "Camera.p2", 0.0),
            _get(data, "Camera.k3", 0.0),
        ),
    )
    pyr = PyramidConfig(
        canny_threshold1=_get(data, "cannyThreshold1", 150.0),
        canny_threshold2=_get(data, "cannyThreshold2", 100.0),
        gaussian_before_canny=_get(
            data, "DO_GAUSSIAN_SMOOTHING_BEFORE_CANNY", False
        ),
        depth_min=_get(data, "DEPTH_MIN", 0.1),
        depth_max=_get(data, "DEPTH_MAX", 5.2),
        pyr_min_lvl=_get(data, "PYR_MIN_LVL", 2),
        pyr_max_lvl=_get(data, "PYR_MAX_LVL", 0),
        undistort=_get(data, "DO_UNDISTORT", False),
        use_edge_hist=_get(data, "USE_EDGE_HIST", True),
        n_percentage=_get(data, "nPercentage", 0.3),
    )
    opt = OptimizerConfig(
        use_edge_filter=_get(algo, "USE_EDGE_FILTER", True),
    )
    trk = TrackerConfig(
        check_init_values=_get(algo, "CHECK_INIT_VALUES", True),
        check_tracking_results=_get(algo, "CHECK_TRACKING_RESULTS", True),
        n_frames_histogram_voting=_get(
            algo, "N_FRAMES_HIST_VOTING", _get(algo, "nFramesHistogramVoting", 3)
        ),
        # revo_tpu extensions (absent from reference YAMLs; keys are ours).
        enable_relocalization=_get(algo, "ENABLE_RELOCALIZATION", True),
        kf_history_size=_get(algo, "KF_HISTORY_SIZE", 5),
        online_loop_closure=_get(algo, "ONLINE_LOOP_CLOSURE", False),
        loop_closure_every=_get(algo, "LOOP_CLOSURE_EVERY", 30),
        loop_closure_radius=_get(algo, "LOOP_CLOSURE_RADIUS", 0.8),
        optimizer=opt,
    )
    datasets = data.get("Datasets", ())
    if isinstance(datasets, str):
        datasets = (datasets,)
    else:
        datasets = tuple(datasets)
    ds = DatasetConfig(
        main_folder=_get(data, "MainFolder", ""),
        datasets=datasets,
        associate_file=_get(data, "ASSOCIATE", "associate.txt"),
        depth_scale_factor=_get(data, "DEPTH_SCALE_FACTOR", 5000.0),
        skip_first_n_frames=_get(data, "SKIP_FIRST_N_FRAMES", 0),
        read_n_images=_get(data, "READ_N_IMAGES", 100000),
        input_type=int(_get(algo, "INPUT_TYPE", _get(data, "INPUT_TYPE", 0))),
    )
    return SystemConfig(
        camera=cam,
        pyramid=pyr,
        tracker=trk,
        dataset=ds,
        do_output_poses=_get(algo, "DO_OUTPUT_POSES", True),
    )


def _load_yaml(path: str) -> dict:
    """Load a flat OpenCV FileStorage / YAML settings file."""
    with open(path) as f:
        return parse_settings(f.read())


def parse_settings(text: str) -> dict:
    """Parse the flat YAML dialect of the settings files.

    Supports what OpenCV FileStorage and the reference configs use:
    ``key: value`` lines, a ``%YAML`` header and ``---`` markers, ``#``
    comments, quoted or bare strings, ints, floats, true/false, and block
    (``- item``) lists.  Values are typed like a YAML safe load: ``150`` is
    an int, ``0.3`` a float, ``"x"`` a string.
    """
    out: dict = {}
    key = None  # the key of an open block list
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.startswith(("%", "---", "...")):
            continue
        stripped = line.lstrip()
        if stripped.startswith("- ") or stripped == "-":
            if key is None:
                raise ValueError(f"list item outside a list: {raw!r}")
            out[key].append(_scalar(stripped[1:].strip()))
            continue
        name, sep, value = line.partition(":")
        if not sep or line[0].isspace():
            raise ValueError(f"not a 'key: value' line: {raw!r}")
        name, value = name.strip(), value.strip()
        if value == "":
            out[name] = []
            key = name
        else:
            out[name] = _scalar(value)
            key = None
    # An empty block list reads as null, like a YAML load of "key:".
    return {k: (None if v == [] else v) for k, v in out.items()}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _scalar(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text
