"""Oracle tests for revo_tpu.ops against OpenCV (the reference's backend).

SURVEY.md §4: unit-test each kernel against a trusted CPU oracle (OpenCV
Canny/DT, the reference's own formulas re-implemented in NumPy).
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from revo_tpu import ops


def synthetic_gray(h=120, w=160, seed=0):
    """Natural-ish test image: smooth blobs + gradients, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 40.0 + 30.0 * np.sin(xx / 17.0) + 25.0 * np.cos(yy / 23.0)
    for _ in range(8):
        cy_, cx_ = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(5, 25)
        a = rng.uniform(40, 120)
        img += a * np.exp(-((yy - cy_) ** 2 + (xx - cx_) ** 2) / (2 * s * s))
    # hard geometric structure for edges
    img[int(h * 0.3):int(h * 0.6), int(w * 0.2):int(w * 0.5)] += 60
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_depth(h=120, w=160, seed=1, hole_frac=0.15):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 1.5 + 0.5 * np.sin(xx / 31.0) + 0.3 * np.cos(yy / 19.0)
    d[rng.random((h, w)) < hole_frac] = 0.0
    return d.astype(np.float32)


class TestFilters:
    def test_pyr_down_matches_opencv(self):
        img = synthetic_gray()
        want = cv2.pyrDown(img).astype(np.float32)
        got = np.asarray(ops.pyr_down(jnp.asarray(img, jnp.float32)))
        assert got.shape == want.shape
        # cv2 uses fixed-point arithmetic; allow off-by-one rounding.
        assert np.abs(got - want).max() <= 1.0
        assert (np.abs(got - want) > 0).mean() < 0.02

    def test_gaussian_blur_matches_opencv(self):
        img = synthetic_gray(seed=3)
        want = cv2.GaussianBlur(img, (7, 7), 2).astype(np.float32)
        got = np.asarray(ops.gaussian_blur(jnp.asarray(img, jnp.float32)))
        assert np.abs(got - want).max() <= 1.0

    def test_sobel_matches_opencv(self):
        img = synthetic_gray(seed=4)
        wx = cv2.Sobel(img, cv2.CV_32F, 1, 0, ksize=3)
        wy = cv2.Sobel(img, cv2.CV_32F, 0, 1, ksize=3)
        gx, gy = ops.sobel(jnp.asarray(img, jnp.float32))
        np.testing.assert_allclose(np.asarray(gx), wx, atol=1e-3)
        np.testing.assert_allclose(np.asarray(gy), wy, atol=1e-3)


class TestDepthSubsample:
    def test_matches_reference_formula(self):
        d = synthetic_depth()
        got = np.asarray(ops.subsample_depth_with_holes(jnp.asarray(d)))
        h2, w2 = d.shape[0] // 2, d.shape[1] // 2
        want = np.zeros((h2, w2), np.float32)
        # NumPy re-implementation of filterSubsampleWithHoles
        # (imgpyramidrgbd.h:228-249)
        for y in range(h2):
            for x in range(w2):
                block = d[2 * y:2 * y + 2, 2 * x:2 * x + 2].ravel()
                good = block[block > 0]
                want[y, x] = good.mean() if good.size else 0.0
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestCanny:
    @pytest.mark.parametrize("seed", [0, 5])
    def test_matches_opencv(self, seed):
        img = synthetic_gray(h=120, w=160, seed=seed)
        want = cv2.Canny(img, 150, 100, apertureSize=3, L2gradient=True) > 0
        got = np.asarray(
            ops.canny(jnp.asarray(img, jnp.float32), 150.0, 100.0)
        )
        inter = (got & want).sum()
        union = (got | want).sum()
        assert union > 0
        iou = inter / union
        # Same input -> the implementation reproduces OpenCV exactly.
        assert iou == 1.0, f"IoU {iou:.4f}"

    def test_blurred_input(self):
        """The DO_GAUSSIAN_SMOOTHING_BEFORE_CANNY path
        (imgpyramidrgbd.cpp:101-108)."""
        img = synthetic_gray(seed=7)
        sm = cv2.GaussianBlur(img, (7, 7), 2)
        # lower thresholds: smoothing shrinks gradients below the TUM 150/100
        want = cv2.Canny(sm, 60, 30, apertureSize=3, L2gradient=True) > 0
        blurred = ops.gaussian_blur(jnp.asarray(img, jnp.float32))
        got = np.asarray(ops.canny(blurred, 60.0, 30.0))
        assert want.sum() > 100 and got.sum() > 100
        # End-to-end (our blur + our canny) vs (cv blur + cv canny): the
        # blurs differ by <=1 gray level on ~0.5% of pixels, which moves a
        # few near-threshold edge pixels; with identical input the canny
        # match is exact (see test_matches_opencv).
        iou = (got & want).sum() / (got | want).sum()
        assert iou > 0.75, f"IoU {iou:.3f}"
        same_input = np.asarray(ops.canny(jnp.asarray(sm, jnp.float32), 60.0, 30.0))
        assert (same_input == want).all()

    def test_empty_image(self):
        got = np.asarray(ops.canny(jnp.zeros((64, 64)), 150.0, 100.0))
        assert not got.any()


class TestEDT:
    def test_matches_opencv_precise(self):
        img = synthetic_gray(seed=2)
        edges = cv2.Canny(img, 150, 100, apertureSize=3, L2gradient=True)
        want = cv2.distanceTransform(
            255 - edges, cv2.DIST_L2, cv2.DIST_MASK_PRECISE
        )
        got = np.asarray(ops.distance_transform(jnp.asarray(edges > 0)))
        np.testing.assert_allclose(got, want, atol=2e-2)

    def test_single_point(self):
        e = np.zeros((33, 47), bool)
        e[10, 20] = True
        got = np.asarray(ops.distance_transform(jnp.asarray(e)))
        yy, xx = np.mgrid[0:33, 0:47]
        want = np.sqrt((yy - 10.0) ** 2 + (xx - 20.0) ** 2)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_vmap_matches_single(self):
        """The batched custom_vmap path (shared band radius) must agree
        with per-image calls, including a near-empty member that widens
        the shared band."""
        rng = np.random.default_rng(7)
        batch = []
        for i in range(3):
            e = rng.random((48, 80)) < (0.002 if i == 2 else 0.05)
            batch.append(e)
        eb = jnp.asarray(np.stack(batch))
        got = np.asarray(jax.vmap(ops.distance_transform)(eb))
        for i in range(3):
            want = np.asarray(ops.distance_transform(eb[i]))
            np.testing.assert_allclose(got[i], want, atol=1e-3)

    def test_no_edges(self):
        got = np.asarray(ops.distance_transform(jnp.zeros((16, 24), bool)))
        assert (got > 100.0).all()

    def test_gradient_structure_signs(self):
        """gx/gy are NEGATED central differences (imgpyramidrgbd.cpp:267-274)."""
        e = np.zeros((32, 32), bool)
        e[16, 16] = True
        s = np.asarray(ops.keyframe_structure(jnp.asarray(e)))
        dt = s[..., 2]
        # interior check vs reference formula
        gx_want = 0.5 * (dt[5, 4] - dt[5, 6])
        gy_want = 0.5 * (dt[4, 5] - dt[6, 5])
        assert abs(s[5, 5, 0] - gx_want) < 1e-6
        assert abs(s[5, 5, 1] - gy_want) < 1e-6
        # to the left of the edge point, dt decreases to the right ->
        # dt[x-1] > dt[x+1] -> gx positive
        assert s[16, 10, 0] > 0


class TestBilinear:
    def test_matches_reference_formula(self):
        rng = np.random.default_rng(0)
        img = rng.normal(size=(20, 30, 3)).astype(np.float32)
        u = rng.uniform(1, 28, size=50).astype(np.float32)
        v = rng.uniform(1, 18, size=50).astype(np.float32)
        got = np.asarray(
            ops.bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        )
        for k in range(50):
            ix, iy = int(u[k]), int(v[k])
            dx, dy = u[k] - ix, v[k] - iy
            dxdy = dx * dy
            want = (
                dxdy * img[iy + 1, ix + 1]
                + (dy - dxdy) * img[iy + 1, ix]
                + (dx - dxdy) * img[iy, ix + 1]
                + (1 - dx - dy + dxdy) * img[iy, ix]
            )
            np.testing.assert_allclose(got[k], want, rtol=2e-5, atol=2e-5)

    def test_window_gather_variant_matches(self):
        """bilinear_sample_window (a gather form of the solver)
        must agree with the 4-take formulation everywhere, including at
        clamped border coordinates."""
        from revo_tpu.ops.interp import (
            bilinear_sample,
            bilinear_sample_pair,
            bilinear_sample_window,
        )

        rng = np.random.default_rng(3)
        img = rng.normal(size=(24, 33, 3)).astype(np.float32)
        u = np.concatenate(
            [rng.uniform(-2, 35, size=200), [0.0, 31.0, 32.9, 1.5]]
        ).astype(np.float32)
        v = np.concatenate(
            [rng.uniform(-2, 26, size=200), [0.0, 22.0, 23.9, 1.5]]
        ).astype(np.float32)
        a = np.asarray(bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
        b = np.asarray(
            bilinear_sample_window(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        )
        np.testing.assert_allclose(a, b, rtol=0, atol=0)
        c = np.asarray(
            bilinear_sample_pair(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        )
        np.testing.assert_allclose(a, c, rtol=0, atol=0)

    def test_quad_table_forms_match(self):
        """Every quad-table storage form (hw12/flat/t — the gather-emitter
        layout knob, OptimizerConfig.quad_form) must reproduce the 4-take
        bilinear exactly, including at clamped border coordinates."""
        from revo_tpu.ops.edt import quad_structure
        from revo_tpu.ops.interp import bilinear_sample, bilinear_sample_quad

        rng = np.random.default_rng(7)
        img = rng.normal(size=(24, 33, 3)).astype(np.float32)
        u = np.concatenate(
            [rng.uniform(-2, 35, size=200), [0.0, 31.0, 32.9, 1.5]]
        ).astype(np.float32)
        v = np.concatenate(
            [rng.uniform(-2, 26, size=200), [0.0, 22.0, 23.9, 1.5]]
        ).astype(np.float32)
        a = np.asarray(
            bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        )
        for form in ("hw12", "flat", "t", "flat16", "flatbf"):
            q = quad_structure(jnp.asarray(img), form)
            got = np.asarray(
                bilinear_sample_quad(
                    q, jnp.asarray(u), jnp.asarray(v), h=24, w=33
                )
            )[:, :3]
            if form == "flatbf":  # bf16 storage: ~8-bit mantissa
                np.testing.assert_allclose(a, got, atol=0.05, err_msg=form)
            else:
                np.testing.assert_allclose(
                    a, got, rtol=0, atol=0, err_msg=form
                )

    def test_dtquad_value_and_surface_gradient(self):
        """The dt-only quad form ("dt4"): the sampled dt matches the 4-take
        bilinear exactly, and the gradients are the analytic derivatives of
        the bilinear surface (negated, struct sign convention) — checked
        against central finite differences of the sampled value."""
        from revo_tpu.ops.edt import quad_structure
        from revo_tpu.ops.interp import bilinear_sample, bilinear_sample_dtquad

        rng = np.random.default_rng(11)
        h, w = 24, 33
        img = rng.normal(size=(h, w, 3)).astype(np.float32)
        # Interior coords with fractional part in [0.1, 0.9] so the +-eps
        # probes stay in the same bilinear cell (where the surface is
        # differentiable).
        u = (
            rng.integers(2, w - 4, size=300) + rng.uniform(0.1, 0.9, size=300)
        ).astype(np.float32)
        v = (
            rng.integers(2, h - 4, size=300) + rng.uniform(0.1, 0.9, size=300)
        ).astype(np.float32)
        q = quad_structure(jnp.asarray(img), "dt4")
        got = np.asarray(
            bilinear_sample_dtquad(q, jnp.asarray(u), jnp.asarray(v), h=h, w=w)
        )
        ref_dt = np.asarray(
            bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v))
        )[:, 2]
        np.testing.assert_allclose(got[:, 2], ref_dt, rtol=0, atol=0)

        eps = 1e-2  # surface is piecewise bilinear: exact for any in-cell eps
        def dt_at(uu, vv):
            return np.asarray(
                bilinear_sample(
                    jnp.asarray(img), jnp.asarray(uu), jnp.asarray(vv)
                )
            )[:, 2]

        fd_gx = -(dt_at(u + eps, v) - dt_at(u - eps, v)) / (2 * eps)
        fd_gy = -(dt_at(u, v + eps) - dt_at(u, v - eps)) / (2 * eps)
        np.testing.assert_allclose(got[:, 0], fd_gx, atol=2e-3)
        np.testing.assert_allclose(got[:, 1], fd_gy, atol=2e-3)

    def test_quad_batched_takes_match(self):
        """The batched-gather reformulations (interp._QUAD_TAKES, the
        vmapped-emitter A/B knob OptimizerConfig.bilinear_impl suffix)
        must be bit-identical to the plain batch-dim take under vmap."""
        from revo_tpu.ops.edt import quad_structure
        from revo_tpu.ops.interp import bilinear_sample_quad

        import jax

        rng = np.random.default_rng(11)
        B, H, W, P = 3, 16, 20, 64
        structs = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        quads = jax.vmap(lambda s: quad_structure(s, "flat"))(
            jnp.asarray(structs)
        )
        u = jnp.asarray(rng.uniform(1.5, W - 2.5, (B, P)).astype(np.float32))
        v = jnp.asarray(rng.uniform(1.5, H - 2.5, (B, P)).astype(np.float32))
        outs = {}
        for bt in ("take", "lanefold", "lanefold12"):
            f = jax.vmap(
                lambda q, uu, vv, bt=bt: bilinear_sample_quad(
                    q, uu, vv, h=H, w=W, batched_take=bt
                )
            )
            outs[bt] = np.asarray(jax.jit(f)(quads, u, v))
        for bt in ("lanefold", "lanefold12"):
            np.testing.assert_array_equal(outs[bt], outs["take"], err_msg=bt)

    def test_gather2d_matches_indexing(self):
        from revo_tpu.ops.interp import gather2d

        rng = np.random.default_rng(4)
        img2 = rng.normal(size=(17, 23)).astype(np.float32)
        img3 = rng.normal(size=(17, 23, 3)).astype(np.float32)
        iy = rng.integers(0, 17, size=64)
        ix = rng.integers(0, 23, size=64)
        np.testing.assert_array_equal(
            np.asarray(gather2d(jnp.asarray(img2), jnp.asarray(iy), jnp.asarray(ix))),
            img2[iy, ix],
        )
        np.testing.assert_array_equal(
            np.asarray(gather2d(jnp.asarray(img3), jnp.asarray(iy), jnp.asarray(ix))),
            img3[iy, ix],
        )

    def test_integer_coords_exact(self):
        img = np.arange(12.0, dtype=np.float32).reshape(3, 4, 1)
        got = np.asarray(
            ops.bilinear_sample(
                jnp.asarray(img), jnp.asarray([1.0, 2.0]), jnp.asarray([0.0, 1.0])
            )
        )
        np.testing.assert_allclose(got[:, 0], [1.0, 6.0])


class TestBackproject:
    def test_matches_loop(self):
        edges = synthetic_gray(seed=8) > 120
        depth = synthetic_depth(seed=9)
        fx, fy, cx, cy = 100.0, 102.0, 80.0, 60.0
        cloud = ops.backproject_edges(
            jnp.asarray(edges), jnp.asarray(depth), fx, fy, cx, cy,
            0.1, 5.2, capacity=8192,
        )
        # NumPy oracle (imgpyramidrgbd.cpp:203-224)
        pts = []
        for yy in range(edges.shape[0]):
            for xx in range(edges.shape[1]):
                z = depth[yy, xx]
                if edges[yy, xx] and np.isfinite(z) and 0.1 < z < 5.2:
                    pts.append([z * (xx - cx) / fx, z * (yy - cy) / fy, z])
        want = np.array(pts, np.float32)
        n = int(cloud.count)
        assert n == len(want)
        got = np.asarray(cloud.points)[np.asarray(cloud.valid)]
        # order-insensitive comparison
        got_sorted = got[np.lexsort(got.T)]
        want_sorted = want[np.lexsort(want.T)]
        np.testing.assert_allclose(got_sorted, want_sorted, rtol=1e-5, atol=1e-6)

    def test_capacity_clipping(self):
        edges = np.ones((16, 16), bool)
        depth = np.full((16, 16), 1.0, np.float32)
        cloud = ops.backproject_edges(
            jnp.asarray(edges), jnp.asarray(depth), 10, 10, 8, 8, 0.1, 5.2,
            capacity=100,
        )
        assert int(cloud.count) == 256
        assert int(np.asarray(cloud.valid).sum()) == 100

    def test_rank_compaction_matches_scatter(self):
        """The rank-select compaction (the default path: dense compare-
        reduces instead of a per-pixel scatter) must reproduce the scatter
        compaction bit-exactly: same slots, same validity, same count —
        including the f32 uniform-decimation rounding on overflow and
        non-multiple-of-128 sizes."""
        from revo_tpu.ops.backproject import _compact_rank, _compact_scatter

        rng = np.random.default_rng(11)
        cases = [
            (rng.random((120, 160)) < 0.06, 512),  # fits
            (rng.random((120, 160)) < 0.5, 1024),  # heavy overflow
            (rng.random((120, 160)) < 0.061, 1170),  # count ~ capacity
            (np.zeros((120, 160), bool), 256),  # empty
            (np.ones((16, 16), bool), 100),  # all edges, overflow
            (rng.random((30, 33)) < 0.2, 128),  # size % 128 != 0
        ]
        for mask, cap in cases:
            ia, va, ca = _compact_scatter(jnp.asarray(mask), cap)
            for impl in ("reduce", "sort", "sort_packed"):
                ib, vb, cb = _compact_rank(
                    jnp.asarray(mask), cap, table_impl=impl
                )
                assert int(ca) == int(cb)
                np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))
                np.testing.assert_array_equal(
                    np.asarray(ia) * np.asarray(va),
                    np.asarray(ib) * np.asarray(vb),
                    err_msg=f"cap={cap} count={int(ca)} impl={impl}",
                )

    def test_rank_fused_depth_survives_nan(self):
        """NaN/inf depths sit on invalid pixels, but 0 * NaN = NaN would
        poison the fused (offset, z) block reduce if unsanitized — the
        rank path must return the same cloud as the scatter path."""
        from revo_tpu.ops.backproject import backproject_edges

        rng = np.random.default_rng(3)
        h, w = 64, 96
        edges = rng.random((h, w)) < 0.1
        depth = rng.uniform(0.5, 4.0, size=(h, w)).astype(np.float32)
        depth[rng.random((h, w)) < 0.2] = np.nan
        depth[rng.random((h, w)) < 0.05] = np.inf
        kw = dict(fx=100.0, fy=100.0, cx=48.0, cy=32.0,
                  depth_min=0.1, depth_max=5.0, capacity=512)
        a = backproject_edges(
            jnp.asarray(edges), jnp.asarray(depth), compaction="scatter", **kw
        )
        for rank_impl in ("rank", "rank_sort", "rank_sort2"):
            b = backproject_edges(
                jnp.asarray(edges), jnp.asarray(depth),
                compaction=rank_impl, **kw
            )
            assert int(a.count) == int(b.count)
            np.testing.assert_array_equal(
                np.asarray(a.valid), np.asarray(b.valid)
            )
            assert np.isfinite(np.asarray(b.points)).all()
            np.testing.assert_allclose(
                np.asarray(a.points), np.asarray(b.points), rtol=0, atol=0
            )


class TestEdgeHist:
    def test_patch_histogram(self):
        edges = synthetic_gray(seed=10) > 128
        counts, occ = ops.patch_histogram(jnp.asarray(edges), 10)
        h, w = edges.shape
        want = np.zeros((h // 10, w // 10), np.int32)
        for yy in range(12 * 10):
            for xx in range(16 * 10):
                if edges[yy, xx]:
                    want[yy // 10, xx // 10] += 1
        np.testing.assert_array_equal(np.asarray(counts), want)
        assert abs(float(occ) - (want > 0).mean()) < 1e-6

    def test_fill_in(self):
        rng = np.random.default_rng(11)
        parent = rng.random((120, 160)) < 0.08
        child = rng.random((60, 80)) < 0.002
        counts, _ = ops.patch_histogram(jnp.asarray(child), 10)
        got = np.asarray(
            ops.fill_in_edges(
                jnp.asarray(child), jnp.asarray(parent), counts,
                patch_size=10, parent_patch_size=20,
            )
        )
        # NumPy oracle (imgpyramidrgbd.cpp:130-140)
        want = child.copy()
        counts_np = np.asarray(counts)
        for yy in range(120):
            for xx in range(160):
                if yy % 2 == 1 and xx % 2 == 1:
                    if counts_np[yy // 20, xx // 20] < 100 * 0.05:
                        if parent[yy, xx]:
                            want[yy // 2, xx // 2] = True
        np.testing.assert_array_equal(got, want)
