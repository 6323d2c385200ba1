"""Tests for the native C++ PNG decoder + prefetcher vs the cv2 oracle."""
import os

import cv2
import numpy as np
import pytest

from revo_tpu.io import native_loader


@pytest.fixture(autouse=True)
def _needs_native():
    # Decided at run time: the first call builds the library.
    if not native_loader.native_available():
        pytest.skip("native IO library cannot be built or loaded here")


@pytest.fixture
def tum_frames(tmp_path):
    """Write TUM-style rgb (8-bit color) + depth (16-bit) PNG pairs."""
    rng = np.random.default_rng(0)
    rgb_paths, depth_paths, rgbs, depths = [], [], [], []
    for i in range(5):
        rgb = rng.integers(0, 256, size=(48, 64, 3), dtype=np.uint8)
        depth = rng.integers(0, 30000, size=(48, 64), dtype=np.uint16)
        rp = os.path.join(tmp_path, f"rgb_{i}.png")
        dp = os.path.join(tmp_path, f"depth_{i}.png")
        cv2.imwrite(rp, rgb)  # cv2 writes BGR channel order
        cv2.imwrite(dp, depth)
        rgb_paths.append(rp)
        depth_paths.append(dp)
        rgbs.append(rgb)
        depths.append(depth)
    return rgb_paths, depth_paths, rgbs, depths


class TestDecode:
    def test_gray_matches_cv2(self, tum_frames):
        rgb_paths, _, rgbs, _ = tum_frames
        for rp, bgr in zip(rgb_paths, rgbs):
            want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
            got = native_loader.load_gray(rp)
            assert got.shape == want.shape
            # identical fixed-point weights -> at most off-by-one from
            # rounding-order differences
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_depth16_exact(self, tum_frames):
        _, depth_paths, _, depths = tum_frames
        for dp, want in zip(depth_paths, depths):
            got = native_loader.load_depth16(dp)
            np.testing.assert_array_equal(got, want)

    def test_png_info(self, tum_frames):
        rgb_paths, depth_paths, _, _ = tum_frames
        w, h, is16 = native_loader.png_info(rgb_paths[0])
        assert (w, h, is16) == (64, 48, False)
        w, h, is16 = native_loader.png_info(depth_paths[0])
        assert (w, h, is16) == (64, 48, True)

    def test_missing_file(self):
        with pytest.raises(IOError):
            native_loader.png_info("/nonexistent.png")


class TestPrefetcher:
    def test_ordered_delivery(self, tum_frames):
        rgb_paths, depth_paths, rgbs, depths = tum_frames
        with native_loader.NativePrefetcher(
            rgb_paths, depth_paths, (48, 64), n_threads=3, window=3
        ) as pf:
            for i in range(5):
                gray, depth = pf.get(i)
                want_gray = cv2.cvtColor(rgbs[i], cv2.COLOR_BGR2GRAY)
                assert np.abs(
                    gray.astype(int) - want_gray.astype(int)
                ).max() <= 1
                np.testing.assert_array_equal(depth, depths[i])

    def test_decode_failure_surfaces(self, tum_frames, tmp_path):
        rgb_paths, depth_paths, _, _ = tum_frames
        bad = os.path.join(tmp_path, "bad.png")
        open(bad, "wb").write(b"not a png")
        with native_loader.NativePrefetcher(
            [rgb_paths[0], bad], [depth_paths[0], depth_paths[1]], (48, 64)
        ) as pf:
            pf.get(0)
            with pytest.raises(IOError):
                pf.get(1)
