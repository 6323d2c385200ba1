"""The flat FileStorage/YAML settings parser (revo_tpu.config) against a
YAML library load of every shipped config, and its dialect features."""
import glob
import os

import pytest

from revo_tpu.config import load_config, parse_settings

CONFIGS = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "config", "*.yaml"))
)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_matches_yaml_load(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    body = "\n".join(l for l in text.splitlines() if not l.startswith("%YAML"))
    want = yaml.safe_load(body) or {}
    got = parse_settings(text)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()
    }


def test_dialect_features():
    got = parse_settings(
        "%YAML:1.0\n---\n# comment\n"
        "a: 150\nb: -0.953104  # trailing comment\nc: \"/x/#y/\"\n"
        "d: 'q'\ne: bare/path/\nf: true\nh:\n  - one\n"
        "  - \"two\"\nempty:\n"
    )
    assert got == {
        "a": 150, "b": -0.953104, "c": "/x/#y/", "d": "q", "e": "bare/path/",
        "f": True, "h": ["one", "two"], "empty": None,
    }
    with pytest.raises(ValueError):
        parse_settings("- orphan\n")


def test_load_config_tum1():
    here = os.path.join(os.path.dirname(__file__), "..", "config")
    cfg = load_config(
        os.path.join(here, "revo_settings.yaml"),
        os.path.join(here, "dataset_tum1.yaml"),
    )
    assert cfg.camera.fx == 517.306408 and cfg.camera.width == 640
    assert cfg.camera.distortion[0] == 0.262383
    assert cfg.pyramid.canny_threshold1 == 150.0
    assert cfg.pyramid.use_edge_hist is True
    assert cfg.dataset.datasets == ("rgbd_dataset_freiburg1_xyz",)
    assert cfg.dataset.depth_scale_factor == 5000.0
    assert cfg.tracker.n_frames_histogram_voting == 3
