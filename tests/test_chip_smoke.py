"""chip_smoke.py's device check: it refuses anything but a GPU, so the
smoke test can never pass on a CPU fallback."""
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_cpu_backend():
    import jax

    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_accepts_gpu_devices():
    kind = "NVIDIA H100 80GB HBM3"
    devs = [SimpleNamespace(platform="gpu", device_kind=kind)] * 4
    assert chip_smoke.require_gpu(devs) == {
        "platform": "gpu", "kind": kind, "count": 4,
    }


def test_exits_nonzero_without_result_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_main_phases_at_small_size(tmp_path, capsys):
    """Phases 2-5 and 7 at 160x120 on the CPU: the control flow and every
    check the card run makes (the 'GPU' side is the CPU device here)."""
    from test_solver import small_cfg

    assert chip_smoke.check_main(small_cfg(), str(tmp_path), workers=2) == []
    out = capsys.readouterr().out
    assert "[ref edge pixel fraction] 0.000e+00" in out
    assert "[report] B=8 batched step" in out


def test_multichip_phase_on_four_virtual_devices(capsys):
    """The ``--chips 4`` paths at 160x120 on four virtual CPU devices."""
    import jax

    from test_solver import small_cfg

    devs = jax.devices()[:4]
    assert len(devs) == 4
    assert chip_smoke.check_multichip(small_cfg(), devs, workers=2) == []
    assert "[multi pipeline_replay 2 cards vs 1 card m]" in capsys.readouterr().out
