"""run.py's backend rule: the CPU only when asked (--cpu or
JAX_PLATFORMS=cpu), otherwise a GPU or an error — never a silent CPU
fallback."""
import pytest

from revo_tpu.run import select_backend


def test_cpu_when_asked(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert select_backend(False) == "cpu"
    monkeypatch.delenv("JAX_PLATFORMS")
    assert select_backend(True) == "cpu"


def test_refuses_silent_cpu_fallback(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="no GPU found"):
        select_backend(False)
