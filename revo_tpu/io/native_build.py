"""Build-on-first-use for the native host libraries under ``native/``.

The shared libraries are never committed: each loader asks for its own
make target, which is compiled from ``native/*.cpp`` on the machine that
loads it (the oracle uses ``-march=native``).  An exclusive file lock makes
the check-and-build safe when several processes (test workers) load the
same library at once, and no process opens a library while another is
still writing it.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def load_native(target: str, timeout: float = 300.0) -> Optional[ctypes.CDLL]:
    """``native/<target>``, built with ``make -C native <target>`` when it
    is missing; None when it cannot be built or loaded on this machine."""
    path = os.path.join(NATIVE_DIR, target)
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                subprocess.run(
                    ["make", "-C", NATIVE_DIR, target],
                    check=True, capture_output=True, timeout=timeout,
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            return ctypes.CDLL(path)
        except OSError:  # a runtime dependency is missing here
            return None
