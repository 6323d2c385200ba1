"""Live-sensor bridges over the native V4L2 engine (native/revo_sensor.cpp).

The reference selects live input with ``INPUT_TYPE`` (io/iowrapperRGBD.h:56-
102): 1 = Orbbec Astra Pro (color via FFMPEG-v4l2/libuvc + depth via OpenNI,
orbbec_astra_pro/OrbbecAstraEngineFFMPEG.cpp:315+, OrbbecAstraEngineUVC.cpp
:93-140), 2 = RealSense ZR300 (realsensesensor.cpp:77-139), 3 = Orbbec Astra
(both streams via OpenNI, OrbbecAstraOpenNIEngine.cpp:298+).  This module
implements those modalities over the kernel's own V4L2 streaming protocol —
no librealsense/libuvc/OpenNI userspace drivers — and yields frames in the
SENSORS.md bridge contract: ``(gray u8 (H, W), depth u16 raw, timestamp)``.

Every bridge also runs against RECORDED sessions through the engine's
replay shim (the full negotiation + streaming + conversion path, no
hardware), which is both the CI story and a field-debugging tool: capture a
misbehaving sensor once, replay it deterministically.
"""
from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from revo_tpu.io.native_build import load_native

_lib: Optional[ctypes.CDLL] = None


def fourcc(code: str) -> int:
    a, b, c, d = (ord(ch) for ch in code)
    return a | (b << 8) | (c << 16) | (d << 24)


YUYV = fourcc("YUYV")
MJPG = fourcc("MJPG")
GREY = fourcc("GREY")
Z16 = fourcc("Z16 ")


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("librevo_sensor.so")
    if lib is None:
        return None
    lib.rs_use_replay_shim.argtypes = [ctypes.c_int]
    lib.rs_replay_register.restype = ctypes.c_int
    lib.rs_replay_register.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.rs_open.restype = ctypes.c_void_p
    lib.rs_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_int,
    ]
    lib.rs_grab.restype = ctypes.c_int
    lib.rs_grab.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.rs_error.restype = ctypes.c_char_p
    lib.rs_error.argtypes = [ctypes.c_void_p]
    lib.rs_close.argtypes = [ctypes.c_void_p]
    lib.rs_width.restype = ctypes.c_int
    lib.rs_width.argtypes = [ctypes.c_void_p]
    lib.rs_height.restype = ctypes.c_int
    lib.rs_height.argtypes = [ctypes.c_void_p]
    lib.rs_register_depth.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rs_yuyv_to_gray.restype = ctypes.c_int
    lib.rs_yuyv_to_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rs_mjpeg_to_gray.restype = ctypes.c_int
    lib.rs_mjpeg_to_gray.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load_lib() is not None


# ---------------------------------------------------------------------------
# Sensor profiles: the reference's knownDeviceIDs table + per-INPUT_TYPE
# stream setup (OrbbecAstraEngineUVC.cpp:34-42, iowrapperRGBD.h:56-102).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SensorProfile:
    name: str
    input_type: int         # the reference's INPUT_TYPE selector
    color_fourcc: int       # V4L2 color stream format
    depth_scale: float      # raw u16 -> metres
    warmup_frames: int      # auto-exposure settle (realsensesensor.cpp:90)
    needs_registration: bool  # depth not factory-aligned to color


PROFILES = {
    # Orbbec Astra Pro: color is a plain UVC camera (MJPEG at 640x480@30),
    # depth wants registration (the reference asks OpenNI for it).
    "astra_pro": SensorProfile("astra_pro", 1, MJPG, 1.0 / 1000.0, 30, True),
    # RealSense ZR300: YUYV color; librealsense aligns depth on-host, we do
    # the same explicitly.  Depth scale nominally 1/1000 (device-queried in
    # the reference, realsensesensor.cpp:95-100).
    "realsense": SensorProfile("realsense", 2, YUYV, 1.0 / 1000.0, 30, True),
    # Orbbec Astra: both streams through OpenNI in the reference; hardware
    # registration mode means frames arrive aligned.
    "astra": SensorProfile("astra", 3, YUYV, 1.0 / 1000.0, 30, False),
}

_BY_INPUT_TYPE = {p.input_type: p for p in PROFILES.values()}


def profile_for_input_type(input_type: int) -> SensorProfile:
    return _BY_INPUT_TYPE[input_type]


# ---------------------------------------------------------------------------
# Session files for the replay shim (and for field capture debugging).
# ---------------------------------------------------------------------------


def write_session(
    path: str,
    frames: Sequence[bytes],
    stamps: Sequence[float],
    width: int,
    height: int,
    fmt: int,
) -> None:
    """Write a raw V4L2 stream session: header + (size, ts, bytes) records."""
    with open(path, "wb") as f:
        f.write(struct.pack("<5I", 0x31535652, width, height, fmt, len(frames)))
        for raw, ts in zip(frames, stamps):
            f.write(struct.pack("<Id", len(raw), float(ts)))
            f.write(raw)


def encode_yuyv(gray: np.ndarray) -> bytes:
    """Pack (H, W) u8 gray as YUYV 4:2:2 (Y = gray, U = V = 128)."""
    h, w = gray.shape
    out = np.empty((h, w, 2), np.uint8)
    out[..., 0] = gray
    out[..., 1] = 128
    return out.tobytes()


def encode_mjpeg(gray: np.ndarray, quality: int = 95) -> bytes:
    """JPEG-encode (H, W) u8 gray (host oracle encoder for session files)."""
    import cv2

    ok, buf = cv2.imencode(
        ".jpg", gray, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    )
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return bytes(buf.tobytes())


def use_replay(mapping: dict[str, str]) -> None:
    """Route the engine's device syscalls to the session replayer and
    register ``{device_path: session_file}`` mappings."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("librevo_sensor.so unavailable")
    lib.rs_use_replay_shim(1)
    for dev, sess in mapping.items():
        if lib.rs_replay_register(dev.encode(), sess.encode()) != 0:
            raise RuntimeError(f"bad session file: {sess}")


def use_real_devices() -> None:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("librevo_sensor.so unavailable")
    lib.rs_use_replay_shim(0)
    lib.rs_replay_clear()


# ---------------------------------------------------------------------------
# The bridge
# ---------------------------------------------------------------------------


class LiveSensor:
    """SENSORS.md bridge over the native V4L2 engine.

    Iterating yields ``(gray u8 (H, W), depth u16 raw, timestamp)`` — feed it
    straight to ``VOSystem.run`` (with the profile's depth_scale in the
    config) or wrap it in ``io.recorder.TUMRecorder`` for DO_RECORD_IMAGES
    -style capture (iowrapperRGBD.cpp:181-217).
    """

    def __init__(
        self,
        profile: SensorProfile,
        color_dev: str = "/dev/video0",
        depth_dev: str = "/dev/video1",
        width: int = 640,
        height: int = 480,
        warmup: Optional[int] = None,
        registration: Optional[dict] = None,
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                "librevo_sensor.so unavailable (make -C native)"
            )
        self._lib = lib
        self.profile = profile
        self._h = lib.rs_open(
            color_dev.encode(),
            depth_dev.encode() if depth_dev else b"",
            width,
            height,
            ctypes.c_uint32(profile.color_fourcc),
            profile.warmup_frames if warmup is None else warmup,
        )
        if not self._h:
            raise RuntimeError(
                f"sensor open failed ({profile.name}: {color_dev} + {depth_dev})"
            )
        self.width = lib.rs_width(self._h)
        self.height = lib.rs_height(self._h)
        # Depth->color registration parameters: dict with Kd, Kc (fx, fy,
        # cx, cy), R (3, 3), t (3,).  None = streams already registered.
        self._reg = registration if profile.needs_registration else None

    def register_depth(self, depth: np.ndarray) -> np.ndarray:
        """Explicit depth-to-color registration (OpenNI
        setImageRegistrationMode / rs_frame_align_framesets equivalent)."""
        if self._reg is None:
            return depth
        return register_depth(
            depth,
            self._reg["Kd"],
            self._reg["Kc"],
            self._reg["R"],
            self._reg["t"],
            self.profile.depth_scale,
            (self.height, self.width),
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        lib = self._lib
        gray = np.empty((self.height, self.width), np.uint8)
        depth = np.empty((self.height, self.width), np.uint16)
        ts = ctypes.c_double(0.0)
        while True:
            r = lib.rs_grab(
                self._h,
                gray.ctypes.data_as(ctypes.c_void_p),
                depth.ctypes.data_as(ctypes.c_void_p),
                ctypes.byref(ts),
            )
            if r == 0:
                return  # end of stream
            if r < 0:
                err = lib.rs_error(self._h).decode()
                raise RuntimeError(f"sensor grab failed: {err}")
            d = depth if self._reg is None else self.register_depth(depth)
            yield gray.copy(), d.copy(), float(ts.value)

    def close(self) -> None:
        if self._h:
            self._lib.rs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_sensor(input_type: int, **kw) -> LiveSensor:
    """INPUT_TYPE-selected live sensor (iowrapperRGBD.h:56-102 semantics:
    1 = Orbbec Astra Pro, 2 = RealSense, 3 = Orbbec Astra)."""
    return LiveSensor(profile_for_input_type(input_type), **kw)


def register_depth(
    depth: np.ndarray,
    Kd: Sequence[float],
    Kc: Sequence[float],
    R: np.ndarray,
    t: np.ndarray,
    depth_scale: float,
    out_shape: Tuple[int, int],
) -> np.ndarray:
    """Depth-to-color registration via the native z-buffered splat."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("librevo_sensor.so unavailable")
    depth = np.ascontiguousarray(depth, np.uint16)
    kd = np.ascontiguousarray(Kd, np.float32)
    kc = np.ascontiguousarray(Kc, np.float32)
    rr = np.ascontiguousarray(R, np.float32).reshape(9)
    tt = np.ascontiguousarray(t, np.float32).reshape(3)
    out = np.zeros(out_shape, np.uint16)
    lib.rs_register_depth(
        depth.ctypes.data_as(ctypes.c_void_p),
        depth.shape[0], depth.shape[1],
        kd.ctypes.data_as(ctypes.c_void_p),
        kc.ctypes.data_as(ctypes.c_void_p),
        rr.ctypes.data_as(ctypes.c_void_p),
        tt.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_float(depth_scale),
        out_shape[0], out_shape[1],
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def yuyv_to_gray(raw: bytes, width: int, height: int) -> np.ndarray:
    lib = _load_lib()
    buf = np.frombuffer(raw, np.uint8)
    out = np.empty((height, width), np.uint8)
    lib.rs_yuyv_to_gray(
        buf.ctypes.data_as(ctypes.c_void_p), width, height,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def mjpeg_to_gray(raw: bytes, width: int, height: int) -> np.ndarray:
    lib = _load_lib()
    buf = np.frombuffer(raw, np.uint8)
    out = np.empty((height, width), np.uint8)
    r = lib.rs_mjpeg_to_gray(
        buf.ctypes.data_as(ctypes.c_void_p), len(raw), width, height,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if r != 0:
        raise RuntimeError("MJPEG decode failed")
    return out
