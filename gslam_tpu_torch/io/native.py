"""ctypes bindings for the native C++ frame loader (native/loader.cpp).

Counterpart of gslam_tpu/io/native.py, binding the same library: the
repository's native/libgslam_native.so, built with `make -C native` at
first use. Every entry point has a pure-Python fallback (logged when the
build fails), so the loaders work unbuilt. Calls into the library release
the GIL, so a prefetch thread decodes and undistorts in parallel with
tracking. This is host I/O; nothing here touches the device.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    cand = Path(__file__).resolve().parents[2] / "native" / "libgslam_native.so"
    if not cand.exists():
        # The .so is not committed; build it in-tree at first use. _TRIED
        # caches the outcome either way so a failed build is attempted at
        # most once per process, with a visible diagnostic.
        import logging
        import subprocess

        log = logging.getLogger("gslam_tpu_torch.io.native")
        try:
            proc = subprocess.run(
                ["make", "-C", str(cand.parent)], capture_output=True,
                timeout=120,
            )
        except Exception as e:
            log.warning("native loader build failed (%s); using the "
                        "pure-Python fallback", e)
            return None
        if proc.returncode != 0 or not cand.exists():
            log.warning(
                "native loader build failed (rc=%d); using the pure-Python "
                "fallback. stderr tail: %s",
                proc.returncode,
                proc.stderr.decode(errors="replace")[-500:],
            )
            return None
    lib = ctypes.CDLL(str(cand))
    lib.gs_png_info.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 4
    lib.gs_png_info.restype = ctypes.c_int
    lib.gs_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.gs_png_decode.restype = ctypes.c_int
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.gs_load_rgb_remap_f32.argtypes = [
        ctypes.c_char_p, f32p, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p,
    ]
    lib.gs_load_rgb_remap_f32.restype = ctypes.c_int
    lib.gs_load_depth_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, f32p,
    ]
    lib.gs_load_depth_f32.restype = ctypes.c_int
    lib.gs_crc8.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gs_crc8.restype = ctypes.c_uint8
    _LIB = lib
    return lib


def available() -> bool:
    return _find_lib() is not None


def build(quiet: bool = True) -> bool:
    """Attempt to build the shared library in-tree."""
    import subprocess

    root = Path(__file__).resolve().parents[2] / "native"
    r = subprocess.run(
        ["make", "-C", str(root)],
        capture_output=quiet,
    )
    global _TRIED
    _TRIED = False
    return r.returncode == 0 and available()


def load_rgb_remap(path, map_x, map_y, roi) -> np.ndarray | None:
    """Decode+undistort an 8-bit RGB PNG; None if the native lib is absent
    or the file isn't a compatible PNG (caller falls back to PIL/cv2)."""
    lib = _find_lib()
    if lib is None:
        return None
    src_h, src_w = map_x.shape
    x, y, w, h = roi
    out = np.empty((h, w, 3), np.float32)
    rc = lib.gs_load_rgb_remap_f32(
        os.fsencode(str(path)),
        np.ascontiguousarray(map_x, np.float32),
        np.ascontiguousarray(map_y, np.float32),
        src_w, src_h, x, y, w, h, out,
    )
    return out if rc == 0 else None


def load_depth(path, roi, depth_scale=5000.0) -> np.ndarray | None:
    lib = _find_lib()
    if lib is None:
        return None
    x, y, w, h = roi
    out = np.empty((h, w), np.float32)
    rc = lib.gs_load_depth_f32(
        os.fsencode(str(path)), x, y, w, h, ctypes.c_float(depth_scale), out
    )
    return out if rc == 0 else None


def crc8(data: bytes) -> int:
    lib = _find_lib()
    if lib is not None:
        return int(lib.gs_crc8(data, len(data)))
    # pure-Python fallback (poly 0x07)
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc
