"""ctypes loader for the native JPEG decode kernel (port of
:mod:`apex_tpu.data._jpeg_native`; the source is the port's own copy,
``apex_tpu_torch/_native/jpegdec.c``).

Compiled at first use with the system ``cc -O3 -shared -fPIC ...
-ljpeg`` into ``build/apex_tpu_torch/`` beside the package (never into
the package directory), under a name keyed on the SHA-256 of the source
and the flags, so an edited source builds anew and a stale library is
never loaded.  The compile goes to a pid-suffixed temporary name and is
published with ``os.replace``, so concurrent processes never load a
half-written library.

Every entry point degrades cleanly, as the reference's do:
:func:`native_available` is False when there is no compiler or no
libjpeg (:func:`build_error` then says why), and
:func:`decode_crop_resize` returns ``None`` on any per-image decode
failure (corrupt file, CMYK, ...) so the caller falls back to PIL for
that image.  This is host code only and imports no torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_available", "jpeg_dims", "decode_crop_resize",
           "build_error"]

SOURCE = Path(__file__).resolve().parent.parent / "_native" / "jpegdec.c"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "apex_tpu_torch")
CC_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CC_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libjpegdec-{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["cc", *CC_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"cc exited {proc.returncode}: "
                f"{(proc.stderr or proc.stdout).strip()[-400:]}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    if _TRIED:  # lock-free fast path
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        lib = None
        try:
            so = _library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            # inside the try: a library missing the symbols must degrade
            # to PIL, not raise out of the loader's constructor
            lib.jpegdec_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.jpegdec_dims.restype = ctypes.c_int
            lib.jpegdec_decode_crop_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.jpegdec_decode_crop_resize.restype = ctypes.c_int
        except Exception as e:  # noqa: BLE001 — recorded, PIL decodes
            lib = None
            _ERROR = f"{type(e).__name__}: {e}"
        _LIB = lib
        _TRIED = True
        return _LIB


def native_available() -> bool:
    """True when the kernel compiled and loaded (cc + libjpeg present)."""
    return _build_and_load() is not None


def build_error() -> Optional[str]:
    """Why the kernel is unavailable (the compiler's last words), or
    ``None`` when it loaded or was never tried."""
    _build_and_load()
    return _ERROR


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """Header-only ``(height, width)`` of a JPEG byte string, or ``None``
    when the native kernel is unavailable or the header does not parse."""
    lib = _build_and_load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.jpegdec_dims(data, len(data), ctypes.byref(h),
                        ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_crop_resize(data: bytes, cy: int, cx: int, ch: int, cw: int,
                       out_h: int, out_w: int, hflip: bool = False
                       ) -> Optional[np.ndarray]:
    """Decode + crop (full-res source coords) + bilinear resize in one
    native call -> uint8 HWC ``(out_h, out_w, 3)``, or ``None`` on any
    failure (the caller falls back to PIL).  The decode runs at the
    smallest M/8 DCT scale that still covers the output size."""
    lib = _build_and_load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.jpegdec_decode_crop_resize(
        data, len(data), int(cy), int(cx), int(ch), int(cw),
        int(out_h), int(out_w), int(bool(hflip)),
        out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out
