"""Build and load the port's CUDA kernels.

Every ``*.cu`` source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
(with ``-I csrc``, so the sources share ``attention_core.cuh``) into one
shared library with a plain C interface, ``build/apex_tpu_torch/
libkernels.so`` beside the package, and loaded with :mod:`ctypes`.  The
build runs at first use and again whenever a source, a header or the flags
change (the SHA-256 of every ``*.cu`` and ``*.cuh`` under ``csrc/`` and of
the flags is kept beside the library).  The sources compile in parallel,
one ``nvcc`` each, and link in one more call; the tensor-core kernels
reach ``cuTensorMapEncodeTiled`` through the runtime's driver entry point,
so the link line needs no ``-lcuda``.

Nothing here falls back: without ``nvcc`` or on a failed compile the build
raises, and a kernel wrapper handed a CUDA tensor raises with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

__all__ = ["build", "library", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "apex_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# argtypes of every launcher: pointers and the stream as c_void_p, so no
# 64-bit address is cut to a 32-bit int
_SIGNATURES = {
    "apex_paged_attention_decode":
        [_I, _I] + [_P] * 8 + [_I] * 6 + [_F, _P],
    "apex_paged_decode_split": [_I] + [_P] * 10 + [_I] * 7 + [_F, _P],
    "apex_paged_decode_splits": [_I],
    "apex_paged_attention_prefill":
        [_I, _I] + [_P] * 9 + [_I] * 8 + [_F, _P],
    "apex_paged_prefill_tc": [_I] + [_P] * 9 + [_I] * 8 + [_F, _P],
    "apex_paged_prefill_tc_smem": [_I, _I],
    "apex_fused_residual_norm": [_I, _I, _I] + [_P] * 7 + [_I, _I, _F, _P],
    "apex_flash_fwd": [_I] + [_P] * 8 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_fwd_tc": [_P] * 8 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_fwd_tc_smem": [_I],
    "apex_flash_dq": [_I] + [_P] * 10 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_dkv": [_I] + [_P] * 11 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_dq_tc": [_P] * 10 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_dkv_tc": [_P] * 11 + [_I] * 8 + [_F, _U, _F, _P],
    "apex_flash_dq_tc_smem": [_I],
    "apex_flash_dkv_tc_smem": [_I],
    "apex_lora_delta": [_I, _I] + [_P] * 5 + [_I] * 6 + [_L, _L, _P],
    "apex_lora_delta_cluster": [_I, _I] + [_P] * 5 + [_I] * 6 + [_L, _L, _P],
    "apex_row_norm": [_I, _I, _I] + [_P] * 4 + [_I, _I, _F, _P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# what the build of the loaded library printed (ptxas register and
# shared-memory use), kept beside it as libkernels.log
last_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin); "
            "the port's CUDA kernels cannot be built")
    return str(path)


def _digest() -> str:
    """SHA-256 of the flags and of every source and header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/`` into ``libkernels.so`` unless an up-to-date build
    exists; return the library's path."""
    global last_build_log
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    saved_log = BUILD_DIR / "libkernels.log"
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        if saved_log.exists():
            last_build_log = saved_log.read_text()
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        name = src.name
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
               str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = BUILD_DIR / f"libkernels.{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking libkernels.so failed:\n{link.stdout}")
        os.replace(tmp, lib)
        last_build_log = "\n".join(logs)
        saved_log.write_text(last_build_log)
        stamp.write_text(digest)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB
