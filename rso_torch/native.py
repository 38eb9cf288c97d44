"""ctypes bindings to the native host library (native/rso_native.cpp).

Counterpart of rso/native.py: independent C++ implementations of the hot
pixel kernels with the reference's contracts (compute_SAD8, tracking_SAD,
FAST segment test), used as cross-language oracles for the CUDA kernels and
their twins.  The library is built from the source at first use, with g++,
into build/rso_torch/native/<hash>/ (the hash covers the source, the flags
and the host CPU: the build is -march=native, so a copy built on another
host could die on an illegal instruction; native/librso_native.so is never
loaded).  Every entry point raises OSError, and `available()` is False,
where it cannot be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
_BUILD_ROOT = _REPO / "build" / "rso_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_LIB = None


def _host_cpu() -> bytes:
    """What -march=native depends on: the CPU's model and feature flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))).encode()


def build_library(name: str, source: Path, flags: tuple,
                  libs: tuple = ()) -> Path:
    """Compile one C++ source into build/rso_torch/native/<hash>/lib<name>.so
    (skipped when it exists); raises OSError where it cannot be built."""
    h = hashlib.sha256(" ".join(flags + libs).encode())
    h.update(_host_cpu())
    h.update(source.read_bytes())
    out = _BUILD_ROOT / "native" / h.hexdigest()[:16] / f"lib{name}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError(f"cannot build {out.name}: g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, str(source), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except subprocess.SubprocessError as e:
        raise OSError(f"cannot build {out.name}: {e}") from e
    if proc.returncode != 0:
        raise OSError(f"cannot build {out.name} ({proc.returncode}):\n"
                      f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library(
        "rso_native", _REPO / "native" / "rso_native.cpp",
        CXX_FLAGS + ("-pthread",))))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    c = ctypes.c_int

    lib.rso_compute_sad8.restype = ctypes.c_uint32
    lib.rso_compute_sad8.argtypes = [u8p, u8p, c, c, c, c, c]
    lib.rso_sad_matrix.restype = None
    lib.rso_sad_matrix.argtypes = [u8p, c, u8p, c, u32p, c]
    lib.rso_hamming_matrix.restype = None
    lib.rso_hamming_matrix.argtypes = [u32p, c, u32p, c, u32p]
    lib.rso_tracking_sad.restype = ctypes.c_uint32
    lib.rso_tracking_sad.argtypes = [u8p, c, c, c, u8p, c, c, c, c, i32p, i32p]
    lib.rso_fast_detect.restype = c
    lib.rso_fast_detect.argtypes = [u8p, c, c, c, c, c, i32p, c]
    lib.rso_downsample2x.restype = None
    lib.rso_downsample2x.argtypes = [u8p, c, c, c, u8p]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _u8(a):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compute_sad8(img_a: np.ndarray, img_b: np.ndarray, ax: int, ay: int,
                 bx: int, by: int) -> int:
    """Scalar 8x8 SAD at two keypoints (reference compute_SAD8 contract)."""
    lib = _load()
    a, pa = _u8(img_a)
    b, pb = _u8(img_b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"images of widths {a.shape[1]} and {b.shape[1]}")
    return int(lib.rso_compute_sad8(pa, pb, a.shape[1], ax, ay, bx, by))


def sad_matrix(patches_a: np.ndarray, patches_b: np.ndarray,
               n_threads: int = 4) -> np.ndarray:
    """[Ka,Kb] u32 SAD of 8x8 u8 patches ([K,64] or [K,8,8])."""
    lib = _load()
    a, pa = _u8(np.reshape(patches_a, (len(patches_a), 64)))
    b, pb = _u8(np.reshape(patches_b, (len(patches_b), 64)))
    out = np.empty((len(a), len(b)), np.uint32)
    lib.rso_sad_matrix(pa, len(a), pb, len(b),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                       n_threads)
    return out


def hamming_matrix(desc_a: np.ndarray, desc_b: np.ndarray) -> np.ndarray:
    """[Ka,Kb] u32 Hamming distances of [K,8] u32 descriptors."""
    lib = _load()
    a = np.ascontiguousarray(desc_a, np.uint32)
    b = np.ascontiguousarray(desc_b, np.uint32)
    if a.shape[1:] != (8,) or b.shape[1:] != (8,):
        raise ValueError(f"descriptors of 8 words, got {a.shape}, {b.shape}")
    out = np.empty((len(a), len(b)), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rso_hamming_matrix(a.ctypes.data_as(u32p), len(a),
                           b.ctypes.data_as(u32p), len(b),
                           out.ctypes.data_as(u32p))
    return out


def tracking_sad(img: np.ndarray, template8x8: np.ndarray, cx: int, cy: int,
                 wx: int, wy: int):
    """Windowed min-SAD search (reference tracking_SAD contract).
    Returns (best_x, best_y, best_sad)."""
    lib = _load()
    a, pa = _u8(img)
    t, pt = _u8(np.reshape(template8x8, 64))
    bx = ctypes.c_int32()
    by = ctypes.c_int32()
    sad = lib.rso_tracking_sad(pa, a.shape[1], a.shape[1], a.shape[0], pt,
                               cx, cy, wx, wy, ctypes.byref(bx),
                               ctypes.byref(by))
    return int(bx.value), int(by.value), int(sad)


def fast_detect(img: np.ndarray, threshold: int, arc: int = 12,
                max_out: int = 100000) -> np.ndarray:
    """Scalar FAST-N detector; returns [N,2] int32 (x, y)."""
    lib = _load()
    a, pa = _u8(img)
    out = np.empty((max_out, 2), np.int32)
    n = lib.rso_fast_detect(pa, a.shape[1], a.shape[1], a.shape[0], threshold,
                            arc,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            max_out)
    return out[: min(n, max_out)]


def downsample2x(img: np.ndarray) -> np.ndarray:
    """2x2 mean of a u8 image, rounded half up, odd last row/column
    dropped."""
    lib = _load()
    a, pa = _u8(img)
    h2, w2 = a.shape[0] // 2, a.shape[1] // 2
    out = np.empty((h2, w2), np.uint8)
    lib.rso_downsample2x(pa, a.shape[1], a.shape[1], a.shape[0],
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
