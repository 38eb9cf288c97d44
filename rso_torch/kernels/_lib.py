"""Build, load and launch the package's CUDA kernels.

All `csrc/*.cu` files compile in ONE `nvcc` call into a shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The library goes to `build/rso_torch/<hash>/` under the
repository root, keyed by a hash of the sources and flags, and is built at
first use: importing this module builds nothing and needs no toolkit.

Each C entry point launches one kernel on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code and counts the
launch.  `LAUNCHES` is how a run shows that its main path went through the
kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "rso_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launches per kernel name, incremented only where a kernel is launched
LAUNCHES: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer (and the stream) is a c_void_p
_SIGNATURES = {
    "rso_corner_response": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rso_stereo_sad_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _F, _F, _F, _P, _P, _P, _P],
    "rso_track_sad_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _F, _F, _F, _P, _P, _P],
    "rso_nullvec9": [_P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "librso_kernels.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library (skipped when it exists)."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(_CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent builder never sees half a file
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library; raises on any failure."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry `rso_<name>` on the current stream; raise on error."""
    fn = getattr(load(), f"rso_{name}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel rso_{name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> int:
    """Validate a kernel operand and return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()
