"""Build, load and launch the package's CUDA kernels.

Each `csrc/*.cu` file compiles in its own `nvcc` process, all started
together, and one link makes a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds).  The
library goes to `build/rso_torch/<hash>/` under the repository root, keyed
by a hash of the sources and flags, and is built at first use: importing
this module builds nothing and needs no toolkit.

Each C entry point launches one kernel on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code and counts the
launch.  `LAUNCHES` is how a run shows that its main path went through the
kernels.  While a CUDA graph is captured, nothing launches: the launches go
to the capture's own record (`record_begin`), and rso_torch.graphs adds them to
LAUNCHES each time it launches the graph; those inside the graph's
conditional nodes (a loop's blocks, a branch) are counted on the device and
added by rso_torch.graphs.settle_launches.  The mesh forms' all_reduces
(`COLLECTIVES`, rso_torch.mesh) are counted the same way: a capture records
them beside the launches (`count_collective`) and `tally` adds a record's
counts to both counters.

Every entry but the null vectors' takes a lane count B: B independent
problems (the sequences of a batched step) in one launch, a grid axis over
the lanes, each operand [B, ...] with its lanes contiguous (the GN
iteration's and RANSAC's inputs may be one for every lane: a lanes' stride
of 0).  A batched
launch counts once, as a replayed one does, so the launches a frame show
that the lanes share them.  The wrappers are custom ops whose vmap rules
(`lanes` below gives their operands) make that one launch, as vmap over a
`pallas_call` adds a grid axis in the reference.
"""
from __future__ import annotations

import collections
import ctypes
import functools
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
              "-Xcompiler", "-fPIC")


# launches per kernel name, incremented only where a kernel is launched
LAUNCHES: collections.Counter = collections.Counter()
# all_reduce calls by "<stage> <axes>": stage "solve" inside an LM loop,
# "gather" for the result after it; axes the mesh dimensions of the group
COLLECTIVES: collections.Counter = collections.Counter()
# the launch records of the captures in progress (innermost last): kernel
# names, and ("all_reduce", key) for a collective
_RECORDS: list = []


def record_begin() -> collections.Counter:
    """From now until record_end, count launches and collectives in the
    Counter returned instead of LAUNCHES and COLLECTIVES: a CUDA graph
    capture, which launches nothing."""
    rec = collections.Counter()
    _RECORDS.append(rec)
    return rec


def record_end(rec: collections.Counter) -> None:
    _RECORDS.remove(rec)


def count_launch(name: str) -> None:
    """One launch of kernel `name`: in the innermost record, else in
    LAUNCHES."""
    if _RECORDS:
        _RECORDS[-1][name] += 1
    else:
        LAUNCHES[name] += 1


def count_collective(key: str) -> None:
    """One all_reduce under `key`: in the innermost record, else in
    COLLECTIVES."""
    if _RECORDS:
        _RECORDS[-1][("all_reduce", key)] += 1
    else:
        COLLECTIVES[key] += 1


def tally(record: collections.Counter) -> None:
    """Add a record's counts to LAUNCHES and COLLECTIVES."""
    for key, n in record.items():
        if n:
            if isinstance(key, tuple):
                COLLECTIVES[key[1]] += n
            else:
                LAUNCHES[key] += n


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_PU = ctypes.POINTER(ctypes.c_ulonglong)
# C signatures: every pointer (and the stream) is a c_void_p
_SIGNATURES = {
    "rso_corner_response": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rso_corner_tile_fits": [_I],
    "rso_stereo_sad_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _F, _F, _F, _P, _P, _P, _P],
    "rso_track_sad_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _F, _F, _F, _P, _P, _P],
    "rso_nullvec9": [_P, _P, _I, _P],
    "rso_hamming_matrix": [_P, _P, _I, _I, _I, _I, _P, _P],
    "rso_sad_matrix": [_P, _P, _I, _I, _I, _I, _P, _P],
    "rso_gn_iter": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _F, _F, _I, _I, _I, _I, _P],
    "rso_lk_track": [_PP, _PP, ctypes.POINTER(ctypes.c_int), _I, _I, _I, _I,
                     _P, _P, _I, _I, _I, _F, _P, _P, _P, _P],
    "rso_ransac_fits": [_I, _I],
    "rso_ransac": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _I, _P, _L,
                   _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P, _PP, _P],
    # csrc/graph_cond.cu: composing and launching CUDA graphs, the stage
    # clock's marks
    "rso_graph_create": [_PP],
    "rso_graph_destroy": [_P],
    "rso_graph_add_child": [_P, _P, _P, _PP],
    "rso_graph_add_handle": [_P, _PU],
    "rso_graph_add_cond": [_P, _P, ctypes.c_ulonglong, _I, _PP, _PP],
    "rso_graph_add_set": [_P, _P, ctypes.c_ulonglong, _P, _P, _P, _I, _PP],
    "rso_graph_instantiate": [_P, _PP],
    "rso_graph_exec_destroy": [_P],
    "rso_graph_launch": [_P, _P],
    "rso_graph_node_types": [_P, ctypes.POINTER(ctypes.c_int), _I],
    "rso_stage_mark": [_P, _I, _I, _P],
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


def _check(cmd: list, returncode: int, stdout: str, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


def build() -> Path:
    """Compile csrc/*.cu into the shared library (skipped when it exists):
    one nvcc per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # every compile is waited for before the first failure is raised
    done = []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        done.append((cmd, proc.returncode, stdout, stderr))
    for result in done:
        _check(*result)
    tmp = out.with_name(f"{out.name}.{tag}")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _check(cmd, proc.returncode, proc.stdout, proc.stderr)
    for _, obj, _ in jobs:
        obj.unlink()
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


def launch(name: str, *args, counted_as: str | None = None) -> None:
    """Call C entry `rso_<name>` on the current stream; raise on error.
    The launch counts under `counted_as` where an entry has two paths."""
    fn = getattr(load(), f"rso_{name}")
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel rso_{name} failed to launch: "
                           f"cudaError {rc}")
    count_launch(counted_as or name)


def call(name: str, *args) -> None:
    """Call C entry `rso_<name>` (no stream, no count); raise on error."""
    rc = getattr(load(), f"rso_{name}")(*args)
    if rc != 0:
        raise RuntimeError(f"rso_{name} failed: cudaError {rc}")


@functools.cache
def _tile_fits(device: int, win: int) -> bool:
    rc = load().rso_corner_tile_fits(win)
    if rc < 0:
        raise RuntimeError(f"rso_corner_tile_fits: cudaError {-rc}")
    return rc == 1


def tile_fits(win: int) -> bool:
    """Whether kernel 1 takes its one-tile path at half-width `win` on the
    current device (else its wide path); asked of the device once."""
    return _tile_fits(torch.cuda.current_device(), win)


def require_cuda(name: str, t: torch.Tensor) -> None:
    """Build and load the library, and raise unless `t` is on a CUDA
    device (a wrapper never falls back to its twin)."""
    load()
    if not t.is_cuda:
        raise ValueError(f"{name}: operands on {t.device}")


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


def lanes(batch_size: int, in_dims, tensors) -> list:
    """The operands of one batched launch, from a vmap rule's arguments:
    each tensor with its batch dimension (`in_dims`) moved first, or, where
    it has none, repeated over the batch_size lanes; all contiguous."""
    return [(t.movedim(d, 0) if d is not None
             else t.expand(batch_size, *t.shape)).contiguous()
            for t, d in zip(tensors, in_dims)]
