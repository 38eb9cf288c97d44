"""ctypes bindings to the measured-reference baseline (native/rso_baseline.cpp).

Counterpart of rso/baseline.py.  The baseline library is an OpenCV port of
the reference pipeline (famoreno/stereo-vo stages 1-5); the tests hold the
port's pose solver to the reference solver's semantics through it, on
identical correspondences (solve_pose below).  It is built from the source
at first use with g++ and OpenCV 4 (pkg-config opencv4) into
build/rso_torch/native/<hash>/ (see rso_torch.native.build_library);
`available()` is False, and solve_pose raises OSError, where OpenCV 4's
development files or g++ are missing.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np

from rso_torch.native import _REPO, CXX_FLAGS, build_library

_LIB = None


def _opencv_flags() -> tuple:
    try:
        proc = subprocess.run(["pkg-config", "--cflags", "--libs", "opencv4"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise OSError(f"pkg-config: {e}") from e
    if proc.returncode != 0 or not proc.stdout.split():
        raise OSError("the baseline needs OpenCV 4 dev (pkg-config opencv4)")
    return tuple(proc.stdout.split())


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library(
        "rso_baseline", _REPO / "native" / "rso_baseline.cpp", CXX_FLAGS,
        _opencv_flags())))
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.baseline_solve_pose.restype = ctypes.c_int
    lib.baseline_solve_pose.argtypes = [f64p, f64p, u8p, ctypes.c_int, f64p,
                                        f64p, f64p, f64p, i32p]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def solve_pose(prev_obs: np.ndarray, cur_obs: np.ndarray, mask: np.ndarray,
               cam, params, initial_pose: np.ndarray | None = None):
    """Reference-semantics two-phase robust GN solve (getChangeInPose
    contract, common.cpp:355-413 -> stage5_optimization.cpp:392-736).

    cam: rso_torch StereoCamera; params: rso_torch LeastSquaresParams.
    Returns (pose6 [w,t] of current wrt previous, valid, (it1, it2)).
    """
    lib = _load()
    p = np.ascontiguousarray(prev_obs, np.float64).reshape(-1, 4)
    c = np.ascontiguousarray(cur_obs, np.float64).reshape(-1, 4)
    m = np.ascontiguousarray(mask, np.uint8)
    n = p.shape[0]
    if c.shape[0] != n or m.shape != (n,):
        raise ValueError(f"{n} previous observations, {c.shape[0]} current, "
                         f"mask {m.shape}")
    cam9 = np.array([float(cam.fx_l), float(cam.fy_l), float(cam.cx_l),
                     float(cam.cy_l), float(cam.fx_r), float(cam.fy_r),
                     float(cam.cx_r), float(cam.cy_r), float(cam.baseline)],
                    np.float64)
    sp7 = np.array([float(params.use_robust_kernel), params.kernel_param,
                    params.initial_max_iters, params.max_iters,
                    params.min_mod_out_vector, params.max_incr_cost,
                    params.residual_threshold], np.float64)
    init = (np.zeros(6) if initial_pose is None
            else np.ascontiguousarray(initial_pose, np.float64))
    out = np.zeros(6, np.float64)
    iters = np.zeros(2, np.int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    ok = lib.baseline_solve_pose(
        p.ctypes.data_as(f64p), c.ctypes.data_as(f64p),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        cam9.ctypes.data_as(f64p), sp7.ctypes.data_as(f64p),
        init.ctypes.data_as(f64p), out.ctypes.data_as(f64p),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, bool(ok), (int(iters[0]), int(iters[1]))
