"""RANSAC for the fundamental matrix as one CUDA kernel (csrc/ransac.cu).

No TPU kernel of the reference: rso's `ransac_fundamental`
(rso/solver/ransac.py) is plain XLA around kernel 4.  The port's plain
version is `rso_torch.solver.ransac.ransac_fundamental_torch`, which the
CPU keeps; `ransac.ransac_fundamental` takes this kernel for CUDA tensors,
eager and captured alike.  One launch runs a whole call: the keys and the
uniform draws (threefry-2x32, as rso_torch.random), the stratified samples,
the Hartley normalisation, every hypothesis's 8-point solve (kernel 4's
null-vector routine) and Sampson count, the winner, the refit and the
final mask, for both eyes.  See the header of csrc/ransac.cu for the design
and its bound on the H100.

The draws come from injected `draws`, else an explicit key a eye, else a
`rso_torch.random.FrameKeys` (the engine's: the kernel hashes the frame
index itself, so no key tensor is computed on the card).  The custom op
`rso_torch::ransac` has a vmap rule: under torch.func.vmap (the batched
engine step) one launch runs every lane, the grid's y axis.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from rso_torch import random as rrandom
from rso_torch.kernels import _lib

_N9 = 9


@functools.cache
def _fits(device: int, N: int, H: int) -> bool:
    """Whether N points and H hypotheses fit a block's shared memory on
    `device` (else the points go to global scratch)."""
    rc = _lib.load().rso_ransac_fits(N, H)
    if rc < -1:
        raise RuntimeError(f"rso_ransac_fits: cudaError {-rc - 1}")
    if rc == -1:
        raise ValueError(f"ransac_cuda: {H} hypotheses do not fit a block's "
                         "shared memory")
    return rc == 1


def _operand(t, d, lanes, name, dtype, shape, dev):
    """(tensor, lanes' stride in elements) of an operand: a lane's own
    (`d`, its batch dimension, moved first) or one for every lane (d None,
    stride 0); (None, 0) where absent.  The tensor is contiguous and
    checked; it is kept until the launch."""
    if t is None:
        return None, 0
    if d is None:
        t = t.contiguous()
        _lib.check(t, name, dtype, shape, dev)
        return t, 0
    t = t.movedim(d, 0).contiguous()
    _lib.check(t, name, dtype, (lanes, *shape), dev)
    return t, math.prod(shape)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(lanes, in_dims, tensors, data, n_iters, threshold,
            probe=None):
    """One launch over `lanes` calls: p1, p2 [E,N,2], mask [N], key [E,2],
    frame [], draws [E,H,8] a lane (key, frame and draws may be None).
    Returns inliers [lanes,E,N], F [lanes,E,3,3], n_inliers [lanes,E],
    ok [lanes,E]; `probe`, a dict, receives the intermediates the tests
    read."""
    p1, p2, mask, key, frame, draws = tensors
    dev = p1.device
    E, N = p1.shape[-3], p1.shape[-2]
    H = int(n_iters)
    if N < 1 or H < 1 or E < 1:
        raise ValueError(f"ransac_cuda: {E} eye(s), {N} points, {H} "
                         "hypotheses")
    f32 = torch.float32
    if frame is not None and frame.dtype not in (torch.int32, torch.int64):
        frame = frame.to(torch.int64)
    ops = [_operand(t, d, lanes, name, dtype, shape, dev)
           for t, d, name, dtype, shape in zip(
               (p1, p2, mask, key, frame, draws), in_dims,
               ("p1", "p2", "mask", "key", "frame", "draws"),
               (f32, f32, torch.bool, torch.int64,
                None if frame is None else frame.dtype, f32),
               ((E, N, 2), (E, N, 2), (N,), (E, 2), (), (E, H, 8)))]
    frame = ops[4][0]
    inliers = torch.empty((lanes, E, N), dtype=torch.bool, device=dev)
    F = torch.empty((lanes, E, 3, 3), dtype=f32, device=dev)
    n_inl = torch.empty((lanes, E), dtype=torch.int32, device=dev)
    ok = torch.empty((lanes, E), dtype=torch.bool, device=dev)
    g_pts = g_idx = None
    if not _fits(dev.index, N, H):     # a copy for each block of a cluster
        g_pts = torch.empty((lanes, E, 8, N, 4), dtype=f32, device=dev)
        g_idx = torch.empty((lanes, E, 8, N), dtype=torch.int32, device=dev)
    probe_ptrs = None
    if probe is not None:
        i32 = torch.int32
        probe.update(
            draws=torch.empty((lanes, E, H, 8), dtype=f32, device=dev),
            idx=torch.empty((lanes, E, H, 8), dtype=i32, device=dev),
            T=torch.empty((lanes, E, 2, 3, 3), dtype=f32, device=dev),
            M=torch.empty((lanes, E, H + 1, _N9, _N9), dtype=f32, device=dev),
            x=torch.empty((lanes, E, H + 1, _N9), dtype=f32, device=dev),
            scores=torch.empty((lanes, E, H + 1), dtype=i32, device=dev),
            best=torch.empty((lanes, E), dtype=i32, device=dev))
        probe_ptrs = (ctypes.c_void_p * 7)(*(
            probe[k].data_ptr() for k in ("draws", "idx", "T", "M", "x",
                                          "scores", "best")))
    _lib.launch("ransac", *(x for t, stride in ops[:5]
                            for x in (_ptr(t), stride)),
                int(frame is not None and frame.dtype == torch.int64),
                _ptr(ops[5][0]), ops[5][1], lanes, E, N, H, int(data),
                float(threshold) * float(threshold),
                inliers.data_ptr(), F.data_ptr(), n_inl.data_ptr(),
                ok.data_ptr(), _ptr(g_pts), _ptr(g_idx), probe_ptrs)
    return inliers, F, n_inl, ok


@torch.library.custom_op(
    "rso_torch::ransac", mutates_args=(), device_types="cuda",
    schema="(Tensor p1, Tensor p2, Tensor mask, Tensor? key, Tensor? frame, "
           "Tensor? draws, int data, int n_iters, float threshold) "
           "-> (Tensor, Tensor, Tensor, Tensor)")
def _ransac_op(p1, p2, mask, key, frame, draws, data, n_iters, threshold):
    out = _launch(1, (None,) * 6, (p1, p2, mask, key, frame, draws), data,
                  n_iters, threshold)
    return tuple(o[0] for o in out)


@torch.library.register_vmap("rso_torch::ransac")
def _ransac_lanes(info, in_dims, p1, p2, mask, key, frame, draws, *scalars):
    """vmap: one launch for every lane (the grid's y axis)."""
    return (_launch(info.batch_size, in_dims[:6],
                    (p1, p2, mask, key, frame, draws), *scalars),
            (0, 0, 0, 0))


def _operands(p1, p2, mask, key, draws):
    """The op's tensors and `data` for a call of ransac_fundamental's
    signature; p1, p2 [E,N,2] (a single view's [N,2] takes E = 1)."""
    if isinstance(key, rrandom.FrameKeys):
        frame, data, key = key.frame, int(key.data), None
    else:
        frame, data = None, 0
        if key is not None and draws is None:
            key = key.reshape(p1.shape[0], 2).to(torch.int64)
        else:
            key = None
    return (p1.to(torch.float32), p2.to(torch.float32), mask.to(torch.bool),
            key, frame, draws), data


def ransac_cuda(p1: torch.Tensor, p2: torch.Tensor, mask: torch.Tensor, key,
                n_iters: int = 64, threshold: float = 1.0,
                draws: torch.Tensor | None = None):
    """The kernel (custom op `rso_torch::ransac`): p1, p2 [E,N,2], mask
    [N], key [E,2] or a rso_torch.random.FrameKeys, draws [E,n_iters,8] or
    None (it replaces the key).  Returns (inliers [E,N], F [E,3,3],
    n_inliers [E], ok [E])."""
    _lib.require_cuda("ransac_cuda", p1)
    tensors, data = _operands(p1, p2, mask, key, draws)
    return _ransac_op(*tensors, data, int(n_iters), float(threshold))


def ransac_probe(p1, p2, mask, key, n_iters: int = 64, threshold: float = 1.0,
                 draws=None):
    """One eager launch as ransac_cuda's that also returns the kernel's
    intermediates, a lane's: draws and idx [E,H,8], T1 and T2 [E,3,3], M
    [E,H+1,9,9] and x [E,H+1,9] (each hypothesis's normal matrix and null
    vector, the refit's last), scores [E,H+1] (the refit's count last),
    best [E]."""
    _lib.require_cuda("ransac_probe", p1)
    tensors, data = _operands(p1, p2, mask, key, draws)
    probe = {}
    out = _launch(1, (None,) * 6, tensors, data, n_iters, threshold,
                  probe=probe)
    probe = {k: v[0] for k, v in probe.items()}
    probe["T1"], probe["T2"] = probe["T"][:, 0], probe["T"][:, 1]
    return tuple(o[0] for o in out), probe
