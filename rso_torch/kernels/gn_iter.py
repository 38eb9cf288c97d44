"""The pose solver's GN iteration as one CUDA kernel (csrc/gn_iter.cu).

No TPU kernel of the reference: rso's GN iteration is plain XLA inside its
`lax.while_loop` (rso/solver/robust_gn.py `_eval_rgn`).  The port's plain
version is `rso_torch.solver.robust_gn.gn_iteration_torch`, ~470 small
PyTorch kernels an iteration on the GPU; the CPU keeps it, and the solver
takes this kernel for CUDA tensors (`robust_gn.gn_iteration`), eager and
captured alike.  The kernel runs the whole iteration, the 6x6 solve and the
carry update included, and writes the carry in place: one launch an
iteration, and in the GN loop's CUDA graph the WHILE node's body holds the
kernel and the loop's flag.  See the header of csrc/gn_iter.cu for the
design and its bound on the H100.

Its variant follows what the solve already observes (`variant`): the
robust kernel, IRLS weighting of H, per-slot weights, LM damping and the
solve backend, each a template parameter of the kernel.  The custom op
`rso_torch::gn_iter` has a vmap rule: under torch.func.vmap (the batched
engine step) one launch runs every lane, a block a lane.
"""
from __future__ import annotations

import math

import torch

from rso_torch.kernels import _lib

# the variant bits of csrc/gn_iter.cu
ROBUST, IRLS, WEIGHTED, LM, EIGH = 1, 2, 4, 8, 16
BACKENDS = {"chol": 0, "eigh": EIGH}


def variant(params, weighted: bool) -> int:
    """The kernel variant of a solve with LeastSquaresParams `params`, with
    per-slot weights or not."""
    if params.solve_backend not in BACKENDS:
        raise ValueError(f"gn_iter: solve_backend {params.solve_backend!r}")
    return (ROBUST * bool(params.use_robust_kernel)
            | IRLS * bool(params.irls_hessian_weighting)
            | WEIGHTED * bool(weighted) | LM * bool(params.use_lm)
            | BACKENDS[params.solve_backend])


# per lane: (name, dtype, shape from T) of the inputs, and of the carry's
# leaves, which the kernel writes in place, in GNCarry's order
_INPUTS = (("cam", torch.float32, lambda T: (9,)),
           ("lmks", torch.float32, lambda T: (T, 3)),
           ("obs", torch.float32, lambda T: (T, 4)),
           ("mask", torch.bool, lambda T: (T,)),
           ("weight", torch.float32, lambda T: (T,)))
_CARRY = (("it", torch.int32, lambda T: ()),
          ("active", torch.bool, lambda T: ()),
          ("dp", torch.float32, lambda T: (6,)),
          ("cost", torch.float32, lambda T: ()),
          ("times_inc", torch.int32, lambda T: ()),
          ("abort", torch.bool, lambda T: ()),
          ("res", torch.float32, lambda T: (T,)),
          ("ec", torch.int32, lambda T: ()),
          ("lam", torch.float32, lambda T: ()))
CARRY = tuple(name for name, _, _ in _CARRY)


def _input(t, d, lanes, name, dtype, shape, device):
    """(pointer, lanes' stride in elements) of an input: a lane's own
    (`d`, its batch dimension, moved first) or one for every lane (d None,
    stride 0)."""
    if t is None:
        return None, 0
    if d is None:
        t = t.contiguous()
        return _lib.check(t, name, dtype, shape, device), 0
    t = t.movedim(d, 0).contiguous()
    return (_lib.check(t, name, dtype, (lanes, *shape), device),
            math.prod(shape))


def _carry(t, d, lanes, name, dtype, shape, device, batched):
    """A carry leaf's pointer: written in place, so under vmap its lanes
    must be its first dimension, contiguous, as the solve makes them."""
    if t is None:
        return None
    if batched:
        if d != 0:
            raise ValueError(f"gn_iter: carry {name} with its lanes on "
                             f"dimension {d}, expected 0")
        shape = (lanes, *shape)
    return _lib.check(t, name, dtype, shape, device)


def _launch(lanes, in_dims, args) -> None:
    (cam, lmks, obs, mask, weight, *carry) = args[:14]
    (v, b2, min_mod, max_incr_cost, max_iters, incr_cost_code,
     bad_cond_code) = args[14:]
    dev = obs.device
    if not obs.is_cuda:
        raise ValueError(f"gn_iter: operands on {dev}")
    T = carry[CARRY.index("res")].shape[-1]   # its lanes, if any, first
    batched = in_dims is not None
    dims = in_dims if batched else (None,) * 14
    ins = [_input(t, d, lanes, name, dtype, shape(T), dev)
           for t, d, (name, dtype, shape) in zip(
               (cam, lmks, obs, mask, weight), dims[:5], _INPUTS)]
    ptrs = [_carry(t, d, lanes, name, dtype, shape(T), dev, batched)
            for t, d, (name, dtype, shape) in zip(carry, dims[5:], _CARRY)]
    flat = [x for pair in ins for x in pair]
    _lib.launch("gn_iter", *flat, *ptrs, lanes, T, v, b2, min_mod,
                max_incr_cost, max_iters, incr_cost_code, bad_cond_code)


@torch.library.custom_op(
    "rso_torch::gn_iter", mutates_args=CARRY, device_types="cuda",
    schema="(Tensor cam, Tensor lmks, Tensor obs, Tensor mask, Tensor? weight, "
           "Tensor(a!) it, Tensor(b!) active, Tensor(c!) dp, Tensor(d!) cost, "
           "Tensor(e!) times_inc, Tensor(f!) abort, Tensor(g!) res, "
           "Tensor(h!) ec, Tensor(i!)? lam, int variant, float b2, "
           "float min_mod, int max_incr_cost, int max_iters, "
           "int incr_cost_code, int bad_cond_code) -> ()")
def _gn_iter_op(cam, lmks, obs, mask, weight, it, active, dp, cost,
                times_inc, abort, res, ec, lam, variant, b2, min_mod,
                max_incr_cost, max_iters, incr_cost_code,
                bad_cond_code) -> None:
    _launch(1, None, (cam, lmks, obs, mask, weight, it, active, dp, cost,
                      times_inc, abort, res, ec, lam, variant, b2, min_mod,
                      max_incr_cost, max_iters, incr_cost_code,
                      bad_cond_code))


@torch.library.register_vmap("rso_torch::gn_iter")
def _gn_iter_lanes(info, in_dims, *args):
    """vmap: every lane in one launch, a block a lane."""
    _launch(info.batch_size, in_dims, args)
    return None, None


def gn_iteration_cuda(cam, lmks, obs, mask, obs_weight, params,
                      max_iters: int, incr_cost_code: int, bad_cond_code: int):
    """The iteration of one GN phase on CUDA tensors: a function of the
    carry (robust_gn.GNCarry) that runs the kernel over it in place and
    returns it.  The camera is stacked here, once a phase, outside the
    loop's body."""
    if not obs.is_cuda:
        raise ValueError(f"gn_iteration_cuda: obs on {obs.device}")
    _lib.load()
    cam9 = torch.stack(tuple(cam))
    v = variant(params, obs_weight is not None)
    scalars = (v, params.kernel_param * params.kernel_param,
               params.min_mod_out_vector, params.max_incr_cost, max_iters,
               incr_cost_code, bad_cond_code)

    def iteration(c):
        _gn_iter_op(cam9, lmks, obs, mask, obs_weight, *(getattr(c, k) for k
                                                        in CARRY), *scalars)
        return c

    return iteration
