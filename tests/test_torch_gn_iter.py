"""The GN iteration kernel (rso_torch/csrc/gn_iter.cu) against its plain
version (rso_torch.solver.robust_gn.gn_iteration_torch), and the solver's
dispatch between them.

On the CPU: the plain iteration is what a CPU tensor runs (the kernel is
never asked), the kernel's variant follows LeastSquaresParams and the
weights, the plain iteration's outcomes on the degenerate cases the kernel
is held to, and the carry written in place (the kernel's protocol, here by
a stand-in that writes the plain iteration's answer into the carry) under
torch.func.vmap and both eager loop runners, equal to the same vmap of
the plain iterations.

On the card (marked `gpu`; this file imports no jax, so it runs on a GPU
host as `python -m pytest --noconftest -m gpu tests/test_torch_gn_iter.py`):
one iteration and whole two-phase solves of tests/test_solver.py's cases
and of the degenerate ones, in every variant (robust kernel on and off,
IRLS on and off, weights given or not, chol and eigh, with and without LM),
the kernel against the plain version on the same card; 11 lanes that stop
at different iterations under vmap, one launch a block, each lane its lone
launch's bits; one launch an iteration; and the composed step's GN WHILE
body, which holds the kernel and the loop's flag and no PyTorch GN op.

Tolerances, the kernel against the plain version: integer and boolean
outputs exact (iterations, the stop, the abort, the error code, the
cost-increase count, inliers); the pose within 1e-5 (rso's batch bound:
both sum the normal equations in f32, in other orders), and one
iteration's increment within 1e-5 plus 1e-4 of its step (a first step of
~1 from afar through an H of condition number up to ~1e5 moves by its
sums' rounding times that; whole solves converge to within 1e-5); residuals
within 5e-3 px^2 (ROADMAP's bound for the batched step) plus 1e-5 of their
value (a squared residual carries twice its residual times its pixel's f32
rounding, ~1e-4 px at 1000 px: 1e-2 px^2 at a 100 px residual, and a slot
at Z ~ 0 reaches 5e25 px^2), and the cost within 5e-3 relative or 5e-3
absolute (px^2; an exact problem's cost is ~1e-8); non-finite entries where
the plain version has them.  A lane in a batch is its lone launch bit for
bit (a lane is one block running the same code): every field the solve's
GN loops give, and the pose from it within 1e-5 (pose_inverse under vmap
is PyTorch's batched arithmetic).
"""
import functools
import math

import pytest
import torch

import _torch_card as card
import _torch_gn_cases as C
from _torch_gn_cases import COST_RTOL, POSE_ATOL, RES_ATOL
from rso_torch.graphs import in_place_blocks, reset_launches, settle_launches
from rso_torch.kernels import _lib
from rso_torch.kernels import gn_iter as GI
from rso_torch.solver import robust_gn as G

SOLVE_INTS = ("valid", "error_code", "num_it", "num_it_final", "inliers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


def _plain_gn(monkeypatch):
    """The solver's iteration forced to the plain version on any device."""
    monkeypatch.setattr(G, "gn_iteration", lambda *a: functools.partial(
        G.gn_iteration_torch, *a))


def _same_solve(got, want, what):
    for name in SOLVE_INTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), (
            f"{what}: {name}")
    torch.testing.assert_close(got.delta_pose, want.delta_pose, rtol=0,
                               atol=POSE_ATOL, msg=C.msg(what, "delta_pose"))
    torch.testing.assert_close(got.pose, want.pose, rtol=0, atol=POSE_ATOL,
                               msg=C.msg(what, "pose"))
    C.close_res(got.residuals, want.residuals, what)
    C.close_cost(got.cost, want.cost, what)


# ---- the CPU: dispatch, variants, the plain iteration's outcomes ---------

@pytest.mark.parametrize("backend", ["chol", "eigh"])
@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("irls", [False, True])
@pytest.mark.parametrize("robust", [False, True])
def test_variant_follows_the_params(robust, irls, lm, backend):
    """One kernel variant a combination of what the solve observes, each
    flag its own bit; nothing else selects one."""
    p = C.LeastSquaresParams(use_robust_kernel=robust,
                             irls_hessian_weighting=irls, use_lm=lm,
                             solve_backend=backend)
    for weighted in (False, True):
        v = GI.variant(p, weighted)
        assert bool(v & GI.ROBUST) == robust and bool(v & GI.IRLS) == irls
        assert bool(v & GI.LM) == lm and bool(v & GI.WEIGHTED) == weighted
        assert bool(v & GI.EIGH) == (backend == "eigh")
        assert 0 <= v < 32


def test_variant_refuses_an_unknown_backend():
    with pytest.raises(ValueError):
        GI.variant(C.LeastSquaresParams(solve_backend="svd"), False)


def test_the_kernel_refuses_cpu_tensors():
    prev, cur, mask, _ = C.case_inputs("noisy")
    with pytest.raises(ValueError):
        GI.gn_iteration_cuda(C.camera(), C.landmarks(prev), cur, mask, None,
                             C.params("robust"), 10, G.VOEC_INCR_FUNC_COST_STG1,
                             G.VOEC_BAD_COND_NUMBER)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(C.CASES))
def test_cpu_tensors_run_the_plain_iteration(monkeypatch, case, weighted):
    """On the CPU the solver's iteration is gn_iteration_torch, and the
    kernel's wrapper is never called: the solve equals the plain one
    forced on every device, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was asked for CPU tensors")

    prev, cur, mask, w = C.case_inputs(case, weighted=weighted)
    p = C.params("robust")
    it = G.gn_iteration(C.camera(), C.landmarks(prev), cur, mask, w, p, 10,
                        G.VOEC_INCR_FUNC_COST_STG1)
    assert it.func is G.gn_iteration_torch
    monkeypatch.setattr(G, "gn_iteration_cuda", refuse)
    got = G.solve_pose(C.camera(), prev, cur, mask, p, obs_weight=w)
    _plain_gn(monkeypatch)
    want = G.solve_pose(C.camera(), prev, cur, mask, p, obs_weight=w)
    card.same_bits("the plain solve", got, want)


@pytest.mark.parametrize("variant", sorted(C.VARIANTS))
def test_plain_iteration_after_the_stop_changes_nothing(variant):
    prev, cur, mask, w = C.case_inputs("outliers", weighted=True)
    p = C.params(variant)
    c = C.carry(len(mask), C.DEFAULT_POSE, p, it=4, cost=7.0, times_inc=1,
                active=False)
    out = G.gn_iteration_torch(C.camera(), C.landmarks(prev), cur, mask, w,
                               p, 10, G.VOEC_INCR_FUNC_COST_STG2, c)
    for field, a, b in zip(out._fields, out, c):
        assert (a is None and b is None) or torch.equal(a, b), field


# outcome of one plain iteration from each degenerate case's carry:
# (error code, abort, active)
DEGENERATE_OUTCOMES = {
    "all_masked": (G.VOEC_BAD_COND_NUMBER, True, False),
    "not_positive_definite": (G.VOEC_BAD_COND_NUMBER, True, False),
    "z_zero": (G.VOEC_BAD_COND_NUMBER, True, False),
    "non_finite_masked": (G.VOEC_BAD_COND_NUMBER, True, False),
    "few_inliers": (G.VOEC_NONE, False, True),
    "cost_increase": (G.VOEC_INCR_FUNC_COST_STG1, True, False),
    "condition_cap": (G.VOEC_BAD_COND_NUMBER, True, False),
    "last_iteration": (G.VOEC_NONE, False, False),
}


def _degenerate_params():
    return [(name, v) for name, (variants, _) in sorted(C.DEGENERATE.items())
            for v in variants]


@pytest.mark.parametrize("name,variant", _degenerate_params())
def test_plain_iteration_on_the_degenerate_cases(name, variant):
    """The outcomes the kernel is held to: a bad condition (no slot, a
    rank-deficient or nearly singular H, an overflowing Jacobian, a NaN
    slot outside the mask) keeps the increment and aborts with
    VOEC_BAD_COND_NUMBER; the cost-increase abort its phase's code; the
    last iteration stops without an abort; seven slots still solve."""
    lmks, obs, mask, c, p = C.degenerate(name, variant)
    out = G.gn_iteration_torch(C.camera(), lmks, obs, mask, None, p, 10,
                               G.VOEC_INCR_FUNC_COST_STG1, C.clone(c))
    ec, abort, active = DEGENERATE_OUTCOMES[name]
    assert (int(out.ec), bool(out.abort), bool(out.active)) == (
        ec, abort, active)
    assert int(out.it) == int(c.it) + 1
    if ec == G.VOEC_BAD_COND_NUMBER:
        assert torch.equal(out.dp, c.dp)


def _in_place_stand_in(monkeypatch):
    """The kernel's protocol on the CPU: the iteration writes the plain
    version's answer into the carry it was given and returns that carry."""
    def gn_iteration(*a):
        def iteration(c):
            new = G.gn_iteration_torch(*a, c)
            for dst, src in zip(c, new):
                if dst is not None:
                    dst.copy_(src)
            return c
        return iteration

    monkeypatch.setattr(G, "gn_iteration", gn_iteration)


@pytest.mark.parametrize("runner", ["eager_blocks", "in_place_blocks"])
@pytest.mark.parametrize("variant", ["robust", "eigh_lm"])
def test_in_place_carry_under_vmap_equals_the_lanes(monkeypatch, variant,
                                                    runner):
    """Five lanes that stop at different iterations, their solves under
    torch.func.vmap with the carry written in place, equal bit for bit to
    the same vmap of the plain iterations, which return a new carry (the
    batched step's protocol, which the kernel follows on the card)."""
    loop = {"eager_blocks": G.eager_blocks,
            "in_place_blocks": in_place_blocks}[runner]
    p = C.params(variant)
    cases = ["noisy", "outliers", "larger_rotation", "identity", "exact"]
    inputs = [C.case_inputs(c, weighted=True) for c in cases]
    stacked = [torch.stack([x[i] for x in inputs]) for i in range(4)]

    def solve(a, b, m, w):
        return G.solve_pose(C.camera(), a, b, m, p, obs_weight=w, loop=loop)

    want = torch.func.vmap(solve)(*stacked)
    _in_place_stand_in(monkeypatch)
    got = torch.func.vmap(solve)(*stacked)
    assert len(set((want.num_it + want.num_it_final).tolist())) > 1
    card.same_bits("the in-place carry", got, want)


def test_operands_of_one_launch():
    """The vmap rule's operands: an input shared by every lane has stride
    0, a lane's own its size; a carry leaf, written in place, must have its
    lanes first."""
    dev = torch.device("cpu")
    cam = torch.arange(9, dtype=torch.float32)
    ptr, stride = GI._input(cam, None, 4, "cam", torch.float32, (9,), dev)
    assert (ptr, stride) == (cam.data_ptr(), 0)
    lmks = torch.zeros(7, 4, 3)                     # lanes on dimension 1
    _, stride = GI._input(lmks, 1, 4, "lmks", torch.float32, (7, 3), dev)
    assert stride == 21
    assert GI._input(None, None, 4, "weight", torch.float32, (7,), dev) == (
        None, 0)
    res = torch.zeros(4, 7)
    assert GI._carry(res, 0, 4, "res", torch.float32, (7,), dev,
                     True) == res.data_ptr()
    with pytest.raises(ValueError):
        GI._carry(res.T, 1, 4, "res", torch.float32, (7,), dev, True)
    with pytest.raises(ValueError):
        GI._carry(res[0], None, 4, "res", torch.float32, (7,), dev, True)


# ---- the card: the kernel against the plain version ----------------------

def _iterate(cam, lmks, obs, mask, w, p, c, max_iters=10,
             code=G.VOEC_INCR_FUNC_COST_STG1):
    """(kernel's carry, plain version's carry) of one iteration from c."""
    kernel = GI.gn_iteration_cuda(cam, lmks, obs, mask, w, p, max_iters,
                                  code, G.VOEC_BAD_COND_NUMBER)(C.clone(c))
    plain = G.gn_iteration_torch(cam, lmks, obs, mask, w, p, max_iters, code,
                                 C.clone(c))
    return kernel, plain


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(C.VARIANTS))
@pytest.mark.parametrize("case", sorted(C.CASES))
def test_cuda_gn_iter_matches_the_plain_iteration(cuda, case, variant):
    """One iteration, weighted and not, from the first iteration's carry
    and from a later one's (a warm increment and a cost to compare)."""
    cam = C.camera(cuda)
    p = C.params(variant)
    for weighted in (False, True):
        prev, cur, mask, w = C.case_inputs(case, cuda, weighted)
        lmks = C.landmarks(prev)
        for start in (dict(dp=[0.0] * 6),
                      dict(dp=C.DEFAULT_POSE * 0.9, it=3, cost=50.0,
                           times_inc=1)):
            c = C.carry(len(mask), params=p, device=cuda, **start)
            reset_launches()
            kernel, plain = _iterate(cam, lmks, cur, mask, w, p, c)
            torch.cuda.synchronize()
            assert _lib.LAUNCHES["gn_iter"] == 1
            card.check_kernel("gn_iter", kernel, plain,
                              f"{case} {variant} w={weighted} "
                              f"it={start.get('it', 0)}", start=c)


@pytest.mark.gpu
@pytest.mark.parametrize("name,variant", _degenerate_params())
def test_cuda_gn_iter_degenerate_cases(cuda, name, variant):
    cam = C.camera(cuda)
    lmks, obs, mask, c, p = C.degenerate(name, variant, cuda)
    kernel, plain = _iterate(cam, lmks, obs, mask, None, p, c)
    card.check_kernel("gn_iter", kernel, plain, f"{name} {variant}", start=c)
    ec, abort, active = DEGENERATE_OUTCOMES[name]
    assert (int(kernel.ec), bool(kernel.abort), bool(kernel.active)) == (
        ec, abort, active)


@pytest.mark.gpu
def test_cuda_gn_iter_leaves_a_stopped_carry(cuda):
    prev, cur, mask, w = C.case_inputs("outliers", cuda, True)
    for variant in sorted(C.VARIANTS):
        p = C.params(variant)
        c = C.carry(len(mask), C.DEFAULT_POSE, p, it=4, cost=7.0,
                    times_inc=1, active=False, device=cuda)
        c.res.fill_(3.0)
        out = GI.gn_iteration_cuda(C.camera(cuda), C.landmarks(prev), cur,
                                   mask, w, p, 10, G.VOEC_INCR_FUNC_COST_STG2,
                                   G.VOEC_BAD_COND_NUMBER)(C.clone(c))
        for field, a, b in zip(out._fields, out, c):
            assert (a is None and b is None) or torch.equal(a, b), field


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(C.VARIANTS))
@pytest.mark.parametrize("case", sorted(C.CASES))
def test_cuda_solve_pose_matches_the_plain_solve(cuda, monkeypatch, case,
                                                 variant):
    """The whole two-phase solve, weighted and not: the kernel's (the
    solver's own path on the card) against the plain iterations', one
    kernel launch an iteration."""
    cam = C.camera(cuda)
    p = C.params(variant)
    for weighted in (False, True):
        prev, cur, mask, w = C.case_inputs(case, cuda, weighted)
        reset_launches()
        got = G.solve_pose(cam, prev, cur, mask, p, obs_weight=w)
        launches = dict(settle_launches())
        with monkeypatch.context() as m:
            _plain_gn(m)
            want = G.solve_pose(cam, prev, cur, mask, p, obs_weight=w)
        _same_solve(got, want, f"{case} {variant} weighted={weighted}")
        iters = int(got.num_it) + int(got.num_it_final)
        assert launches.get("gn_iter", 0) == iters
        assert "eigh6" not in launches


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["robust", "eigh_lm"])
def test_cuda_gn_iter_lanes_equal_lone_launches(cuda, variant):
    """11 lanes of a frame's shape (T = 896) under torch.func.vmap: one
    launch a block for every lane, lanes that stop at different iterations,
    each lane its lone solve bit for bit."""
    cam = C.camera(cuda)
    p = C.params(variant)
    inputs = [C.frame_inputs(100 + b, cuda) for b in range(11)]
    stacked = [torch.stack([x[i] for x in inputs]) for i in range(4)]
    reset_launches()
    got = torch.func.vmap(lambda a, b, m, w: G.solve_pose(
        cam, a, b, m, p, obs_weight=w))(*stacked)
    batched = dict(settle_launches())
    alone = []
    for x in inputs:
        alone.append(G.solve_pose(cam, *x[:3], p, obs_weight=x[3]))
    iters = [(int(r.num_it), int(r.num_it_final)) for r in alone]
    assert len(set(iters)) > 1, iters
    # the loops run to the slowest lane: one launch a block for all lanes
    assert batched["gn_iter"] == (max(i for i, _ in iters)
                                  + max(j for _, j in iters))
    for b, want in enumerate(alone):
        for field, x, y in zip(want._fields, got, want):
            if field == "pose":
                torch.testing.assert_close(x[b], y, rtol=0, atol=POSE_ATOL)
            else:
                assert torch.equal(x[b], y), (b, field)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(C.VARIANTS))
def test_cuda_frame_solve_matches_the_plain_solve(cuda, monkeypatch, variant):
    """A frame's T = 896 slots, octave weights and outliers: the kernel's
    solve against the plain iterations'; on a frame the residuals also
    within RES_ATOL alone, the slots left out the same, and the cost within
    COST_RTOL relative above 1 and absolute below."""
    cam = C.camera(cuda)
    p = C.params(variant)
    for seed in range(4):
        prev, cur, mask, w = C.frame_inputs(seed, cuda)
        got = G.solve_pose(cam, prev, cur, mask, p, obs_weight=w)
        with monkeypatch.context() as m:
            _plain_gn(m)
            want = G.solve_pose(cam, prev, cur, mask, p, obs_weight=w)
        _same_solve(got, want, f"frame {seed} {variant}")
        fin = want.residuals < 1e30
        assert torch.equal(fin, got.residuals < 1e30)
        gap = (got.residuals[fin] - want.residuals[fin]).abs()
        assert not fin.any() or gap.max() <= RES_ATOL, gap.max()
        g, w_ = got.cost.item(), want.cost.item()
        assert abs(g - w_) <= COST_RTOL * max(abs(w_), 1.0) or (
            math.isnan(g) and math.isnan(w_)), (g, w_)


@pytest.mark.gpu
def test_cuda_gn_while_body_is_the_kernel(cuda):
    """Engine's composed step on the bench scene: each GN WHILE node's body
    holds the kernel, the loop's flag and no PyTorch GN op (at most a few
    nodes), its recorded launches the kernel's one; after settle_launches
    LAUNCHES["gn_iter"] counts the GN blocks the frames ran (GN_BLOCK 1:
    their iterations)."""
    from rso_torch.engine import Engine
    from rso_torch.graphs import node_types
    from rso_torch.synthetic import make_sequence, synthetic_config

    assert G.GN_BLOCK == 1
    seq = make_sequence(n_frames=6, n_points=2000, H=376, W=1241)
    eng = Engine(synthetic_config(), seq.cam, device=cuda)
    frames = [(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
              for a, b in seq.frames]
    eng.process_frame(*frames[0])
    step = eng._get_step(376, 1241)
    blocks = [seg for v in step._variants.values()
              for segs in v.graphs.values() for seg in segs
              if seg.loop is not None]
    assert len(blocks) == 2
    for seg in blocks:
        types = node_types(seg.graph.raw_cuda_graph())
        assert sum(types.values()) <= 15, types
        assert dict(seg.launches) == {"gn_iter": 1}
    reset_launches()
    iters = 0
    for left, right in frames[1:]:
        r = eng.process_frame(left, right)
        iters += int(r.num_it) + int(r.num_it_final)
    assert settle_launches()["gn_iter"] == iters > 0
