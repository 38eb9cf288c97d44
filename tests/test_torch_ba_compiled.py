"""Bundle adjustment's LM loop in blocks of masked iterations, and the
compiled solve, on the CPU.

`LM_BLOCK` iterations run between two reads of the loop's stop flag, and an
iteration after the stop (or past max_iters) changes nothing: for every
block size the solve equals the one-iteration blocks bit for bit (poses,
landmarks, cost, n_iters, converged), and reads its flag once per block but
the last.  The cases: one window (robust, tol = 0, a tol that stops it
early), the odometry prior, the marginalization prior, both priors with a
landmark weight, and a batch of windows with a padding slot (`active`).

`solve_lm`, the compiled solve that `bundle_adjust` and the batched window
solve run, is on the CPU the same CompiledStep as on the card without the
capture: it equals the eager loop bit for bit, reads its flag as often,
never changes a result it returned, and keys its graphs by the Python
scalars they bake in (a call that differs only in tol, kernel_param or
max_iters gets its own).  With the odometry prior it holds against rso's
jitted solve at tests/test_torch_ba.py's tolerances (no noise-floor tie on
that problem, so n_iters and converged are exact).
"""
import functools

import jax
import numpy as np
import pytest
import torch

import rso.ba.ba as J
import rso_torch.ba.ba as T
import test_torch_ba as TBA
from rso_torch.ba.window_sharded import (
    stack_problems,
    window_sharded_bundle_adjust,
)
from rso_torch.solver.robust_gn import HOST_READS

MAX_ITERS = 12
BLOCKS = [1, 2, 3, 5, "max"]
PRIOR = dict(rel_w_rot=4e2, rel_w_trans=25.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: deterministic CPU sums, and the suite runs
    several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _window(seed, P=5, L=96):
    """(port BAProblem, true poses) of tests/test_ba.py's problem (made
    once; no test writes into it)."""
    from test_ba import make_ba_problem

    prob, true_poses, _ = make_ba_problem(np.random.default_rng(seed), P=P,
                                          L=L)
    return TBA._port(prob), np.asarray(true_poses)


def _case(name):
    """(BAProblem, levenberg_marquardt keyword arguments, active)."""
    prob, true_poses = _window(0)
    rel = torch.from_numpy(TBA._rel(true_poses, 0))
    marg = TBA._marg_prior(prob.poses.numpy(), 0)
    kw, active = {}, None
    if name == "tol0":
        kw = {"tol": 0.0}
    elif name == "early":
        kw = {"tol": 1e-2}
    elif name == "odometry_prior":
        kw = dict(PRIOR, rel_meas=rel)
    elif name == "marg_prior":
        kw = {"marg_prior": marg}
    elif name == "both_priors":
        prob = prob._replace(lmk_weight=torch.linspace(0.2, 1.0, 96))
        kw = dict(PRIOR, rel_meas=rel, marg_prior=marg)
    elif name == "batch":
        probs = [prob, _window(1)[0], _window(2)[0], prob]
        prob = stack_problems(probs)
        kw = dict(PRIOR, rel_meas=torch.stack([rel] * 4))
        active = torch.tensor([True, True, True, False])
    return prob, kw, active


CASES = ["window", "tol0", "early", "odometry_prior", "marg_prior",
         "both_priors", "batch"]


def _args(kw, max_iters=MAX_ITERS):
    a = dict(max_iters=max_iters, kernel_param=3.0, use_robust=True,
             fix_first=True, init_lambda=1e-4, tol=1e-5)
    a.update(kw)
    return a


def _eager(prob, kw, active, max_iters=MAX_ITERS):
    """levenberg_marquardt's eager loop: (result, flag reads)."""
    HOST_READS.clear()
    out = T.levenberg_marquardt(TBA.TCAM, prob, **_args(kw, max_iters),
                                active=active)
    return out, HOST_READS["lm"]


def _compiled(prob, kw, active, max_iters=MAX_ITERS):
    """solve_lm (the compiled solve's eager form): (result, flag reads)."""
    HOST_READS.clear()
    out = T.solve_lm(TBA.TCAM, prob, **_args(kw, max_iters), active=active)
    return out, HOST_READS["lm"]


def _reads(n_it: int, max_iters: int, block: int) -> int:
    """Flag reads of a solve that ran n_it iterations: one after each
    block that ran, but none after the last block the loop allows."""
    b = min(block, max_iters)
    return min(-(-n_it // b), -(-max_iters // b) - 1)


def _same(a, b, what):
    for field, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: {field} differs"


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", CASES)
def test_blocks_equal_one_iteration_blocks(monkeypatch, case, block):
    prob, kw, active = _case(case)
    monkeypatch.setattr(T, "LM_BLOCK", 1)
    one, reads_one = _eager(prob, kw, active)
    b = MAX_ITERS if block == "max" else block
    monkeypatch.setattr(T, "LM_BLOCK", b)
    out, reads = _eager(prob, kw, active)
    _same(one, out, f"LM_BLOCK {block}")
    n = int(one.n_iters.max())
    assert reads_one == _reads(n, MAX_ITERS, 1)
    assert reads == _reads(n, MAX_ITERS, b)
    if case == "tol0":
        assert n == MAX_ITERS and not bool(one.converged)
    if case == "early":
        assert n < MAX_ITERS and bool(one.converged)
    if case == "batch":
        assert int(one.n_iters[3]) == 0 and bool(one.converged[3])
        assert torch.equal(one.poses[3], prob.poses[3])
        assert len(set(one.n_iters[:3].tolist())) > 1


@pytest.mark.parametrize("case", CASES)
def test_compiled_solve_equals_the_eager_loop(case):
    prob, kw, active = _case(case)
    want, reads = _eager(prob, kw, active)
    got, got_reads = _compiled(prob, kw, active)
    _same(want, got, case)
    assert got_reads == reads
    again, _ = _compiled(prob, kw, active)
    _same(want, again, f"{case}, second call")


def test_bundle_adjust_is_the_compiled_solve():
    """bundle_adjust and the batched window solve go through solve_lm's
    cache (one entry each), equal to the eager loop."""
    prob, kw, _ = _case("both_priors")
    T._SOLVES.clear()
    got = T.bundle_adjust(TBA.TCAM, prob, max_iters=MAX_ITERS, **kw)
    _same(_eager(prob, kw, None)[0], got, "bundle_adjust")
    assert len(T._SOLVES) == 1
    probs = [_window(1)[0], _window(2)[0]]
    wins = window_sharded_bundle_adjust(TBA.TCAM, probs, max_iters=MAX_ITERS)
    assert len(T._SOLVES) == 2
    want, _ = _eager(stack_problems(probs), {"rel_meas": torch.zeros(2, 4, 6)},
                     None)
    for w, out in enumerate(wins):
        _same(type(want)(*(t[w] for t in want)), out, f"window {w}")


def test_a_later_call_leaves_an_earlier_result_unchanged():
    prob, _, _ = _case("window")
    other = _window(3)[0]
    first = T.bundle_adjust(TBA.TCAM, prob, max_iters=MAX_ITERS)
    held = type(first)(*(t.clone() for t in first))
    second = T.bundle_adjust(TBA.TCAM, other, max_iters=MAX_ITERS)
    _same(held, first, "the first result after a second call")
    assert not torch.equal(first.poses, second.poses)


@pytest.mark.parametrize("changed", ["tol", "kernel_param", "max_iters"])
def test_a_changed_scalar_gets_its_own_solve(changed):
    """The stale-graph guard: same shapes, one Python scalar changed; each
    call gives its own eager answer from its own cache entry."""
    prob, _, _ = _case("window")
    base = {"tol": 1e-5, "kernel_param": 3.0, "max_iters": MAX_ITERS}
    other = dict(base, **{"tol": {"tol": 1e-2}, "kernel_param":
                          {"kernel_param": 1.0}, "max_iters":
                          {"max_iters": 4}}[changed])
    T._SOLVES.clear()
    outs = []
    for kw in (base, other, base):
        m = kw["max_iters"]
        rest = {k: v for k, v in kw.items() if k != "max_iters"}
        got, _ = _compiled(prob, rest, None, max_iters=m)
        _same(_eager(prob, rest, None, max_iters=m)[0], got, str(kw))
        outs.append(got)
    assert len(T._SOLVES) == 2
    assert not torch.equal(outs[0].poses, outs[1].poses)


def test_compiled_solve_against_the_reference():
    """The odometry-prior window against rso's jitted bundle_adjust."""
    prob, true_poses = _window(0)
    jprob, _ = TBA._problem("P5")
    rel = TBA._rel(true_poses, 0)
    ref = J.bundle_adjust(TBA.CAM, jprob, max_iters=TBA.MAX_ITERS,
                          rel_meas=rel, **PRIOR)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    ours = T.bundle_adjust(TBA.TCAM, prob, max_iters=TBA.MAX_ITERS,
                           rel_meas=rel, **PRIOR)
    assert int(ours.n_iters) == int(ref.n_iters)
    assert bool(ours.converged) == bool(ref.converged)
    assert float(ours.cost) == pytest.approx(float(ref.cost),
                                             rel=TBA.COST_RTOL)
    np.testing.assert_allclose(ours.poses.numpy(), ref.poses, rtol=0,
                               atol=TBA.POSE_ATOL)
    np.testing.assert_allclose(ours.lmks.numpy(), ref.lmks, rtol=0,
                               atol=TBA.LMK_ATOL)
