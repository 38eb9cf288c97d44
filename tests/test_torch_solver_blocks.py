"""The pose solver's GN loop in blocks of masked iterations, on the CPU.

`GN_BLOCK` iterations run between two reads of the loop's stop flag, and
an iteration after the stop changes nothing: for every block size the solve
equals the one-iteration blocks bit for bit (every field, both phases'
iteration counts), and reads its flag once per block but the last.  With
one-iteration blocks it holds against rso's `lax.while_loop` solve at
tests/test_torch_solver.py's tolerances.  The cases: that file's problems,
robust and plain, a warm start with weights, the degenerate bad-condition
abort, the too-many-cost-increases abort in phase 1 and in phase 2 (GN and
LM), the eigh backend, and LM on both backends.
"""
import numpy as np
import pytest
import torch

import test_torch_solver as TS
from rso.config import LeastSquaresParams as JLS
from rso_torch.config import LeastSquaresParams as TLS
from rso_torch.solver import robust_gn
from rso_torch.solver import solve_pose as t_solve

BLOCKS = [2, 3, 4, 7, "max"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(case):
    return TS.make_problem(sorted(TS.CASES).index(case), **TS.CASES[case])


def _degenerate():
    prev, cur, mask = TS.make_problem(7, n=20)
    prev[:] = prev[0]
    cur[:] = cur[0]
    return prev, cur, mask


def _warm_start():
    prev, cur, mask = TS.make_problem(5, noise=0.3)
    init = np.asarray([0.0, 0.0, 0.0, 0.0, 0.0, -0.25], np.float32)
    weight = np.where(np.arange(len(mask)) % 3 == 0, 0.25, 1.0).astype(np.float32)
    return prev, cur, mask, init, weight


def _far_start():
    prev, cur, mask = TS.make_problem(0, noise=0.3)
    init = np.asarray([0.6, -0.4, 0.2, 1.0, 1.0, 1.0], np.float32)
    return prev, cur, mask, init, None


# name -> (problem, params kwargs, outcome-only comparison with rso)
SOLVES = {
    **{c: (lambda c=c: _problem(c), {}, False) for c in sorted(TS.CASES)},
    "warm_start_weights": (_warm_start, {}, False),
    "no_robust_kernel": (lambda: TS.make_problem(6, noise=0.3),
                         {"use_robust_kernel": False}, False),
    "degenerate_bad_cond": (_degenerate, {}, False),
    # max_incr_cost 0: the first cost increase aborts; phase 1 from a far
    # warm start, whose third step raises the cost by 2% (GN) and 6% (LM)
    "increase_phase_1": (_far_start, {"max_incr_cost": 0}, True),
    "increase_phase_1_lm": (_far_start, {"max_incr_cost": 0, "use_lm": True},
                            False),
    "increase_phase_2": (lambda: TS.make_problem(12, noise=0.5),
                         {"max_incr_cost": 0}, False),
    "increase_phase_2_lm": (lambda: TS.make_problem(0, noise=0.5),
                            {"max_incr_cost": 0, "use_lm": True,
                             "use_robust_kernel": False}, False),
    "eigh_outliers": (lambda: _problem("outliers"),
                      {"solve_backend": "eigh"}, False),
    "lm_chol_noisy": (lambda: _problem("noisy"), {"use_lm": True}, False),
    "lm_eigh_outliers": (lambda: _problem("outliers"),
                         {"solve_backend": "eigh", "use_lm": True}, False),
    "ill_conditioned_lm": (TS._ill_conditioned, {"use_lm": True}, True),
}


def _inputs(case):
    prob = SOLVES[case][0]()
    prev, cur, mask = prob[:3]
    init, weight = prob[3:] if len(prob) > 3 else (None, None)
    return prev, cur, mask, init, weight


def _solve(monkeypatch, case, block):
    """The port's solve with GN_BLOCK = block: (result, flag reads)."""
    prev, cur, mask, init, weight = _inputs(case)
    params = TLS(**SOLVES[case][1])
    if block == "max":
        block = max(params.initial_max_iters, params.max_iters)
    monkeypatch.setattr(robust_gn, "GN_BLOCK", block)
    robust_gn.HOST_READS.clear()
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = t_solve(TS.TCAM, t(prev), t(cur), t(mask), params,
                  initial_pose=t(init), obs_weight=t(weight))
    return out, robust_gn.HOST_READS["gn"], params, block


def _reads(n_it: int, max_iters: int, block: int) -> int:
    """Flag reads of one phase that ran n_it iterations: one after each
    block that ran, but none after the last block the phase allows."""
    b = min(block, max_iters)
    return min(-(-n_it // b), -(-max_iters // b) - 1)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_blocks_equal_one_iteration_blocks(monkeypatch, case, block):
    one, reads_one, params, _ = _solve(monkeypatch, case, 1)
    out, reads, _, b = _solve(monkeypatch, case, block)
    for field, a, x in zip(one._fields, one, out):
        assert torch.equal(a, x), f"{field} differs at GN_BLOCK {block}"
    n1, n2 = int(out.num_it), int(out.num_it_final)
    assert reads_one == (_reads(n1, params.initial_max_iters, 1)
                         + _reads(n2, params.max_iters, 1))
    assert reads == (_reads(n1, params.initial_max_iters, b)
                     + _reads(n2, params.max_iters, b))


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_one_iteration_blocks_match_reference(monkeypatch, case):
    """GN_BLOCK = 1 against rso's solve: tests/test_torch_solver.py's
    _compare_solve, or its _compare_outcome (validity and error code exact,
    iteration counts within 1, the pose within 1e-4 where valid), which
    that file holds its aborting and ill-conditioned solves to, on the
    ill-conditioned case and the phase-1 GN abort (its pose ends 4.6 m out,
    where float32 rounds at 2e-5)."""
    monkeypatch.setattr(robust_gn, "GN_BLOCK", 1)
    prev, cur, mask, init, weight = _inputs(case)
    kw = SOLVES[case][1]
    if SOLVES[case][2]:
        TS._compare_outcome(prev, cur, mask, JLS(**kw), TLS(**kw), 1e-4)
    else:
        TS._compare_solve(prev, cur, mask, JLS(**kw), TLS(**kw), init=init,
                          weight=weight)


@pytest.mark.parametrize("case,code", [
    ("degenerate_bad_cond", robust_gn.VOEC_BAD_COND_NUMBER),
    ("increase_phase_1", robust_gn.VOEC_INCR_FUNC_COST_STG1),
    ("increase_phase_1_lm", robust_gn.VOEC_INCR_FUNC_COST_STG1),
    ("increase_phase_2", robust_gn.VOEC_INCR_FUNC_COST_STG2),
    ("increase_phase_2_lm", robust_gn.VOEC_INCR_FUNC_COST_STG2)])
def test_the_abort_cases_abort(monkeypatch, case, code):
    out, _, _, _ = _solve(monkeypatch, case, robust_gn.GN_BLOCK)
    assert int(out.error_code) == code and not bool(out.valid)
