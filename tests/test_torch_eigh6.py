"""The eigh6 kernel's twin (rso_torch.kernels.eigh6, cyclic Jacobi) against
rso's `jnp.linalg.eigh` on the CPU, and the GN's eigh step built on it
against rso's `_eval_rgn` and `solve_pose`.

On the GPU the port's eigh backend runs the eigh6 kernel, whose arithmetic
the twin repeats (tests/test_torch_cuda.py holds the two together on the
card); on the CPU the port keeps LAPACK's eigh, as rso does, so the GN here
takes the twin only by monkeypatching `robust_gn._eigh`.

Tolerances: eigenvalues within 1e-5 of |w[5]| (both backward stable in
f32: |dw| <~ 6 eps ||H||); eigenvectors through the residual ||H v - w v||
and V^T V - I, each within 1e-5 of ||H|| and 1: where eigenvalues cluster
below eps ||H|| (cond >~ 1e7, rank-deficient) single eigenvectors are not
determined and two solvers may pick any basis of their span; cond = w[5] /
w[0] within 1e-3 relative where cond <= 1e3; the GN step dx within 1e-4
relative and bad_cond exact on rso's own solver cases; the whole solve as
tests/test_torch_solver.py holds it (counts, codes and inliers exact, the
pose within 1e-5).  w[0] against float64 (_torch_card.EIGH6_F64_CASES: cond
1e3-1e7 and graded GN matrices): the twin's error, median and max, no more
than LAPACK f32's on the same matrices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_card as card
from rso.config import LeastSquaresParams as JLS
from rso.solver import solve_pose as j_solve
from rso.solver.robust_gn import _eval_rgn as j_eval
from rso_torch.config import LeastSquaresParams as TLS
from rso_torch.geometry.stereo_camera import triangulate
from rso_torch.kernels.eigh6 import SWEEPS, eigh6_torch
from rso_torch.solver import robust_gn as G
from rso_torch.solver import solve_pose as t_solve
from test_torch_solver import CASES, JCAM, TCAM, make_problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrices(seed, B, cond):
    """_torch_card's GN-like matrices (cond 0: rank 3), as numpy."""
    return card.gn_normal_matrices(np.random.default_rng(seed), B, cond,
                                   "cpu").numpy()


@pytest.mark.parametrize("cond", [1.0, 10.0, 1e3, 1e5, 1e7, 0])
def test_twin_against_jnp_eigh(cond):
    H = _matrices(int(cond) % 97, 64, cond)
    w_ref, _ = jnp.linalg.eigh(jnp.asarray(H))
    w_ref = np.asarray(w_ref)
    w, V = eigh6_torch(torch.from_numpy(H))
    w, V = w.numpy(), V.numpy()
    norm = np.abs(w_ref).max(-1, keepdims=True)
    assert np.all(np.diff(w, axis=-1) >= 0)
    assert np.all(np.abs(w - w_ref) <= 1e-5 * norm)
    H64, V64 = H.astype(np.float64), V.astype(np.float64)
    res = np.abs(H64 @ V64 - V64 * w[:, None, :]).max((1, 2))
    assert np.all(res <= 1e-5 * norm[:, 0]), res.max()
    orth = np.abs(V64.transpose(0, 2, 1) @ V64 - np.eye(6)).max((1, 2))
    assert np.all(orth <= 1e-5), orth.max()
    if 0 < cond <= 1e3:
        c_ref = w_ref[:, 5] / w_ref[:, 0]
        np.testing.assert_allclose(w[:, 5] / w[:, 0], c_ref, rtol=1e-3)


@pytest.mark.parametrize("case", card.EIGH6_F64_CASES)
def test_twin_w0_against_float64(case):
    """w[0], which sets the GN's cond, against np.linalg.eigvalsh of the
    same f32 matrices in float64: the twin's relative error, median and
    max over the case's matrices, no more than LAPACK f32's (torch's eigh
    on the CPU, the reference's routine there).  At cond 1e6-1e7 both lose
    most digits of w[0] (the f32 input's own conditioning); on graded GN
    matrices the Jacobi twin keeps more than LAPACK."""
    H = card.eigh6_f64_cases("cpu")[case]
    twin = card.w0_rel_err_f64(H, eigh6_torch(H)[0])
    lapack = card.w0_rel_err_f64(H, torch.linalg.eigh(H)[0])
    assert np.median(twin) <= np.median(lapack), (np.median(twin),
                                                  np.median(lapack))
    assert twin.max() <= lapack.max(), (twin.max(), lapack.max())


def test_twin_reads_the_lower_triangle_and_keeps_identity():
    """eigh's convention: the upper triangle is ignored; the identity (the
    GN's stand-in for a non-finite H) comes back exactly."""
    H = _matrices(3, 4, 1e2)
    upper = np.triu(np.ones((6, 6), bool), 1)
    junk = np.where(upper, np.float32(1e9), H)
    w, V = eigh6_torch(torch.from_numpy(H))
    wj, Vj = eigh6_torch(torch.from_numpy(junk))
    assert torch.equal(w, wj) and torch.equal(V, Vj)
    w, V = eigh6_torch(torch.eye(6))
    assert torch.equal(w, torch.ones(6)) and torch.equal(V, torch.eye(6))
    assert SWEEPS >= 6


def _jacobi_gn(monkeypatch):
    monkeypatch.setattr(G, "_eigh", eigh6_torch)


@pytest.mark.parametrize("case", ["exact", "identity", "noisy", "outliers",
                                  "larger_rotation"])
@pytest.mark.parametrize("lm", [False, True])
def test_gn_eigh_step_on_the_twin(monkeypatch, case, lm):
    """One GN evaluation on the eigh branch (the twin inside) against rso's
    _eval_rgn at the same landmarks and increment: dx within 1e-4 of its
    largest entry (1e-6 absolute), bad_cond exact, the cost within 1e-5 and
    the squared residuals within 1e-5 relative (1e-3 px^2 absolute: the
    increment puts them at up to ~2e3 px^2)."""
    _jacobi_gn(monkeypatch)
    prev, cur, mask = make_problem(sorted(CASES).index(case), **CASES[case])
    delta = np.asarray([0.002, -0.001, 0.0005, 0.01, 0.0, 0.02], np.float32)
    jp, tp = JLS(solve_backend="eigh", use_lm=lm), TLS(solve_backend="eigh",
                                                       use_lm=lm)
    lam = 1e-3 if lm else None
    tprev = torch.from_numpy(prev)
    lmks = triangulate(TCAM, tprev[:, 0], tprev[:, 1], tprev[:, 2])
    dx, cost, res, bad = G._eval_rgn(TCAM, lmks, torch.from_numpy(cur),
                                     torch.from_numpy(mask),
                                     torch.from_numpy(delta), tp,
                                     lm_lambda=None if lam is None else
                                     torch.tensor(lam))
    jdx, jcost, jres, jbad = j_eval(JCAM, jnp.asarray(lmks.numpy()),
                                    jnp.asarray(cur), jnp.asarray(mask),
                                    jnp.asarray(delta), jp, lm_lambda=lam)
    assert bool(bad) == bool(jbad)
    if not bool(jbad):
        jdx = np.asarray(jdx)
        np.testing.assert_allclose(dx.numpy(), jdx, rtol=0,
                                   atol=1e-4 * np.abs(jdx).max() + 1e-6)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    fin = np.asarray(jres) < 1e30
    np.testing.assert_array_equal(res.numpy() < 1e30, fin)
    np.testing.assert_allclose(res.numpy()[fin], np.asarray(jres)[fin],
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", ["noisy", "outliers", "larger_rotation"])
@pytest.mark.parametrize("lm", [False, True])
def test_solve_pose_eigh_on_the_twin(monkeypatch, case, lm):
    """The whole two-phase solve with the twin as its eigensolver against
    rso's eigh solve: counts, error code, validity and inliers exact, the
    pose within 1e-5."""
    _jacobi_gn(monkeypatch)
    prev, cur, mask = make_problem(sorted(CASES).index(case), **CASES[case])
    jp, tp = JLS(solve_backend="eigh", use_lm=lm), TLS(solve_backend="eigh",
                                                       use_lm=lm)
    ref = j_solve(JCAM, jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(mask),
                  jp)
    out = t_solve(TCAM, torch.from_numpy(prev), torch.from_numpy(cur),
                  torch.from_numpy(mask), tp)
    for name in ("valid", "error_code", "num_it", "num_it_final", "inliers"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose),
                               atol=1e-5)
