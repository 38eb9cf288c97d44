"""rso_torch.ba.ba against rso.ba.ba on the CPU.

The problems are tests/test_ba.py's make_ba_problem (0.2 px noise, a 1 cm
pose and 20 cm landmark perturbation) at P=5, L=96 (seed 0) and P=8, L=256
(seed 1), each from its own generator.  Tolerances, measured on them:

  * `_project_grid`, `inv3x3`: equal bit for bit to the reference run op
    by op (the same float32 operations in the same order; under jit XLA
    contracts some of the Jacobian's products into FMAs, an ulp apart); the
    3x3 inverse also on a singular block and one under the |det| < 1e-12
    guard, which inverts to zero.
  * `ba_normal_equations`, with a landmark at z = 0 in the first camera
    (pixels ~1e11, H_pp overflows to inf where the plain least squares has
    no robust weight) and one at x = 3e38 (non-finite pixels, masked out),
    and a per-landmark weight: the non-finite entries are the same, every
    block within NE_RTOL of its own largest entry (measured 2.4e-6 against
    the jitted reference: the port's products run as batched GEMMs, XLA
    sums in another order and contracts FMAs).
  * `relpose_prior_terms` at a zero rotation vector (the first pose, and
    the first measurement's rotation): finite, H, g and cost within
    PRIOR_RTOL of their largest entry (measured 5.1e-7).  The port's
    Jacobian is closed-form; test_relpose_jacobian_equals_forward_mode
    holds it to forward-mode AD, which the reference uses.
  * `_schur_solve`: the reduced camera system is ill-conditioned at small
    damping, so its rounding grows: at lam = 1e-4 the pose step within
    SCHUR_POSE_ATOL (measured 2.1e-5 of steps ~2e-2) and the landmark step
    within SCHUR_LMK_ATOL (4.2e-4 m of ~1.3 m); at lam = 1, also with the
    gauge free, both within SCHUR_DAMPED_ATOL (measured 3.8e-6).
  * `bundle_adjust`: poses within POSE_ATOL (rad, m; measured 2.1e-6),
    landmarks within LMK_ATOL m (measured 3.6e-4 m at 5-30 m depth), the
    final cost within COST_RTOL (measured 7e-6).  With the gauge free the
    window drifts along the gauge (~1e-2), so its relative poses T_p T_0^-1
    are compared instead (measured 6.2e-7).

The LM loop's decisions (accept or reject, converged) are compared
iteration by iteration: the reference's carry is recorded before and after
every iteration of its while_loop (a jax.debug.callback in a wrapper of
lax.while_loop, checked to leave the result bit for bit unchanged), the
port's by runs with max_iters = 0, 1, 2, ...  The costs after each step
agree within STEP_COST_RTOL (measured 5.3e-5: the first steps solve the
reduced system at lam = 1e-4, whose rounding the test_schur_solve bounds
show; with the gauge free, whose directions only lam damps, within
FREE_GAUGE_STEP_RTOL, measured 7.3e-3), and the decisions agree until both
runs sit within FLOOR_RTOL of the converged cost (measured: every first
difference came within 8.1e-6 of it).  There the f32 cost has reached its
noise floor: an accept compares two costs that differ by less than the
two packages' rounding of the [P,L] sum (the initial costs already differ
by ~3 ulp), and one side may accept a last small step that the other
rejects, so n_iters and converged from there on are set by such ties.  On
these problems that happens in 10 of the 12 cases, at iteration 4-11 (e.g.
P=8 with a marginalization prior: the reference accepts a step < tol at
iteration 5 and converges, the port's cost there is 1.8e-6 above the
floor and it rejects every step until max_iters).  Where no tie occurs
(P=5 with the odometry prior, P=8 least squares), n_iters and converged are
exact; at tol = 0 n_iters is max_iters on both sides.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from scipy.spatial.transform import Rotation

import rso.ba.ba as J
import rso_torch.ba.ba as T
from rso_torch.geometry import StereoCamera
from test_ba import CAM, _rel_from_poses, make_ba_problem

TCAM = StereoCamera.from_numpy(jax.tree_util.tree_map(np.asarray, CAM))
SIZES = {"P5": (5, 96, 0), "P8": (8, 256, 1)}
RODRIGUES_ATOL = 1.2e-7
JACOBIAN_ATOL = 5e-7
NE_RTOL = 1e-5
PRIOR_RTOL = 2e-6
SCHUR_POSE_ATOL = 5e-5
SCHUR_LMK_ATOL = 1e-3
SCHUR_DAMPED_ATOL = 1e-5
POSE_ATOL = 5e-6
LMK_ATOL = 1e-3
COST_RTOL = 2e-5
STEP_COST_RTOL = 1e-4
FREE_GAUGE_STEP_RTOL = 2e-2
FLOOR_RTOL = 2e-5
MAX_ITERS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: deterministic CPU sums, and the suite runs
    several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(size):
    """(reference BAProblem, true poses) of the size."""
    P, L, seed = SIZES[size]
    prob, true_poses, _ = make_ba_problem(np.random.default_rng(seed), P=P,
                                          L=L)
    return prob, np.asarray(true_poses)


def _port(prob):
    return T.ba_problem_from_numpy(jax.tree_util.tree_map(np.asarray, prob),
                                   device="cpu")


def _rel(true_poses, seed):
    """Noisy VO relative motions of the true poses; the first one with a
    zero rotation vector."""
    rel = _rel_from_poses(true_poses) + np.random.default_rng(seed).normal(
        0, 1e-3, (true_poses.shape[0] - 1, 6)).astype(np.float32)
    rel[0, :3] = 0.0
    return rel


def _marg_prior(poses, seed):
    """A float64 marginalization prior (H [P,6,P,6] PSD, b [P,6], lin
    [P,6]) over the window, as SlidingWindow.prior_terms lays it out."""
    r = np.random.default_rng(seed + 100)
    P = poses.shape[0]
    A = r.normal(0, 10.0, (P * 6, P * 6))
    H = A @ A.T / (P * 6) + 100.0 * np.eye(P * 6)
    b = r.normal(0, 1.0, P * 6)
    lin = np.asarray(poses, np.float64) + r.normal(0, 1e-3, (P, 6))
    return H.reshape(P, 6, P, 6), b.reshape(P, 6), lin


def _blockwise(ours, ref, axes, rtol, what):
    """Non-finite entries equal; finite ones within rtol of the largest
    entry of their block (axes: the block's dims, None for the whole)."""
    ref = np.asarray(ref, np.float64)
    ours = ours.numpy().astype(np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(ours), fin, err_msg=what)
    np.testing.assert_array_equal(ours[~fin], ref[~fin], err_msg=what)
    ref, ours = np.where(fin, ref, 0.0), np.where(fin, ours, 0.0)
    scale = np.abs(ref).max(axis=axes, keepdims=axes is not None)
    assert np.all(np.abs(ours - ref) <= rtol * scale), what


def test_batched_rodrigues_equals_the_per_pose_form():
    """rodrigues_with_grad over [...,3] (as _project_grid calls it) against
    the same function called pose by pose (the reference's
    tests/test_ba.py:376 check): within RODRIGUES_ATOL, one ulp of 1
    (measured 6e-8 in R, 1e-9 in dR): batched, the 3x3 product K @ K runs
    as a batched matmul.  The reference's vmapped form equals the batched
    one bit for bit (test_project_grid)."""
    from rso_torch.geometry.rotations import rodrigues_with_grad

    w = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.3, (2, 4, 3)).astype(np.float32))
    w[0, 0] = 0.0                                   # the small-angle branch
    R, dR = rodrigues_with_grad(w)
    for i in range(2):
        for j in range(4):
            r1, d1 = rodrigues_with_grad(w[i, j])
            torch.testing.assert_close(R[i, j], r1, rtol=0,
                                       atol=RODRIGUES_ATOL)
            torch.testing.assert_close(dR[i, j], d1, rtol=0,
                                       atol=RODRIGUES_ATOL)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_relpose_jacobian_equals_forward_mode(batch):
    """The closed-form Jacobian of the odometry residuals against
    torch.func.jacfwd of the residuals (the reference's jax.jacfwd form),
    with zero rotation vectors in the poses and the measurements: within
    JACOBIAN_ATOL, 2 ulp of 1 (measured 2.4e-7)."""
    r = np.random.default_rng(5)
    poses = torch.from_numpy(r.normal(0, 0.3, batch + (5, 6)).astype(np.float32))
    rel = torch.from_numpy(r.normal(0, 0.1, batch + (4, 6)).astype(np.float32))
    poses[..., 0, :3] = 0.0
    rel[..., 0, :3] = 0.0
    jac = torch.func.jacfwd(T._relpose_residuals)
    for _ in batch:
        jac = torch.func.vmap(jac)
    ours = T._relpose_jacobian(poses, rel)
    assert torch.isfinite(ours).all()
    torch.testing.assert_close(ours, jac(poses, rel), rtol=0,
                               atol=JACOBIAN_ATOL)


@pytest.mark.parametrize("size", SIZES)
def test_project_grid(size):
    prob, _ = _problem(size)
    ours = T._project_grid(TCAM, *_port(prob)[:2])
    ref = J._project_grid(CAM, prob.poses, prob.lmks)
    for name, a, b in zip(("pix", "J_pose", "J_lmk"), ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_inv3x3():
    M = np.random.default_rng(4).normal(size=(64, 3, 3)).astype(np.float32)
    M = M @ M.transpose(0, 2, 1)
    M[5] = np.outer([1, 2, 3], [1, 2, 3])           # singular
    M[6] *= 1e-5                                    # |det| ~1e-15 < 1e-12
    ours = T.inv3x3(torch.from_numpy(M)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(J.inv3x3(jnp.asarray(M))))
    assert not ours[5].any() and not ours[6].any()


@pytest.mark.parametrize("use_robust", [True, False])
@pytest.mark.parametrize("size", SIZES)
def test_ba_normal_equations(size, use_robust):
    prob, _ = _problem(size)
    P, L, seed = SIZES[size]
    lmks = np.asarray(prob.lmks).copy()
    lmks[3] = [0.5, 0.2, 0.0]       # z = 0 in the first camera (at the origin)
    lmks[7] = [3e38, 0.0, 10.0]     # non-finite pixels
    w = np.random.default_rng(seed).uniform(0.1, 1.0, L).astype(np.float32)
    ref_prob = prob._replace(lmks=jnp.asarray(lmks), lmk_weight=jnp.asarray(w))
    ours = T.ba_normal_equations(TCAM, _port(ref_prob), use_robust=use_robust)
    ref = jax.jit(J.ba_normal_equations, static_argnames="use_robust")(
        CAM, ref_prob, use_robust=use_robust)
    # blocks: cost; per pose; per landmark; per pose; per landmark; per
    # (pose, landmark); r2 and m elementwise (exact)
    axes = (None, (-1,), (-1,), (-2, -1), (-2, -1), (-2, -1))
    names = ("cost", "g_p", "g_l", "H_pp", "H_ll", "H_pl")
    for name, a, b, ax in zip(names, ours, ref, axes):
        _blockwise(a, b, ax, NE_RTOL, name)
    for name, a, b in zip(("r2", "m"), ours[6:], ref[6:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("size", SIZES)
def test_relpose_prior_terms_at_a_zero_rotvec(size):
    prob, true_poses = _problem(size)
    assert not true_poses[0, :3].any()
    rel = _rel(true_poses, SIZES[size][2])
    ours = T.relpose_prior_terms(torch.from_numpy(true_poses),
                                 torch.from_numpy(rel), 4e2, 25.0)
    ref = jax.jit(J.relpose_prior_terms, static_argnums=(2, 3))(
        jnp.asarray(true_poses), jnp.asarray(rel), 4e2, 25.0)
    for name, a, b in zip(("H", "g", "cost"), ours, ref):
        assert torch.isfinite(a).all(), name
        _blockwise(a, b, None, PRIOR_RTOL, name)


@pytest.mark.parametrize("case", ["lam1e-4", "lam1e-4_prior", "lam1_free_gauge"])
@pytest.mark.parametrize("size", SIZES)
def test_schur_solve(size, case):
    prob, true_poses = _problem(size)
    tprob = _port(prob)
    ref_ne = jax.jit(J.ba_normal_equations)(CAM, prob)
    ours_ne = T.ba_normal_equations(TCAM, tprob)
    lam, fix_first = (1.0, False) if case == "lam1_free_gauge" else (1e-4, True)
    ref_prior = ours_prior = None
    if case.endswith("prior"):
        rel = _rel(true_poses, SIZES[size][2])
        ref_prior = jax.jit(J.relpose_prior_terms, static_argnums=(2, 3))(
            prob.poses, jnp.asarray(rel), 4e2, 25.0)[:2]
        ours_prior = T.relpose_prior_terms(tprob.poses, torch.from_numpy(rel),
                                           4e2, 25.0)[:2]
    ref = jax.jit(J._schur_solve, static_argnums=6)(
        *ref_ne[1:6], jnp.float32(lam), fix_first, jnp.any(prob.mask, axis=0),
        prior=ref_prior)
    ours = T._schur_solve(*ours_ne[1:6], lam, fix_first, tprob.mask.any(0),
                          prior=ours_prior)
    atols = ((SCHUR_DAMPED_ATOL,) * 2 if lam == 1.0
             else (SCHUR_POSE_ATOL, SCHUR_LMK_ATOL))
    for name, a, b, atol in zip(("dpose", "dlmk"), ours, ref, atols):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=name)


def _reference_trace(prob, kw):
    """The reference's bundle_adjust with its carry recorded before and
    after every LM iteration: (BAResult, [(poses, cost, done)] for
    iterations 0..n_iters)."""
    rec = []

    def record(poses, cost, done):
        rec.append((np.asarray(poses), float(cost), bool(done)))

    def while_loop(cond, body, init):
        def body_rec(carry):
            out = body(carry)
            jax.debug.callback(record, out[1], out[4], out[5])
            return out

        jax.debug.callback(record, init[1], init[4], init[5])
        return lax.while_loop(cond, body_rec, init)

    fn = jax.jit(J.bundle_adjust.__wrapped__, static_argnames=(
        "max_iters", "use_robust", "fix_first", "rel_w_rot", "rel_w_trans"))
    saved = J.lax
    J.lax = types.SimpleNamespace(while_loop=while_loop)
    try:
        res = jax.tree_util.tree_map(np.asarray, fn(CAM, prob, **kw))
        jax.effects_barrier()
    finally:
        J.lax = saved
    plain = jax.tree_util.tree_map(np.asarray, J.bundle_adjust(CAM, prob,
                                                               **kw))
    for a, b in zip(res, plain):        # the recording changed nothing
        np.testing.assert_array_equal(a, b)
    return res, rec[:int(res.n_iters) + 1]


def _port_trace(tprob, kw):
    """The port's result and its carry after 0, 1, ... iterations (runs
    with max_iters = k stop where the full run stood after k)."""
    res = T.bundle_adjust(TCAM, tprob, **kw)
    trace = []
    for k in range(int(res.n_iters) + 1):
        r = T.bundle_adjust(TCAM, tprob, **dict(kw, max_iters=k))
        trace.append((r.poses.numpy(), float(r.cost), bool(r.converged)))
    return res, trace


def _relative_poses(poses6):
    """T_p T_0^-1 of world->cam 6-vectors: the poses without the gauge."""
    Ts = []
    for p in np.asarray(poses6, np.float64):
        M = np.eye(4)
        M[:3, :3] = Rotation.from_rotvec(p[:3]).as_matrix()
        M[:3, 3] = p[3:]
        Ts.append(M)
    return np.stack([M @ np.linalg.inv(Ts[0]) for M in Ts])


CASES = {
    "robust": {},
    "least_squares": {"use_robust": False},
    "free_gauge": {"fix_first": False},
    "odometry_prior": {"rel_w_rot": 4e2, "rel_w_trans": 25.0},
    "marg_prior": {},
    "tol0": {"tol": 0.0},
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("size", SIZES)
def test_bundle_adjust(size, case):
    prob, true_poses = _problem(size)
    seed = SIZES[size][2]
    kw = dict(CASES[case], max_iters=MAX_ITERS)
    if case == "odometry_prior":
        kw["rel_meas"] = _rel(true_poses, seed)
    if case == "marg_prior":
        kw["marg_prior"] = _marg_prior(np.asarray(prob.poses), seed)
    ref, ref_trace = _reference_trace(prob, kw)
    ours, our_trace = _port_trace(_port(prob), kw)

    # decisions iteration by iteration, until both sit at the noise floor
    final = float(ref.cost)
    step_rtol = FREE_GAUGE_STEP_RTOL if case == "free_gauge" else STEP_COST_RTOL
    tie = None
    for k in range(1, min(len(ref_trace), len(our_trace))):
        (_, rc0, _), (_, rc, rd) = ref_trace[k - 1], ref_trace[k]
        (_, oc0, _), (_, oc, od) = our_trace[k - 1], our_trace[k]
        if (rc < rc0, rd) != (oc < oc0, od):
            tie = k
            assert abs(rc0 - final) <= FLOOR_RTOL * final, (k, rc0, final)
            assert abs(oc0 - final) <= FLOOR_RTOL * final, (k, oc0, final)
            break
        assert oc == pytest.approx(rc, rel=step_rtol), k
    if tie is None:
        assert int(ours.n_iters) == int(ref.n_iters)
        assert bool(ours.converged) == bool(ref.converged)
    if case == "tol0":
        assert int(ours.n_iters) == int(ref.n_iters) == MAX_ITERS
        assert not bool(ours.converged) and not bool(ref.converged)
    assert ours.n_iters.dtype == torch.int32

    assert float(ours.cost) == pytest.approx(final, rel=COST_RTOL)
    if case == "free_gauge":
        np.testing.assert_allclose(_relative_poses(ours.poses.numpy()),
                                   _relative_poses(ref.poses), rtol=0,
                                   atol=POSE_ATOL)
        return
    np.testing.assert_allclose(ours.poses.numpy(), ref.poses, rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(ours.lmks.numpy(), ref.lmks, rtol=0,
                               atol=LMK_ATOL)
    if kw.get("fix_first", True):
        assert torch.equal(ours.poses[0], _port(prob).poses[0])
