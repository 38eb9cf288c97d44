"""The mesh forms of rso_torch on the CPU: SPMD over torch.distributed with
gloo, against rso's on the conftest's 8-device virtual mesh and against the
port's one-device solves.

One spawn for the module: tests/_torch_mesh_ranks.py runs 4 ranks (one
torch thread each, a FileStore in a temporary directory) through every case
below and writes each rank's results; the tests compare them.

  * distributed_bundle_adjust on 4 ranks (BA_CASES: the plain solve, the
    odometry prior, lmk_weight, and L = 63, which 4 does not divide):
    every rank returns the same bits; against the reference's
    distributed_bundle_adjust(make_mesh(4)) costs within COST_RTOL, poses
    within POSE_ATOL, landmarks (padded to 64 on both) within LMK_ATOL, and
    where the two stop at different iterations the port's cost at the
    earlier stop within FLOOR_RTOL of the converged cost (n_iters are set by
    ties at the f32 noise floor, tests/test_torch_ba.py); against the port's
    bundle_adjust the decisions (accept, converged) iteration by iteration
    until both sit within FLOOR_RTOL of the converged cost, then the same
    tolerances; two all_reduces an iteration of the loop, which runs whole
    blocks of LM_BLOCK iterations (masked past the stop), and one before
    it.  On a one-rank mesh it equals bundle_adjust bit for bit.
  * window_sharded_bundle_adjust on a (2,2) ('win','lmk') mesh, 3 windows
    of L = 63 (one padded window, one padded landmark), plain and with the
    odometry prior: against the reference's make_win_mesh(2, 2) and the
    port's one-device batch as above; no collective on 'win' inside the
    loop (one 'win' gather after it), the check tools/eval_ba_comm.py makes
    on the reference's HLO.  On a one-rank (1,1) mesh it equals the batch
    bit for bit.
  * BatchEngine on a 2-rank 'seq' mesh: each rank's sequence equal to an
    Engine alone, integer fields exactly and floats within BATCH_POSE_ATOL
    / BATCH_RES_ATOL (a rank's step is a torch.func.vmap over its one lane,
    whose batched einsum, H^-1 g and triangular solves sum in another order
    than a lone step's; measured by tests/_torch_batch_gaps.py: pose <=
    4.3e-7, residuals <= 3.8e-5); B = 2 on 4 ranks runs on one (the
    reference's rule).
  * initialize_multihost: False in one process, True in two, with a
    2-rank global_landmark_mesh; rso-fleet over those two ranks writes the
    one-process run's counts and reports mesh_devices 2; its trajectories
    and ATEs within BATCH_POSE_ATOL of the one-process run's (two lanes
    there against one a rank: the batched sums above).
"""
import contextlib
import io
import json
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import rso.ba.distributed as JD
import rso.ba.window_sharded as JS
import rso_torch.ba as TB
import rso_torch.ba.ba as TBB
import rso_torch.cli.fleet as t_fleet
from _torch_mesh_ranks import (
    FLEET_ARGV,
    SEQ_FRAMES,
    numpy_tree,
    one_rank_group,
    sequences,
    spawn,
)
from rso_torch.ba.multihost import initialize_multihost
from rso_torch.engine import Engine
from rso_torch.geometry import StereoCamera
from rso_torch.synthetic import synthetic_config
from test_torch_ba_window import _rels
from test_window_sharded import CAM, _make_problem

WORLD = 4
MAX_ITERS = 10
POSE_ATOL = 5e-6
LMK_ATOL = 3e-3
COST_RTOL = 2e-5
FLOOR_RTOL = 2e-5
PRIOR = dict(rel_w_rot=4e2, rel_w_trans=25.0)
# a batched lane against a lone Engine: rso's own batch test's pose bound
# (tests/test_parallel.py) and the engine tolerances
BATCH_POSE_ATOL = 1e-5
BATCH_RES_ATOL = 5e-3
CAM_KW = dict(fx_l=500.0, fy_l=500.0, cx_l=320.0, cy_l=240.0, baseline=0.5)
TCAM = StereoCamera.make(**CAM_KW)


def _ba_cases():
    """name -> (reference BAProblem, keyword arguments)."""
    weighted = _make_problem(9)
    weighted = weighted._replace(
        lmk_weight=jax.numpy.linspace(0.2, 1.0, 64, dtype=jax.numpy.float32))
    prior = _make_problem(8)
    return {
        "plain": (_make_problem(7), {}),
        "odometry_prior": (prior, dict(PRIOR, rel_meas=_rels([prior])[0])),
        "lmk_weight": (weighted, {}),
        "odd_landmarks": (_make_problem(10, L=63), {}),
    }


def _win_cases():
    """name -> (reference window problems, keyword arguments)."""
    probs = [_make_problem(s, L=63) for s in range(3)]
    return {"plain": (probs, {}),
            "odometry_prior": (probs, dict(PRIOR, rel_meas=_rels(probs)))}


BA_CASES = _ba_cases()
WIN_CASES = _win_cases()


def _arrays(prob):
    return tuple(None if x is None else np.array(x) for x in prob)


def _kw(kw):
    """Keyword arguments with numpy leaves and max_iters."""
    out = dict(kw, max_iters=MAX_ITERS)
    if "rel_meas" in kw:
        r = kw["rel_meas"]
        out["rel_meas"] = (np.array(r) if not isinstance(r, list)
                           else [np.array(x) for x in r])
    return out


def _loop_iterations(n_iters: int) -> int:
    """The iterations the LM loop ran for a solve of n_iters: whole blocks,
    up to the block that stopped it."""
    b = min(TBB.LM_BLOCK, MAX_ITERS)
    return b * min(-(-n_iters // b), -(-MAX_ITERS // b))


def _port(prob):
    return TB.BAProblem(*(None if a is None else torch.from_numpy(a)
                          for a in _arrays(prob)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (tests/_torch_mesh_ranks.py)."""
    d = tmp_path_factory.mktemp("mesh")
    spec = {"cam": CAM_KW,
            "ba": {c: (_arrays(p), _kw(kw)) for c, (p, kw) in BA_CASES.items()},
            "win": {c: ([_arrays(p) for p in ps], _kw(kw))
                    for c, (ps, kw) in WIN_CASES.items()}}
    (d / "inputs.pkl").write_bytes(pickle.dumps(spec))
    return d, spawn(d, WORLD)


@pytest.fixture(scope="module")
def group():
    with one_rank_group():
        yield


def _torch_kw(kw):
    out = dict(kw)
    if "rel_meas" in kw:
        r = kw["rel_meas"]
        out["rel_meas"] = (torch.from_numpy(r) if not isinstance(r, list)
                           else [torch.from_numpy(x) for x in r])
    return out


def _same(a: dict, b: dict, what):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _hold(ours: dict, ref, trace: list, what):
    """ours against ref (any object with the BAResult fields) at the
    tolerances; where they stop apart, ours at the earlier stop (trace[k]:
    ours after k iterations) within FLOOR_RTOL of the converged cost."""
    final = float(ref.cost)
    assert float(ours["cost"]) == pytest.approx(final, rel=COST_RTOL), what
    np.testing.assert_allclose(ours["poses"], np.asarray(ref.poses), rtol=0,
                               atol=POSE_ATOL, err_msg=what)
    np.testing.assert_allclose(ours["lmks"], np.asarray(ref.lmks), rtol=0,
                               atol=LMK_ATOL, err_msg=what)
    first = min(int(ours["n_iters"]), int(ref.n_iters))
    if int(ours["n_iters"]) != int(ref.n_iters):
        assert abs(float(trace[first]["cost"]) - final) <= FLOOR_RTOL * final


def _decisions(ours_trace: list, ref_trace: list, what):
    """Accept and converged equal iteration by iteration until both runs
    sit within FLOOR_RTOL of the converged cost."""
    final = float(ref_trace[-1]["cost"])
    for k in range(1, min(len(ours_trace), len(ref_trace))):
        oc0, oc = (float(ours_trace[j]["cost"]) for j in (k - 1, k))
        rc0, rc = (float(ref_trace[j]["cost"]) for j in (k - 1, k))
        same = ((oc < oc0, bool(ours_trace[k]["converged"]))
                == (rc < rc0, bool(ref_trace[k]["converged"])))
        if not same:
            assert abs(oc0 - final) <= FLOOR_RTOL * final, (what, k)
            assert abs(rc0 - final) <= FLOOR_RTOL * final, (what, k)
            return
    assert len(ours_trace) == len(ref_trace), what


# ---- distributed_bundle_adjust ---------------------------------------------


@pytest.mark.parametrize("case", BA_CASES)
def test_distributed_ba_ranks_agree(ranks, case):
    _, out = ranks
    for r in range(1, WORLD):
        _same(out[r]["ba"][case][0], out[0]["ba"][case][0], f"rank {r}")


@pytest.mark.parametrize("case", BA_CASES)
def test_distributed_ba_against_the_reference(ranks, case):
    prob, kw = BA_CASES[case]
    ref = JD.distributed_bundle_adjust(CAM, prob, JD.make_mesh(WORLD),
                                       max_iters=MAX_ITERS, **kw)
    ours, trace, _ = ranks[1][0]["ba"][case]
    assert ours["lmks"].shape == np.asarray(ref.lmks).shape == (64, 3)
    _hold(ours, ref, trace, case)


@pytest.mark.parametrize("case", BA_CASES)
def test_distributed_ba_against_bundle_adjust(ranks, case):
    prob, kw = BA_CASES[case]
    tprob, tkw = _port(prob), _torch_kw(_kw(kw))
    L = tprob.lmks.shape[0]
    one = numpy_tree(TB.bundle_adjust(TCAM, tprob, **tkw))
    one_trace = [numpy_tree(TB.bundle_adjust(TCAM, tprob,
                                             **dict(tkw, max_iters=k)))
                 for k in range(int(one["n_iters"]) + 1)]
    ours, trace, _ = ranks[1][0]["ba"][case]
    _decisions(trace, one_trace, case)
    ours = dict(ours, lmks=ours["lmks"][:L])
    _hold(ours, TB.BAResult(**one), trace, case)


@pytest.mark.parametrize("case", BA_CASES)
def test_distributed_ba_two_all_reduces_an_iteration(ranks, case):
    for r in range(WORLD):
        res, _, coll = ranks[1][r]["ba"][case]
        n = _loop_iterations(int(res["n_iters"]))
        assert coll == {"solve lmk": 1 + 2 * n, "gather lmk": 1}, r


@pytest.mark.parametrize("case", BA_CASES)
def test_one_rank_mesh_equals_bundle_adjust(group, case):
    prob, kw = BA_CASES[case]
    tprob, tkw = _port(prob), _torch_kw(_kw(kw))
    got = TB.distributed_bundle_adjust(TCAM, tprob, TB.make_mesh(device="cpu"),
                                       **tkw)
    for name, a, b in zip(got._fields, got,
                          TB.bundle_adjust(TCAM, tprob, **tkw)):
        assert torch.equal(a, b), name


# ---- window_sharded_bundle_adjust ------------------------------------------


@pytest.mark.parametrize("case", WIN_CASES)
def test_window_sharded_ranks_agree(ranks, case):
    _, out = ranks
    for r in range(1, WORLD):
        for w, (a, b) in enumerate(zip(out[r]["win"][case][0],
                                       out[0]["win"][case][0])):
            _same(a, b, f"rank {r} window {w}")


@pytest.mark.parametrize("case", WIN_CASES)
def test_window_sharded_against_the_reference(ranks, case):
    probs, kw = WIN_CASES[case]
    refs = JS.window_sharded_bundle_adjust(CAM, probs, JS.make_win_mesh(2, 2),
                                           max_iters=MAX_ITERS, **kw)
    ours, trace, _ = ranks[1][0]["win"][case]
    assert len(ours) == len(refs) == 3
    for w, (o, r) in enumerate(zip(ours, refs)):
        assert o["lmks"].shape == (63, 3)
        _hold(o, r, [t[w] for t in trace], f"window {w}")


@pytest.mark.parametrize("case", WIN_CASES)
def test_window_sharded_against_the_batch(ranks, case):
    probs, kw = WIN_CASES[case]
    tkw = _torch_kw(_kw(kw))
    batch = TB.window_sharded_bundle_adjust(TCAM, [_port(p) for p in probs],
                                            **tkw)
    ours, trace, _ = ranks[1][0]["win"][case]
    for w, (o, b) in enumerate(zip(ours, batch)):
        _hold(o, b, [t[w] for t in trace], f"window {w}")


@pytest.mark.parametrize("case", WIN_CASES)
def test_no_collective_on_win_in_the_loop(ranks, case):
    for r in range(WORLD):
        res, _, coll = ranks[1][r]["win"][case]
        row = [0, 1] if r < 2 else [2]          # windows of the rank's row
        n = _loop_iterations(max(int(res[w]["n_iters"]) for w in row))
        assert coll == {"solve lmk": 1 + 2 * n, "gather lmk": 1,
                        "gather win": 1}, r


@pytest.mark.parametrize("case", WIN_CASES)
def test_one_rank_win_mesh_equals_the_batch(group, case):
    probs, kw = WIN_CASES[case]
    tprobs, tkw = [_port(p) for p in probs], _torch_kw(_kw(kw))
    mesh = TB.make_win_mesh(1, 1, device="cpu")
    for w, (a, b) in enumerate(zip(
            TB.window_sharded_bundle_adjust(TCAM, tprobs, mesh, **tkw),
            TB.window_sharded_bundle_adjust(TCAM, tprobs, **tkw))):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), (w, name)


def test_mesh_arguments_raise(group):
    prob = _port(BA_CASES["plain"][0])
    with pytest.raises(ValueError, match="DeviceMesh"):
        TB.distributed_bundle_adjust(TCAM, prob, object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        TB.window_sharded_bundle_adjust(TCAM, [prob], mesh=object())
    with pytest.raises(ValueError, match="axes"):
        TB.window_sharded_bundle_adjust(TCAM, [prob],
                                        mesh=TB.make_mesh(device="cpu"))
    with pytest.raises(ValueError, match="world holds 1"):
        TB.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="world holds 1"):
        TB.make_win_mesh(2, 2, device="cpu")


# ---- BatchEngine, multihost, rso-fleet --------------------------------------


@pytest.mark.parametrize("rank", [0, 1])
def test_batch_engine_on_a_seq_mesh(ranks, rank):
    got = ranks[1][rank]["seq"]
    assert got["sequences"] == [rank] and got["mesh_devices"] == 2
    assert got["gather"] == [0, 1]
    seq = sequences()[rank]
    eng = Engine(synthetic_config(), seq.cam, device="cpu")
    assert len(got["frames"]) == SEQ_FRAMES
    for n, ((left, right), frame) in enumerate(zip(seq.frames,
                                                   got["frames"])):
        alone = numpy_tree(eng.process_frame(left, right))
        for field, a in alone.items():
            what = f"frame {n} {field}"
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(frame[field][0], a,
                                              err_msg=what)
            else:
                atol = (BATCH_RES_ATOL if field in ("residuals", "cost")
                        else BATCH_POSE_ATOL)
                np.testing.assert_allclose(frame[field][0], a, atol=atol,
                                           rtol=0, err_msg=what)


def test_batch_engine_reference_rule(ranks):
    """B = 2 on 4 ranks does not divide: rank 0 steps both."""
    worlds = [r["seq"]["world"] for r in ranks[1]]
    assert worlds == [([0, 1], 1)] + [([], 1)] * (WORLD - 1)


def test_initialize_multihost(ranks, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialized = dist.is_initialized()
    assert initialize_multihost() is False
    assert initialize_multihost("localhost:1", num_processes=1) is False
    assert dist.is_initialized() == initialized
    for r in (0, 1):
        got = ranks[1][r]["multihost"]
        assert got["started"] is True
        assert got["size"] == 2 and got["axes"] == ("lmk",)


def test_fleet_over_two_ranks(ranks, tmp_path):
    d, out = ranks
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_fleet.main(FLEET_ARGV + ["--out-dir", str(tmp_path)],
                          device="cpu")
    alone = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and alone["mesh_devices"] == 1
    r0, r1 = out[0]["multihost"], out[1]["multihost"]
    assert r0["fleet_rc"] == r1["fleet_rc"] == 0
    assert r1["fleet_stdout"] == ""
    summary = json.loads(r0["fleet_stdout"].splitlines()[-1])
    assert list(summary) == list(alone)
    assert summary["mesh_devices"] == 2
    for k in ("sequences", "frames_per_seq", "total_frames", "valid_frac"):
        assert summary[k] == alone[k], k
    np.testing.assert_allclose(summary["ate_rmse_m"], alone["ate_rmse_m"],
                               atol=BATCH_POSE_ATOL, rtol=0)
    for i in range(2):
        name = f"seq_synthetic_{i}.txt"
        np.testing.assert_allclose(np.loadtxt(d / "fleet" / name),
                                   np.loadtxt(tmp_path / name),
                                   atol=BATCH_POSE_ATOL, rtol=0, err_msg=name)
