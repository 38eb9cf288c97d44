"""The entry points of rso_torch on the CPU: against rso's, and their own
properties, exact.

The slice: rso.cli.demo.main and rso_torch.cli.demo.main (device="cpu") run
the same argv, `--synthetic --frames 4`, once each for the module
(tests/_torch_cli.py records every Engine.process_frame result).  Valid
flags, error codes and every count are equal on every frame; poses within
POSE_ATOL (rad and m), the written trajectories within TRAJ_ATOL (m);
the printed lines are equal but for the run's FPS.  The reference's demo
matches its SAD candidates through the MXU shortlist on the CPU
(`use_mxu_distance`, a TPU-only formulation the port leaves out); on these
4 frames it picks the same matches as the port's exact SAD, and no flat
RANSAC near-tie moves a track, so every frame takes the tight bound.

Port-only, exact (torch.equal, or equal bytes of the files the demo
writes): --chunk equals the per-frame run; --ba equals a direct VOWithBA
run and --ba-offline a direct KeyframeCollector + refine_trajectory; a
--save-state / --load-state round trip; --watch equals --img-dir on the
same pairs; --ba --ba-distributed (a one-rank mesh) equals --ba; run_bench
returns the reference's keys; rso-stages prints the reference's span
names; every entry point raises without CUDA.  BatchEngine equals one
Engine per sequence and rso-fleet's sequence 0 the demo's trajectory,
integers exactly and floats within BATCH_POSE_ATOL (the batched step's
sums, test_batch_engine).
"""
import contextlib
import io
import json
import math
import re

import numpy as np
import pytest
import torch

import rso.cli.demo as j_demo
import rso.engine as j_engine
import rso_torch.cli.bench as t_bench
import rso_torch.cli.demo as t_demo
import rso_torch.cli.eval as t_eval
import rso_torch.cli.fleet as t_fleet
import rso_torch.cli.stages as t_stages
import rso_torch.engine as t_engine
from _torch_cli import run_demo
from _torch_mesh_ranks import one_rank_group
from rso_torch.ba import KeyframeCollector, VOWithBA, refine_trajectory
from rso_torch.geometry import pose_matrix
from rso_torch.io import load_state
from rso_torch.io.checkpoint import _leaves
from rso_torch.io.trajectory import write_kitti
from rso_torch.parallel import BatchEngine
from rso_torch.synthetic import make_sequence, synthetic_config

ARGV = ["--synthetic", "--frames", "4"]
POSE_ATOL = 1e-5
TRAJ_ATOL = 1e-5
N_BA_FRAMES = 10        # keyframes at frames 0, 3, 6, 9: BA solves
# rso/cli/bench.py:219-236
BENCH_KEYS = ["fps", "fps_live_per_dispatch", "step_ms_device",
              "fps_device_step", "ba_iters_per_sec", "ate_rmse_m",
              "detect_ms_per_image", "detect_hbm_gbps_model",
              "detect_hbm_util_vs_v5e_peak", "n_frames", "image", "backend",
              "device"]
# rso/cli/fleet.py:226-231
FLEET_KEYS = ["sequences", "frames_per_seq", "total_frames", "wall_s",
              "frames_per_sec", "valid_frac", "mesh_devices", "ate_rmse_m"]
# rso/cli/stages.py
SPANS = (["_stg1 (rectify+pyramid)"]
         + [f"_stg2 detect.oct={o} {e}" for o in range(3) for e in "LR"]
         + [f"_stg3 match.oct={o}" for o in range(3)]
         + [f"_stg4 track.oct={o}" for o in range(3)]
         + ["_stg5 (robust GN)", "processNewImagePair (fused)",
            "fused step, pipelined"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(argv):
    return run_demo(t_demo.main, t_engine.Engine, argv, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    out = {}
    for name, main, eng, kw in (("ref", j_demo.main, j_engine.Engine, {}),
                                ("port", t_demo.main, t_engine.Engine,
                                 {"device": "cpu"})):
        argv = ARGV + ["--out", str(d / f"{name}.txt"),
                       "--tum", str(d / f"{name}.tum"),
                       "--viz-dir", str(d / f"{name}_viz"),
                       "--save-state", str(d / f"{name}.npz")]
        out[name] = run_demo(main, eng, argv, **kw)
    return d, out


def test_demo_against_reference(runs):
    d, out = runs
    (rc_j, lines_j, ref), (rc_t, lines_t, got) = out["ref"], out["port"]
    assert rc_j == rc_t == 0
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        for field in ("valid", "error_code", "detected_feats",
                      "stereo_matches", "tracked_feats_from_last_frame",
                      "tracked_feats_from_last_KF", "track_mask"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(r, field),
                                          err_msg=f"frame {i} {field}")
        np.testing.assert_allclose(g.pose, r.pose, rtol=0, atol=POSE_ATOL,
                                   err_msg=f"frame {i}")
    assert sum(bool(r.valid) for r in ref) == 3
    np.testing.assert_allclose(np.loadtxt(d / "port.txt"),
                               np.loadtxt(d / "ref.txt"), rtol=0,
                               atol=TRAJ_ATOL)
    fps = re.compile(r"in [0-9.]+s \([0-9.]+ FPS\)")
    mask = lambda ls: [fps.sub("", s).replace("port", "ref")  # noqa: E731
                       for s in ls]
    assert mask(lines_t) == mask(lines_j)
    assert (d / "port_viz" / "trajectory.html").exists()


def test_chunk_equals_per_frame(runs, tmp_path):
    d, _ = runs
    out = tmp_path / "chunk.txt"
    rc, lines, _ = _port(ARGV + ["--chunk", "3", "--out", str(out),
                                 "--tum", str(tmp_path / "chunk.tum")])
    assert rc == 0
    assert [s for s in lines if "chunk of" in s][0].startswith(
        "[rso] chunk of 3: 2/3 valid")
    assert out.read_bytes() == (d / "port.txt").read_bytes()
    assert (tmp_path / "chunk.tum").read_bytes() == (d / "port.tum").read_bytes()


def _frames(n):
    return make_sequence(n_frames=n, n_points=2000)


BA_ARGV = ["--synthetic", "--frames", str(N_BA_FRAMES), "--ba",
           "--verbosity", "0"]


@pytest.fixture(scope="module")
def ba_run(tmp_path_factory):
    """(return code, stdout lines, trajectory file) of rso-demo --ba."""
    out = tmp_path_factory.mktemp("ba") / "ba.txt"
    rc, lines, _ = _port(BA_ARGV + ["--out", str(out)])
    return rc, lines, out


def test_ba_equals_vo_with_ba(ba_run, tmp_path):
    rc, lines, out = ba_run
    assert rc == 0
    seq = _frames(N_BA_FRAMES)
    vo = VOWithBA(synthetic_config(), seq.cam, device="cpu")
    outs = [vo.process_frame(l, r) for l, r in seq.frames]
    assert sum(o.ba_cost is not None for o in outs) >= 1
    n_kf = sum(o.is_keyframe for o in outs)
    assert f"[rso] {n_kf} keyframes in window BA" in lines
    write_kitti(str(tmp_path / "direct.txt"),
                np.stack([np.eye(4)] + [o.pose_wc for o in outs]))
    assert out.read_bytes() == (tmp_path / "direct.txt").read_bytes()


def test_ba_offline_equals_refine_trajectory(tmp_path):
    out = tmp_path / "off.txt"
    rc, lines, _ = _port(["--synthetic", "--frames", str(N_BA_FRAMES),
                          "--ba-offline", "--out", str(out),
                          "--verbosity", "0"])
    assert rc == 0
    seq = _frames(N_BA_FRAMES)
    eng = t_engine.Engine(synthetic_config(), seq.cam, device="cpu")
    col = KeyframeCollector(eng, synthetic_config())
    T, poses = np.eye(4), []
    for i, (left, right) in enumerate(seq.frames):
        res = eng.process_frame(left, right)
        if bool(res.valid):
            T = T @ pose_matrix(res.pose).numpy()
        poses.append(T.copy())
        col.observe(i, res, T)
    assert len(col.kfs) >= 3
    refined = refine_trajectory(seq.cam, col.kfs, col.kf_frame_idx,
                                np.stack(poses), window=8, device="cpu")
    assert (f"[rso] offline window-sharded refine: {len(col.kfs)} keyframes"
            in lines)
    write_kitti(str(tmp_path / "direct.txt"),
                np.concatenate([np.eye(4)[None], refined]))
    assert out.read_bytes() == (tmp_path / "direct.txt").read_bytes()


def test_checkpoint_round_trip(runs, tmp_path):
    """--save-state writes the run's last state; --load-state resumes from
    it: the first frame is tracked against the saved frame, as an Engine
    given that state tracks it."""
    d, _ = runs
    seq = _frames(4)
    cfg = synthetic_config()
    direct = t_engine.Engine(cfg, seq.cam, device="cpu")
    for left, right in seq.frames:
        direct.process_frame(left, right)
    saved = load_state(str(d / "port.npz"), cfg, device="cpu")
    for a, b in zip(_leaves(saved), _leaves(direct.state)):
        assert torch.equal(a, b)
    rc, lines, got = _port(ARGV + ["--load-state", str(d / "port.npz"),
                                   "--out", str(tmp_path / "resumed.txt")])
    assert rc == 0
    want = [direct.process_frame(left, right) for left, right in seq.frames]
    assert int(want[0].error_code) != 5           # not a first frame
    for g, w in zip(got, want):
        for field, a, b in zip(w._fields, g, w):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=field)
    rc, _, _ = _port(ARGV + ["--load-state", str(tmp_path / "missing.npz"),
                             "--out", str(tmp_path / "x.txt")])
    assert rc == 2


def test_watch_equals_img_dir(tmp_path):
    """--watch over a directory whose pairs are all there gives the
    --img-dir run's trajectory; the sources' own refusals exit with 2."""
    from PIL import Image

    seq = make_sequence(n_frames=4, n_points=800, H=120, W=160)
    d = tmp_path / "stream"
    d.mkdir()
    for i, (left, right) in enumerate(seq.frames):
        Image.fromarray(left).save(d / f"left_{i:04d}.png")
        Image.fromarray(right).save(d / f"right_{i:04d}.png")
    cam = tmp_path / "cam.ini"
    cam.write_text("[CAMERA_PARAMS]\nresolution=[160 120]\nfx=100\nfy=100\n"
                   "cx=80\ncy=60\nbaseline=0.3\n")
    src = ["--img-dir", str(d), "--cam", str(cam), "--verbosity", "0"]
    outs = []
    for extra in ([], ["--watch", "--watch-idle", "0.5"]):
        out = tmp_path / f"traj{len(outs)}.txt"
        rc, _, results = _port(src + extra + ["--out", str(out)])
        assert rc == 0 and len(results) == 4
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert _port(["--img-dir", str(d), "--out",
                      str(tmp_path / "x.txt")])[0] == 2
        assert _port(["--img-dir", str(d), "--watch", "--out",
                      str(tmp_path / "x.txt")])[0] == 2
        assert _port(["--kitti", str(tmp_path / "none"), "--out",
                      str(tmp_path / "x.txt")])[0] == 2
    assert "--img-dir requires --cam" in err.getvalue()
    assert "--watch needs --img-dir and --cam" in err.getvalue()
    assert "cannot load dataset" in err.getvalue()


def test_ba_distributed_exits_2(ba_run, tmp_path):
    """--ba-distributed no longer exits with 2: in one process its solves
    run on a one-rank mesh, and the run equals --ba's bit for bit."""
    out = tmp_path / "dist.txt"
    with one_rank_group():
        rc, lines, _ = _port(BA_ARGV + ["--ba-distributed", "--out",
                                        str(out)])
    assert rc == ba_run[0] == 0
    fps = re.compile(r"in [0-9.]+s \([0-9.]+ FPS\)")
    assert ([fps.sub("", s).replace(str(out), "OUT") for s in lines]
            == [fps.sub("", s).replace(str(ba_run[2]), "OUT")
                for s in ba_run[1]])
    assert out.read_bytes() == ba_run[2].read_bytes()


def test_batch_engine():
    """BatchEngine(B=2): process_frames ([B,...]) and process_chunk
    ([N,B,...]) equal one Engine per sequence, field by field and state by
    state: integer fields exactly, floats within BATCH_POSE_ATOL (pose,
    state) and BATCH_RES_ATOL (residuals, cost), since the batched step (one
    torch.func.vmap for both lanes) sums in another order than a lone step
    where its operations are batched (the GN gradient's einsum, H^-1 g and
    the batched triangular solves, tests/test_torch_batch.py); measured
    here (tests/_torch_batch_gaps.py): pose <= 3.1e-7, residuals <=
    1.8e-4, cost <= 6.5e-5.  A mesh that
    is not a torch DeviceMesh raises (the 'seq' mesh:
    tests/test_torch_mesh.py)."""
    seqs = [make_sequence(n_frames=4, n_points=2000, seed=s)
            for s in range(2)]
    cfg = synthetic_config()
    cam = seqs[0].cam
    H, W = seqs[0].frames[0][0].shape
    be = BatchEngine(cfg, cam, batch=2, img_h=H, img_w=W, device="cpu")
    engines = [t_engine.Engine(cfg, cam, device="cpu") for _ in seqs]
    lefts = np.stack([[f[0] for f in s.frames] for s in seqs])   # [B,N,H,W]
    rights = np.stack([[f[1] for f in s.frames] for s in seqs])
    first = be.process_frames(lefts[:, 0], rights[:, 0])
    chunk = be.process_chunk(lefts[:, 1:], rights[:, 1:])
    assert first.pose.shape == (2, 6) and chunk.pose.shape == (3, 2, 6)
    for b, eng in enumerate(engines):
        alone = [eng.process_frame(l, r) for l, r in seqs[b].frames]
        batched = [_at(first, b)] + [_at(chunk, b, n) for n in range(3)]
        for n, (a, g) in enumerate(zip(alone, batched)):
            for field, x, y in zip(a._fields, a, g):
                _batch_close(x, y, field, f"sequence {b} frame {n} {field}")
        lane = type(be.states)(*(_lane_of(t, b) for t in be.states))
        for x, y in zip(_leaves(eng.state), _leaves(lane)):
            _batch_close(x, y, "state", f"sequence {b} state")
    assert bool(chunk.valid.all())
    with pytest.raises(ValueError):
        BatchEngine(cfg, cam, batch=2, img_h=H, img_w=W, mesh=object(),
                    device="cpu")


# a batched lane against a lone Engine (test_batch_engine)
BATCH_POSE_ATOL = 1e-5      # rso's own batch test, tests/test_parallel.py
BATCH_RES_ATOL = 5e-3       # the engine tolerances, tests/test_torch_engine.py


def _lane_of(tree, b):
    """Lane b of a batched tree (tuples of tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    return type(tree)(*(_lane_of(t, b) for t in tree)) if hasattr(
        tree, "_fields") else tuple(_lane_of(t, b) for t in tree)


def _batch_close(x, y, field, what):
    if not x.dtype.is_floating_point:
        assert torch.equal(x, y), what
        return
    atol = BATCH_RES_ATOL if field in ("residuals", "cost") else BATCH_POSE_ATOL
    torch.testing.assert_close(y, x, atol=atol, rtol=0, msg=what)


def _at(res, b, n=None):
    """Sequence b's result (of frame n of a chunk)."""
    return type(res)(*(t[b] if n is None else t[n, b] for t in res))


def test_fleet_sequence_0_is_the_demo(runs, tmp_path):
    d, _ = runs
    rc, out = _stdout(t_fleet.main, ["--synthetic", "2", "--frames", "4",
                                     "--chunk", "3", "--out-dir",
                                     str(tmp_path)], device="cpu")
    assert rc == 0
    summary = json.loads(out.splitlines()[-1])
    assert list(summary) == FLEET_KEYS
    assert summary["mesh_devices"] == 1 and summary["total_frames"] == 8
    # the fleet's lanes step batched: within BATCH_POSE_ATOL (test_batch_engine)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "seq_synthetic_0.txt"),
                               np.loadtxt(d / "port.txt"),
                               atol=BATCH_POSE_ATOL, rtol=0)


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a, **kw)
    return rc, buf.getvalue()


def test_run_bench_keys():
    out = t_bench.run_bench(n_frames=4, n_points=400, warmup=1, width=128,
                            height=96, repeat_passes=1, device="cpu")
    assert list(out) == BENCH_KEYS
    assert out["detect_hbm_util_vs_v5e_peak"] is None
    assert out["backend"] == "cpu" and out["image"] == "128x96"
    for k, v in out.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v >= 0, k


def test_stages_span_names():
    rc, out = _stdout(t_stages.main, ["--width", "128", "--height", "96",
                                      "--points", "300", "--iters", "1"],
                      device="cpu")
    assert rc == 0
    names = [s[:40].rstrip() for s in out.splitlines()]
    for span in SPANS:
        assert span in names, span


@pytest.mark.parametrize("call", [
    lambda: t_demo.main(ARGV),
    lambda: t_eval.main(["est.txt", "gt.txt"]),
    lambda: t_fleet.main(["--synthetic", "1", "--frames", "2"]),
    lambda: t_stages.main(["--iters", "1"]),
    lambda: t_bench.main(["--frames", "2"]),
    lambda: t_bench.run_bench(n_frames=2),
    lambda: BatchEngine(synthetic_config(), make_sequence(2).cam, 1, 8, 8),
], ids=["demo", "eval", "fleet", "stages", "bench", "run_bench",
        "BatchEngine"])
def test_entry_points_need_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
