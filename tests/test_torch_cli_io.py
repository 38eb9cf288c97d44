"""The entry points' host modules against rso on the CPU: trajectory files,
ATE and RPE, rso-eval's output, the dataset loaders (KITTI, Malaga,
image-dir and EuRoC layouts written with PIL, through both prefetch routes),
the watched directory under an injected clock, the logger, the camera pose
on the robot, the live viewer and the visualization writer.

Every comparison is exact: these modules are copies of the reference's host
numpy, and the same bytes in give the same bytes (or arrays) out.  The one
behavior the port adds: a decode error in the prefetch thread is raised to
the consumer (the reference's thread ends the stream with it).
"""
import contextlib
import io
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

import rso.cli.demo as j_demo
import rso.cli.eval as j_eval
import rso.engine as j_engine
import rso.io.datasets as j_ds
import rso.io.trajectory as j_traj
import rso.metrics.ate as j_ate
import rso.metrics.live_view as j_live
import rso.metrics.logging as j_log
import rso.metrics.profiler as j_prof
import rso.metrics.viz as j_viz
import rso_torch.cli.demo as t_demo
import rso_torch.cli.eval as t_eval
import rso_torch.engine as t_engine
import rso_torch.io.datasets as t_ds
import rso_torch.io.native_loader as t_native
import rso_torch.io.trajectory as t_traj
import rso_torch.metrics.ate as t_ate
import rso_torch.metrics.live_view as t_live
import rso_torch.metrics.logging as t_log
import rso_torch.metrics.profiler as t_prof
import rso_torch.metrics.viz as t_viz
from rso_torch.synthetic import make_unrectified_sequence, synthetic_config
from test_euroc_e2e import _yaml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poses(rng, n):
    """n camera-to-world 4x4 poses along a wandering path."""
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :3] = Rotation.from_rotvec(
        np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)).as_matrix()
    out[:, :3, 3] = np.cumsum(rng.normal(0, 0.5, (n, 3)), 0)
    return out


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a, **kw)
    return rc, buf.getvalue()


# ---- trajectory files, ATE, RPE, rso-eval -----------------------------------

def test_trajectory_files(tmp_path):
    rng = np.random.default_rng(0)
    poses = _poses(rng, 9)
    ts = np.cumsum(rng.uniform(0.05, 0.15, 9))
    for name, write in (("kitti", lambda m, p: m.write_kitti(p, poses)),
                        ("tum", lambda m, p: m.write_tum(p, poses, ts)),
                        ("tum_no_ts", lambda m, p: m.write_tum(p, poses))):
        write(j_traj, str(tmp_path / f"j_{name}"))
        write(t_traj, str(tmp_path / f"t_{name}"))
        assert ((tmp_path / f"j_{name}").read_bytes()
                == (tmp_path / f"t_{name}").read_bytes()), name
    np.testing.assert_array_equal(t_traj.read_kitti(str(tmp_path / "t_kitti")),
                                  j_traj.read_kitti(str(tmp_path / "j_kitti")))
    for a, b in zip(t_traj.read_tum(str(tmp_path / "t_tum")),
                    j_traj.read_tum(str(tmp_path / "j_tum"))):
        np.testing.assert_array_equal(a, b)
    rel = [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(8)]
    np.testing.assert_array_equal(t_traj.integrate_relative(rel),
                                  j_traj.integrate_relative(rel))


@pytest.mark.parametrize("align,with_scale,delta", [
    (True, False, 1), (True, True, 2), (False, False, 3)])
def test_ate_and_rpe(align, with_scale, delta):
    rng = np.random.default_rng(1)
    gt = _poses(rng, 12)
    est = gt.copy()
    est[:, :3, 3] = 1.1 * est[:, :3, 3] + rng.normal(0, 0.05, (12, 3))
    est[:, :3, :3] = est[:, :3, :3] @ Rotation.from_rotvec(
        rng.normal(0, 0.01, (12, 3))).as_matrix()
    assert (t_ate.ate_rmse(est, gt, align=align, with_scale=with_scale)
            == j_ate.ate_rmse(est, gt, align=align, with_scale=with_scale))
    assert t_ate.rpe(est, gt, delta=delta) == j_ate.rpe(est, gt, delta=delta)


@pytest.mark.parametrize("extra", [[], ["--align-scale"], ["--rpe-delta", "2"],
                                   ["--tum"]])
def test_eval_stdout(tmp_path, extra):
    rng = np.random.default_rng(2)
    gt = _poses(rng, 10)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.1, (10, 3))
    write = ((lambda p, x: j_traj.write_tum(p, x)) if "--tum" in extra
             else j_traj.write_kitti)
    write(str(tmp_path / "est"), est[:9])
    write(str(tmp_path / "gt"), gt)
    argv = [str(tmp_path / "est"), str(tmp_path / "gt")] + extra
    want = _stdout(j_eval.main, argv)
    assert _stdout(t_eval.main, argv, device="cpu") == want
    assert want[1].startswith("ATE RMSE: ")


# ---- datasets ---------------------------------------------------------------

def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """KITTI, Malaga, image-dir and EuRoC trees written with PIL, each with
    its own frames (gray PNG, RGB PNG for the image dir, JPEG for Malaga)."""
    root = tmp_path_factory.mktemp("layouts")
    rng = np.random.default_rng(3)
    img = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    out = {}

    d = root / "kitti"
    for i in range(4):
        _png(str(d / "image_0" / f"{i:06d}.png"), img(40, 56))
        _png(str(d / "image_1" / f"{i:06d}.png"), img(40, 56))
    P0 = "718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0"
    P1 = "718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0"
    (d / "calib.txt").write_text(f"P0: {P0}\nP1: {P1}\nP2: {P0}\nP3: {P1}\n")
    (d / "times.txt").write_text("\n".join(f"{0.1037 * i:.6e}"
                                           for i in range(4)) + "\n")
    j_traj.write_kitti(str(root / "kitti_poses.txt"), _poses(rng, 4))
    out["kitti"] = (str(d), str(root / "kitti_poses.txt"))

    d = root / "malaga" / "Images"
    for i, stamp in enumerate(("1261228749.918590", "1261228749.968602",
                               "1261228750.018612")):
        for eye in ("left", "right"):
            if i == 1 and eye == "right":
                continue        # a missing eye skips only that frame
            os.makedirs(str(d), exist_ok=True)
            Image.fromarray(img(32, 48)).save(
                str(d / f"img_CAMERA1_{stamp}_{eye}.jpg"), quality=90)
    out["malaga"] = (str(root / "malaga"), None)

    d = root / "imgdir"
    for i in range(3):
        _png(str(d / f"left_{i:04d}.png"), img(24, 40, 3))
        _png(str(d / f"right_{i:04d}.png"), img(24, 40, 3))
    (root / "cam.ini").write_text(
        "[CAMERA_PARAMS]\nresolution=[40 24]\nfx=50\nfy=51\ncx=20\ncy=12\n"
        "baseline=0.3\n")
    out["imgdir"] = (str(d), str(root / "cam.ini"))

    d = root / "euroc"
    seq, calib = make_unrectified_sequence(n_frames=3, n_points=300, H=48,
                                           W=64)
    H, W = calib.size
    T_r = np.eye(4)
    T_r[:3, :3], T_r[:3, 3] = calib.R_lr, calib.t_lr
    for name, T_BS, K, dist in (("cam0", np.eye(4), calib.K_l, calib.dist_l),
                                ("cam1", T_r, calib.K_r, calib.dist_r)):
        os.makedirs(str(d / "mav0" / name / "data"))
        (d / "mav0" / name / "sensor.yaml").write_text(_yaml(
            T_BS, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dist[:4], W, H))
    for i, (l, r) in enumerate(seq.frames):
        ts = 1403636579763555584 + i * 50_000_000
        _png(str(d / "mav0" / "cam0" / "data" / f"{ts}.png"), l)
        _png(str(d / "mav0" / "cam1" / "data" / f"{ts}.png"), r)
    out["euroc"] = (str(d), None)
    return out


def _load(mod, calib_mod, layout, args):
    path, extra = args
    if layout == "kitti":
        return mod.load_kitti(path, poses_file=extra)
    if layout == "malaga":
        return mod.load_malaga(path)
    if layout == "imgdir":
        return mod.load_image_dir(path, calib_mod.load_mrpt_ini_calib(extra))
    return mod.load_euroc(path)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("layout", ["kitti", "malaga", "imgdir", "euroc"])
def test_datasets(layouts, layout, native):
    import rso.io.calib as j_calib
    import rso.io.native_loader as j_native
    import rso_torch.io.calib as t_calib

    if native and not (t_native.available() and j_native.available()):
        pytest.skip("native/librso_loader.so is not built on this host")
    ref = _load(j_ds, j_calib, layout, layouts[layout])
    got = _load(t_ds, t_calib, layout, layouts[layout])
    assert len(got) == len(ref) > 0
    assert got.left_paths == ref.left_paths
    assert got.right_paths == ref.right_paths
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    for name in ref.cam._fields:
        assert getattr(got.cam, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got.cam, name).numpy(),
                                      np.asarray(getattr(ref.cam, name)))
    if ref.gt_poses is None:
        assert got.gt_poses is None
    else:
        np.testing.assert_array_equal(got.gt_poses, ref.gt_poses)
    if ref.rectify_maps is None:
        assert got.rectify_maps is None
    else:
        for a, b in zip(np.asarray(got.rectify_maps).reshape(4, -1),
                        np.asarray(ref.rectify_maps).reshape(4, -1)):
            np.testing.assert_array_equal(a, b)
    frames_ref = list(ref.prefetch(native=native))
    frames_got = list(got.prefetch(native=native))
    assert len(frames_got) == len(frames_ref) == len(ref)
    for f, g in zip(frames_ref, frames_got):
        assert (g.index, g.timestamp) == (f.index, f.timestamp)
        assert g.left.dtype == np.uint8
        np.testing.assert_array_equal(g.left, f.left)
        np.testing.assert_array_equal(g.right, f.right)


def test_decoders(tmp_path, monkeypatch):
    """cv2, else PIL, else the native loader, else an error naming all
    three; none of them is needed to import the module."""
    img = np.random.default_rng(4).integers(0, 256, (20, 30), dtype=np.uint8)
    path = str(tmp_path / "g.png")
    _png(path, img)
    np.testing.assert_array_equal(t_ds._imread_gray(path), img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(t_ds._imread_gray(path), img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    if t_native.available():
        np.testing.assert_array_equal(t_ds._imread_gray(path), img)
    monkeypatch.setattr(t_native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="cv2.*PIL.*native"):
        t_ds._imread_gray(path)


def test_prefetch_raises_a_decode_error(tmp_path):
    good = np.zeros((8, 8), np.uint8)
    for i in range(3):
        _png(str(tmp_path / f"left_{i:04d}.png"), good)
        _png(str(tmp_path / f"right_{i:04d}.png"), good)
    (tmp_path / "right_0001.png").write_bytes(b"not an image")
    ds = t_ds.load_image_dir(str(tmp_path), synthetic_cam())
    it = ds.prefetch(native=False)
    assert next(it).index == 0
    with pytest.raises(Exception):
        next(it)


def synthetic_cam():
    from rso_torch.geometry import StereoCamera

    return StereoCamera.make(fx_l=50.0, fy_l=50.0, cx_l=4.0, cy_l=4.0,
                             baseline=0.1)


class _Clock:
    """An injected time module: monotonic time advances only in sleep(),
    and each sleep first applies the next scheduled file operation."""

    def __init__(self, schedule):
        self.t = 0.0
        self.schedule = list(schedule)

    def monotonic(self):
        return self.t

    def sleep(self, s):
        if self.schedule:
            self.schedule.pop(0)()
        self.t += s


def _watch(mod, d, frames):
    def pair(i, which=("left", "right")):
        def op():
            for eye in which:
                _png(str(d / f"{eye}_{i:04d}.png"), frames[i][eye == "right"])
        return op

    grow = lambda: _png(str(d / "left_0003.png"), frames[3][0])  # noqa: E731
    schedule = [pair(0), pair(1, ("left",)), pair(1, ("right",)), lambda: None,
                pair(3, ("right",)), lambda: None, lambda: None,
                pair(2), grow, lambda: None, lambda: None]
    clock = _Clock(schedule)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = [(f.index, f.timestamp, f.left.copy(), f.right.copy())
               for f in mod.watch_image_dir(str(d), poll_s=0.25,
                                            idle_timeout_s=1.0, _time=clock)]
    return got, err.getvalue(), clock.t


def test_watch_image_dir(tmp_path):
    """A pair is held until both files exist with sizes stable over one
    poll; a late pair behind a served stem is dropped with a warning; the
    stream ends after the idle timeout — the same frames, warnings and end
    time as the reference under the same clock."""
    rng = np.random.default_rng(5)
    frames = [(rng.integers(0, 256, (12, 16), dtype=np.uint8),
               rng.integers(0, 256, (12, 16), dtype=np.uint8))
              for _ in range(4)]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = _watch(j_ds, tmp_path / "j", frames)
    got = _watch(t_ds, tmp_path / "t", frames)
    assert [g[:2] for g in got[0]] == [r[:2] for r in ref[0]]
    assert len(ref[0]) >= 2
    for g, r in zip(got[0], ref[0]):
        np.testing.assert_array_equal(g[2], r[2])
        np.testing.assert_array_equal(g[3], r[3])
    assert got[1:] == ref[1:]
    assert "out-of-order" in ref[1]


# ---- logging, spans, error names, camera pose on the robot ------------------

def test_span_profiler():
    """The same spans give the reference's report; device_span also marks
    a torch.profiler trace with the span's name."""
    spans = {"_stg1 (rectify+pyramid)": [0.0011, 0.0013],
             "processNewImagePair": [0.05, 0.07, 0.06]}
    profs = [t_prof.SpanProfiler(), j_prof.SpanProfiler()]
    for p in profs:
        p.times.update({k: list(v) for k, v in spans.items()})
    assert profs[0].summary() == profs[1].summary()
    p = t_prof.SpanProfiler()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as trace:
        with p.device_span("_stg5 (robust GN)"):
            torch.ones(4).sum()
        p.enter("outer")
        p.leave("outer")
    assert sorted(p.times) == ["_stg5 (robust GN)", "outer"]
    assert "_stg5 (robust GN)" in {e.name for e in trace.events()}
    off = t_prof.SpanProfiler(enabled=False)
    with off.device_span("x"), off.span("y"):
        pass
    assert not off.times


@pytest.mark.parametrize("code", list(range(-1, 9)))
def test_error_name(code):
    assert t_log.error_name(code) == j_log.error_name(code)
    assert (t_log.error_name(torch.tensor(code, dtype=torch.int32))
            == j_log.error_name(np.int32(code)))


def test_logger(tmp_path):
    rng = np.random.default_rng(6)
    T = 24
    arrays = dict(
        pose=rng.normal(0, 1, 6).astype(np.float32), valid=np.bool_(True),
        error_code=np.int32(0), num_it=np.int32(3), num_it_final=np.int32(2),
        detected_feats=rng.integers(0, 99, (3, 2)).astype(np.int32),
        stereo_matches=rng.integers(0, 99, 3).astype(np.int32),
        tracked_feats_from_last_frame=np.int32(40),
        tracked_feats_from_last_KF=np.int32(30),
        residuals=rng.uniform(0, 1, T).astype(np.float32),
        track_mask=rng.uniform(size=T) < 0.5,
        inliers=rng.uniform(size=T) < 0.5, cost=np.float32(1.5),
        obs_outlier=rng.uniform(size=T) < 0.1)
    assert t_engine.StepResult._fields == j_engine.StepResult._fields
    res_t = t_engine.StepResult(**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in arrays.items()})
    res_j = j_engine.StepResult(**arrays)
    for mod, res, sub in ((t_log, res_t, "t"), (j_log, res_j, "j")):
        lg = mod.VOLogger(2, save_files=True, out_dir=str(tmp_path / sub))
        lg.dump_result(7, res)
    with np.load(tmp_path / "t" / "frame_0007.npz") as a, \
            np.load(tmp_path / "j" / "frame_0007.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for level in (0, 1, 2):
        for v in (0, 1, 2):
            assert (_stdout(t_log.VOLogger(v).log, level, "msg")
                    == _stdout(j_log.VOLogger(v).log, level, "msg"))


CAM_POSES = [[0, 0, 0, 90, 0, 0], [1, 2, 3, 90, 90, 0],
             [0.5, -0.2, 1.5, 12.5, -30, 170]]
CAM_ARGS = [["--cam-pose", "0.5 0 0 90 0 -10"], ["--cam-pose", "0 0 0 0 0 0"],
            [], ["--config", "INI:[0.5 0 0 90 0 -10]"],
            ["--config", "INI:[0.5, 0, 0, 90, 0, -10]"],
            ["--config", "INI:[0 0 0 0 0 0]"], ["--cam-pose", "1 2 x 0 0 0"],
            ["--cam-pose", "1 2 3"], ["--config", "INI:[1 2 3 4 5]"]]


@pytest.mark.parametrize("v", CAM_POSES)
def test_pose_on_robot(v):
    np.testing.assert_array_equal(t_demo._pose_on_robot(v),
                                  j_demo._pose_on_robot(v))


@pytest.mark.parametrize("args", CAM_ARGS)
def test_cam_pose_from_args(tmp_path, args):
    """The flag and the INI key, both vector styles, zero and absent (None),
    and the SystemExit messages of bad values."""
    args = list(args)
    if args and args[1].startswith("INI:"):
        ini = tmp_path / "app.ini"
        ini.write_text(f"[GENERAL]\ncamera_pose_on_robot={args[1][4:]}\n")
        args[1] = str(ini)
    out = []
    for mod in (j_demo, t_demo):
        a = mod.build_parser().parse_args(["--synthetic"] + args)
        try:
            out.append(("ok", mod._cam_pose_from_args(a)))
        except SystemExit as e:
            out.append(("exit", str(e)))
    (kind_j, val_j), (kind_t, val_t) = out
    assert kind_t == kind_j
    if val_j is None or kind_j == "exit":
        assert val_t == val_j
    else:
        np.testing.assert_array_equal(val_t, val_j)


# ---- live viewer and visualization ------------------------------------------

def _publish(viewer, rng, canvas=None):
    for i in range(5):
        T = _poses(rng, 1)[0]
        viewer.publish(i, T, i % 2 == 0,
                       {"fps": round(10.0 + i, 1), "tracked": np.int32(40 + i),
                        "err": "voecNone"}, canvas if i == 3 else None)


def _http(url, data=None):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST" if data is not None else "GET"),
                timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_live_viewer():
    """/state's JSON equals the reference's for the same published frames;
    the port's server answers /state, /frame.jpg and /control (the token
    checked as the reference checks it)."""
    gt = _poses(np.random.default_rng(7), 6)
    viewers = []
    for mod in (j_live, t_live):
        ctl = mod.RemoteControl()
        v = mod.LiveViewer(0, control=ctl)
        v.set_ground_truth(gt)
        _publish(v, np.random.default_rng(8),
                 canvas=np.zeros((8, 16, 3), np.uint8))
        viewers.append((v, ctl))
    (vj, _), (vt, ctl) = viewers
    for since in (0, 2, 7):
        assert vt._state_json(since) == vj._state_json(since)
    port = vt.start()
    try:
        base = f"http://127.0.0.1:{port}"
        code, body = _http(f"{base}/state?since=1")
        assert code == 200 and body == vj._state_json(1)
        assert json.loads(body)["latest"]["frame"] == 4
        code, body = _http(f"{base}/")
        assert code == 200 and vt.token.encode() in body
        code, body = _http(f"{base}/frame.jpg")
        assert code == 200 and body[:2] == b"\xff\xd8"
        assert _http(f"{base}/control?t=wrong", b"q")[0] == 403
        assert _http(f"{base}/control?t={vt.token}", b"x")[0] == 400
        assert _http(f"{base}/control?t={vt.token}", b"q") == (200, b"ok")
        assert ctl.pop() == "q" and ctl.pop() is None
        assert _http(f"{base}/nothing")[0] == 404
    finally:
        vt.stop()


def test_viz(tmp_path):
    rng = np.random.default_rng(9)
    est, gt = _poses(rng, 7), _poses(rng, 7)
    for gt_ in (gt, None):
        for mod, sub in ((j_viz, "j"), (t_viz, "t")):
            mod.VizWriter(str(tmp_path / sub)).write_trajectory_html(est, gt_)
        assert ((tmp_path / "t" / "trajectory.html").read_bytes()
                == (tmp_path / "j" / "trajectory.html").read_bytes())

    # the overlay of the port's state, and of the same state as numpy leaves
    cfg = synthetic_config()
    st = t_engine.init_state(cfg, device="cpu")
    o0 = st.prev.octaves[0]
    K = o0.left.xy.shape[0]
    g = torch.Generator().manual_seed(0)
    xy = lambda: torch.rand(K, 2, generator=g) * torch.tensor([60.0, 40.0])  # noqa: E731
    o0 = o0._replace(
        left=o0.left._replace(xy=xy(), valid=torch.rand(K, generator=g) < 0.3),
        right=o0.right._replace(xy=xy(),
                                valid=torch.rand(K, generator=g) < 0.3),
        matches=o0.matches._replace(
            ridx=torch.randint(0, K, (K,), generator=g, dtype=torch.int32),
            valid=torch.rand(K, generator=g) < 0.2))
    st = st._replace(prev=st.prev._replace(
        octaves=(o0,) + st.prev.octaves[1:]))
    st_np = t_engine._tree_map(lambda t: t.numpy(), st)
    left = rng.integers(0, 256, (40, 60), dtype=np.uint8)
    right = rng.integers(0, 256, (40, 60), dtype=np.uint8)
    np.testing.assert_array_equal(t_live.overlay_from_state(left, right, st),
                                  j_live.overlay_from_state(left, right, st_np))
