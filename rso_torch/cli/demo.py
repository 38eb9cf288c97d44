"""rso-demo: run stereo VO over a dataset or synthetic sequence.

Counterpart of rso/cli/demo.py (same arguments, printed lines and return
codes) and of the reference's demo-stereo-odometry app
(demo-main.cpp:41-298): source selection (--kitti / --euroc / --malaga /
--img-dir / --synthetic replace the reference's --input/--sensor/--img_dir),
engine config INI (--config, same sections/keys), per-frame loop, global pose
composition, trajectory writing, and an ATE report when ground truth exists.
The engine runs on the GPU unless main's caller passes device="cpu", and
main raises where CUDA is absent.  --ba-distributed shards each BA solve's
landmarks over a mesh of every rank (rso_torch.ba.distributed.make_mesh):
under torchrun, one rank per card, each running the same demo; in a plain
process, a one-rank mesh, whose solves equal --ba's bit for bit.
--profile turns on the program's own tracers for the run
(rso_torch.metrics.profiler): its host spans, reported at exit as the
reference's CTimeLogger report, and the stage clock, whose marks in the
step's graph give device ms a frame by stage over the frames after the
first (which captures the marked graph).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("rso-demo", description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti", metavar="SEQ_DIR", help="KITTI odometry sequence dir")
    src.add_argument("--euroc", metavar="SEQ_DIR", help="EuRoC MAV sequence dir")
    src.add_argument("--malaga", metavar="DIR", help="Malaga Urban image dir")
    src.add_argument("--img-dir", metavar="DIR", help="generic left_*/right_* dir")
    src.add_argument("--synthetic", action="store_true", help="synthetic blob sequence")
    p.add_argument("--config", help="INI config (reference section/key names)")
    p.add_argument("--cam", help="camera calibration INI (MRPT style)")
    p.add_argument("--poses", help="ground-truth poses file (KITTI format)")
    p.add_argument("--frames", type=int, default=0, help="limit frame count")
    p.add_argument("--out", default="trajectory.txt", help="output trajectory (KITTI fmt)")
    p.add_argument("--tum", help="also write TUM-format trajectory here")
    p.add_argument("--viz-dir", help="write overlay PNGs + trajectory HTML here")
    p.add_argument("--save-state", help="write engine checkpoint here at the end")
    p.add_argument("--load-state", help="resume engine checkpoint")
    p.add_argument("--verbosity", type=int, default=1)
    p.add_argument("--coast", action="store_true",
                   help="bridge invalid frames with the last valid motion "
                        "(constant-velocity prior) instead of zero motion")
    p.add_argument("--pause", action="store_true",
                   help="start paused; interactive keys on a TTY: "
                        "p=pause/resume, s=single-step, q=quit "
                        "(reference demo-main.cpp:256-284)")
    p.add_argument("--live", type=int, nargs="?", const=0, default=None,
                   metavar="PORT",
                   help="serve a live 3D trajectory/overlay view on "
                        "http://127.0.0.1:PORT (0 or no value = pick a free "
                        "port).  Browser buttons pause/step/quit the run — "
                        "the live-GUI contract of the reference's second "
                        "thread (gui_thread.cpp:76-325) on a headless "
                        "accelerator host")
    p.add_argument("--live-overlay", type=int, default=10, metavar="N",
                   help="with --live: publish a feature/pairing overlay "
                        "image every N frames (0 = never; pulls octave-0 "
                        "features to the host, off the device hot path; "
                        "skipped for unrectified rigs whose features live "
                        "in rectified coordinates)")
    p.add_argument("--cam-pose", metavar="'X Y Z YAW PITCH ROLL'",
                   help="camera pose on the robot (metres, degrees, MRPT "
                        "CPose3D convention): the output trajectory becomes "
                        "the ROBOT path via E*delta*inv(E) composition "
                        "(reference demo-main.cpp:228-243; same as the INI "
                        "GENERAL/camera_pose_on_robot key, which this flag "
                        "overrides)")
    p.add_argument("--watch", action="store_true",
                   help="with --img-dir: LIVE streaming mode — process new "
                        "left_*/right_* pairs as they appear (the headless "
                        "analogue of the reference's live camera input, "
                        "demo-main.cpp:210-239); ends after --watch-idle "
                        "seconds with no new pair")
    p.add_argument("--watch-idle", type=float, default=10.0, metavar="S",
                   help="--watch stream-over timeout (default 10 s)")
    p.add_argument("--profile", action="store_true",
                   help="print the program's host spans and device ms a "
                        "frame by stage (its stage clock) at exit")
    p.add_argument("--chunk", type=int, default=0, metavar="N",
                   help="offline path: N frames per Engine.process_chunk "
                        "call instead of frame-at-a-time calls — same math "
                        "and state evolution, one host read-back per chunk.  "
                        "Interactive keys act at chunk boundaries")
    p.add_argument("--ba", action="store_true",
                   help="sliding-window bundle adjustment at keyframe rate")
    p.add_argument("--ba-offline", action="store_true",
                   help="collect keyframes during the run, then refine the "
                        "whole trajectory afterwards via window-sharded BA "
                        "(all windows solve as one batch on the device; "
                        "rso_torch.ba.offline.refine_trajectory)")
    p.add_argument("--ba-window", type=int, default=8, help="BA keyframe window")
    p.add_argument("--ba-landmarks", type=int, default=1024, help="BA landmark slots")
    p.add_argument("--ba-distributed", action="store_true",
                   help="shard BA landmarks over every rank of the "
                        "process group (one rank without one)")
    return p


def _pose_on_robot(v) -> np.ndarray:
    """[x y z yaw° pitch° roll°] -> 4x4 homogeneous (MRPT CPose3D:
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll), angles in degrees — the
    camera_pose_on_robot convention of demo-main.cpp:178-180)."""
    x, y, z, yaw, pitch, roll = [float(a) for a in v]
    cy, sy = np.cos(np.deg2rad(yaw)), np.sin(np.deg2rad(yaw))
    cp, sp = np.cos(np.deg2rad(pitch)), np.sin(np.deg2rad(pitch))
    cr, sr = np.cos(np.deg2rad(roll)), np.sin(np.deg2rad(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    Rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    E = np.eye(4)
    E[:3, :3] = Rz @ Ry @ Rx
    E[:3, 3] = [x, y, z]
    return E


def _cam_pose_from_args(args) -> np.ndarray | None:
    """--cam-pose flag, else the config INI's GENERAL/camera_pose_on_robot
    (the key the reference app INI carries); None when absent/zero."""
    v = None
    src = "--cam-pose"
    if args.cam_pose:
        try:
            v = [float(a) for a in args.cam_pose.split()]
        except ValueError:
            raise SystemExit("bad --cam-pose (need 6 numbers: "
                             "x y z yaw pitch roll)")
    elif args.config:
        import configparser

        p = configparser.ConfigParser(inline_comment_prefixes=("//", ";", "#"))
        p.optionxform = str
        p.read(args.config)
        raw = p.get("GENERAL", "camera_pose_on_robot", fallback=None)
        if raw:
            src = (f"GENERAL/camera_pose_on_robot in {args.config}")
            try:
                # accept both "[x y z ...]" and the comma-separated INI
                # vector style "[x, y, z, ...]"
                v = [float(a) for a in
                     raw.replace("[", " ").replace("]", " ")
                        .replace(",", " ").split()]
            except ValueError:
                raise SystemExit(f"bad {src}: {raw!r} (need 6 numbers: "
                                 "x y z yaw pitch roll)")
    if v is None:
        return None
    if len(v) != 6:
        raise SystemExit(f"bad {src}: needs 6 values: x y z yaw pitch roll")
    if not any(v):
        return None  # identity extrinsic: skip the per-pose conjugation
    return _pose_on_robot(v)


class _KeyControl:
    """Interactive pause/step/quit keys — the runtime control the reference
    demo offers through its GUI key handler (demo-main.cpp:256-284,
    gui_thread.cpp:328-338): p toggles pause, s steps one frame while
    paused, q quits.  Reads stdin non-blockingly; inert when stdin is not a
    TTY (CI, piped runs) or on platforms without select-able stdin.
    """

    def __init__(self, start_paused: bool = False, remote=None):
        self.paused = start_paused
        self.remote = remote  # a live_view.RemoteControl or None
        try:
            self.tty = sys.stdin is not None and sys.stdin.isatty()
        except (ValueError, OSError):
            self.tty = False

    def _next_cmd(self, timeout: float = 0.0):
        """One pending command from the browser (preferred) or the TTY."""
        if self.remote is not None:
            c = self.remote.pop()
            if c:
                return c
        if self.tty:
            return self._poll_key(timeout)
        if timeout:
            time.sleep(min(timeout, 0.25))
        return None

    def _poll_key(self, timeout: float = 0.0):
        import select

        try:
            r, _, _ = select.select([sys.stdin], [], [], timeout)
        except (ValueError, OSError):
            # stdin is a TTY but not select()-able (e.g. Windows console):
            # fall back to inert mode permanently, otherwise wait_if_paused
            # would spin forever with no way to unpause or quit
            self.tty = False
            self.paused = False
            return None
        if r:
            ch = sys.stdin.readline().strip().lower()
            return ch[:1] if ch else None
        return None

    def wait_if_paused(self) -> bool:
        """Process pending commands; block while paused.  False => quit."""
        if not self.tty and self.remote is None:
            return True
        k = self._next_cmd(0.0)
        while True:
            if k == "q":
                return False
            if k == "p":
                self.paused = not self.paused
                print(f"[rso] {'paused' if self.paused else 'resumed'} "
                      "(p=pause/resume, s=step, q=quit)", file=sys.stderr)
            if k == "s" and self.paused:
                return True  # single-step: run one frame, stay paused
            if not self.paused:
                return True
            k = self._next_cmd(0.25)


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    from rso_torch.metrics.profiler import PROFILER, STAGE_CLOCK

    if not args.profile:
        return _run(args, device)
    PROFILER.clear()
    STAGE_CLOCK.reset()
    PROFILER.enabled = STAGE_CLOCK.on = True
    try:
        return _run(args, device)
    finally:
        PROFILER.enabled = STAGE_CLOCK.on = False


def _run(args, device):
    from rso_torch.config import RSOConfig, load_config
    from rso_torch.engine import Engine, _device
    from rso_torch.geometry import pose_matrix
    from rso_torch.metrics.ate import ate_rmse, rpe
    from rso_torch.metrics.logging import VOLogger, error_name
    from rso_torch.metrics.profiler import PROFILER, STAGE_CLOCK

    device = _device(device)

    # ---- source select (reference demo-main.cpp:110-146) -------------------
    gt = None
    rectify_maps = None
    if args.synthetic:
        from rso_torch.synthetic import make_sequence, synthetic_config

        seq = make_sequence(n_frames=args.frames or 30, n_points=2000)
        cam = seq.cam
        frames = [(l, r, 0.1 * i) for i, (l, r) in enumerate(seq.frames)]
        gt = seq.poses
        cfg = synthetic_config()
    elif args.watch:
        if not args.img_dir or not args.cam:
            print("--watch needs --img-dir and --cam", file=sys.stderr)
            return 2
        import itertools

        from rso_torch.io.calib import load_mrpt_ini_calib
        from rso_torch.io.datasets import watch_image_dir

        cam = load_mrpt_ini_calib(args.cam)
        gen = ((f.left, f.right, f.timestamp)
               for f in watch_image_dir(args.img_dir,
                                        idle_timeout_s=args.watch_idle))
        frames = itertools.islice(gen, args.frames) if args.frames else gen
        cfg = RSOConfig()
    else:
        from rso_torch.io import datasets

        try:
            if args.kitti:
                ds = datasets.load_kitti(args.kitti, poses_file=args.poses)
            elif args.euroc:
                ds = datasets.load_euroc(args.euroc)
            elif args.malaga:
                ds = datasets.load_malaga(args.malaga)
            else:
                from rso_torch.io.calib import load_mrpt_ini_calib

                if not args.cam:
                    print("--img-dir requires --cam", file=sys.stderr)
                    return 2
                ds = datasets.load_image_dir(args.img_dir,
                                             load_mrpt_ini_calib(args.cam))
        except (FileNotFoundError, KeyError) as e:
            print(f"[rso] cannot load dataset: {e}", file=sys.stderr)
            return 2
        if len(ds) == 0:
            print("[rso] dataset is empty (no stereo frames found)",
                  file=sys.stderr)
            return 2
        cam = ds.cam
        gt = ds.gt_poses
        rectify_maps = ds.rectify_maps  # EuRoC: on-device undistort/rectify
        n = len(ds) if not args.frames else min(args.frames, len(ds))
        frames = ((f.left, f.right, f.timestamp)
                  for f in ds.prefetch() if f.index < n)
        cfg = RSOConfig()

    if args.config:
        cfg = load_config(args.config, base=cfg)
    # parse errors raise SystemExit with a source-specific message
    # (--cam-pose flag vs the config INI's camera_pose_on_robot key)
    cam_on_robot = _cam_pose_from_args(args)

    logger = VOLogger(args.verbosity)
    eng = Engine(cfg, cam, rectify_maps=rectify_maps, device=device)
    if args.load_state:
        from rso_torch.io.checkpoint import load_state

        try:
            eng.state = load_state(args.load_state, cfg, device=device)
        except Exception as e:
            print(f"[rso] cannot load state '{args.load_state}': {e}",
                  file=sys.stderr)
            return 2

    # ---- main loop (reference demo-main.cpp:210-287) -----------------------
    ba = None
    if args.ba:
        from rso_torch.ba.pipeline import VOWithBA

        mesh = None
        if args.ba_distributed:
            from rso_torch.ba.distributed import make_mesh
            from rso_torch.ba.multihost import initialize_multihost

            initialize_multihost()          # torchrun's ranks, if any
            mesh = make_mesh(device=device)
        ba = VOWithBA(cfg, cam, max_keyframes=args.ba_window,
                      max_landmarks=args.ba_landmarks, mesh=mesh,
                      device=device)
        ba.engine = eng

    collector = None
    if args.ba_offline:
        if ba is not None or args.chunk > 0:
            print("[rso] --ba-offline needs the per-frame path without --ba "
                  "(it collects keyframe state each frame)", file=sys.stderr)
            return 2
        from rso_torch.ba.offline import KeyframeCollector

        collector = KeyframeCollector(eng, cfg)

    viewer = remote = None
    if args.live is not None:
        from rso_torch.metrics.live_view import LiveViewer, RemoteControl

        remote = RemoteControl()
        viewer = LiveViewer(args.live, control=remote)
        print(f"[rso] live view: http://127.0.0.1:{viewer.start()}/",
              file=sys.stderr)
        print(f"[rso] control: curl -X POST "
              f"'http://127.0.0.1:{viewer.port}/control?t={viewer.token}' "
              f"-d p", file=sys.stderr)
        if gt is not None:
            viewer.set_ground_truth(np.asarray(gt))

    keys = _KeyControl(start_paused=args.pause, remote=remote)
    T = np.eye(4)
    poses = [T.copy()]
    times = [0.0]
    n_frames = 0
    n_kf = 0
    last_delta = None
    staged_from = None      # frames run before the stage clock's count
    t_start = time.time()

    if args.chunk > 0:
        if ba is not None:
            print("[rso] --chunk is incompatible with --ba (the window BA "
                  "pipeline consumes per-frame results)", file=sys.stderr)
            return 2
        import torch

        buf_l, buf_r, buf_ts = [], [], []

        def flush():
            nonlocal T, last_delta, n_frames, staged_from
            if not buf_l:
                return
            # the chunk's images go to the device in one copy per eye
            res = eng.process_chunk(
                torch.from_numpy(np.stack(buf_l)).to(device),
                torch.from_numpy(np.stack(buf_r)).to(device))
            # ONE batched pose_matrix for the whole chunk and one read-back
            # (a pose's matrix has the same bits alone and in a batch, so the
            # trajectory equals the per-frame path's)
            rel_T = pose_matrix(res.pose).cpu().numpy()
            val = res.valid.cpu().numpy()
            for k in range(len(buf_l)):
                if val[k]:
                    last_delta = rel_T[k]
                    T = T @ last_delta
                elif args.coast and last_delta is not None:
                    T = T @ last_delta
                poses.append(T.copy())
                times.append(buf_ts[k])
                n_frames += 1
                if viewer is not None:
                    viewer.publish(n_frames - 1, T, bool(val[k]),
                                   {"fps": round(n_frames / max(
                                       time.time() - t_start, 1e-9), 1)})
            logger.log(1, f"[rso] chunk of {len(buf_l)}: "
                          f"{int(val.sum())}/{len(buf_l)} valid, "
                          f"pos={T[:3, 3].round(3).tolist()}")
            buf_l.clear(), buf_r.clear(), buf_ts.clear()
            if args.profile and staged_from is None:
                STAGE_CLOCK.reset()     # the first chunk captured the graph
                staged_from = n_frames

        # honor a start-paused run (--pause) BEFORE the first chunk is
        # buffered/dispatched, matching per-frame mode's pause-before-
        # frame-1 semantics
        if not keys.wait_if_paused():
            print("[rso] quit requested", file=sys.stderr)
            frames = iter(())
        for left, right, ts in frames:
            buf_l.append(left)
            buf_r.append(right)
            buf_ts.append(ts)
            if len(buf_l) == args.chunk:
                flush()
                # interactive controls (TTY or --live browser) act at
                # chunk boundaries: pause blocks here, quit stops
                if not keys.wait_if_paused():
                    print("[rso] quit requested", file=sys.stderr)
                    buf_l.clear(), buf_r.clear(), buf_ts.clear()
                    break
        flush()
        frames = ()  # per-frame loop below sees an exhausted source

    for left, right, ts in frames:
        if not keys.wait_if_paused():
            print("[rso] quit requested", file=sys.stderr)
            break
        if ba is not None:
            with PROFILER.span("ba.process_frame"):
                out = ba.process_frame(left, right)
            T = out.pose_wc
            n_kf += int(out.is_keyframe)
            valid = out.vo_valid
        else:
            res = eng.process_frame(left, right)
            valid = bool(res.valid)
            if valid:
                last_delta = pose_matrix(res.pose).cpu().numpy()
                T = T @ last_delta
            elif args.coast and last_delta is not None:
                # constant-velocity coast: bridge invalid frames with
                # the last valid inter-frame motion (the engine reports
                # the gap via result.valid; the trajectory stays usable)
                T = T @ last_delta
        poses.append(T.copy())
        times.append(ts)
        n_frames += 1
        if args.profile and staged_from is None:
            STAGE_CLOCK.reset()     # the first frame captured the graph
            staged_from = n_frames
        if viewer is not None:
            cnt = {"fps": round(n_frames / max(time.time() - t_start,
                                               1e-9), 1)}
            if ba is None:
                cnt["tracked"] = int(res.tracked_feats_from_last_frame)
                cnt["err"] = error_name(res.error_code)
            canvas = None
            # no overlay for unrectified rigs (EuRoC): state features live
            # in rectified coordinates, the raw host frames don't — drawing
            # one on the other would offset every mark by the rectify warp
            if (args.live_overlay and n_frames % args.live_overlay == 0
                    and eng.state is not None and rectify_maps is None):
                from rso_torch.metrics.live_view import overlay_from_state

                canvas = overlay_from_state(left, right, eng.state)
            viewer.publish(n_frames - 1, T, bool(valid), cnt, canvas)
        if collector is not None:
            collector.observe(n_frames - 1, res, T)
        if ba is not None:
            logger.log(1, f"[rso] frame {n_frames}: valid={valid} "
                          f"kf={bool(out.is_keyframe)} "
                          f"pos={T[:3, 3].round(3).tolist()}")
        else:
            logger.log(1, f"[rso] frame {n_frames}: valid={valid} "
                          f"({error_name(res.error_code)}) "
                          f"tracked={int(res.tracked_feats_from_last_frame)} "
                          f"pos={T[:3, 3].round(3).tolist()}")
    wall = time.time() - t_start
    if ba is not None:
        print(f"[rso] {n_kf} keyframes in window BA")

    poses = np.stack(poses)
    if collector is not None and len(collector.kfs) >= 3:
        from rso_torch.ba.offline import refine_trajectory

        # poses[0] is the pre-run identity; frames are poses[1:]
        refined = refine_trajectory(cam, collector.kfs,
                                    collector.kf_frame_idx, poses[1:],
                                    window=args.ba_window, device=device)
        print(f"[rso] offline window-sharded refine: "
              f"{len(collector.kfs)} keyframes")
        if gt is not None:
            n = min(len(refined), len(gt))
            print(f"[rso] VO-only ATE: {ate_rmse(poses[1:][:n], gt[:n]):.4f}"
                  f" m -> refined: {ate_rmse(refined[:n], gt[:n]):.4f} m")
        poses = np.concatenate([poses[:1], refined])
    from rso_torch.io.trajectory import write_kitti, write_tum

    # camera-on-robot extrinsic: conjugation distributes over composition,
    # so E @ T_t @ inv(E) of the composed pose equals the reference's
    # per-frame pose = pose * (E * delta * inv(E)) chain exactly
    # (demo-main.cpp:235-240).  Files get the robot path; ATE/viz stay in
    # the camera frame (ground truth is camera-frame).
    out_poses = poses
    if cam_on_robot is not None:
        out_poses = np.einsum("ij,njk,kl->nil", cam_on_robot, poses,
                              np.linalg.inv(cam_on_robot))
        print("[rso] trajectory written in ROBOT frame "
              "(camera_pose_on_robot applied)", file=sys.stderr)
    write_kitti(args.out, out_poses)
    if args.tum:
        write_tum(args.tum, out_poses, np.asarray(times))
    print(f"[rso] {n_frames} frames in {wall:.2f}s "
          f"({n_frames / max(wall, 1e-9):.2f} FPS) -> {args.out}")

    if gt is not None:
        n = min(len(poses), len(gt))
        a = ate_rmse(poses[:n], gt[:n])
        rt, rr = rpe(poses[:n], gt[:n])
        print(f"[rso] ATE RMSE: {a:.4f} m | RPE: {rt:.4f} m / {rr:.4f} deg")

    if args.viz_dir:
        from rso_torch.metrics.viz import VizWriter

        vw = VizWriter(args.viz_dir)
        vw.write_trajectory_html(poses, gt)
        print(f"[rso] wrote {args.viz_dir}/trajectory.html")

    if args.save_state and eng.state is not None:
        from rso_torch.io.checkpoint import save_state

        save_state(args.save_state, eng.state)
        print(f"[rso] saved engine state -> {args.save_state}")

    if viewer is not None:
        viewer.stop()
    if args.profile:
        PROFILER.report()
        STAGE_CLOCK.settle()
        print(f"\nstage clock over {n_frames - (staged_from or 0)} frames "
              "after the first:")
        print(STAGE_CLOCK.summary(n_frames - (staged_from or 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
