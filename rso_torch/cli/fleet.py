"""rso-fleet: run MANY sequences at once on one device.

Counterpart of rso/cli/fleet.py (same arguments, printed lines, JSON summary
keys and return codes).  Within a sequence frame t depends on t-1, so
parallelism happens ACROSS sequences: rso_torch.parallel.BatchEngine takes a
[B,N,H,W] chunk, its states through one step (on the GPU unless main's
caller passes device="cpu"; raises without CUDA).  Under torchrun (or in
processes that started their process group, e.g. with
rso_torch.ba.multihost.initialize_multihost) the B sequences go over a
'seq' mesh of every rank, one per card:

    torchrun --nproc-per-node N -m rso_torch.cli.fleet --kitti ... --kitti ...

`mesh_devices` is the number of ranks that step; rank 0 prints the lines and
writes every sequence's trajectory.  An offline benchmark sweep (e.g. KITTI
00-10) becomes one program instead of B serial demo runs; the reference app
has no analogue (demo-main.cpp runs exactly one stream).

Sources: repeated --kitti/--euroc/--malaga/--img-dir sequence dirs (all must
share image size, calibration, and rectification maps — the step is built
for one camera), or --synthetic B for B differently-
seeded synthetic sequences.  Emits one
KITTI-format trajectory per sequence, a per-sequence ATE line when ground
truth is available, and one JSON summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("rso-fleet", description=__doc__)
    p.add_argument("--kitti", action="append", default=[], metavar="SEQ_DIR",
                   help="KITTI odometry sequence dir (repeatable)")
    p.add_argument("--euroc", action="append", default=[], metavar="SEQ_DIR",
                   help="EuRoC MAV sequence dir (repeatable; on-device "
                        "undistort/rectify like rso-demo)")
    p.add_argument("--malaga", action="append", default=[], metavar="DIR",
                   help="Malaga Urban image dir (repeatable)")
    p.add_argument("--img-dir", action="append", default=[], metavar="DIR",
                   help="generic left_*/right_* dir (repeatable; needs --cam)")
    p.add_argument("--cam", help="camera calibration INI for --img-dir")
    p.add_argument("--poses", action="append", default=[], metavar="FILE",
                   help="ground-truth poses file for the Nth --kitti dir "
                        "(repeatable, matched in order; enables the ATE "
                        "lines)")
    p.add_argument("--synthetic", type=int, default=0, metavar="B",
                   help="run B synthetic blob sequences with seeds 0..B-1")
    p.add_argument("--frames", type=int, default=0,
                   help="frames per sequence (0 = shortest sequence length)")
    p.add_argument("--chunk", type=int, default=64, metavar="N",
                   help="frames per BatchEngine.process_chunk call")
    p.add_argument("--config", help="INI config (reference section/key names)")
    p.add_argument("--out-dir", default="fleet_out",
                   help="trajectories land here as seq_<i>.txt")
    p.add_argument("--coast", action="store_true",
                   help="bridge invalid frames with the last valid motion")
    return p


def _load_sequences(args):
    """-> (cfg, cam, n_frames, per-sequence frame ITERATORS, gts, names).

    Frames stream chunk-by-chunk through the iterators (dataset sources use
    the background prefetch ring) — a B-sequence KITTI sweep never holds
    more than B x chunk frames on the host.
    """
    if args.synthetic:
        from rso_torch.synthetic import make_sequence, synthetic_config

        seqs = [make_sequence(n_frames=args.frames or 30, n_points=2000,
                              seed=s) for s in range(args.synthetic)]
        n = min(len(s.frames) for s in seqs)
        its = [iter(s.frames) for s in seqs]
        gts = [s.poses for s in seqs]
        return (synthetic_config(), seqs[0].cam, n, its, gts,
                ["synthetic_%d" % i for i in range(args.synthetic)], None)

    from rso_torch.config import RSOConfig
    from rso_torch.io import datasets

    dss, names = [], []
    for i, d in enumerate(args.kitti):
        poses = args.poses[i] if i < len(args.poses) else None
        dss.append(datasets.load_kitti(d, poses_file=poses))
        names.append(d.rstrip("/").rsplit("/", 1)[-1])
    for d in args.euroc:
        dss.append(datasets.load_euroc(d))
        names.append(d.rstrip("/").rsplit("/", 1)[-1])
    for d in args.malaga:
        dss.append(datasets.load_malaga(d))
        names.append(d.rstrip("/").rsplit("/", 1)[-1])
    for d in args.img_dir:
        from rso_torch.io.calib import load_mrpt_ini_calib

        if not args.cam:
            raise SystemExit("--img-dir requires --cam")
        dss.append(datasets.load_image_dir(d, load_mrpt_ini_calib(args.cam)))
        names.append(d.rstrip("/").rsplit("/", 1)[-1])
    if not dss:
        raise SystemExit("no sequences given "
                         "(--kitti/--euroc/--malaga/--img-dir/--synthetic)")
    for ds, name in zip(dss, names):
        if len(ds) == 0:
            raise SystemExit(f"sequence {name} is empty "
                             "(no stereo frames found)")
    # de-duplicate display names (two parents with the same leaf dir would
    # silently overwrite each other's seq_<name>.txt)
    seen: dict = {}
    for i, nm in enumerate(names):
        if nm in seen:
            names[i] = f"{nm}_{i}"
            if seen[nm] is not None:
                j = seen[nm]
                names[j] = f"{nm}_{j}"
                seen[nm] = None
        else:
            seen[nm] = i

    cam0 = dss[0].cam
    for i, ds in enumerate(dss[1:], 1):
        if not all(np.allclose(np.asarray(a), np.asarray(b))
                   for a, b in zip(cam0, ds.cam)):
            raise SystemExit(
                f"sequence {names[i]} has different calibration than "
                f"{names[0]}: the fleet step is built for one camera; run "
                "mismatched rigs in separate fleets")
    n = min(len(ds) for ds in dss)
    if args.frames:
        n = min(n, args.frames)
    rmaps = dss[0].rectify_maps
    for i, ds in enumerate(dss[1:], 1):
        a, b = rmaps, ds.rectify_maps
        flat = lambda t: [np.asarray(m) for pair in t for m in pair]
        same = (a is None) == (b is None) and (
            a is None or all(x.shape == y.shape and np.allclose(x, y)
                             for x, y in zip(flat(a), flat(b))))
        if not same:
            raise SystemExit(f"sequence {names[i]} has different "
                             "rectification maps: run it in its own fleet")
    its = [((f.left, f.right) for f in ds.prefetch()) for ds in dss]
    gts = [ds.gt_poses for ds in dss]
    return RSOConfig(), cam0, n, its, gts, names, rmaps


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from rso_torch.ba.multihost import initialize_multihost
    from rso_torch.config import load_config
    from rso_torch.engine import _device
    from rso_torch.geometry import pose_matrix
    from rso_torch.mesh import make_device_mesh
    from rso_torch.metrics.ate import ate_rmse
    from rso_torch.parallel import BatchEngine

    device = _device(device)

    if args.chunk < 1:
        raise SystemExit("--chunk must be >= 1 (frames per device dispatch)")
    cfg, cam, n, its, gts, names, rectify_maps = _load_sequences(args)
    if args.config:
        cfg = load_config(args.config, base=cfg)
    if n == 0:
        raise SystemExit("no frames to process")

    B = len(its)
    firsts = [next(it) for it in its]  # peek one frame for the image size
    H, W = firsts[0][0].shape[:2]
    for i, f in enumerate(firsts):
        if f[0].shape[:2] != (H, W):
            raise SystemExit(f"sequence {names[i]} is {f[0].shape[:2]}, "
                             f"fleet is {H}x{W}: image sizes must match")
    pending = [[f] for f in firsts]  # peeked frames re-enter the stream

    mesh, rank = None, 0
    if dist.is_initialized() or initialize_multihost():
        mesh = make_device_mesh((dist.get_world_size(),), ("seq",), device)
        rank = dist.get_rank()
    be = BatchEngine(cfg, cam, batch=B, img_h=H, img_w=W, mesh=mesh,
                     rectify_maps=rectify_maps, device=device)
    n_devices = be.mesh_devices
    if rank == 0:
        print(f"[rso-fleet] {B} sequences x {n} frames at {W}x{H} over "
              f"{n_devices} device(s)", file=sys.stderr)

    def pull(i, m):
        out = pending[i][:m]
        del pending[i][:m]
        while len(out) < m:
            out.append(next(its[i]))
        return out

    mine = be.sequences                 # this rank's share of the B
    Ts = [np.eye(4) for _ in mine]
    trajs = [[np.eye(4)] for _ in mine]
    last_delta = [None] * len(mine)
    n_valid = 0
    t0 = time.time()
    done = 0
    while mine and done < n:
        m = min(args.chunk, n - done)
        batch = [pull(i, m) for i in range(B)]
        lefts = np.stack([np.stack([f[0] for f in b]) for b in batch])
        rights = np.stack([np.stack([f[1] for f in b]) for b in batch])
        res = be.process_chunk(lefts, rights)  # [m,b,...]
        rel = pose_matrix(res.pose).cpu().numpy()
        val = res.valid.cpu().numpy()
        for t in range(m):
            for i in range(len(mine)):
                if val[t, i]:
                    last_delta[i] = rel[t, i]
                    Ts[i] = Ts[i] @ rel[t, i]
                    n_valid += 1
                elif args.coast and last_delta[i] is not None:
                    Ts[i] = Ts[i] @ last_delta[i]
                trajs[i].append(Ts[i].copy())
        done += m
    wall = time.time() - t0
    # every rank's trajectories, valid count and time, in sequence order
    shares = be.gather((trajs, n_valid, wall))
    if rank != 0:
        return 0
    trajs = [t for share in shares for t in share[0]]
    n_valid = sum(share[1] for share in shares)
    wall = max(share[2] for share in shares)

    import os

    from rso_torch.io.trajectory import write_kitti

    os.makedirs(args.out_dir, exist_ok=True)
    ates = []
    for i in range(B):
        poses = np.stack(trajs[i])
        out = os.path.join(args.out_dir, f"seq_{names[i]}.txt")
        write_kitti(out, poses)
        a = None
        if gts[i] is not None:
            k = min(len(poses), len(gts[i]))
            a = float(ate_rmse(poses[:k], np.asarray(gts[i])[:k]))
            print(f"[rso-fleet] {names[i]}: ATE RMSE {a:.4f} m -> {out}",
                  file=sys.stderr)
        ates.append(a)

    summary = {"sequences": B, "frames_per_seq": n,
               "total_frames": B * n, "wall_s": round(wall, 3),
               "frames_per_sec": round(B * n / max(wall, 1e-9), 2),
               "valid_frac": round(n_valid / max(B * n, 1), 4),
               "mesh_devices": n_devices,
               "ate_rmse_m": ates}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
