"""rso-stages: per-stage timing report (profiler parity tool).

Counterpart of rso/cli/stages.py: each stage is called on its own and timed
over --iters calls, each call ending in a device synchronize, with the
reference's span names (`_stg1`..`_stg5`, cf. its CTimeLogger report printed
on destruction), then the whole step per call and back to back.  Runs on the
GPU unless main's caller passes device="cpu"; raises where CUDA is absent.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("rso-stages", description=__doc__)
    p.add_argument("--width", type=int, default=1241)
    p.add_argument("--height", type=int, default=376)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)

    import torch

    from rso_torch import random as rrandom
    from rso_torch.config import LeastSquaresParams
    from rso_torch.engine import _device, init_state, make_step
    from rso_torch.frontend.detect import detect_features
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
    from rso_torch.frontend.stereo_match import match_left_right
    from rso_torch.frontend.track import track_interframe
    from rso_torch.geometry.stereo_camera import StereoCamera
    from rso_torch.metrics.profiler import SpanProfiler
    from rso_torch.solver.robust_gn import solve_pose
    from rso_torch.synthetic import make_sequence, synthetic_config

    dev = _device(device)
    H, W = args.height, args.width
    cam = StereoCamera.make(fx_l=718.856, fy_l=718.856, cx_l=W / 2.0,
                            cy_l=H / 2.0, baseline=0.5371)
    seq = make_sequence(n_frames=2, n_points=args.points, H=H, W=W, cam=cam)
    cam = cam.to(dev)
    cfg = synthetic_config()
    K = cfg.tpu.max_kps_per_octave
    O = cfg.n_octaves

    img_l = torch.from_numpy(seq.frames[0][0]).to(dev)
    img_r = torch.from_numpy(seq.frames[0][1]).to(dev)
    prof = SpanProfiler()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(name, fn, *xs):
        out = fn(*xs)
        sync()
        for _ in range(args.iters):
            with prof.span(name):
                out = fn(*xs)
                sync()
        return out

    pyr_l, pyr_r = timed("_stg1 (rectify+pyramid)",
                         lambda a, b: (build_pyramid(to_grayscale(a), O),
                                       build_pyramid(to_grayscale(b), O)),
                         img_l, img_r)

    th = torch.full((), 20, dtype=torch.int32, device=dev)

    def det(im):
        return detect_features(im, cfg.detect, K, th, False,
                               arc=cfg.tpu.fast_arc)

    feats = []
    for o in range(O):
        fl = timed(f"_stg2 detect.oct={o} L", det, pyr_l[o])
        fr = timed(f"_stg2 detect.oct={o} R", det, pyr_r[o])
        feats.append((fl, fr))

    def mm(a, b):
        return match_left_right(a, b, cfg.lr_match, W, 0.0)

    matches = [timed(f"_stg3 match.oct={o}", mm, *feats[o]) for o in range(O)]

    key = rrandom.PRNGKey(0, dev)

    def trk(fl, fr, m):
        return track_interframe(fl, fr, m, fl, fr, m, cfg.if_match, key,
                                cfg.tpu.ransac_iters, cfg.tpu.ransac_threshold)

    for o in range(O):
        timed(f"_stg4 track.oct={o}", trk, *feats[o], matches[o])

    rng = np.random.default_rng(0)
    prev = torch.tensor(rng.uniform(100, 1000, (O * K, 4)),
                        dtype=torch.float32, device=dev)
    cur = prev + 2.0
    mask = torch.ones(O * K, dtype=torch.bool, device=dev)
    timed("_stg5 (robust GN)",
          lambda a, b, m: solve_pose(cam, a, b, m, LeastSquaresParams()),
          prev, cur, mask)

    step = make_step(cfg, cam, H, W)
    st = init_state(cfg, (H, W), dev)
    st, _ = step(st, img_l, img_r)
    timed("processNewImagePair (fused)",
          lambda s: step(s, img_l, img_r)[1].pose, st)

    # back to back: the steps queue their work, one synchronize at the end
    s_ = st
    s_, res = step(s_, img_l, img_r)
    sync()
    t0 = time.time()
    for _ in range(args.iters):
        s_, res = step(s_, img_l, img_r)
    sync()
    pipelined_ms = 1e3 * (time.time() - t0) / args.iters

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend: {dev.type} {name}")
    prof.report()
    print(f"\n{'fused step, pipelined':<40}{args.iters:>8}"
          f"{pipelined_ms:>12.3f}")
    print("\nnotes: per-span numbers include one device synchronize each "
          "(compare against the back-to-back step line); the step reads "
          "back the pose solver's stop flag every iteration, so its calls "
          "overlap little even back to back.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
