"""The float gaps between a lane of the port's BatchEngine and an Engine
running the lane's sequence alone, on the CPU at one torch thread (as the
tests run), for the scenes of the tests that bound them: the largest
difference of pose, squared residuals and cost over every lane and frame
(integer fields are asserted equal).

    PYTHONPATH=. python tests/_torch_batch_gaps.py     (~1 min)

  test_torch_batch     3 lanes, make_sequence seeds 0-2, 1200 points,
                       120x160, 4 frames
  test_torch_cli       2 lanes, seeds 0-1, 2000 points at the default
                       size, 4 frames (test_batch_engine)
  test_torch_mesh      one lane (a 'seq' rank's share), seeds 0 and 1, 600
                       points, 160x240, 3 frames
"""
import numpy as np
import torch

from rso_torch.engine import Engine
from rso_torch.parallel import BatchEngine
from rso_torch.synthetic import make_sequence, synthetic_config


def gaps(seqs, n_frames) -> dict:
    cfg, cam = synthetic_config(), seqs[0].cam
    h, w = seqs[0].frames[0][0].shape
    be = BatchEngine(cfg, cam, batch=len(seqs), img_h=h, img_w=w,
                     device="cpu")
    res = [be.process_frames(np.stack([s.frames[n][0] for s in seqs]),
                             np.stack([s.frames[n][1] for s in seqs]))
           for n in range(n_frames)]
    worst = {}
    for b, s in enumerate(seqs):
        eng = Engine(cfg, cam, device="cpu")
        for n in range(n_frames):
            alone = eng.process_frame(*s.frames[n])
            for f, x, y in zip(alone._fields, alone, res[n]):
                if not x.dtype.is_floating_point:
                    assert torch.equal(x, y[b]), (b, n, f)
                elif x.numel():
                    worst[f] = max(worst.get(f, 0.0),
                                   (x - y[b]).abs().max().item())
    return worst


def main() -> None:
    torch.set_num_threads(1)
    print("test_torch_batch", gaps([make_sequence(
        n_frames=4, n_points=1200, H=120, W=160, seed=s) for s in range(3)], 4))
    print("test_torch_cli", gaps([make_sequence(
        n_frames=4, n_points=2000, seed=s) for s in range(2)], 4))
    for s in (0, 1):
        print(f"test_torch_mesh seed {s}", gaps([make_sequence(
            n_frames=3, n_points=600, H=160, W=240, seed=s)], 3))


if __name__ == "__main__":
    main()
