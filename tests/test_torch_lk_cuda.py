"""The LK kernel (rso_torch/csrc/lk_track.cu) against its plain version
(rso_torch.frontend.optical_flow.lk_track_torch) on the card, and the
flow and detect_every paths that run it.

Every test is marked `gpu` and skips without a CUDA device.  The file
imports neither jax nor rso:

    python -m pytest --noconftest -m gpu tests/test_torch_lk_cuda.py

Inputs and tolerances: tests/_torch_lk_cases.py (the bench scene at
1241x376, the KITTI preset's slots; positions and residuals within 2e-3
where both track, on detect_every's calls where the slot also converged;
status differences only at a gate's edge, the seed bit for bit).  A lane in a batch is its lone launch bit for bit (a lane is
blocks running the same code).
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_card as card
import _torch_lk_cases as C
from rso_torch.frontend import optical_flow as OF
from rso_torch.graphs import reset_launches, settle_launches
from rso_torch.kernels import _lib
from rso_torch.synthetic import make_sequence, synthetic_config

H, W, SLOTS = C.H, C.W, C.SLOTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("octave", [0, 1, 2])
def test_cuda_lk_kernel_matches_the_plain_version(cuda, octave):
    """Both eyes of an octave in one launch, against the plain version on
    the same card."""
    pyr = C.scene(cuda)
    prev, cur, pts, valid = C.octave_case(pyr, octave, 10 * octave)
    reset_launches()
    got = OF.lk_track_eyes(prev, cur, pts, valid)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"lk_track": 1}
    print(card.check_kernel("lk_track", got, C.plain(prev, cur, pts, valid),
                            width=W >> octave, height=H >> octave))


@pytest.mark.gpu
@pytest.mark.parametrize("win,iters", [(2, 3), (5, 3), (7, 3)])
def test_cuda_lk_kernel_other_windows(cuda, win, iters):
    """Narrower windows than the port's (a block's 512 pixel slots cover
    any up to win 10, idle threads past the window) against the plain
    version."""
    pyr = C.scene(cuda, seed=1)
    prev, cur, pts, valid = C.octave_case(pyr, 1, 7)
    got = OF.lk_track_eyes(prev, cur, pts, valid, win=win, iters=iters)
    want = C.plain(prev, cur, pts, valid, win=win, iters=iters)
    print(C.agree(got, want, W >> 1, H >> 1))


@pytest.mark.gpu
@pytest.mark.parametrize("seed_range,scene", [
    pytest.param(4, 2, id="4"), pytest.param(12, 2, id="12"),
    pytest.param(12, 0, id="12-scene0")])
def test_cuda_lk_seed_bit_for_bit(cuda, seed_range, scene):
    """With no iteration on one level the kernel returns the keypoint plus
    its coarse SAD seed: the plain seed bit for bit (FASTER keypoints sit on
    whole pixels, so the sum is exact); scene 0 is the one chip_smoke.py
    times LK on."""
    pyr = C.scene(cuda, seed=scene)
    for octave in range(3):
        img0, img1 = pyr[0][0][octave], pyr[1][0][octave]
        pts, valid = C.points(img0, SLOTS[octave], octave, spread=0.0)
        pts = torch.round(pts)
        got = OF.lk_track([img0], [img1], pts, valid, iters=0,
                          seed_range=seed_range)
        seed = OF._coarse_sad_seed(img0, img1, pts, seed_range)
        assert torch.equal(got.pos - pts, seed), octave
        assert bool((seed != 0).any())


@pytest.mark.gpu
def test_cuda_lk_lanes_are_lone_calls(cuda):
    """Under torch.func.vmap (the batched step) one launch runs 3 lanes, each
    lane its lone launch bit for bit."""
    cases = [C.octave_case(C.scene(cuda, seed=s), 0, s) for s in range(3)]
    lone = [OF.lk_track_eyes(*c) for c in cases]
    stacked = [torch.stack([c[i] for c in cases]) for i in (2, 3)]
    prev = [[torch.stack([c[0][e][lvl] for c in cases]) for lvl in range(3)]
            for e in (0, 1)]
    cur = [[torch.stack([c[1][e][lvl] for c in cases]) for lvl in range(3)]
           for e in (0, 1)]
    reset_launches()
    batched = torch.func.vmap(OF.lk_track_eyes)(prev, cur, *stacked)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["lk_track"] == 1
    card.check_lanes("lk_track", batched, lone.__getitem__, len(lone))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["engine", "batch"])
def test_cuda_flow_marked_graph_equals_the_unmarked(cuda, entry):
    """The flow path's composed graph with the stage clock's marks on gives
    the unmarked graph's results bit for bit and the same launches a frame:
    one lk_track launch an octave (both eyes; all lanes), no tracking
    kernel; the clock charges `lk` once an octave a frame."""
    from rso_torch.engine import Engine
    from rso_torch.metrics.profiler import STAGE_CLOCK, STAGES
    from rso_torch.parallel import BatchEngine

    base = synthetic_config()
    cfg = base.replace(if_match=dataclasses.replace(base.if_match,
                                                    ifm_method=3))
    n = 8
    seqs = [make_sequence(n_frames=n, n_points=2000, H=H, W=W, seed=s)
            for s in range(2)]
    runs = []
    STAGE_CLOCK.reset()
    try:
        for on in (False, True):
            STAGE_CLOCK.on = on
            if entry == "engine":
                eng = Engine(cfg, seqs[0].cam, device=cuda)
                step = lambda i: eng.process_frame(*seqs[0].frames[i])  # noqa: E731
            else:
                be = BatchEngine(cfg, seqs[0].cam, batch=2, img_h=H, img_w=W,
                                 device=cuda)
                step = lambda i: be.process_frames(  # noqa: E731
                    np.stack([s.frames[i][0] for s in seqs]),
                    np.stack([s.frames[i][1] for s in seqs]))
            runs.append([])
            for i in range(n):
                reset_launches()
                res = step(i)
                runs[-1].append((res, dict(settle_launches())))
        STAGE_CLOCK.on = False
        for i, ((a, la), (b, lb)) in enumerate(zip(*runs)):
            card.same_bits(f"frame {i}", a, b)
            assert la == lb, f"frame {i} launches"
            assert la.get("lk_track") == cfg.n_octaves, la
            assert not la.get("track_sad_fused"), la
        ns, marks = STAGE_CLOCK.settle()
        assert set(marks) == set(STAGES) - {"propagate", "ransac"}
        assert marks["lk"] == cfg.n_octaves * n and ns["lk"] > 0
    finally:
        STAGE_CLOCK.on = False
        STAGE_CLOCK.reset()


@pytest.mark.gpu
def test_cuda_lk_wider_window_refused(cuda):
    """One build of the kernel, up to win 10: a wider window is refused."""
    pyr = C.scene(cuda)
    prev, cur, pts, valid = C.octave_case(pyr, 2, 0)
    with pytest.raises(ValueError, match="win 11"):
        OF.lk_track_eyes(prev, cur, pts, valid, win=11)


@pytest.mark.gpu
def test_cuda_lk_propagate_calls_match_the_plain_version(cuda):
    """detect_every's own calls (the engine's propagation, both eyes in one
    launch, each eye its own valid mask: the left features, the stereo
    pairs) on 21 bench frames, each held to the plain version on the same
    inputs: the positions where both track and the slot converged."""
    base = synthetic_config()
    cfg = base.replace(tpu=dataclasses.replace(base.tpu, detect_every=3))
    calls, detected = C.propagate_calls(cfg, card.bench_scene(), cuda, 21)
    assert calls and len(detected) < 21, detected
    for frame, octave, got, want, conv, w, h in calls:
        rows, gaps, n, n_loose, loose_gap = C.agree(got, want, w, h, conv,
                                                    min_tracked=0.0)
        print(f"frame {frame} octave {octave}: status differs at {rows}; "
              f"where both track and converged, position gap {gaps[0]} px, "
              f"residual gap {gaps[1]}; {n_loose} of {n} not converged, "
              f"widest gap there {loose_gap} px")
