"""Inputs and comparisons for the LK kernel's checks on the card
(tests/test_torch_lk_cuda.py, chip_smoke.py), made with the port alone, no
jax.

Inputs: two frames of the bench scene at 1241x376 (make_sequence, 2000
points), FASTER keypoints of each octave's images (K = 512 / 256 / 128 at
octaves 0 / 1 / 2, the KITTI preset's slots), moved by seeded offsets, with
border, off-image and invalid slots; LK runs from octave o down the pyramid
(3 - o levels), both eyes in one launch, as the engine's flow path runs it.
`propagate_calls` records detect_every's own calls instead: the engine's
propagation on the bench scene, each eye with its own valid mask.

Tolerances, the kernel against the plain version on the same card:
positions and residuals within 2e-3 (px; grey levels) where both track the
keypoint (ROADMAP's bound of the port against rso: both sum each
441-pixel window in f32, in other orders); on detect_every's calls, whose
points are positions LK tracked from frame to frame, where both track and
the slot has converged.  LK runs a fixed count of iterations and has no
test of convergence, so a slot counts as converged where the plain
version's last iteration moved it by under CONV_PX (`converged`: `iters`
against `iters` - 1 iterations a level); an iterate still moving along an
edge (the aperture problem: a near-singular structure tensor) amplifies the
sums' rounding, 0.85 px apart at a residual 0.002 apart on an H100.  Such
slots are counted, at most MAX_UNCONVERGED of those both track, and their
gaps printed.  A status
that differs only at a gate's edge (`gate_edges`: the residual within
EDGE_ERR of max_err, or the position within EDGE_PX of the image's inner
border) and at most MAX_FLIPS a call, each listed; the coarse SAD seed bit
for bit (exact sums).
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch.config import DetectParams
from rso_torch.frontend import optical_flow as OF
from rso_torch.frontend.detect import detect_features
from rso_torch.frontend.pyramid import build_pyramid, to_grayscale
from rso_torch.synthetic import make_sequence

H, W = 376, 1241
SLOTS = (512, 256, 128)
POS_ATOL = 2e-3
ERR_ATOL = 2e-3
MAX_ERR = 20.0
EDGE_ERR = 1e-2
EDGE_PX = 2e-3
MAX_FLIPS = 2
CONV_PX = 0.01          # calcOpticalFlowPyrLK's default epsilon, px
MAX_UNCONVERGED = 0.5   # of the slots both track (7-32% on detect_every's)


def scene(dev, seed=0):
    """Per frame and eye the 3-level pyramid on `dev`."""
    seq = make_sequence(n_frames=2, n_points=2000, H=H, W=W, seed=seed)
    return [[build_pyramid(to_grayscale(torch.from_numpy(seq.frames[f][e])
                                        .to(dev)), 3) for e in (0, 1)]
            for f in (0, 1)]


def points(img, k, seed, spread=2.0):
    """FASTER keypoints of `img` moved by seeded offsets, the last slots at
    the border and off the image, every 7th slot invalid."""
    f = detect_features(img, DetectParams(), k,
                        torch.tensor(20, dtype=torch.int32, device=img.device),
                        False)
    h, w = img.shape
    rng = np.random.default_rng(seed)
    xy = f.xy.cpu().numpy() + rng.uniform(-spread, spread, (k, 2))
    xy[-4:] = [[0.0, 0.0], [w - 1.0, h - 1.0], [-3.2, 20.0], [w + 2.5, 30.3]]
    valid = f.valid.clone()
    valid[::7] = False
    valid[-4:] = True
    return torch.tensor(xy, dtype=torch.float32, device=img.device), valid


def octave_case(pyr, octave, seed):
    """Both eyes' keypoints at `octave` and the pyramids from there down."""
    pts, valid = zip(*(points(pyr[0][e][octave], SLOTS[octave], seed + e)
                       for e in (0, 1)))
    return ([pyr[0][e][octave:] for e in (0, 1)],
            [pyr[1][e][octave:] for e in (0, 1)],
            torch.stack(pts), torch.stack(valid))


def gate_edges(a, b, width, height):
    """The slots whose status differs between two FlowResults (numpy, any
    leading shape), each with its margins: the residuals' distance to
    max_err and the positions' distance to the inner border [1, size - 1).
    Returns (list of (index, err margin, border margin), all at an edge)."""
    sa, sb = a.status.cpu().numpy(), b.status.cpu().numpy()
    rows = []
    for idx in zip(*np.nonzero(sa != sb)):
        errs = [float(r.err.cpu().numpy()[idx]) for r in (a, b)]
        pos = [r.pos.cpu().numpy()[idx] for r in (a, b)]
        m_err = min(abs(e - MAX_ERR) for e in errs)
        m_px = min(min(abs(p[0] - 1), abs(p[0] - (width - 1)), abs(p[1] - 1),
                       abs(p[1] - (height - 1))) for p in pos)
        rows.append((tuple(int(i) for i in idx), m_err, float(m_px)))
    return rows, all(m_e <= EDGE_ERR or m_p <= EDGE_PX for _, m_e, m_p in rows)


def plain(prev, cur, pts, valid, **kw):
    """The plain version eye by eye, stacked as lk_track_eyes returns."""
    outs = [OF.lk_track_torch(p, c, x, v, **kw)
            for p, c, x, v in zip(prev, cur, pts, valid)]
    return OF.FlowResult(*(torch.stack(f) for f in zip(*outs)))


def converged(prev, cur, pts, valid, iters=10, **kw):
    """[E, K]: the plain version's last iteration moved the slot by under
    CONV_PX in each coordinate (its result at `iters` against `iters` - 1
    iterations a level)."""
    a = plain(prev, cur, pts, valid, iters=iters, **kw).pos
    b = plain(prev, cur, pts, valid, iters=iters - 1, **kw).pos
    return ((a - b).abs() < CONV_PX).all(-1)


def agree(got, want, width, height, conv=None, min_tracked=0.5):
    """Hold the kernel's FlowResult to the plain version's (the tolerances
    above); `conv`, `converged`'s mask, leaves the slots that did not
    converge out of the gaps (None: every slot both track is held);
    `min_tracked` of the slots must track in both.  Returns the status
    differences (gate_edges' rows), the widest position and residual gaps
    over the slots held, the count of slots both track, of those not
    converged and their widest position gap."""
    rows, at_edges = gate_edges(got, want, width, height)
    if not (at_edges and len(rows) <= MAX_FLIPS):
        raise AssertionError(f"status differs away from a gate's edge or "
                             f"too often: {rows}")
    both = (got.status & want.status).cpu()
    if int(both.sum()) < min_tracked * both.numel():
        raise AssertionError(f"{int(both.sum())} of {both.numel()} slots "
                             "tracked by both")
    conv = torch.ones_like(both) if conv is None else conv.cpu()
    held, loose = both & conv, both & ~conv
    n_loose = int(loose.sum())
    if n_loose > MAX_UNCONVERGED * int(both.sum()):
        raise AssertionError(f"{n_loose} of {int(both.sum())} slots tracked "
                             "by both did not converge")
    pos_gap = (got.pos.cpu() - want.pos.cpu()).abs().amax(-1)
    gaps = [float(pos_gap[held].max()) if held.any() else 0.0,
            float((got.err.cpu() - want.err.cpu()).abs()[held].max())
            if held.any() else 0.0]
    if not (gaps[0] <= POS_ATOL and gaps[1] <= ERR_ATOL):
        raise AssertionError(f"over the slots held, position gap {gaps[0]} px, residual gap "
                             f"{gaps[1]}")
    return rows, gaps, int(both.sum()), n_loose, (
        float(pos_gap[loose].max()) if n_loose else 0.0)


def propagate_calls(cfg, seq, dev, n_frames):
    """detect_every's own LK calls: the eager step on `seq`'s first
    n_frames, the engine's propagation taking the kernel (`lk_track_eyes`),
    each call also run through the plain version on the same inputs.
    Returns ([(frame, octave, kernel's FlowResult, plain's, `converged`'s
    mask, width, height)], the frames that detected)."""
    import rso_torch.engine as E

    calls, frame = [], [0]
    kernel = E.lk_track_eyes

    def recording(prev, cur, pts, valid, *a, **kw):
        got = kernel(prev, cur, pts, valid, *a, **kw)
        want = plain(prev, cur, pts, valid, *a, **kw)
        conv = converged(prev, cur, pts, valid, *a, **kw)
        octave = len(calls) % cfg.n_octaves
        h, w = cur[0][0].shape
        calls.append((frame[0], octave, got, want, conv, w, h))
        return got

    frames = [(torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev))
              for l, r in seq.frames[:n_frames]]
    hw = tuple(frames[0][0].shape[:2])
    step = E.make_step(cfg, E.Engine(cfg, seq.cam, device=dev).cam, *hw)
    st = E.init_state(cfg, hw, dev)
    detected = []
    E.lk_track_eyes = recording
    try:
        for i, (left, right) in enumerate(frames):
            frame[0] = i
            n = len(calls)
            st, _ = step(st, left, right)
            if len(calls) == n:
                detected.append(i)
    finally:
        E.lk_track_eyes = kernel
    return calls, detected
