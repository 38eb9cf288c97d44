"""On the card: the cells `kitti_flow.live` and `euroc.fleet` (the
lower-precision control comes out not correct, a short run correct, as
test_vobench_card.py holds the other cells), and the LK kernel on
`kitti_flow.live`'s own frames, at 1241x376, on the keypoints the program
tracks there, against its plain version and against the plain float64
tracker vobench/reflk.py.

    python -m pytest -p no:cacheprovider -s -m gpu vobench/tests/test_vobench_flow_card.py

Each test is marked `gpu` and skips where there is no CUDA device.

Tolerances of the LK comparison: positions and residuals within 2e-3 (px;
grey levels) where both sides track the keypoint (ROADMAP's bound of the
port against rso; the kernel sums each 441-pixel window in f32, the plain
version in another order, the reference in f64: tests/test_torch_lk_cuda.py
and tests/test_torch_lk_reference.py); a status that differs only at a
gate's edge (the residual within 1e-2 of max_err, or the position within
2e-3 px of the inner border), each printed.
"""
import json

import numpy as np
import pytest
import torch

import _cells
from vobench import drive, judge, reflk, run

CELLS = ("kitti_flow.live", "euroc.fleet")
SEED = 2**31 + 23
FRAMES = 6
ATOL = 2e-3
EDGE_ERR = 1e-2
EDGE_PX = 2e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def _cell(name):
    return run.load_cell(json.loads((_cells.ROOT / "BENCHMARK.json").read_text()),
                         name)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    c = _cell(cell)
    t = c["traffic"]
    laps, _ = drive.render_laps(c["cfg"], drive.lane_seeds(t, SEED),
                                int(t.get("chunk", 0)), card)
    n = int(c["cfg"]["lap"]["frames"])
    pairs = judge.draw([range(1, n)] * laps.shape[0], int(t["sample_pairs"]),
                       SEED)
    got = judge.control(c["cfg"], laps, pairs, card)
    assert got["pose_gap_px"] > judge.limits(run.BENCH_DIR, cell)["pose_gap_px"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    c = _cell(cell)
    c["end_to_end"] = []
    res = run.run_cell(c, SEED, 3.0, False, card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["failed"] == 0


def _compare(what, got, want, w, h):
    """Positions and residuals where both track; the slots whose status
    differs, with their margins to the gates. Returns the printed row."""
    g_pos, g_st, g_err = (x.double().cpu() for x in got)
    w_pos, w_st, w_err = (x.double().cpu() for x in want)
    g_st, w_st = g_st.bool(), w_st.bool()
    both = g_st & w_st
    gap = (g_pos - w_pos).abs().amax(-1)[both]
    edges = []
    for idx in torch.nonzero(g_st != w_st).tolist():
        idx = tuple(idx)
        m_err = min(abs(float(e[idx]) - 20.0) for e in (g_err, w_err))
        m_px = min(min(float(p[idx][0]) - 1, w - 1 - float(p[idx][0]),
                       float(p[idx][1]) - 1, h - 1 - float(p[idx][1]),
                       key=abs) for p in (g_pos, w_pos))
        edges.append((idx, round(m_err, 5), round(abs(m_px), 5)))
    row = {"what": what, "slots": int(g_st.numel()), "both": int(both.sum()),
           "pos_max": float(gap.max()), "err_max":
           float((g_err - w_err).abs()[both].max()), "status_differs": edges}
    print(json.dumps(row), flush=True)
    assert row["pos_max"] <= ATOL and row["err_max"] <= ATOL, row
    assert all(e <= EDGE_ERR or p <= EDGE_PX for _, e, p in edges), row
    return row


@pytest.mark.gpu
def test_the_lk_kernel_on_the_cell_s_frames(card):
    """The engine's own flow step on the cell's first frames: for each
    frame after the first and each octave, both eyes' tracked keypoints
    from the previous state, the kernel against the plain version and the
    float64 reference on the same pyramids."""
    from rso_torch.engine import Engine
    from rso_torch.frontend.optical_flow import lk_track_eyes, lk_track_torch
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale

    c = _cell("kitti_flow.live")
    cfg = c["cfg"]
    laps, _ = drive.render_laps(cfg, [SEED], 0, card)
    rso_cfg, cam, _ = drive.program_inputs(cfg, c["ini"], card)
    eng = Engine(rso_cfg, cam, device=card)
    lk = cfg["lk"]
    kw = dict(win=lk["win"], iters=lk["iters"], max_err=lk["max_err"],
              seed_range=lk["seed_range"])
    for i in range(FRAMES):
        left, right = laps[0, 0, i], laps[0, 1, i]
        st = eng.state
        if st is not None:
            cur = [build_pyramid(to_grayscale(x.to(card)), rso_cfg.n_octaves)
                   for x in (left, right)]
            for o, p in enumerate(st.prev.octaves):
                ridx = torch.clamp(p.matches.ridx.long(), min=0)
                pts = torch.stack([p.left.xy, p.right.xy[ridx]])
                ok = torch.stack([p.matches.valid] * 2)
                prev_pyrs = [list(st.prev_pyr_l[o:]), list(st.prev_pyr_r[o:])]
                cur_pyrs = [cur[0][o:], cur[1][o:]]
                got = lk_track_eyes(prev_pyrs, cur_pyrs, pts, ok, **kw)
                plain = [lk_track_torch(prev_pyrs[e], cur_pyrs[e], pts[e],
                                        ok[e], **kw) for e in (0, 1)]
                ref = [reflk.track(prev_pyrs[e], cur_pyrs[e], pts[e], ok[e],
                                   **kw) for e in (0, 1)]
                h, w = cur_pyrs[0][0].shape
                _compare(f"frame {i} octave {o} plain", got,
                         [torch.stack(f) for f in zip(*plain)], w, h)
                _compare(f"frame {i} octave {o} reflk", got,
                         [torch.stack(f) for f in zip(*ref)], w, h)
        eng.process_frame(left, right)
    torch.cuda.synchronize()
    assert np.isfinite(eng.state.last_pose.cpu().numpy()).all()
