"""On the card: the lower-precision control comes out not correct, and a
short run of each cell comes out correct, at the cells' own sizes.

    python -m pytest -p no:cacheprovider -m gpu vobench/tests/test_vobench_card.py

Each test is marked `gpu` and skips where there is no CUDA device."""
import json

import pytest

import _cells
from vobench import drive, judge, run

CELLS = ("kitti.live", "euroc.live", "kitti.fleet")
SEED = 2**31 + 17


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def _cell(name):
    return run.load_cell(json.loads((_cells.ROOT / "BENCHMARK.json").read_text()),
                         name)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    """The reference computed in bfloat16, put in the program's place on
    frames drawn as a run draws them, reads over the cell's limit."""
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
