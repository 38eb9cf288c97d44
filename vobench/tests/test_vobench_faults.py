"""The comparison that decides `correct` fails a broken timed path.

A run drives the program on the CPU (the harness's look for a card is
skipped) at a small size, with the timed path broken underneath: the
program's state left unchanged by each step, half of the lanes left out,
each pose altered where it is produced, or every second frame called not
valid; `correct` comes out false. The sound run beside them comes out true
under the same limits."""
import pytest
import torch

import _cells
from vobench import run

torch.set_num_threads(2)

CASES = [("kitti.live", None, True), ("kitti.live", "stale", False),
         ("kitti.live", "alter", False), ("kitti.live", "lost", False),
         ("euroc.live", None, True),
         ("euroc.live", "stale", False), ("euroc.live", "alter", False),
         ("kitti.fleet", None, True), ("kitti.fleet", "half", False),
         ("kitti.fleet", "stale", False), ("kitti.fleet", "alter", False),
         ("kitti.fleet", "lost", False)]


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, correct):
    c = _cells.small_cell(cell)
    res = run.run_cell(c, 2**31 + 11, 2.0, False, "cpu", fault=fault)
    assert res["correct"] is correct, res["checks"]
