"""The comparison that decides `correct` fails a broken timed path in the
cells `kitti_flow.live` (pyramidal-LK tracking through Engine) and
`euroc.fleet` (11 EuRoC lanes through BatchEngine), as
test_vobench_faults.py holds the other cells: a run on the CPU at a small
size with the program's state left unchanged by each step, each pose
altered where it is produced, or half of the lanes left out; `correct`
comes out false. The sound run beside them comes out true under the same
limits. The LK reference (reflk.py) and its yardstick (roofline_lk.py)
import nothing of the program and nothing of JAX."""
import pytest
import torch

import _cells
from test_vobench_imports import BENCH, _imports
from vobench import run

torch.set_num_threads(2)

CASES = [("kitti_flow.live", None, True), ("kitti_flow.live", "stale", False),
         ("kitti_flow.live", "alter", False),
         ("euroc.fleet", None, True), ("euroc.fleet", "half", False),
         ("euroc.fleet", "stale", False)]


@pytest.mark.parametrize("cell,fault,correct", CASES)
def test_broken_timed_path_is_not_correct(cell, fault, correct):
    c = _cells.small_cell(cell)
    res = run.run_cell(c, 2**31 + 11, 2.0, False, "cpu", fault=fault)
    assert res["correct"] is correct, res["checks"]


@pytest.mark.parametrize("name", ["reflk.py", "roofline_lk.py"])
def test_the_lk_reference_and_yardstick_import_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(BENCH / name)}
    assert not tops & {"rso_torch", "rso", "jax", "jaxlib"}, name
