"""Engine parity of the KITTI preset (configs/kitti.ini: subpixel refine,
robust 1-to-1 matching) and of the eigh solve with LM damping, against rso
on the CPU.

See tests/_torch_paths.py for the runs and the tolerances.  The optical
flow, rectified and detect_every paths are in files of their own, so that
the suite's workers share the reference runs.
"""
import pytest
import torch

import _torch_paths as P

PATHS = ("kitti", "eigh_lm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("frame", range(P.N_FRAMES))
@pytest.mark.parametrize("path", PATHS)
def test_step_without_the_ransac_filter(path, frame):
    P.check_exact(path, frame)


@pytest.mark.parametrize("path", PATHS)
def test_steps_with_the_ransac_filter(path):
    assert P.check_with_ransac(path) <= 1
