"""Engine parity of the SAD modes (KLT + SAD + SAD, the default modes on the
dense SAD matrices, and the default modes with adaptive NMS) against rso, on
the CPU.

See tests/_torch_modes.py for the runs and the tolerances.  The modes of
this file run on one test worker; the descriptor modes are in a file of
their own, so that the suite's workers share the reference runs.
"""
import pytest
import torch

import _torch_modes as M

MODES = ("klt_sad_sad", "sad_dense", "adaptive_nms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("frame", range(M.N_FRAMES))
@pytest.mark.parametrize("mode", MODES)
def test_step_without_the_ransac_filter(mode, frame):
    M.check_exact(mode, frame)


@pytest.mark.parametrize("mode", MODES)
def test_steps_with_the_ransac_filter(mode):
    assert M.check_with_ransac(mode) <= 1
