"""Engine parity of the descriptor modes (FAST_ORB + DESC_RBR + DESC_WIN,
ORB + DESC_BF + DESC_BF, upright) against rso, on the CPU.

See tests/_torch_modes.py for the runs and the tolerances.  The modes of
this file run on one test worker; the SAD modes are in a file of their own,
so that the suite's workers share the reference runs.
"""
import pytest
import torch

import _torch_modes as M

MODES = ("fast_orb_rbr_win", "orb_bf_bf")


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
