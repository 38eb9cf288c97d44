"""Engine parity of the OPTICAL_FLOW path (pyramidal LK on both eyes,
flow-guided association, the per-octave fundamental-matrix RANSAC), against
rso on the CPU.

See tests/_torch_paths.py for the runs and the tolerances.
"""
import numpy as np
import pytest
import torch

import _torch_paths as P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("frame", range(P.N_FRAMES))
def test_step_without_the_ransac_filter(frame):
    P.check_exact("flow", frame)


def test_steps_with_the_ransac_filter():
    assert P.check_with_ransac("flow") <= 1


def test_flow_state_carries_the_pyramids():
    """The state after a flow step holds this frame's pyramids, equal to
    the reference's."""
    _, _, states, _ = P.reference_run("flow", False)
    state, _ = P.port_step("flow", False, 1)
    assert len(state.prev_pyr_l) == len(states[2].prev_pyr_l) == 3
    for ours, ref in zip(state.prev_pyr_l + state.prev_pyr_r,
                         tuple(states[2].prev_pyr_l) + tuple(states[2].prev_pyr_r)):
        np.testing.assert_array_equal(ours.numpy(), ref)
