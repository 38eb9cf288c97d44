"""Host-side input and output: calibration, rectification maps and the
engine-state checkpoint (counterparts of rso/io/calib.py and
rso/io/checkpoint.py)."""
from rso_torch.io.calib import (
    FullCalibration,
    compute_rectify_maps,
    load_euroc_calib,
    load_kitti_calib,
    load_mrpt_ini_calib,
)
from rso_torch.io.checkpoint import load_state, save_state

__all__ = [
    "FullCalibration", "compute_rectify_maps", "load_euroc_calib",
    "load_kitti_calib", "load_mrpt_ini_calib", "load_state", "save_state",
]
