"""Host-side input and output: calibration, rectification maps, datasets,
trajectory files and the engine-state checkpoint (counterparts of
rso/io/calib.py, datasets.py, trajectory.py and checkpoint.py)."""
from rso_torch.io.calib import (
    FullCalibration,
    compute_rectify_maps,
    load_euroc_calib,
    load_kitti_calib,
    load_mrpt_ini_calib,
)
from rso_torch.io.checkpoint import load_state, save_state
from rso_torch.io.datasets import (
    StereoDataset,
    StereoFrame,
    load_euroc,
    load_image_dir,
    load_kitti,
    load_malaga,
)
from rso_torch.io.trajectory import (
    integrate_relative,
    read_kitti,
    read_tum,
    write_kitti,
    write_tum,
)

__all__ = [
    "FullCalibration", "compute_rectify_maps", "load_euroc_calib",
    "load_kitti_calib", "load_mrpt_ini_calib", "load_state", "save_state",
    "StereoDataset", "StereoFrame", "load_euroc", "load_image_dir",
    "load_kitti", "load_malaga", "integrate_relative", "read_kitti",
    "read_tum", "write_kitti", "write_tum",
]
