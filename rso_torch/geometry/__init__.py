from rso_torch.geometry.rotations import (
    rodrigues,
    rodrigues_with_grad,
    rotvec_from_matrix,
)
from rso_torch.geometry.se3 import (
    pose_apply,
    pose_compose,
    pose_from_matrix,
    pose_inverse,
    pose_matrix,
)
from rso_torch.geometry.stereo_camera import (
    StereoCamera,
    project_landmarks,
    project_stereo,
    project_stereo_with_jacobian,
    triangulate,
)

__all__ = [
    "rodrigues",
    "rodrigues_with_grad",
    "rotvec_from_matrix",
    "pose_compose",
    "pose_inverse",
    "pose_matrix",
    "pose_from_matrix",
    "pose_apply",
    "StereoCamera",
    "triangulate",
    "project_stereo",
    "project_stereo_with_jacobian",
    "project_landmarks",
]
