from rso_torch.solver.ransac import RansacResult, ransac_fundamental
from rso_torch.solver.robust_gn import (
    VOEC_BAD_COND_NUMBER,
    VOEC_BAD_TRACKING,
    VOEC_FIRST_ITERATION,
    VOEC_INCR_FUNC_COST_STG1,
    VOEC_INCR_FUNC_COST_STG2,
    VOEC_NONE,
    VOEC_TOO_FEW_INLIERS,
    PoseSolveResult,
    solve_pose,
)

__all__ = [
    "PoseSolveResult",
    "solve_pose",
    "RansacResult",
    "ransac_fundamental",
    "VOEC_NONE",
    "VOEC_BAD_TRACKING",
    "VOEC_BAD_COND_NUMBER",
    "VOEC_INCR_FUNC_COST_STG1",
    "VOEC_INCR_FUNC_COST_STG2",
    "VOEC_FIRST_ITERATION",
    "VOEC_TOO_FEW_INLIERS",
]
