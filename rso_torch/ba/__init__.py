"""Bundle adjustment: the LM + Schur window solve, on one device or with
its landmarks (and windows) sharded over a mesh of ranks, the sliding
window with marginalization, VO + BA online, and offline trajectory
refinement (counterpart of rso/ba/)."""
from rso_torch.ba.ba import (
    BAProblem,
    BAResult,
    ba_normal_equations,
    ba_problem_from_numpy,
    bundle_adjust,
)
from rso_torch.ba.distributed import (
    distributed_bundle_adjust,
    make_mesh,
    pad_problem,
)
from rso_torch.ba.offline import KeyframeCollector, refine_trajectory
from rso_torch.ba.pipeline import VOWithBA
from rso_torch.ba.window import KeyframeObs, SlidingWindow, should_make_keyframe
from rso_torch.ba.window_sharded import (
    make_win_mesh,
    split_into_windows,
    stitch_window_poses,
    window_sharded_bundle_adjust,
)

__all__ = [
    "KeyframeCollector",
    "refine_trajectory",
    "make_win_mesh",
    "split_into_windows",
    "stitch_window_poses",
    "window_sharded_bundle_adjust",
    "BAProblem",
    "BAResult",
    "ba_normal_equations",
    "ba_problem_from_numpy",
    "bundle_adjust",
    "distributed_bundle_adjust",
    "make_mesh",
    "pad_problem",
    "KeyframeObs",
    "SlidingWindow",
    "should_make_keyframe",
    "VOWithBA",
]
