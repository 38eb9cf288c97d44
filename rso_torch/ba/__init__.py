"""Bundle adjustment on one device: the LM + Schur window solve, the
sliding window with marginalization, VO + BA online, and offline
trajectory refinement (counterpart of rso/ba/).  The reference's mesh forms
(`distributed_bundle_adjust`, `pad_problem`, `make_mesh`, `make_win_mesh`)
come with a later slice; here the offline windows are a batch dimension."""
from rso_torch.ba.ba import (
    BAProblem,
    BAResult,
    ba_normal_equations,
    ba_problem_from_numpy,
    bundle_adjust,
)
from rso_torch.ba.offline import KeyframeCollector, refine_trajectory
from rso_torch.ba.pipeline import VOWithBA
from rso_torch.ba.window import KeyframeObs, SlidingWindow, should_make_keyframe
from rso_torch.ba.window_sharded import (
    split_into_windows,
    stitch_window_poses,
    window_sharded_bundle_adjust,
)

__all__ = [
    "KeyframeCollector",
    "refine_trajectory",
    "split_into_windows",
    "stitch_window_poses",
    "window_sharded_bundle_adjust",
    "BAProblem",
    "BAResult",
    "ba_normal_equations",
    "ba_problem_from_numpy",
    "bundle_adjust",
    "KeyframeObs",
    "SlidingWindow",
    "should_make_keyframe",
    "VOWithBA",
]
