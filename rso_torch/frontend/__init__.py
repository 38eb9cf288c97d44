from rso_torch.frontend.detect import Features, detect_features, octave_budget
from rso_torch.frontend.pyramid import build_pyramid, downsample2x, to_grayscale
from rso_torch.frontend.stereo_match import StereoMatches, match_left_right
from rso_torch.frontend.track import TrackResult, track_interframe

__all__ = [
    "Features",
    "detect_features",
    "octave_budget",
    "build_pyramid",
    "downsample2x",
    "to_grayscale",
    "StereoMatches",
    "match_left_right",
    "TrackResult",
    "track_interframe",
]
