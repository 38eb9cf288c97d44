"""Typed, frozen configuration tree for the PyTorch engine.

A copy of `rso/config.py`: same dataclasses, field names, defaults, INI
sections and keys, so the reference's INI files load unchanged and a config
built by either package works in both (the enums are `IntEnum`s and compare
by value).  It is a copy rather than an import because importing anything
under `rso` loads jax (rso/__init__.py), and this package never does.
`tests/test_torch_geometry.py` holds the two equal field by field, on the
defaults and on every `configs/*.ini`.

The [TPU] section keeps every key.  Keys that select a TPU-only formulation
(`use_pallas`, `use_mxu_distance`, `use_fused_match`, `use_pallas_detect`,
`interpret_pallas`, `topk_recall`, `detect_bf16`, `fast_i16`) are accepted
and ignored: the port always runs the exact formulation.
"""
from __future__ import annotations

import configparser
import dataclasses
import enum
from dataclasses import dataclass


class DetectMethod(enum.IntEnum):
    ORB = 0
    FAST_ORB = 1
    FASTER = 2
    KLT = 3


class NMSMethod(enum.IntEnum):
    STANDARD = 0
    ADAPTIVE = 1


class StereoMatchMethod(enum.IntEnum):
    DESC_BF = 0
    DESC_RBR = 1
    SAD = 2


class IFMatchMethod(enum.IntEnum):
    DESC_BF = 0
    DESC_WIN = 1
    SAD = 2
    OPTICAL_FLOW = 3


@dataclass(frozen=True)
class RectifyParams:
    nOctaves: int = 3


@dataclass(frozen=True)
class DetectParams:
    detect_method: DetectMethod = DetectMethod.FASTER
    target_feats_per_pixel: float = 10.0 / 1000.0
    KLT_win: int = 4
    minimum_KLT_response: float = 10.0
    non_maximal_suppression: bool = True
    nmsMethod: NMSMethod = NMSMethod.STANDARD
    min_distance: int = 3
    orb_nfeats: int = 500
    orb_nlevels: int = 8
    minimum_ORB_response: float = 0.0
    fast_min_th: int = 5
    fast_max_th: int = 30
    initial_FAST_threshold: int = 20
    update_dyn_thresholds: bool = False
    orb_upright: bool = False


@dataclass(frozen=True)
class LeftRightMatchParams:
    match_method: StereoMatchMethod = StereoMatchMethod.SAD
    sad_max_distance: int = 200
    sad_max_ratio: float = 0.5
    orb_max_distance: float = 40.0
    orb_min_th: int = 30
    orb_max_th: int = 100
    enable_robust_1to1_match: bool = False
    rectified_images: bool = False
    max_y_diff: float = 0.0
    min_z: float = 0.3
    max_z: float = 5.0
    use_z_gate: bool = False


@dataclass(frozen=True)
class InterFrameMatchParams:
    ifm_method: IFMatchMethod = IFMatchMethod.SAD
    ifm_win_w: int = 40
    ifm_win_h: int = 40
    sad_max_distance: int = 200
    sad_max_ratio: float = 0.5
    orb_max_distance: float = 40.0
    filter_fund_matrix: bool = True


@dataclass(frozen=True)
class LeastSquaresParams:
    use_robust_kernel: bool = True
    kernel_param: float = 3.0
    max_iters: int = 100
    initial_max_iters: int = 10
    min_mod_out_vector: float = 1e-3
    std_noise_pixels: float = 1.0
    max_incr_cost: int = 3
    residual_threshold: float = 10.0
    bad_tracking_th: int = 5
    use_previous_pose_as_initial: bool = True
    use_custom_initial_pose: bool = False
    irls_hessian_weighting: bool = True
    use_lm: bool = False
    lm_init_lambda: float = 1e-3
    solve_backend: str = "chol"


@dataclass(frozen=True)
class GUIParams:
    show_gui: bool = False
    draw_all_raw_feats: bool = False
    draw_lr_pairings: bool = False
    draw_tracking: bool = True


@dataclass(frozen=True)
class GeneralParams:
    vo_use_matches_ids: bool = False
    vo_save_files: bool = False
    vo_debug: bool = False
    vo_pause_it: bool = False
    vo_out_dir: str = "out"
    max_recovery_frames: int = 3


@dataclass(frozen=True)
class TPUParams:
    """Static capacities and numerics; see the module docstring for the keys
    the port ignores."""

    max_kps_per_octave: int = 512
    max_tracks: int = 1024
    octave_slot_decay: bool = True
    ransac_iters: int = 256
    ransac_threshold: float = 1.0
    detect_every: int = 1
    propagate_min_matches: int = 48
    topk_recall: float = 0.95
    fast_arc: int = 12
    use_pallas: bool = False
    use_mxu_distance: bool = True
    use_fused_match: bool = True
    use_pallas_detect: bool = False
    subpixel_track_refine: bool = False
    refine_iters: int = 2
    refine_ssd_gate: bool = False
    detect_bf16: bool = False
    fast_i16: bool = False
    interpret_pallas: bool = False


@dataclass(frozen=True)
class RSOConfig:
    rectify: RectifyParams = RectifyParams()
    detect: DetectParams = DetectParams()
    lr_match: LeftRightMatchParams = LeftRightMatchParams()
    if_match: InterFrameMatchParams = InterFrameMatchParams()
    least_squares: LeastSquaresParams = LeastSquaresParams()
    gui: GUIParams = GUIParams()
    general: GeneralParams = GeneralParams()
    tpu: TPUParams = TPUParams()

    @property
    def n_octaves(self) -> int:
        """ORB detection works on a single octave; other detectors use the
        pyramid (reference stage1_rectify.cpp:80)."""
        if self.detect.detect_method == DetectMethod.ORB:
            return 1
        return self.rectify.nOctaves

    def replace(self, **kw) -> "RSOConfig":
        return dataclasses.replace(self, **kw)


_SECTION_FIELDS = {
    "RECTIFY": ("rectify", RectifyParams, {"nOctaves": "nOctaves"}),
    "DETECT": (
        "detect",
        DetectParams,
        {
            "detect_method": "detect_method",
            "min_distance": "min_distance",
            "target_feats_per_pixel": "target_feats_per_pixel",
            "initial_FAST_threshold": "initial_FAST_threshold",
            "fast_min_th": "fast_min_th",
            "fast_max_th": "fast_max_th",
            "KLT_win": "KLT_win",
            "minimum_KLT_response": "minimum_KLT_response",
            "orb_nfeats": "orb_nfeats",
            "orb_nlevels": "orb_nlevels",
            "minimum_ORB_response": "minimum_ORB_response",
            "non_maximal_suppression": "non_maximal_suppression",
            "non_max_supp_method": "nmsMethod",
        },
    ),
    "MATCH": (
        "lr_match",
        LeftRightMatchParams,
        {
            "match_method": "match_method",
            "max_y_diff": "max_y_diff",
            "enable_robust_1to1_match": "enable_robust_1to1_match",
            "rectified_images": "rectified_images",
            "min_z": "min_z",
            "max_z": "max_z",
            "sad_max_ratio": "sad_max_ratio",
            "sad_max_distance": "sad_max_distance",
            "orb_min_th": "orb_min_th",
            "orb_max_th": "orb_max_th",
            "orb_max_distance": "orb_max_distance",
            "use_z_gate": "use_z_gate",
        },
    ),
    "IF-MATCH": (
        "if_match",
        InterFrameMatchParams,
        {
            "if_match_method": "ifm_method",
            "filter_fund_matrix": "filter_fund_matrix",
            "window_height": "ifm_win_h",
            "window_width": "ifm_win_w",
            "sad_max_ratio": "sad_max_ratio",
            "sad_max_distance": "sad_max_distance",
            "orb_max_distance": "orb_max_distance",
        },
    ),
    "LEAST_SQUARES": (
        "least_squares",
        LeastSquaresParams,
        {
            "std_noise_pixels": "std_noise_pixels",
            "use_previous_pose_as_initial": "use_previous_pose_as_initial",
            "initial_max_iters": "initial_max_iters",
            "max_iters": "max_iters",
            "min_mod_out_vector": "min_mod_out_vector",
            "max_incr_cost": "max_incr_cost",
            "residual_threshold": "residual_threshold",
            "bad_tracking_th": "bad_tracking_th",
            "use_robust_kernel": "use_robust_kernel",
            "kernel_param": "kernel_param",
        },
    ),
    "GUI": (
        "gui",
        GUIParams,
        {
            "show_gui": "show_gui",
            "draw_all_raw_feats": "draw_all_raw_feats",
            "draw_lr_pairings": "draw_lr_pairings",
            "draw_tracking": "draw_tracking",
        },
    ),
    "GENERAL": (
        "general",
        GeneralParams,
        {
            "vo_use_matches_ids": "vo_use_matches_ids",
            "vo_save_files": "vo_save_files",
            "vo_debug": "vo_debug",
            "vo_pause_it": "vo_pause_it",
            "vo_out_dir": "vo_out_dir",
        },
    ),
    "TPU": (
        "tpu",
        TPUParams,
        {f.name: f.name for f in dataclasses.fields(TPUParams)},
    ),
}

_ENUM_FIELDS = {
    "detect_method": DetectMethod,
    "nmsMethod": NMSMethod,
    "match_method": StereoMatchMethod,
    "ifm_method": IFMatchMethod,
}


def _parse_value(field_type, raw: str):
    raw = raw.strip()
    if field_type is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if field_type is int:
        return int(float(raw))
    if field_type is float:
        return float(raw)
    if isinstance(field_type, type) and issubclass(field_type, enum.IntEnum):
        return field_type(int(raw))
    return raw


def load_config(path: str, base: RSOConfig | None = None) -> RSOConfig:
    """Load an INI config with the reference's sections/keys into an RSOConfig."""
    cfg = base or RSOConfig()
    parser = configparser.ConfigParser(inline_comment_prefixes=("//", ";", "#"))
    parser.optionxform = str  # preserve case of keys
    with open(path) as f:
        parser.read_string(f.read())

    updates = {}
    for section, (attr, cls, keymap) in _SECTION_FIELDS.items():
        if not parser.has_section(section):
            continue
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for ini_key, field_name in keymap.items():
            if parser.has_option(section, ini_key):
                ftype = _ENUM_FIELDS.get(field_name, fields[field_name].type)
                if isinstance(ftype, str):  # from __future__ annotations
                    ftype = {"int": int, "float": float, "bool": bool, "str": str}.get(
                        ftype, _ENUM_FIELDS.get(field_name, str)
                    )
                kw[field_name] = _parse_value(ftype, parser.get(section, ini_key))
        if kw:
            updates[attr] = dataclasses.replace(getattr(cfg, attr), **kw)
    return cfg.replace(**updates) if updates else cfg
