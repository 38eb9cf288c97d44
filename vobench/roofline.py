"""Least times of the program's own kernels at a configuration's launch
shapes, against the H100's published peaks.

The operation and byte counts are those of chip_smoke.py (`corner_ops`,
`stereo_bound`, `track_bound`, the null-vector kernel's), copied so that
the yardstick stays fixed. Kernels 2 and 3 form their SAD only on the
pairs the mask admits, a count the program does not report: their
operations here are the mask's alone, a lower bound, so their least time
is never overstated.
"""
from __future__ import annotations

PEAK_OPS = 67e12       # f32 outside the tensor cores, H100 SXM at 700 W
PEAK_BYTES = 3.35e12   # HBM3
PATCH = 64             # 8x8 SAD patch


def least_s(ops: float, n_bytes: float) -> float:
    """The larger of operations over the peak rate and bytes (each input
    read once, each output written once) over the memory rate."""
    return max(ops / PEAK_OPS, n_bytes / PEAK_BYTES)


def corner_ops(win: int) -> int:
    """Kernel 1's operations a pixel (190 at win 4)."""
    return 142 + 12 * win


def octave_slots(nfeats: int, n_octaves: int, k_max: int = 512) -> list:
    """Feature slots an octave: the octave's budget (k0 = nfeats*2O/(2^O-1),
    halved an octave) up to a multiple of 128, at least 128, at most k_max."""
    if n_octaves == 1:
        budget = [nfeats]
    else:
        k0 = int(nfeats * (2 * n_octaves) / (2 ** n_octaves - 1))
        budget = [max(1, int(round(k0 / 2 ** o))) for o in range(n_octaves)]
    return [min(k_max, max(128, -(-b // 128) * 128)) for b in budget]


def frame_launches(height: int, width: int, nfeats: int, n_octaves: int,
                   win: int = 4, lanes: int = 1) -> dict:
    """{kernel name: [least seconds of each launch of one frame]} of the
    SAD path (FASTER + fused stereo + fused tracking + flat RANSAC), each
    launch serving `lanes` sequences."""
    out = {"corner_response_kernel": [], "stereo_sad_kernel": [],
           "track_sad_kernel": [], "nullvec9_kernel": []}
    P = PATCH
    for o, K in enumerate(octave_slots(nfeats, n_octaves)):
        px = (height >> o) * (width >> o)
        for _eye in range(2):
            out["corner_response_kernel"].append(
                lanes * least_s(corner_ops(win) * px, 8 * px))
        out["stereo_sad_kernel"].append(lanes * least_s(
            K * K * 10, 4 * 2 * K * (P + 2) + 2 * K + 12 * K))
        out["track_sad_kernel"].append(lanes * least_s(
            K * K * 10, 4 * 2 * K * (2 * P + 3) + 2 * K + 8 * K))
    for B in (512, 2):           # RANSAC's hypotheses, then the refit
        out["nullvec9_kernel"].append(lanes * least_s(B * 900, B * 90 * 4))
    return out


OWN_KERNELS = ("corner_response_kernel", "corner_colsum_kernel",
               "corner_wide_kernel", "stereo_sad_kernel", "track_sad_kernel",
               "nullvec9_kernel", "hamming_kernel", "sad_kernel",
               "eigh6_kernel")


def ini_shapes(path: str) -> dict:
    """The launch shapes an INI preset sets: features a frame and octaves
    (the detector's window stays at its default, 4)."""
    import configparser

    p = configparser.ConfigParser(inline_comment_prefixes=("//", ";", "#"))
    p.optionxform = str
    p.read(path)
    return {"nfeats": p.getint("DETECT", "orb_nfeats", fallback=500),
            "n_octaves": p.getint("RECTIFY", "nOctaves", fallback=3)}
