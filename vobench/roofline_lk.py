"""LK's least time a frame at a configuration's shapes (the `lk_roofline`
metric), counted from the mathematics of pyramidal LK, whatever kernel
computes it, against the H100's published peaks (roofline.least_s).

Operations, each +, -, x and |.| one, a window of n = (2 win + 1)^2 pixels:

  a keypoint-level   (55 + 12 iters) n: the template and its two central
                     differences, five bilinear reads of 7 each and 2 + 2
                     for the differences (39 n); the structure tensor's
                     three products and sums (6 n); each iteration a
                     bilinear read of the current window (7 n), its residual
                     (n) and the two products and sums of the right-hand side
                     (4 n); the final residual's read, difference, |.| and
                     sum (10 n).  At win 10, iters 10: 175 x 441 = 77175.
  a seed             (2 range + 1)^2 displacements of an 8x8 SAD: 64
                     differences, |.| and sums each (192), and one compare
                     (193 (2 range + 1)^2).  At range 12: 120625.

A frame runs LK once an octave o on both eyes of its octave_slots(...)[o]
slots, from level o down the pyramid: (n_octaves - o) keypoint-levels and
one seed a slot.  KITTI (500 features, 3 octaves: 512 / 256 / 128 slots):
2 x (512 x (3 x 77175 + 120625) + 256 x (2 x 77175 + 120625) + 128 x
(77175 + 120625)) = 552.0 MFLOP, 8.24 us at 67 TFLOP/s.

Bytes, each input read once and each output written once: both eyes'
previous and current pyramids (every level of a 1241x376 frame's is 612316
f32 pixels, 2.45 MB; 9.80 MB the four), each slot's point (8) and valid
flag (1) in, its position (8), status (1) and residual (4) out: 9.84 MB, 2.94 us at
3.35 TB/s.  So LK is bound by operations.
"""
from __future__ import annotations

from vobench.roofline import least_s, octave_slots

SEED_WIN = 8


def keypoint_level_ops(win: int, iters: int) -> int:
    n = (2 * win + 1) ** 2
    return (55 + 12 * iters) * n


def seed_ops(seed_range: int) -> int:
    return (3 * SEED_WIN * SEED_WIN + 1) * (2 * seed_range + 1) ** 2


def frame_ops(nfeats: int, n_octaves: int, lk: dict, eyes: int = 2) -> int:
    per_level = keypoint_level_ops(int(lk["win"]), int(lk["iters"]))
    seed = seed_ops(int(lk["seed_range"])) if int(lk["seed_range"]) > 0 else 0
    return eyes * sum(K * ((n_octaves - o) * per_level + seed)
                      for o, K in enumerate(octave_slots(nfeats, n_octaves)))


def frame_bytes(height: int, width: int, nfeats: int, n_octaves: int,
                eyes: int = 2) -> int:
    pixels = sum((height >> lvl) * (width >> lvl) for lvl in range(n_octaves))
    slots = sum(octave_slots(nfeats, n_octaves))
    return eyes * (2 * 4 * pixels + slots * (8 + 1 + 8 + 1 + 4))


def frame_least_s(cfg: dict, shapes: dict) -> float:
    """Least seconds of one frame's LK: `cfg` a configuration (camera, its
    "lk" block), `shapes` roofline.ini_shapes of its preset."""
    cam = cfg["camera"]
    return least_s(frame_ops(shapes["nfeats"], shapes["n_octaves"], cfg["lk"]),
                   frame_bytes(cam["height"], cam["width"], shapes["nfeats"],
                               shapes["n_octaves"]))
