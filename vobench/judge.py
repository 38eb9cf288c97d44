"""The comparison that decides `correct`.

Once the window has closed and the program is freed, a sample of the
frames the window delivered, drawn from the seed, is worked out again by
the plain reference (`refvo`, float64) from the same raw frames, and each
of the program's answers is judged by what it says. The number compared:

  pose_gap_px   over the sampled frames the reference finds valid, the
                mean, the widest TRIM of them left out, of the median
                distance by which the reference's landmarks land apart in
                the current image under the program's motion and under the
                reference's; a frame the program calls not valid counts
                LOST_PX, so `valid` is held too (infinite where the
                reference can judge under half of the sampled frames)

Its limit is per cell, in limits/<cell>.json, set between the largest
reading of sound runs and the smallest of the lower-precision control (the
reference in bfloat16 in the program's place; `control`).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from vobench import refvo
from vobench.stats import pose_matrix

CHECKS = ("pose_gap_px",)
# the gap a frame counts where the program calls it not valid and the
# reference does not: over the gap of every sound frame but the rare ones
# TRIM leaves out (the others under 0.9 px)
LOST_PX = 2.0
# the share of the widest gaps left out of the mean: about one frame in a
# thousand the program loses, or misses by some 9 px, where the reference
# is within 0.03 px of the truth; four such frames in 200 would double the
# mean
TRIM = 0.02


def sample(rec, count: int, seed: int) -> list:
    """(lane, stream frame) pairs drawn from the frames the window ran."""
    return draw([range(max(1, rec.warm), len(p)) for p in rec.poses],
                count, seed)


def draw(frames: list, count: int, seed: int) -> list:
    """(lane, frame) pairs: an equal share of `count` from each lane's
    `frames[lane]`, drawn from the seed, in order."""
    per = -(-count // len(frames))
    out = []
    for lane, pool in enumerate(frames):
        rng = np.random.default_rng([seed, lane])
        got = rng.choice(len(pool), size=min(per, len(pool)), replace=False)
        out += [(lane, pool[i]) for i in sorted(got)]
    return out


def program_motion(rec, lane: int, k: int):
    """The program's T_{prev<-cur} of stream frame k, or None where the
    frame is not valid."""
    if not rec.valid[lane][k]:
        return None
    return pose_matrix(rec.poses[lane][k])


class Reference:
    """The reference's camera and rectification of a configuration."""

    def __init__(self, cfg: dict, device):
        cam = cfg["camera"]
        self.device = torch.device(device)
        self.params = cfg["reference"]
        if "K_l" in cam:
            self.cam, self.R_rect, maps = refvo.rectification(cam)
            self.maps = [torch.as_tensor(m, device=self.device) for m in maps]
        else:
            self.cam = refvo.Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                    cam["baseline_m"])
            self.R_rect, self.maps = np.eye(3), None

    def image(self, img: torch.Tensor, eye: int, dtype) -> torch.Tensor:
        x = img.to(self.device).to(torch.float64)
        if self.maps is not None:
            x = refvo.remap(x, self.maps[eye])
        return x.to(dtype)

    def step(self, laps, lane: int, k: int, n: int, dtype) -> refvo.Step:
        i0, i1 = (k - 1) % n, k % n
        return refvo.step(self.image(laps[lane, 0, i0], 0, dtype),
                          self.image(laps[lane, 1, i0], 1, dtype),
                          self.image(laps[lane, 0, i1], 0, dtype),
                          self.cam, self.params, dtype)

    def ground_truth(self, poses: np.ndarray) -> np.ndarray:
        """The lap's camera-to-world poses in the rectified left camera's
        axes, the program's."""
        R4 = np.eye(4)
        R4[:3, :3] = self.R_rect
        return R4 @ poses @ R4.T


def compare(motions: list, refs: list, cam: refvo.Camera, truth=None) -> dict:
    """The checks over pairs of (program motion, None where the program
    calls the frame not valid; reference Step); with `truth` (each pair's
    true motion) also, under "diag", each judged pair's gap and both sides'
    gaps to the truth (NaN where the program gave no motion)."""
    gaps, diag, lost = [], [], 0
    for i, (T, ref) in enumerate(zip(motions, refs)):
        if not ref.valid:
            continue
        if T is None:
            lost += 1
            gaps.append(LOST_PX)
        else:
            gaps.append(refvo.pose_gap_px(T, ref.T, ref.points, cam))
        if truth is not None:
            diag.append((gaps[-1], float("nan") if T is None else
                         refvo.pose_gap_px(T, truth[i], ref.points, cam),
                         refvo.pose_gap_px(ref.T, truth[i], ref.points, cam)))
    kept = sorted(gaps)[:len(gaps) - round(TRIM * len(gaps))]
    enough = kept and 2 * len(gaps) >= len(refs)
    out = {"pose_gap_px": sum(kept) / len(kept) if enough else float("inf"),
           "judged": len(gaps), "lost": lost}
    if truth is not None:
        out["diag"] = diag
    return out


def judge(rec, cfg: dict, laps, pairs: list, device, truth=None) -> dict:
    """The checks of the program's answers on `pairs` against the
    reference."""
    ref = Reference(cfg, device)
    n = int(cfg["lap"]["frames"])
    motions = [program_motion(rec, lane, k) for lane, k in pairs]
    refs = [ref.step(laps, lane, k, n, torch.float64) for lane, k in pairs]
    return compare(motions, refs, ref.cam, truth)


def control(cfg: dict, laps, pairs: list, device, truth=None) -> dict:
    """The checks of the reference computed in bfloat16, put in the
    program's place, against the reference in float64."""
    ref = Reference(cfg, device)
    n = int(cfg["lap"]["frames"])
    motions, refs = [], []
    for lane, k in pairs:
        low = ref.step(laps, lane, k, n, torch.bfloat16)
        motions.append(low.T if low.valid else None)
        refs.append(ref.step(laps, lane, k, n, torch.float64))
    return compare(motions, refs, ref.cam, truth)


def true_motions(gt: np.ndarray, pairs: list) -> list:
    """T_{prev<-cur} of each pair from the lanes' (rectified) true poses
    [lanes, n, 4, 4]."""
    n = gt.shape[1]
    return [np.linalg.inv(gt[lane, (k - 1) % n]) @ gt[lane, k % n]
            for lane, k in pairs]


def limits(bench_dir: Path, cell: str) -> dict:
    return json.loads((bench_dir / "limits" / f"{cell}.json").read_text())
