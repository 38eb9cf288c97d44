"""Many sequences at once on one device (counterpart of rso/parallel.py).

Within a sequence, frame t depends on t-1 (the previous-frame state and the
pose warm start), so parallelism runs across *sequences*: offline benchmark
sweeps (KITTI 00-10) go through one BatchEngine.  The reference vmaps its
jitted step over a batch of engine states sharded over a device mesh; here
the B states go through one step from make_step, one after another, so each
sequence's results are those of an Engine running that sequence alone, bit
for bit.  One step launch per kernel for all B is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from rso_torch.config import RSOConfig
from rso_torch.engine import StepResult, _device, init_state, make_step
from rso_torch.geometry.stereo_camera import StereoCamera

MESH_ERROR = ("a device mesh is not supported: BatchEngine runs its "
              "sequences on one device")


def _stack(results, dim: int = 0) -> StepResult:
    return StepResult(*(torch.stack(v, dim) for v in zip(*results)))


class BatchEngine:
    """Run B independent sequences through one step on one device (the GPU
    unless the caller passes device="cpu"; raises without CUDA).  `states`
    holds the B engine states; a `mesh` raises ValueError."""

    def __init__(self, cfg: RSOConfig, cam: StereoCamera, batch: int,
                 img_h: int, img_w: int, mesh=None, rectify_maps=None,
                 device="cuda"):
        if mesh is not None:
            raise ValueError(MESH_ERROR)
        self.device = _device(device)
        if not isinstance(cam, StereoCamera):
            cam = StereoCamera.from_numpy(cam)
        self.batch = batch
        self.cfg = cfg
        maps = None if rectify_maps is None else tuple(
            tuple(torch.as_tensor(m, dtype=torch.float32, device=self.device)
                  for m in eye) for eye in rectify_maps)
        self._step = make_step(cfg, cam.to(self.device), img_h, img_w,
                               rectify_maps=maps)
        self.states = [init_state(cfg, (img_h, img_w), self.device)
                       for _ in range(batch)]

    def _images(self, imgs) -> torch.Tensor:
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        return imgs.to(self.device)

    def _frames(self, lefts, rights) -> StepResult:
        """One frame of every sequence: lefts/rights [B,H,W] on the device."""
        out = []
        for b in range(self.batch):
            self.states[b], res = self._step(self.states[b], lefts[b],
                                             rights[b])
            out.append(res)
        return _stack(out)

    def process_frames(self, lefts, rights) -> StepResult:
        """lefts/rights: [B,H,W] u8, one frame per sequence -> results with
        a leading [B] axis."""
        return self._frames(self._images(lefts), self._images(rights))

    def process_chunk(self, lefts, rights) -> StepResult:
        """lefts/rights: [B,N,H,W] u8, N frames of each sequence -> results
        stacked [N,B,...] along the frame axis, as the reference's scan
        returns them."""
        lefts, rights = self._images(lefts), self._images(rights)
        return _stack([self._frames(lefts[:, n], rights[:, n])
                       for n in range(lefts.shape[1])])
