"""Many sequences at once (counterpart of rso/parallel.py).

Within a sequence, frame t depends on t-1 (the previous-frame state and the
pose warm start), so parallelism runs across *sequences*: offline benchmark
sweeps (KITTI 00-10) go through one BatchEngine.  The reference vmaps its
jitted step over a batch of engine states sharded over a 'seq' mesh.  Here
each rank of a 'seq' DeviceMesh (one process per device, SPMD) takes the
global [B,...] inputs and steps its contiguous B/n sequences, one after
another through one step from make_step, so each sequence's results are
those of an Engine running that sequence alone, bit for bit.  The steps
need no collective; `gather` collects host summaries through the mesh's
group (gloo's runs on the host, so several ranks can share one card).  One
step launch per kernel for all of a rank's sequences is later work.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from rso_torch.config import RSOConfig
from rso_torch.engine import StepResult, _device, init_state, make_step
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.mesh import check_mesh


def _stack(results, dim: int = 0) -> StepResult:
    return StepResult(*(torch.stack(v, dim) for v in zip(*results)))


class BatchEngine:
    """Run B independent sequences through one step (on the GPU unless the
    caller passes device="cpu"; raises without CUDA).

    mesh: None for every sequence in this process, or a 'seq' DeviceMesh,
    every rank of which builds a BatchEngine with the same arguments and
    steps `sequences`, its contiguous share; where B does not divide over
    the mesh, the reference's rule runs all B on its first rank
    (`mesh_devices` says how many ranks step) and the others hold none.
    `states` holds this rank's engine states.
    """

    def __init__(self, cfg: RSOConfig, cam: StereoCamera, batch: int,
                 img_h: int, img_w: int, mesh=None, rectify_maps=None,
                 device="cuda"):
        self.device = _device(device)
        if not isinstance(cam, StereoCamera):
            cam = StereoCamera.from_numpy(cam)
        self.batch = batch
        self.cfg = cfg
        self.mesh = mesh
        rank, n = 0, 1
        if mesh is not None:
            check_mesh(mesh, ("seq",))
            rank, n = mesh.get_local_rank("seq"), mesh.size()
        # every rank that divides the batch steps B/n of it, else one
        self.mesh_devices = n if batch % n == 0 else 1
        per = batch // self.mesh_devices
        self.sequences = (range(rank * per, (rank + 1) * per)
                          if rank < self.mesh_devices else range(0))
        maps = None if rectify_maps is None else tuple(
            tuple(torch.as_tensor(m, dtype=torch.float32, device=self.device)
                  for m in eye) for eye in rectify_maps)
        self._step = make_step(cfg, cam.to(self.device), img_h, img_w,
                               rectify_maps=maps)
        self.states = [init_state(cfg, (img_h, img_w), self.device)
                       for _ in self.sequences]

    def gather(self, obj) -> list:
        """Every rank's `obj` (a host object) in mesh order, on every rank,
        through the 'seq' group ([obj] without a mesh)."""
        if self.mesh is None:
            return [obj]
        out = [None] * self.mesh.size()
        dist.all_gather_object(out, obj, group=self.mesh.get_group("seq"))
        return out

    def _images(self, imgs) -> torch.Tensor:
        """This rank's sequences of the global [B,...] images, on the
        device."""
        imgs = imgs[self.sequences.start:self.sequences.stop]
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.from_numpy(np.ascontiguousarray(imgs))
        return imgs.to(self.device)

    def _frames(self, lefts, rights) -> StepResult:
        """One frame of this rank's sequences: lefts/rights [b,H,W] on the
        device."""
        out = []
        for b in range(len(self.sequences)):
            self.states[b], res = self._step(self.states[b], lefts[b],
                                             rights[b])
            out.append(res)
        return _stack(out)

    def process_frames(self, lefts, rights) -> StepResult | None:
        """lefts/rights: [B,H,W] u8, one frame per sequence -> results of
        this rank's sequences with a leading [b] axis (None where it holds
        none)."""
        if not self.sequences:
            return None
        return self._frames(self._images(lefts), self._images(rights))

    def process_chunk(self, lefts, rights) -> StepResult | None:
        """lefts/rights: [B,N,H,W] u8, N frames of each sequence -> results
        of this rank's sequences stacked [N,b,...] along the frame axis, as
        the reference's scan returns them (None where it holds none)."""
        if not self.sequences:
            return None
        lefts, rights = self._images(lefts), self._images(rights)
        return _stack([self._frames(lefts[:, n], rights[:, n])
                       for n in range(lefts.shape[1])])
