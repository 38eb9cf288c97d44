"""Many sequences at once (counterpart of rso/parallel.py).

Within a sequence, frame t depends on t-1 (the previous-frame state and the
pose warm start), so parallelism runs across *sequences*: offline benchmark
sweeps (KITTI 00-10) go through one BatchEngine.  The reference runs
`jax.jit(jax.vmap(step))` over a batch of engine states sharded over a
'seq' mesh, and `lax.scan` of it for a chunk.  Here the same: the B
sequences step as one batched step a frame, `torch.func.vmap` of
make_step's step over a leading sequence axis of the state and the images,
run through one `rso_torch.graphs.CompiledStep`, so on the GPU as one CUDA
graph captured once and launched once a frame (process_chunk launches it N
times with no read between them, the scan).  Each CUDA kernel launches
once for all sequences, the sequence axis a grid axis of its launch (the
kernels' vmap rules, as vmap over a `pallas_call` adds a grid axis in the
reference).

The pose solver's GN loop runs while any sequence's runs (its flag reduced
over the lanes by `robust_gn.any_lane`, tested on the device by the graph's
WHILE node: rso's vmap of `lax.while_loop`), and with detect_every > 1 the
step's branch is chosen on the device for all sequences
(`lanes_branches`): the detect or the propagate body where they agree,
else a third that runs both branches and gives each sequence its own
(rso's `lax.cond` under vmap).  On the CPU the same batched step runs
eagerly through the same buffers, reading the branch and the flags on the
host, as Engine does.

Each rank of a 'seq' DeviceMesh (one process per device, SPMD) takes the
global [B,...] inputs and steps its contiguous B/n sequences, batched.  The
steps need no collective; `gather` collects host summaries through the
mesh's group (gloo's runs on the host, so several ranks can share one card).
BatchEngine opens PROFILER's spans (rso_torch.metrics.profiler)
`process_chunk` and `images_in`; under vmap the step's stage-clock marks
launch once for all lanes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from rso_torch.config import RSOConfig
from rso_torch.engine import (MIXED, StepResult, _device, detect_flag,
                              init_state, lanes_detect, make_step)
from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.graphs import Branches, CompiledStep, tree_map
from rso_torch.mesh import check_mesh
from rso_torch.metrics.profiler import PROFILER


def batched_step(step):
    """The batched form of an image step of make_step: (states, lefts,
    rights) with a leading lanes' axis on every leaf -> (states', results),
    all lanes in one vmapped call."""
    def run(states, lefts, rights, *, loop, do_detect=None):
        one = functools.partial(step, loop=loop, do_detect=do_detect)
        return torch.func.vmap(one)(states, lefts, rights)
    return run


def lanes_branches(cfg: RSOConfig) -> Branches:
    """The branches of a batched step: (all lanes detect, none does,
    MIXED), read on the host by lanes_detect, on the device from every
    lane's detect_flag."""
    def flags(states):
        f = torch.func.vmap(lambda st: detect_flag(cfg, st))(states)
        every, some = f.all(), f.any()
        return torch.stack([every, ~some, some & ~every])

    return Branches(keys=(True, False, MIXED),
                    read=lambda sts: lanes_detect(cfg, sts), flags=flags)


class BatchEngine:
    """Run B independent sequences through one batched step (on the GPU
    unless the caller passes device="cpu"; raises without CUDA).

    mesh: None for every sequence in this process, or a 'seq' DeviceMesh,
    every rank of which builds a BatchEngine with the same arguments and
    steps `sequences`, its contiguous share; where B does not divide over
    the mesh, the reference's rule runs all B on its first rank
    (`mesh_devices` says how many ranks step) and the others hold none.
    `states` is this rank's batched EngineState (every leaf [b, ...], None
    where it holds none), as the reference's is.
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
        step = make_step(cfg, cam.to(self.device), img_h, img_w,
                         rectify_maps=maps)
        branches = lanes_branches(cfg) if cfg.tpu.detect_every > 1 else None
        # as Engine._get_step: one graph launch a frame on the GPU
        self._step = CompiledStep(batched_step(step), branches=branches,
                                  capture=self.device.type == "cuda")
        b = len(self.sequences)
        self.states = None if b == 0 else tree_map(
            lambda x: x.expand(b, *x.shape).clone(),
            init_state(cfg, (img_h, img_w), self.device))

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

    def process_frames(self, lefts, rights) -> StepResult | None:
        """lefts/rights: [B,H,W] u8, one frame per sequence -> results of
        this rank's sequences with a leading [b] axis (None where it holds
        none)."""
        if not self.sequences:
            return None
        with PROFILER.span("images_in"):
            lefts, rights = self._images(lefts), self._images(rights)
        self.states, results = self._step(self.states, lefts, rights)
        return results

    def process_chunk(self, lefts, rights) -> StepResult | None:
        """lefts/rights: [B,N,H,W] u8, N frames of each sequence -> results
        of this rank's sequences stacked [N,b,...] along the frame axis, as
        the reference's scan returns them (None where it holds none): the
        batched step's graph launched N times, the states kept in its
        buffers between frames."""
        if not self.sequences:
            return None
        with PROFILER.span("process_chunk"):
            with PROFILER.span("images_in"):
                lefts, rights = self._images(lefts), self._images(rights)
            self.states, results = self._step.chunk(
                self.states, lefts.unbind(1), rights.unbind(1))
        return results
