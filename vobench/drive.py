"""The traffic: one general driver of the program's entries, set by a
traffic file's parameters.

entry "engine"     one stream through `Engine.process_frame`, closed loop:
                   each frame's host arrays come from a pinned lap buffer and
                   its pose and `valid` reach the host before the next frame.
entry "batch"      `lanes` streams through `BatchEngine.process_chunk`,
                   `chunk` frames a call, each chunk copied from pinned host
                   memory and its results read back before the next.

Every stream starts at frame 0 of its lap: set-up runs its first frames
(`warm_frames`, or `warm_chunks` chunks), which capture the program's
graphs, and the window continues the same stream.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from vobench import gen
from vobench.trace import span


@dataclass
class Record:
    """What a run saw. Per stream frame (all lanes): the program's pose
    (a [6] T_{prev<-cur}), `valid`, GN iterations; per window: counts and
    times."""
    lanes: int
    poses: list = field(default_factory=list)      # [lane] -> list of arrays
    valid: list = field(default_factory=list)      # [lane] -> list of bool
    num_it: list = field(default_factory=list)     # [lane] -> list of int
    warm: int = 0                  # stream frames a lane ran in set-up
    window_frames: int = 0         # frames completed in the window, all lanes
    window_s: float = 0.0
    latency_ms: list = field(default_factory=list)  # per window frame
    engine_host_s: float = 0.0     # host seconds inside Engine.process_frame
    engine_calls: int = 0
    host_reads: int = 0            # robust_gn.HOST_READS over the window
    lane_step_s: float = 0.0       # device seconds of process_chunk (events)
    lane_steps: int = 0
    trace: object = None           # trace.Trace of the traced slice
    trace_frames: int = 0          # frames in the traced slice, all lanes

    def __post_init__(self):
        for f in ("poses", "valid", "num_it"):
            setattr(self, f, [[] for _ in range(self.lanes)])


def program_inputs(cfg: dict, ini_path: str, device):
    """(RSOConfig, StereoCamera, rectify maps or None) of a configuration,
    made with the program's own loader and rectification."""
    from rso_torch.config import load_config
    from rso_torch.geometry.stereo_camera import StereoCamera
    from rso_torch.io.calib import FullCalibration, compute_rectify_maps

    rso_cfg = load_config(ini_path)
    cam = cfg["camera"]
    if "K_l" not in cam:
        return rso_cfg, StereoCamera.make(
            fx_l=cam["fx"], fy_l=cam["fy"], cx_l=cam["cx"], cy_l=cam["cy"],
            baseline=cam["baseline_m"]), None
    calib = FullCalibration(
        K_l=np.asarray(cam["K_l"], float), K_r=np.asarray(cam["K_r"], float),
        dist_l=np.asarray(cam["dist_l"], float),
        dist_r=np.asarray(cam["dist_r"], float),
        R_lr=np.asarray(cam["R_lr"], float), t_lr=np.asarray(cam["t_lr"], float),
        size=(cam["height"], cam["width"]))
    rcam, maps_l, maps_r = compute_rectify_maps(calib)
    return rso_cfg, rcam, (maps_l, maps_r)


def lane_seeds(traffic: dict, seed: int) -> list:
    """Each lane's seed: the run's for one lane, seed * 100 + lane for
    more."""
    lanes = int(traffic.get("lanes", 1))
    return [seed] if lanes == 1 else [seed * 100 + b for b in range(lanes)]


def render_laps(cfg: dict, seeds: list, extra: int, device) -> tuple:
    """Each seed's lap rendered on the device into pinned host memory
    [lanes, 2, n + extra, H, W] (the first `extra` frames repeated at the
    end, so that a chunk never wraps), and each lane's true camera-to-world
    poses [lanes, n, 4, 4]."""
    n = int(cfg["lap"]["frames"])
    H, W = cfg["camera"]["height"], cfg["camera"]["width"]
    pin = torch.device(device).type == "cuda"
    buf = torch.empty((len(seeds), 2, n + extra, H, W), dtype=torch.uint8,
                      pin_memory=pin)
    lap = torch.empty((n, 2, H, W), dtype=torch.uint8, device=device)
    poses = []
    for b, s in enumerate(seeds):
        poses.append(gen.make_lap(cfg, s, device, lap))
        buf[b, :, :n].copy_(lap.transpose(0, 1))
        buf[b, :, n:].copy_(buf[b, :, :extra])
    del lap
    return buf, np.stack(poses)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Fault:
    """A broken timed path, for the harness's own tests: "stale" keeps the
    program's state from advancing (each step returns the state it was
    given), "half" leaves half of the lanes out, "alter" shifts each pose
    where it is produced (1 mrad more yaw), "lost" calls every second frame
    not valid."""

    def __init__(self, kind: str | None):
        self.kind = kind
        self.n = 0

    def engine(self, eng):
        if self.kind == "stale":
            step = eng.process_frame

            def stale(left, right):
                before = eng.state
                res = step(left, right)
                if before is not None:
                    eng.state = before
                return res
            eng.process_frame = stale

    def batch(self, eng):
        if self.kind == "stale":
            step = eng._step

            def stale(states, lefts, rights):
                # each frame's step given the chunk's first state again
                out = [step(states, l, r)[1] for l, r in zip(lefts, rights)]
                return states, type(out[0])(*(torch.stack(f) for f in zip(*out)))
            step.chunk = stale

    def pose6(self, p: np.ndarray) -> np.ndarray:
        if self.kind == "alter":
            p = p.copy()
            p[..., 1] += 1e-3
        return p

    def valid(self, v: bool) -> bool:
        self.n += 1
        return v and not (self.kind == "lost" and self.n % 2 == 0)

    def lanes(self, poses: np.ndarray) -> np.ndarray:
        """Results [frames, lanes, 6]: with "half", the rows of the second
        half of the lanes are never written (they read as zeros)."""
        if self.kind == "half":
            poses[:, poses.shape[1] // 2:] = 0.0
        return poses


class Driver:
    """One traffic entry over the rendered laps."""

    def __init__(self, traffic: dict, cfg: dict, ini_path: str, laps,
                 device, fault: Fault):
        self.t = traffic
        self.cfg = cfg
        self.laps = laps
        self.n = int(cfg["lap"]["frames"])
        self.device = torch.device(device)
        self.fault = fault
        self.lanes = laps.shape[0]
        self.rec = Record(lanes=self.lanes)
        self.k = 0                                     # next stream frame
        rso_cfg, cam, maps = program_inputs(cfg, ini_path, device)
        entry = traffic["entry"]
        self.unit = {"engine": self._engine_frame, "batch": self._chunk}[entry]
        if entry == "engine":
            from rso_torch.engine import Engine
            self.eng = Engine(rso_cfg, cam, rectify_maps=maps, device=device)
            fault.engine(self.eng)
        elif entry == "batch":
            from rso_torch.parallel import BatchEngine
            H, W = cfg["camera"]["height"], cfg["camera"]["width"]
            self.eng = BatchEngine(rso_cfg, cam, self.lanes, H, W,
                                   rectify_maps=maps, device=device)
            fault.batch(self.eng)
            c = int(traffic["chunk"])
            self.stage = [torch.empty((self.lanes, c, H, W), dtype=torch.uint8,
                                      device=device) for _ in range(2)]
        if self.device.type == "cuda":
            self.host6 = torch.empty(6, dtype=torch.float32, pin_memory=True)
            self.hostv = torch.empty((), dtype=torch.bool, pin_memory=True)

    # ---- one stream through Engine ----------------------------------------
    def _engine_frame(self, timed: bool):
        i = self.k % self.n
        left, right = self.laps[0, 0, i], self.laps[0, 1, i]
        t0 = time.perf_counter()
        with span("process_frame"):
            res = self.eng.process_frame(left, right)
        t1 = time.perf_counter()
        with span("read_pose"):
            pose, valid = self._read(res.pose, res.valid)
        t2 = time.perf_counter()
        self._keep(0, self.fault.pose6(pose), valid, res.num_it)
        if timed:
            self.rec.latency_ms.append((t2 - t0) * 1e3)
            self.rec.engine_host_s += t1 - t0
            self.rec.engine_calls += 1
        self.k += 1
        return 1

    def _read(self, pose, valid):
        if self.device.type != "cuda":
            return pose.numpy().astype(np.float64), bool(valid)
        self.host6.copy_(pose, non_blocking=True)
        self.hostv.copy_(valid, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.host6.numpy().astype(np.float64), bool(self.hostv)

    def _keep(self, lane, pose, valid, num_it):
        self.rec.poses[lane].append(pose)
        self.rec.valid[lane].append(self.fault.valid(valid))
        self.rec.num_it[lane].append(num_it)       # read after the window

    # ---- lanes through BatchEngine -----------------------------------------
    def _chunk(self, timed: bool):
        c = int(self.t["chunk"])
        s = self.k % self.n
        with span("copy_in"):
            for eye in range(2):
                for b in range(self.lanes):
                    self.stage[eye][b].copy_(self.laps[b, eye, s:s + c],
                                             non_blocking=True)
        cuda = self.device.type == "cuda"
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with span("process_chunk"):
            res = self.eng.process_chunk(self.stage[0], self.stage[1])
        if cuda:
            e1.record()
        with span("read_results"):
            poses = res.pose.double().cpu().numpy()          # [c, B, 6]
            valid = res.valid.cpu().numpy().copy()           # [c, B]
        poses = self.fault.lanes(poses)
        for f in range(c):
            for b in range(self.lanes):
                self._keep(b, self.fault.pose6(poses[f, b]), bool(valid[f, b]),
                           res.num_it[f, b])
        if timed and cuda:
            self.rec.lane_step_s += e0.elapsed_time(e1) * 1e-3
            self.rec.lane_steps += c
        self.k += c
        return c * self.lanes

    # ---- phases ------------------------------------------------------------
    def warm(self):
        """Set-up: the stream's first frames, which capture the graphs."""
        units = int(self.t.get("warm_frames", 0))
        if "warm_chunks" in self.t:
            units = int(self.t["warm_chunks"]) * int(self.t["chunk"])
        while self.k < units:
            self.unit(False)
        _sync(self.device)
        self.rec.warm = self.k

    def window(self, seconds: float):
        """Run whole units until `seconds` have passed; counts the frames
        they completed and their time."""
        from rso_torch.solver.robust_gn import HOST_READS

        reads0 = sum(HOST_READS.values())
        t0 = time.perf_counter()
        frames = 0
        while time.perf_counter() - t0 < seconds:
            frames += self.unit(True)
        _sync(self.device)
        self.rec.window_s = time.perf_counter() - t0
        self.rec.window_frames = frames
        self.rec.host_reads = sum(HOST_READS.values()) - reads0

    def traced(self, units: int):
        """A profiled slice of `units` more steps; returns (events, host s,
        frames)."""
        from vobench import trace

        with trace.profiled() as h:
            t0 = time.perf_counter()
            frames = 0
            for _ in range(units):
                frames += self.unit(False)
            _sync(self.device)
            dt = time.perf_counter() - t0
        self.rec.trace_frames = frames
        return h.result, dt, frames

    def finish(self):
        """Read the kept device scalars; drop the program."""
        for lane in range(self.lanes):
            self.rec.num_it[lane] = [int(x) for x in self.rec.num_it[lane]]
        for name in ("eng", "stage"):
            if hasattr(self, name):
                delattr(self, name)
        return self.rec
