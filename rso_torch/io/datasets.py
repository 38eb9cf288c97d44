"""Dataset loaders: KITTI odometry, EuRoC MAV, Malaga Urban, image directories.

A copy of rso/io/datasets.py, which cannot be imported here because
importing any `rso` module loads jax; the cameras are this package's
StereoCamera (on the CPU) and the rectify maps stay numpy (Engine puts them
on its device once).  It covers the reference demo's three image sources
(demo-main.cpp:110-146: live camera / rawlog / image dir) plus the benchmark
datasets named in BASELINE.json.  All loaders yield (left u8 [H,W],
right u8 [H,W], timestamp) and expose a StereoCamera.  Decode is host-side
through cv2, else PIL, else the native loader (native/build.sh), chosen at
each decode so that importing this module needs none of them; a
background prefetch thread overlaps decode with device compute.  A decode
error in the prefetch thread is raised where the frame is consumed.
"""
from __future__ import annotations

import os
import glob as globmod
import queue
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np

from rso_torch.geometry.stereo_camera import StereoCamera
from rso_torch.io.calib import load_kitti_calib

def _imread_gray(path):
    """8-bit grayscale [H,W] of an image file, decoded by the first of cv2,
    PIL and the native loader that this host has."""
    try:
        import cv2
    except ImportError:
        pass
    else:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        return np.asarray(Image.open(path).convert("L"))
    from rso_torch.io import native_loader

    if not native_loader.available():
        raise RuntimeError(
            "no image decoder: needs cv2 (opencv-python), PIL (Pillow) or "
            "the native loader native/librso_loader.so (native/build.sh, "
            "which needs the libpng and libjpeg headers)")
    return native_loader.decode_gray(path)


class _Failed(NamedTuple):
    error: BaseException


class StereoFrame(NamedTuple):
    left: np.ndarray
    right: np.ndarray
    timestamp: float
    index: int


class StereoDataset:
    """Base: a calibrated list of stereo frame paths."""

    def __init__(self, left_paths, right_paths, timestamps, cam: StereoCamera,
                 gt_poses: np.ndarray | None = None, rectify_maps=None):
        assert len(left_paths) == len(right_paths)
        self.left_paths = left_paths
        self.right_paths = right_paths
        self.timestamps = timestamps
        self.cam = cam
        self.gt_poses = gt_poses  # [N,4,4] camera-to-world, if available
        # ((map_lx,map_ly),(map_rx,map_ry)) for unrectified rigs (EuRoC);
        # None when images are already rectified (KITTI, Malaga).  Callers
        # must pass this to Engine(rectify_maps=...) — the reference applies
        # its cached CStereoRectifyMap per frame (stage1_rectify.cpp:66-73).
        self.rectify_maps = rectify_maps

    def __len__(self):
        return len(self.left_paths)

    def __getitem__(self, i) -> StereoFrame:
        return StereoFrame(
            left=_imread_gray(self.left_paths[i]),
            right=_imread_gray(self.right_paths[i]),
            timestamp=float(self.timestamps[i]),
            index=i,
        )

    def __iter__(self) -> Iterator[StereoFrame]:
        for i in range(len(self)):
            yield self[i]

    def prefetch(self, depth: int = 4,
                 native: bool | None = None) -> Iterator[StereoFrame]:
        """Background-decode iterator: the host half of the double-buffered
        pipeline (SURVEY section 2.5 PP row).

        native=True forces the C++ prefetch ring (native/rso_loader.cpp,
        the equivalent of the reference's MRPT acquisition layer),
        native=False the Python thread and its decode, None auto-selects.
        """
        if native is not False:
            try:
                from rso_torch.io import native_loader

                if native_loader.available():
                    ring = native_loader.NativePrefetcher(
                        self.left_paths, self.right_paths, depth=depth)
                    return (StereoFrame(left, right,
                                        float(self.timestamps[i]), i)
                            for left, right, i in ring)
            except (OSError, RuntimeError):
                if native:  # explicitly requested: surface the failure
                    raise
        return self._prefetch_python(depth)

    def _prefetch_python(self, depth: int = 4) -> Iterator[StereoFrame]:
        q: queue.Queue = queue.Queue(maxsize=depth)
        SENTINEL = object()

        def worker():
            try:
                for i in range(len(self)):
                    q.put(self[i])
            except Exception as e:       # raised in the consumer's thread
                q.put(_Failed(e))
            finally:
                q.put(SENTINEL)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, _Failed):
                raise item.error
            yield item


def load_kitti(seq_dir: str, calib_file: str | None = None,
               poses_file: str | None = None) -> StereoDataset:
    """KITTI odometry sequence directory (image_0/image_1 + calib.txt [+ poses])."""
    lp = sorted(globmod.glob(os.path.join(seq_dir, "image_0", "*.png")))
    rp = sorted(globmod.glob(os.path.join(seq_dir, "image_1", "*.png")))
    calib = calib_file or os.path.join(seq_dir, "calib.txt")
    cam = load_kitti_calib(calib)
    times_file = os.path.join(seq_dir, "times.txt")
    if os.path.exists(times_file):
        ts = np.loadtxt(times_file)
    else:
        ts = np.arange(len(lp)) * 0.1
    gt = None
    if poses_file and os.path.exists(poses_file):
        raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
        gt = np.tile(np.eye(4), (raw.shape[0], 1, 1))
        gt[:, :3, :] = raw
    return StereoDataset(lp, rp, ts, cam, gt)


def load_euroc(seq_dir: str) -> StereoDataset:
    """EuRoC MAV directory (mav0/cam0, mav0/cam1). Images are unrectified:
    the returned dataset carries the rectified StereoCamera *and* the
    per-eye remap grids in .rectify_maps, which must reach
    Engine(rectify_maps=...) so stage 1 undistorts on device (reference
    stage1_rectify.cpp:66-73)."""
    c0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    c1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    lp = sorted(globmod.glob(os.path.join(c0, "*.png")))
    rp = sorted(globmod.glob(os.path.join(c1, "*.png")))
    n = min(len(lp), len(rp))
    lp, rp = lp[:n], rp[:n]
    ts = np.array([float(os.path.splitext(os.path.basename(p))[0]) * 1e-9
                   for p in lp])
    from rso_torch.io.calib import compute_rectify_maps, load_euroc_calib

    calib = load_euroc_calib(
        os.path.join(seq_dir, "mav0", "cam0", "sensor.yaml"),
        os.path.join(seq_dir, "mav0", "cam1", "sensor.yaml"))
    cam, map_l, map_r = compute_rectify_maps(calib)
    return StereoDataset(lp, rp, ts, cam, rectify_maps=(map_l, map_r))


def load_malaga(seq_dir: str, cam: StereoCamera | None = None) -> StereoDataset:
    """Malaga Urban dataset extract (BASELINE.json config #4).

    Accepts either the extract root (`malaga-urban-dataset-extract-XX/`,
    whose stereo frames live under `Images/`) or the images directory
    itself.  Frames are named
    `img_CAMERA1_<unix_ts.decimals>_left.jpg` / `..._right.jpg`; pairing is
    by filename STEM (the shared prefix before `_left`/`_right`), not list
    position, so a single missing eye skips that frame instead of shifting
    every later pair off by one.  Timestamps come from the filename when it
    carries one (the dataset's 20 Hz capture clock), else a synthetic 20 Hz
    ramp.  Images are already rectified (the extracts ship the rectified
    stereo stream), so no rectify_maps.
    """
    img_dir = seq_dir
    sub = os.path.join(seq_dir, "Images")
    if os.path.isdir(sub):
        img_dir = sub

    def _pairs(ext):
        lp = {_strip_eye(p, "left"): p
              for p in globmod.glob(os.path.join(img_dir, f"*left*{ext}"))}
        rp = {_strip_eye(p, "right"): p
              for p in globmod.glob(os.path.join(img_dir, f"*right*{ext}"))}
        stems = sorted(set(lp) & set(rp))
        return [lp[s] for s in stems], [rp[s] for s in stems], stems

    lps, rps, stems = _pairs(".jpg")
    if not lps:  # some extracts are re-encoded as png
        lps, rps, stems = _pairs(".png")
    ts = []
    for i, s in enumerate(stems):
        # img_CAMERA1_1261228749.918590 -> 1261228749.918590
        tail = s.rsplit("_", 1)[-1]
        try:
            ts.append(float(tail))
        except ValueError:
            ts.append(i * 0.05)
    t0 = ts[0] if ts else 0.0
    ts = np.asarray([t - t0 for t in ts])
    if cam is None:  # published Malaga stereo parameters (1024x768 rig)
        cam = StereoCamera.make(fx_l=795.11588, fy_l=795.11588,
                                cx_l=517.12973, cy_l=395.59665,
                                baseline=0.1194)
    return StereoDataset(lps, rps, ts, cam)


def _strip_eye(path: str, eye: str) -> str:
    """Filename stem shared by both eyes: basename minus extension and the
    trailing `_left`/`_right` (or `left`/`right`) marker."""
    base = os.path.splitext(os.path.basename(path))[0]
    for marker in (f"_{eye}", eye):
        idx = base.rfind(marker)
        if idx >= 0:
            return base[:idx] + base[idx + len(marker):]
    return base


def load_image_dir(dir_path: str, cam: StereoCamera,
                   left_glob: str = "left_*.png",
                   right_glob: str = "right_*.png") -> StereoDataset:
    """Generic image-directory source (the reference's --img_dir mode,
    demo-main.cpp:122-146)."""
    lp = sorted(globmod.glob(os.path.join(dir_path, left_glob)))
    rp = sorted(globmod.glob(os.path.join(dir_path, right_glob)))
    n = min(len(lp), len(rp))
    return StereoDataset(lp[:n], rp[:n], np.arange(n) * 0.1, cam)


def watch_image_dir(dir_path: str,
                    left_glob: str = "left_*.png",
                    right_glob: str = "right_*.png",
                    poll_s: float = 0.2,
                    idle_timeout_s: float = 10.0,
                    _time=time):
    """Live streaming source: yield stereo pairs AS THEY APPEAR in a
    directory — the headless substitute for the reference's live camera
    input (demo-main.cpp:210-239 pulls CObservationStereoImages from an
    MRPT camera/rawlog stream until the stream ends; here the camera
    driver is whatever process drops `left_NNN.png`/`right_NNN.png` files).

    Pairs are matched by filename STEM (`left_0007.png` <-> `right_0007.png`),
    not list position, so one permanently missing file on either side skips
    that single frame instead of shifting every later pair off by one.  A
    file that appears but is still being written would decode short — each
    image is read only after its size is stable across one poll interval —
    and every already-stable pair drains in ONE poll pass (a backlog, or a
    writer faster than 1/poll_s, does not queue up behind a
    one-frame-per-poll cap).  Frames are yielded in sorted-stem order
    (zero-padded names, like the reference's image dirs); a straggler pair
    completing after a later stem was served is dropped with a warning
    rather than emitted out of order.  The generator ends after
    `idle_timeout_s` with no new complete pair (stream over).
    """
    import sys

    def _stem(path: str) -> str:
        base = os.path.splitext(os.path.basename(path))[0]
        return base.split("_", 1)[1] if "_" in base else base

    idx = 0
    last_served: str | None = None
    sizes: dict = {}
    warned: set = set()   # out-of-order stems already reported
    last_new = _time.monotonic()
    while True:
        lp = {_stem(p): p for p in
              globmod.glob(os.path.join(dir_path, left_glob))}
        rp = {_stem(p): p for p in
              globmod.glob(os.path.join(dir_path, right_glob))}
        progressed = False
        for k in sorted(set(lp) & set(rp)):
            if last_served is not None and k <= last_served:
                # warn on EVERY dropped late pair, including one that first
                # appears fully formed after a later stem was served (e.g. a
                # file copied in late, never sighted in `sizes`) — a pair
                # must never vanish without a trace
                if k in sizes or k not in warned:
                    print(f"[rso] watch: dropping out-of-order pair {k!r}",
                          file=sys.stderr)
                    warned.add(k)
                    sizes.pop(k, None)
                continue
            try:
                sz = (os.path.getsize(lp[k]), os.path.getsize(rp[k]))
            except OSError:
                continue  # racing the writer; retry next poll
            if sizes.get(k) != sz:
                sizes[k] = sz  # first sighting or still growing:
                continue       # require one stable-size poll
            yield StereoFrame(_imread_gray(lp[k]), _imread_gray(rp[k]),
                              timestamp=idx * 0.1, index=idx)
            sizes.pop(k, None)
            last_served = k
            idx += 1
            progressed = True
        if progressed:
            last_new = _time.monotonic()
        elif _time.monotonic() - last_new > idle_timeout_s:
            return
        _time.sleep(poll_s)
