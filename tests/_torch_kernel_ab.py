"""Device time of two designs of all six kernels, on one card in one run.

    python3 tests/_torch_kernel_ab.py (--parent REV | --parent-src DIR)
                                      [--out FILE]

Builds an earlier design of the four `csrc/*.cu` sources (SOURCES) into a
scratch library under the git-ignored `build/rso_torch_ab/`: from
`git show REV:rso_torch/csrc/<file>`, or from the four files in DIR where
there is no git checkout.  Then, on the bench scene's inputs as
chip_smoke.py's phase 3 makes them:

  * kernel 2 (`stereo_sad_fused`) at K = 512/256/128, with the engine's
    mask (|dy| <= 1, 1 <= disparity <= 0.7 W) and with the open mask (1e4:
    every valid pair with a disparity >= 1 admitted);
  * kernel 3 (`track_sad_fused`) at K = 512/256/128, with the engine's
    window (40 px) and with the open window (1e4: every pair admitted);
  * kernel 1 (`corner_response`) at the three octaves of 1241x376;
  * kernel 6 (`sad_matrix`) at K = 512/256/128 on the bench patches of
    frames 0 and 1;
  * kernel 5 (`hamming_matrix`) at K = 512/256/128 on the bench FAST_ORB
    descriptors of frames 0 and 1;
  * kernel 4 (`nullvec9`) at B = 512 (RANSAC's 2 eyes x 256 hypotheses) and
    B = 2 (the refit), random rank-8 matrices as chip_smoke.py makes them;
  * two floors, in the same turns: `fill 1` (torch.zeros(1)'s kernel, the
    least a launch takes) and `fill KxK` (zero_() of a [K,K] f32 tensor,
    the least a kernel that writes kernel 5's output takes).

It checks each design bit for bit against the twin, kernel 4's against the
earlier design (its twin is another algorithm), also at B = 1, 31, 32, 33
and 129, on rank-4 and all-zero matrices and on matrices scaled by 1e-30 to
1e30 (quotients outside the division's fast range); then times it: the
median of the kernel's own duration over 50 launches (torch.profiler's CUDA
activity, all in one session: _torch_card.device_times) and the median call
time (CUDA events around the wrapper).  The designs run in turns, earlier,
new, new, earlier in each of ROUNDS rounds.  Both designs go through the same Python
wrappers: the wrappers' library handle is swapped for the earlier library.

Needs a CUDA device and imports neither jax nor rso.  Prints one line per
measurement and the card's name and power limit; writes the JSON to --out.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("stereo_fused.cu", "fast_detect.cu", "distance.cu", "smallchol.cu")
ENTRIES = ("rso_stereo_sad_fused", "rso_track_sad_fused", "rso_corner_response",
           "rso_sad_matrix", "rso_hamming_matrix", "rso_nullvec9")
DESIGNS = ("earlier", "new")
ROUNDS = 2


def _compile(srcs, out: Path) -> Path:
    """nvcc the sources (the package's flags) into one shared library."""
    from rso_torch.kernels import _lib

    out.parent.mkdir(parents=True, exist_ok=True)
    objs = []
    for src in srcs:
        obj = out.with_name(f"{Path(src).stem}.o")
        cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _lib._check(cmd, proc.returncode, proc.stdout, proc.stderr)
        objs.append(str(obj))
    cmd = [_lib._nvcc(), "-shared", "-o", str(out), *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _lib._check(cmd, proc.returncode, proc.stdout, proc.stderr)
    return out


def _load(path: Path) -> ctypes.CDLL:
    from rso_torch.kernels import _lib

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def earlier_sources(rev: str | None, src_dir: str | None) -> list[Path]:
    """The earlier design's sources, copied under build/rso_torch_ab/."""
    texts = {}
    for name in SOURCES:
        if src_dir:
            texts[name] = (Path(src_dir) / name).read_text()
        else:
            texts[name] = subprocess.run(
                ["git", "show", f"{rev}:rso_torch/csrc/{name}"], cwd=REPO,
                capture_output=True, text=True, check=True).stdout
    key = hashlib.sha256("".join(texts[n] for n in SOURCES).encode())
    out = REPO / "build" / "rso_torch_ab" / key.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    for name, text in texts.items():
        (out / name).write_text(text)
    return [out / name for name in SOURCES]


@contextlib.contextmanager
def using(lib):
    """Route the package's wrappers to another build of the kernels."""
    from rso_torch.kernels import _lib

    saved = _lib._lib
    _lib._lib = lib
    try:
        yield
    finally:
        _lib._lib = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--parent", help="git revision of the earlier design")
    src.add_argument("--parent-src", help="directory holding the earlier "
                     "design's " + ", ".join(SOURCES))
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import _torch_card as card
    from rso_torch import kernels as K
    from rso_torch.kernels import _lib

    smi = card.nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    srcs = earlier_sources(None if args.parent_src else args.parent,
                           args.parent_src)
    designs = {"earlier": _load(_compile(srcs, srcs[0].parent / "libearlier.so")),
               "new": _lib.load()}

    dev = torch.device("cuda")
    bi = card.BenchInputs(card.bench_scene(card.N_FRAMES), dev)
    dense_kw = dict(bi.track_kw, win_row=1e4, win_col=1e4)
    cases = []   # (kernel, label, call, twin: None to hold new to earlier)
    for o in range(3):
        a, kw = bi.stereo_args(o), bi.stereo_kw(o)
        open_kw = dict(kw, max_y_diff=1e4, max_disp=1e4)
        for label, k in (("engine mask", kw), ("mask 1e4", open_kw)):
            cases.append(("stereo_sad_kernel", f"K={bi.Ks[o]} {label}",
                          lambda a=a, k=k: K.stereo_sad_fused_cuda(*a, **k),
                          lambda a=a, k=k: K.stereo_sad_fused_torch(*a, **k)))
    for o in range(3):
        a = bi.track_args(o)
        for label, kw in (("window 40", bi.track_kw), ("window 1e4", dense_kw)):
            cases.append(("track_sad_kernel", f"K={bi.Ks[o]} {label}",
                          lambda a=a, kw=kw: K.track_sad_fused_cuda(*a, **kw),
                          lambda a=a, kw=kw: K.track_sad_fused_torch(*a, **kw)))
    for img in bi.pyr:
        cases.append(("corner_response_kernel", "x".join(map(str, img.shape)),
                      lambda img=img: K.corner_response_cuda(img, bi.th),
                      lambda img=img: K.corner_response_torch(img, bi.th)))
    for o in range(3):
        a, b = bi.frames[0][o][0].patch, bi.frames[1][o][0].patch
        cases.append(("sad_kernel", f"K={bi.Ks[o]}",
                      lambda a=a, b=b: K.sad_matrix_cuda(a, b),
                      lambda a=a, b=b: K.sad_matrix_torch(a, b)))
    for o in range(3):
        a, b = bi.descs[0][o].desc, bi.descs[1][o].desc
        cases.append(("hamming_kernel", f"K={bi.Ks[o]}",
                      lambda a=a, b=b: K.hamming_matrix_cuda(a, b),
                      lambda a=a, b=b: K.hamming_matrix_torch(a, b)))
    rng = np.random.default_rng(0)
    for B in (512, 2):
        M = card.rank8_matrices(rng, B, dev)
        cases.append(("nullvec9_kernel", f"B={B}",
                      lambda M=M: K.nullvec9_cuda(M), None))
    # the floors: design-free, timed in the same turns
    one = torch.zeros(1, device=dev)
    cases.append((card.FILL_KERNEL, "fill 1", one.zero_, None))
    for k in bi.Ks:
        out = torch.empty((k, k), device=dev)
        cases.append((card.FILL_KERNEL, f"fill {k}x{k}", out.zero_, None))
    # kernel 4 bit for bit against the earlier design, untimed
    checked = [card.rank8_matrices(rng, B, dev) for B in (1, 31, 32, 33, 129)]
    A = torch.tensor(rng.normal(0, 1, (16, 4, 9)), dtype=torch.float32,
                     device=dev)
    checked += [(A.transpose(1, 2) @ A).contiguous(),
                torch.zeros((4, 9, 9), device=dev)]
    # quotients outside the division's fast range, and at its edges
    checked += [card.rank8_matrices(rng, 64, dev) * s
                for s in (1e-30, 1e-20, 1e-12, 1e12, 1e20, 1e30)]
    for M in checked:
        new = K.nullvec9_cuda(M)
        with using(designs["earlier"]):
            if not torch.equal(K.nullvec9_cuda(M), new):
                raise AssertionError(f"nullvec9 B={M.shape[0]}: new != earlier")
    print(f"nullvec9: new == earlier at B = {[M.shape[0] for M in checked]} "
          "(B = 16 rank 4, B = 4 zero, B = 64 scaled by 1e-30 .. 1e30)",
          flush=True)

    def through(lib, call):
        def run():
            with using(lib):
                return call()
        return run

    # every check first, then the call times, then every device time in one
    # profiler session (_torch_card.device_times), all in the same turns; the
    # profiler goes last, as the process runs slower after it
    runs = []   # (case index, design, kernel, fn)
    for c, (kernel, label, call, twin) in enumerate(cases):
        ref = twin() if twin else through(designs["earlier"], call)()
        for name in DESIGNS:
            card.same_bits(f"{name} {kernel} {label} against the "
                           f"{'twin' if twin else 'earlier'}",
                           through(designs[name], call)(), ref)
        # in turns: earlier, new, new, earlier
        runs += [(c, name, kernel, through(designs[name], call))
                 for _ in range(ROUNDS) for name in DESIGNS + DESIGNS[::-1]]
    ms = [card.median_ms(fn) for _, _, _, fn in runs]
    us = card.device_times([(kernel, fn) for _, _, kernel, fn in runs])

    results = []
    for c, (kernel, label, _, _) in enumerate(cases):
        mine = [(name, u, m) for (ci, name, _, _), u, m in zip(runs, us, ms)
                if ci == c]
        dev_us = {n: [u for name, u, _ in mine if name == n] for n in DESIGNS}
        call_ms = {n: [m for name, _, m in mine if name == n] for n in DESIGNS}
        row = dict(kernel=kernel, shape=label, device_us=dev_us, call_ms=call_ms,
                   median_device_us={n: statistics.median(v) for n, v in dev_us.items()},
                   median_call_ms={n: statistics.median(v) for n, v in call_ms.items()})
        results.append(row)
        print(f"{kernel} {label}: device us " + ", ".join(
            f"{n} {row['median_device_us'][n]:.3f} {dev_us[n]}" for n in DESIGNS)
            + "; call ms " + ", ".join(
            f"{n} {row['median_call_ms'][n]:.4f}" for n in DESIGNS), flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=torch.cuda.get_device_name(0),
                                   nvidia_smi=smi, results=results), indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
