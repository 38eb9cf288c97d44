"""The ranks of tests/test_torch_mesh.py: the port's mesh forms in several
processes on the CPU, through gloo.  No jax here: every rank imports only
torch, numpy and rso_torch.

    python tests/_torch_mesh_ranks.py DIR RANK WORLD

DIR holds `inputs.pkl` (written by the test: the camera, the BA problems and
the window batches as numpy arrays, with their keyword arguments) and the
FileStore the ranks meet through.  Each rank, one torch thread:
  * distributed_bundle_adjust on a WORLD-rank 'lmk' mesh, every BA case,
    with the result after 0, 1, ... n_iters iterations (runs with
    max_iters = k) and the collectives of the full run;
  * window_sharded_bundle_adjust on a (2, WORLD/2) ('win','lmk') mesh,
    every window case, the results after 0..max_iters iterations, the
    collectives;
  * for both, the mesh solve as it ran before it was a compiled solve
    (levenberg_marquardt's eager loop, then the landmark gather:
    _torch_card.eager_mesh_solves)
    and the stop flags the loop read with LM_BLOCK = 1, one an iteration;
  * BatchEngine on a 'seq' mesh of ranks 0 and 1: two sequences (seeds 0
    and 1) of SEQ_FRAMES frames at SEQ_H x SEQ_W, frame 0 through
    process_frames and the rest through process_chunk; and the reference's
    rule on the WORLD-rank 'seq' mesh for B = 2 (which sequences each rank
    holds);
then ranks 0 and 1 start a second group with initialize_multihost, take
global_landmark_mesh, and run rso-fleet over it (FLEET_ARGV).  Each rank
writes `rank<R>.pkl`.
"""
from __future__ import annotations

import contextlib
import io
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import _torch_card as card

REPO = Path(__file__).resolve().parents[1]
SEQ_FRAMES, SEQ_H, SEQ_W = 3, 160, 240
FLEET_ARGV = ["--synthetic", "2", "--frames", "3", "--chunk", "2"]


@contextlib.contextmanager
def one_rank_group():
    """A one-rank gloo group for the test process (the port's make_mesh
    starts one where none exists), destroyed afterwards if it was made
    here."""
    from rso_torch.mesh import ensure_group

    made = not dist.is_initialized()
    ensure_group("cpu")
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def spawn(out_dir: Path, world: int, timeout: float = 300.0) -> list[dict]:
    """Run WORLD ranks of this file on out_dir; every rank's results."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(out_dir), str(r), str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed ({p.returncode}):\n"
                               f"{o[-4000:]}")
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def numpy_tree(t):
    """A NamedTuple of tensors as a dict of numpy arrays."""
    return {k: v.numpy() for k, v in t._asdict().items()}


def _problem(arrays):
    from rso_torch.ba import BAProblem

    return BAProblem(*(None if a is None else torch.from_numpy(a)
                       for a in arrays))


@contextlib.contextmanager
def _flags_read(flags: list):
    """The stop flags the LM loop reads, one an iteration (LM_BLOCK 1),
    appended to `flags`."""
    import rso_torch.ba.ba as B
    import rso_torch.solver.robust_gn as G

    block, read = B.LM_BLOCK, G.read_flag

    def record(site, running):
        flags.append(read(site, running))
        return flags[-1]

    B.LM_BLOCK, G.read_flag = 1, record
    try:
        yield
    finally:
        B.LM_BLOCK, G.read_flag = block, read


def _ba(cam, spec, world):
    from rso_torch.ba import distributed_bundle_adjust, make_mesh
    from rso_torch.mesh import COLLECTIVES

    mesh = make_mesh(world, device="cpu")
    out = {}
    for case, (arrays, kw) in spec.items():
        prob = _problem(arrays)
        COLLECTIVES.clear()
        res = distributed_bundle_adjust(cam, prob, mesh, **kw)
        coll = dict(COLLECTIVES)
        trace = [numpy_tree(distributed_bundle_adjust(
            cam, prob, mesh, **dict(kw, max_iters=k)))
            for k in range(int(res.n_iters) + 1)]
        with card.eager_mesh_solves():
            eager = numpy_tree(distributed_bundle_adjust(cam, prob, mesh,
                                                         **kw))
        flags = []
        with _flags_read(flags):
            distributed_bundle_adjust(cam, prob, mesh, **kw)
        out[case] = (numpy_tree(res), trace, coll, eager, flags)
    return out


def _windows(cam, spec, world):
    from rso_torch.ba import make_win_mesh, window_sharded_bundle_adjust
    from rso_torch.mesh import COLLECTIVES

    mesh = make_win_mesh(2, world // 2, device="cpu")
    out = {}
    for case, (windows, kw) in spec.items():
        probs = [_problem(a) for a in windows]
        COLLECTIVES.clear()
        res = window_sharded_bundle_adjust(cam, probs, mesh, **kw)
        coll = dict(COLLECTIVES)
        trace = [[numpy_tree(r) for r in window_sharded_bundle_adjust(
            cam, probs, mesh, **dict(kw, max_iters=k))]
            for k in range(kw["max_iters"] + 1)]
        with card.eager_mesh_solves():
            eager = [numpy_tree(r) for r in window_sharded_bundle_adjust(
                cam, probs, mesh, **kw)]
        flags = []
        with _flags_read(flags):
            window_sharded_bundle_adjust(cam, probs, mesh, **kw)
        out[case] = ([numpy_tree(r) for r in res], trace, coll, eager, flags)
    return out


def sequences():
    from rso_torch.synthetic import make_sequence

    return [make_sequence(n_frames=SEQ_FRAMES, n_points=600, H=SEQ_H,
                          W=SEQ_W, seed=s) for s in (0, 1)]


def _seq(rank, world):
    from rso_torch.mesh import make_device_mesh
    from rso_torch.parallel import BatchEngine
    from rso_torch.synthetic import synthetic_config

    seqs, cfg = sequences(), synthetic_config()
    lefts = np.stack([[f[0] for f in s.frames] for s in seqs])  # [B,N,H,W]
    rights = np.stack([[f[1] for f in s.frames] for s in seqs])
    kw = dict(batch=2, img_h=SEQ_H, img_w=SEQ_W, device="cpu")
    out = {}
    mesh = make_device_mesh((2,), ("seq",), "cpu", ranks=[0, 1])
    if rank < 2:
        be = BatchEngine(cfg, seqs[0].cam, mesh=mesh, **kw)
        first = be.process_frames(lefts[:, 0], rights[:, 0])
        chunk = be.process_chunk(lefts[:, 1:], rights[:, 1:])
        out["sequences"] = list(be.sequences)
        out["mesh_devices"] = be.mesh_devices
        out["frames"] = [numpy_tree(first)] + [
            numpy_tree(type(chunk)(*(t[n] for t in chunk)))
            for n in range(SEQ_FRAMES - 1)]
        out["gather"] = be.gather(rank)
    # B = 2 over the whole world: the reference's rule when it does not
    # divide (world 4) is one rank with both
    be = BatchEngine(cfg, seqs[0].cam,
                     mesh=make_device_mesh((world,), ("seq",), "cpu"), **kw)
    out["world"] = (list(be.sequences), be.mesh_devices)
    return out


def _multihost(out_dir, rank):
    from rso_torch.ba.multihost import global_landmark_mesh, initialize_multihost
    from rso_torch.cli import fleet

    started = initialize_multihost(f"file://{out_dir}/store2", 2, rank,
                                   backend="gloo")
    mesh = global_landmark_mesh()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet.main(FLEET_ARGV + ["--out-dir", str(out_dir / "fleet")],
                        device="cpu")
    dist.destroy_process_group()
    return {"started": started, "size": mesh.size(),
            "axes": mesh.mesh_dim_names, "fleet_rc": rc,
            "fleet_stdout": buf.getvalue()}


def main(out_dir: Path, rank: int, world: int) -> None:
    from rso_torch.geometry import StereoCamera

    torch.set_num_threads(1)
    spec = pickle.loads((out_dir / "inputs.pkl").read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank)
    cam = StereoCamera.make(**spec["cam"])
    out = {"ba": _ba(cam, spec["ba"], world),
           "win": _windows(cam, spec["win"], world),
           "seq": _seq(rank, world)}
    dist.destroy_process_group()
    if rank < 2:
        out["multihost"] = _multihost(out_dir, rank)
    (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
