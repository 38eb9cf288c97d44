"""The entry points' parity: shared helpers, and the bounds of chip_smoke's
entry-point phase.

`run_demo` runs either package's rso-demo `main` in-process with its
stdout captured and every Engine.process_frame result recorded (each leaf
as numpy), so that a test can hold the port's run against the reference's
frame by frame.  `demo_ate` is the ATE the demo prints, from the trajectory
file it wrote.

Run as a script, it prints the reference's own CPU run of the argv that
chip_smoke.py's phase 10(a) gives the port (`--synthetic --frames N`): the
valid frames and the ATE, the bounds DEMO_REF there.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_cli.py 30
"""
import contextlib
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _to_numpy(x):
    if hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_demo(main, engine_cls, argv, **kw):
    """(return code, stdout lines, [StepResult of numpy leaves] in call
    order) of main(argv, **kw), with engine_cls.process_frame recorded."""
    inner = engine_cls.process_frame
    results = []

    def recorded(self, *a, **k):
        out = inner(self, *a, **k)
        results.append(_to_numpy(out))
        return out

    buf = io.StringIO()
    engine_cls.process_frame = recorded
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv, **kw)
    finally:
        engine_cls.process_frame = inner
    return rc, buf.getvalue().splitlines(), results


def demo_ate(traj_path, gt_poses) -> float:
    """The ATE the demo prints (its poses[0] is the identity before the
    first frame, compared with gt[0] as the demo does)."""
    from rso_torch.io.trajectory import read_kitti
    from rso_torch.metrics.ate import ate_rmse

    poses = read_kitti(traj_path)
    n = min(len(poses), len(gt_poses))
    return ate_rmse(poses[:n], gt_poses[:n])


def reference_bounds(n_frames: int, out_dir: str):
    """(valid frames, ATE) of the reference demo's `--synthetic --frames
    n_frames` on the CPU."""
    from rso.cli.demo import main
    from rso.engine import Engine
    from rso.synthetic import make_sequence

    out = os.path.join(out_dir, "reference.txt")
    rc, _, results = run_demo(main, Engine, ["--synthetic", "--frames",
                                             str(n_frames), "--out", out,
                                             "--verbosity", "0"])
    assert rc == 0
    gt = make_sequence(n_frames=n_frames, n_points=2000).poses
    return sum(bool(r.valid) for r in results), demo_ate(out, gt)


if __name__ == "__main__":
    import tempfile

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    with tempfile.TemporaryDirectory() as d:
        valid, ate = reference_bounds(n, d)
    print(f"reference rso-demo --synthetic --frames {n}: valid {valid}, "
          f"ATE {ate!r} m")
