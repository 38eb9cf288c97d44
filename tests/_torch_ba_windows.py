"""The window solves of VOWithBA on the bench scene: the card, the port on
the CPU and the reference, on the same problems.

On the GPU host (no jax needed):

    python3 tests/_torch_ba_windows.py dump

runs VOWithBA at its defaults over chip_smoke.py's 30 bench frames on the
card and writes every window solve's inputs and the card's result to
chiprun_out/ba_windows.npz.  Then, on a host with jax:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_ba_windows.py \\
        compare chiprun_out/ba_windows.npz

solves each window again with rso.ba.bundle_adjust (JAX on the CPU) and
rso_torch.ba.bundle_adjust on the CPU, and prints per window the largest
pose (rad, m) and landmark (m) differences of reference vs CPU, reference
vs card and CPU vs card, the three costs and iteration counts.  These
bound chip_smoke.py's BA_WINDOW_* tolerances.
"""
import os
import sys

import numpy as np

FIELDS = ("poses", "lmks", "obs", "mask", "lmk_weight")


def dump(path="chiprun_out/ba_windows.npz"):
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import _torch_card as card
    import rso_torch.ba.pipeline as pipeline
    from rso_torch.ba import VOWithBA
    from rso_torch.synthetic import synthetic_config

    seq = card.bench_scene(card.N_FRAMES)
    dev = torch.device("cuda")
    vo = VOWithBA(synthetic_config(), seq.cam)
    with card.CallRecorder(pipeline, "bundle_adjust") as rec:
        for left, right in seq.frames:
            vo.process_frame(torch.from_numpy(left).to(dev),
                             torch.from_numpy(right).to(dev))
    out = {"n": np.array(len(rec.calls)),
           "cam": torch.stack(list(seq.cam)).numpy()}
    for i, ((_cam, prob), kw, res) in enumerate(rec.calls):
        if kw.get("marg_prior") is not None:
            raise ValueError("the default pipeline has no marginalization")
        for name in FIELDS:
            out[f"{i}_{name}"] = getattr(prob, name).cpu().numpy()
        out[f"{i}_rel_meas"] = np.asarray(kw["rel_meas"])
        for name in ("poses", "lmks", "cost", "n_iters"):
            out[f"{i}_card_{name}"] = getattr(res, name).cpu().numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    print(f"{len(rec.calls)} window solves written to {path}")


def compare(path):
    import jax.numpy as jnp
    import torch

    import rso.ba.ba as J
    import rso_torch.ba.ba as T
    from rso.geometry.stereo_camera import StereoCamera as JCamera
    from rso_torch.geometry import StereoCamera

    torch.set_num_threads(1)
    d = np.load(path)
    jcam = JCamera(*(jnp.asarray(np.float32(v)) for v in d["cam"]))
    tcam = StereoCamera(*(torch.tensor(np.float32(v)) for v in d["cam"]))
    kw = dict(max_iters=15, rel_w_rot=4e2, rel_w_trans=25.0)
    for i in range(int(d["n"])):
        f = {k: d[f"{i}_{k}"] for k in FIELDS + ("rel_meas",)}
        ref = J.bundle_adjust(jcam, J.BAProblem(*(jnp.asarray(f[k])
                                                  for k in FIELDS)),
                              rel_meas=jnp.asarray(f["rel_meas"]), **kw)
        cpu = T.bundle_adjust(tcam, T.BAProblem(*(torch.from_numpy(f[k])
                                                  for k in FIELDS)),
                              rel_meas=f["rel_meas"], **kw)
        sols = {"reference": (np.asarray(ref.poses), np.asarray(ref.lmks)),
                "cpu": (cpu.poses.numpy(), cpu.lmks.numpy()),
                "card": (d[f"{i}_card_poses"], d[f"{i}_card_lmks"])}
        used = f["mask"].any(0)

        def diff(a, b):
            (pa, la), (pb, lb) = sols[a], sols[b]
            return (float(np.abs(pa - pb).max()),
                    float(np.abs(la - lb)[used].max()))

        print(f"window {i}: P={f['poses'].shape[0]}, {int(used.sum())} "
              f"landmarks; poses/landmarks reference-cpu {diff('reference', 'cpu')}, "
              f"reference-card {diff('reference', 'card')}, cpu-card "
              f"{diff('cpu', 'card')}; cost {float(ref.cost)} / "
              f"{float(cpu.cost)} / {float(d[f'{i}_card_cost'])}; "
              f"iterations {int(ref.n_iters)} / {int(cpu.n_iters)} / "
              f"{int(d[f'{i}_card_n_iters'])}")


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(*sys.argv[2:])
    else:
        compare(sys.argv[2])
