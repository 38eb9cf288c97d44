"""Where the card and the CPU part in the engine's flat RANSAC filter.

    python3 tests/_torch_ransac_devices.py [--frames 10] [--out FILE]

Drives each mode of `rso_torch.synthetic.mode_config` over the bench scene
of chip_smoke.py on the card, and steps each frame again on the CPU from the
card's state (the same inputs chip_smoke.py's CPU re-runs take).  For each
frame it reports:

  * which StepResult fields differ between the devices (integers: how many
    elements; floats: the largest absolute difference), and whether a second
    card step from the same state equals the first (determinism);
  * the first of the step's stage calls (pyramid, detection, stereo
    matching, tracking, the filter) whose outputs differ, and whether its
    inputs were equal;
  * the filter on those inputs in seven variants: the plain path
    (`ransac.ransac_fundamental_torch`) with arithmetic in float32 (the
    port's, `ransac.PREC`) or float64, null vectors from kernel 4 or from its
    twin on the card, and the CPU; and the RANSAC kernel (float32, the
    engine's filter on the card).  Per variant: the winning hypothesis and
    its inlier count per eye, how many of the 256 hypotheses reach that
    count, the refit's count, and the tracked count the filter leaves;
  * for the card's variants against the CPU's in the same arithmetic: how
    many hypotheses' inlier counts differ, the count the card gives the
    CPU's winner, and the final model's relative difference;
  * the float32 Sampson distances' rounding error near the 1 px gate: the
    CPU's winning model scored in float32 and in float64.

First it prints, for the Shi-Tomasi response of bench frame 0 on both
devices, how many elements of each intermediate differ.

Needs a CUDA device and imports neither jax nor rso.  Prints one line per
frame and writes everything to --out as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rso_torch import engine as E                          # noqa: E402
from rso_torch import random as rrandom                    # noqa: E402
from rso_torch import kernels as K                         # noqa: E402
from rso_torch.solver import ransac as R                   # noqa: E402
from rso_torch.synthetic import mode_config, synthetic_config  # noqa: E402

H, W = 376, 1241
MODES = ("default", "fast_orb_rbr_win", "klt_sad_sad", "orb_bf_bf",
         "adaptive_nms")
# the engine's stage calls, compared between the devices in call order
STAGES = ("build_pyramid", "detect_features", "match_left_right",
          "track_interframe", "ransac_fundamental")
VARIANTS = [(prec, nv, dev) for prec in ("f32", "f64")
            for nv, dev in (("kernel", "cuda"), ("twin", "cuda"),
                            ("twin", "cpu"))] + [("f32", "ransac", "cuda")]
# the card's variants each arithmetic has
CARD = {"f32": ("kernel", "twin", "ransac"), "f64": ("kernel", "twin")}


def _config(mode):
    """chip_smoke.py's configuration of each mode."""
    if mode == "default":
        return synthetic_config()
    return mode_config(mode, upright=mode != "fast_orb_rbr_win")


def _summary(scores, refit, res, mask):
    best = scores.argmax(-1)
    top = scores.max(-1).values
    both = res.inliers[0] & res.inliers[1]
    tracked = torch.where(res.ok[0] & res.ok[1], both, mask)
    return dict(scores=scores.cpu(), best=best.tolist(), top=top.tolist(),
                n_top=(scores == top[:, None]).sum(-1).tolist(),
                refit=refit.tolist(), n_inliers=res.n_inliers.tolist(),
                ok=res.ok.tolist(), tracked=int(tracked.sum()),
                tracked_mask=tracked.cpu(), F=res.F.cpu())


def _keys(keys, dev):
    """The eyes' keys [2,2] on `dev` (the engine passes a FrameKeys)."""
    if isinstance(keys, rrandom.FrameKeys):
        keys = keys.keys(2)
    return keys.to(dev)


def _kernel(inp):
    """The engine's filter call on `inp` through the RANSAC kernel (its
    hypotheses' counts from the kernel's probe); returns its summary."""
    from rso_torch.kernels.ransac import ransac_probe

    (p1, p2, mask, keys), kw = inp
    res, probe = ransac_probe(p1, p2, mask, _keys(keys, p1.device), **kw)
    H = kw["n_iters"]
    return _summary(probe["scores"][:, :H], probe["scores"][:, H],
                    R.RansacResult(*res), mask)


def _filter(inp, dev, prec, twin):
    """The engine's filter call on `inp` moved to `dev`, the plain path in
    `prec`, with the null vectors from the twin if `twin`; returns its
    summary."""
    (p1, p2, mask, keys), kw = inp
    kw = dict(kw)
    p1, p2, mask = (t.to(dev) for t in (p1, p2, mask))
    keys = _keys(keys, dev)
    seen = []
    sampson = R._sampson_sq

    def spy(*a):
        out = sampson(*a)
        seen.append(out)
        return out

    saved = R.PREC, R.nullvec9_auto, R._sampson_sq
    R.PREC = torch.float64 if prec == "f64" else torch.float32
    R.nullvec9_auto = K.nullvec9_torch if twin else K.nullvec9_auto
    R._sampson_sq = spy
    try:
        res = R.ransac_fundamental_torch(p1, p2, mask, keys, **kw)
    finally:
        R.PREC, R.nullvec9_auto, R._sampson_sq = saved
    d2h, d2r = seen                            # hypotheses, then the refit
    thr2 = kw["threshold"] ** 2
    scores = (mask & (d2h <= thr2)).sum(-1)    # [E,H]
    score_r = (mask & (d2r <= thr2)).sum(-1)
    return _summary(scores, score_r, res, mask)


def _gate_error(inp, F):
    """|d2_f32 - d2_f64| of the CPU's winning model F [E,3,3], over the
    tracks with 0.5 <= d2_f64 <= 2 px^2: (count, max, median)."""
    (p1, p2, mask, _), _ = inp
    p1, p2, mask = p1.cpu(), p2.cpu(), mask.cpu()
    d32 = R._sampson_sq(F, p1, p2)
    d64 = R._sampson_sq(F.double(), p1.double(), p2.double())
    near = mask & (d64 >= 0.5) & (d64 <= 2.0)
    err = (d32.double() - d64).abs()[near]
    if err.numel() == 0:
        return (0, None, None)
    return (int(err.numel()), err.max().item(), err.median().item())


def shi_tomasi_parting(img):
    """The intermediates of detect.shi_tomasi_response on the card and on
    the CPU for one image: per intermediate, how many elements differ.
    `torch_sqrt` is PyTorch's own root of the radicand, which the port
    replaces with detect._sqrt_rn; `response` is the port's."""
    import numpy as np

    from rso_torch.frontend.detect import _box_sum, _shift2d, shi_tomasi_response

    def parts(x, win=4):
        gx = (_shift2d(x, 1, 0) - _shift2d(x, -1, 0)) * 0.5
        gy = (_shift2d(x, 0, 1) - _shift2d(x, 0, -1)) * 0.5
        inv_n = float(np.float32(1.0 / (2 * win + 1) ** 2))
        gxx = _box_sum(gx * gx, win) * inv_n
        gyy = _box_sum(gy * gy, win) * inv_n
        gxy = _box_sum(gx * gy, win) * inv_n
        tr_half = 0.5 * (gxx + gyy)
        d = gxx - gyy
        radicand = torch.clamp(0.25 * (d * d) + gxy * gxy, min=0.0)
        return dict(gx=gx, gy=gy, gxx=gxx, gyy=gyy, gxy=gxy, tr_half=tr_half,
                    d=d, radicand=radicand, torch_sqrt=torch.sqrt(radicand),
                    response=shi_tomasi_response(x, win))

    g, c = parts(img.cuda()), parts(img.cpu())
    return {k: int((g[k].cpu() != c[k]).sum()) for k in g}


def _field_diffs(a, b):
    out = {}
    for name, x, y in zip(a._fields, a, b):
        x, y = x.cpu(), y.cpu()
        if x.dtype.is_floating_point:
            d = (x.double() - y.double()).abs().max().item() if x.numel() else 0.0
            if d > 0:
                out[name] = d
        elif not torch.equal(x, y):
            out[name] = int((x != y).sum())
    return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _leaves(y)]
    if isinstance(x, dict):
        return _leaves(list(x.values()))
    return []


def _parting(log_g, log_c):
    """The first stage call whose outputs differ between the devices: its
    name, its index among the step's stage calls, whether its inputs were
    equal, and per differing output leaf (number of differing elements, the
    largest difference where both are finite)."""
    for n, ((name, a_g, kw_g, o_g), (_, a_c, kw_c, o_c)) in enumerate(
            zip(log_g, log_c)):
        diff = {}
        for k, (x, y) in enumerate(zip(_leaves(o_g), _leaves(o_c))):
            x = x.cpu()
            if not torch.equal(x, y):
                ne = x != y
                fin = ne & torch.isfinite(x.double()) & torch.isfinite(y.double())
                d = (x.double() - y.double())[fin].abs()
                diff[k] = (int(ne.sum()), d.max().item() if d.numel() else None)
        if diff:
            ins = _leaves((a_g, kw_g)), _leaves((a_c, kw_c))
            return dict(stage=name, call=n, outputs_differ=diff,
                        inputs_equal=all(torch.equal(x.cpu(), y)
                                         for x, y in zip(*ins)))
    return None


def run(mode, seq, n_frames, card="cuda"):
    """The rows of `mode`; `card` is the device that stands for the card."""
    cfg = _config(mode)
    cuda, cpu = torch.device(card), torch.device("cpu")
    step_g = E.make_step(cfg, seq.cam.to(cuda), H, W)
    step_c = E.make_step(cfg, seq.cam.to(cpu), H, W)
    log = []
    saved = {name: getattr(E, name) for name in STAGES}

    def spy(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            log.append((name, a, kw, out))
            return out
        return call

    for name, fn in saved.items():
        setattr(E, name, spy(name, fn))
    rows = []
    try:
        st = E.init_state(cfg, (H, W), device=cuda)
        for i in range(n_frames):
            left, right = (torch.from_numpy(x) for x in seq.frames[i])
            log.clear()
            nxt, rg = step_g(st, left.to(cuda), right.to(cuda))
            log_g = list(log)
            _, rg2 = step_g(st, left.to(cuda), right.to(cuda))
            log.clear()
            _, rc = step_c(E._tree_map(lambda t: t.cpu(), st), left, right)
            log_c = list(log)
            in_g, in_c = ([(a, kw) for name, a, kw, _ in lg
                           if name == "ransac_fundamental"][0]
                          for lg in (log_g, log_c))
            row = dict(mode=mode, frame=i,
                       tracked_cuda=int(rg.tracked_feats_from_last_frame),
                       tracked_cpu=int(rc.tracked_feats_from_last_frame),
                       fields_differ=_field_diffs(rg, rc),
                       card_repeat_equal=not _field_diffs(rg, rg2),
                       parts_at=_parting(log_g, log_c))
            v = {f"{p}/{nv}/{d}": _kernel(in_g) if nv == "ransac" else
                 _filter(in_c if d == "cpu" else in_g,
                         cpu if d == "cpu" else cuda, p, nv == "twin")
                 for p, nv, d in VARIANTS}
            for p in ("f32", "f64"):
                c = v[f"{p}/twin/cpu"]
                for nv in CARD[p]:
                    g = v[f"{p}/{nv}/cuda"]
                    row[f"{p} {nv}: hypotheses differing from cpu"] = int(
                        (g["scores"] != c["scores"]).sum())
                    row[f"{p} {nv}: tracked mask differs"] = not torch.equal(
                        g["tracked_mask"], c["tracked_mask"])
                    # the final model's largest difference, relative to
                    # its largest entry, up to sign
                    dF = torch.minimum((g["F"] - c["F"]).abs().amax((1, 2)),
                                       (g["F"] + c["F"]).abs().amax((1, 2)))
                    row[f"{p} {nv}: final F relative difference"] = (
                        dF / c["F"].abs().amax((1, 2))).tolist()
                    # the count the card gives the CPU's winner, per eye
                    row[f"{p} {nv}: card's count at cpu's winner"] = [
                        int(g["scores"][e, b]) for e, b in enumerate(c["best"])]
            row["variants"] = {k: {n: x for n, x in s.items()
                                   if n not in ("scores", "tracked_mask", "F")}
                               for k, s in v.items()}
            row["f32 gate error (n, max, median) px^2"] = _gate_error(
                in_c, v["f32/twin/cpu"]["F"])
            rows.append(row)
            tr = " ".join(f"{k}={s['tracked']}" for k, s in v.items())
            print(f"{mode} {i}: tracked cuda {row['tracked_cuda']} cpu "
                  f"{row['tracked_cpu']} | parts at {row['parts_at']}"
                  f" | card repeat equal {row['card_repeat_equal']} | "
                  f"differ {row['fields_differ']} | filter {tr} | "
                  f"hyp. differing f32 kernel/twin/ransac "
                  f"{row['f32 kernel: hypotheses differing from cpu']}/"
                  f"{row['f32 twin: hypotheses differing from cpu']}/"
                  f"{row['f32 ransac: hypotheses differing from cpu']} f64 "
                  f"{row['f64 kernel: hypotheses differing from cpu']}/"
                  f"{row['f64 twin: hypotheses differing from cpu']} | "
                  f"gate err {row['f32 gate error (n, max, median) px^2']}",
                  flush=True)
            st = nxt
    finally:
        for name, fn in saved.items():
            setattr(E, name, fn)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default="chiprun_out/ransac_devices.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import _torch_card as card

    seq = card.bench_scene(card.N_FRAMES)   # its frames
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale

    img = build_pyramid(to_grayscale(torch.from_numpy(seq.frames[0][0])), 1)[0]
    print("shi_tomasi_response, bench frame 0 left, elements that differ "
          f"between the card and the CPU: {shi_tomasi_parting(img)}", flush=True)
    rows = []
    for mode in args.modes.split(","):
        rows += run(mode, seq, args.frames)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
