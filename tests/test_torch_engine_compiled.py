"""Engine's compiled step (rso_torch.graphs.CompiledStep) on the CPU.

On the CPU the compiled-step object runs the step eagerly through its
static buffers, each GN block writing its carry in place, as the graphs do
on the card.  Held against a plain make_step loop from the same first state
(an Engine whose steps are make_step's functions, so the accessors are the
same code): every field of every frame and every leaf of the state bit for
bit, at 160x240 with the default config, detect_every = 3 and the
precomputed steps; with repeat, the threshold and ID accessors, the
keyframe watermark and a checkpoint between frames; process_chunk against
process_frame; and a state or result the caller holds unchanged by later
steps.  The parity of the whole slice with rso stays with
test_torch_engine*.py and test_torch_modes_*.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rso_torch.engine import Engine, make_step
from rso_torch.graphs import CompiledStep, leaves, tree_clone
from rso_torch.io import load_state, save_state
from rso_torch.solver.robust_gn import HOST_READS
from rso_torch.synthetic import make_sequence, synthetic_config

H, W = 160, 240
N_FRAMES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FRAMES, n_points=1800, H=H, W=W)


def _frames(seq):
    return [(torch.from_numpy(l), torch.from_numpy(r)) for l, r in seq.frames]


def _config(every=1):
    cfg = synthetic_config()
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=every))


def _engines(cfg, seq):
    """(compiled, plain): the plain Engine's steps are make_step's eager
    functions, cached per key as the compiled ones are."""
    eng, plain = (Engine(cfg, seq.cam, device="cpu") for _ in range(2))
    steps = {}

    def plain_step(h, w, precomputed=None):
        key = (h, w, precomputed)
        if key not in steps:
            steps[key] = make_step(cfg, plain.cam, h, w,
                                   precomputed=precomputed)
        return steps[key]

    plain._get_step = plain_step
    return eng, plain


def _same(a, b, what):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b))):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"
    assert len(leaves(a)) == len(leaves(b))


def _same_result(a, b, what):
    for field, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: {field} differs"


@pytest.mark.parametrize("every", [1, 3])
def test_engine_equals_the_plain_step(seq, every):
    eng, plain = _engines(_config(every), seq)
    step = eng._get_step(H, W)
    assert isinstance(step, CompiledStep) and not step.capture
    HOST_READS.clear()
    for i, (left, right) in enumerate(_frames(seq)):
        _same_result(eng.process_frame(left, right),
                     plain.process_frame(left, right), f"frame {i}")
        _same(eng.state, plain.state, f"state after frame {i}")
    # detect_every reads its branch once a frame in each engine
    assert HOST_READS["detect_every"] == (2 * N_FRAMES if every > 1 else 0)
    assert step.n_graphs == 0


def test_engine_with_the_accessors_repeat_and_a_checkpoint(seq, tmp_path):
    eng, plain = _engines(_config(), seq)
    f = _frames(seq)
    path = str(tmp_path / "state.npz")

    def both(what, i, repeat=False):
        _same_result(eng.process_frame(*f[i], repeat=repeat),
                     plain.process_frame(*f[i], repeat=repeat), what)
        _same(eng.state, plain.state, f"{what}: state")

    both("frame 0", 0)
    both("frame 1", 1)
    for e in (eng, plain):
        e.set_fast_threshold(15)
    both("after set_fast_threshold", 2)
    both("repeat", 3, repeat=True)
    for e in (eng, plain):
        e.reset_ids()
    both("after reset_ids", 3)
    for e in (eng, plain):
        e.set_this_frame_as_kf()
    both("after set_this_frame_as_kf", 4)
    save_state(path, eng.state)
    for e in (eng, plain):
        e.state = load_state(path, e.cfg, (H, W), device="cpu")
    both("after a checkpoint load", 5)
    for e in (eng, plain):
        e.reset()
    both("after reset", 0)


@pytest.mark.parametrize("every", [1, 3])
def test_chunk_equals_frames(seq, every):
    """process_chunk(4) against 4 process_frame calls of the same compiled
    engine kind; a repeat after the chunk runs from the state before it."""
    cfg = _config(every)
    eng, per_frame = (Engine(cfg, seq.cam, device="cpu") for _ in range(2))
    f = _frames(seq)
    eng.process_frame(*f[0])
    per_frame.process_frame(*f[0])
    chunk = eng.process_chunk([x[0] for x in f[1:5]], [x[1] for x in f[1:5]])
    for i in range(4):
        want = per_frame.process_frame(*f[1 + i])
        _same_result(type(chunk)(*(t[i] for t in chunk)), want,
                     f"chunk frame {i}")
    _same(eng.state, per_frame.state, "state after the chunk")
    plain = Engine(cfg, seq.cam, device="cpu")
    plain.process_frame(*f[0])
    _same_result(eng.process_frame(*f[5], repeat=True),
                 plain.process_frame(*f[5]), "repeat after the chunk")


def test_held_state_and_result_are_not_changed(seq):
    eng = Engine(_config(), seq.cam, device="cpu")
    f = _frames(seq)
    eng.process_frame(*f[0])
    held_state = eng.state
    held_result = eng.process_frame(*f[1])
    copies = tree_clone(held_state), tree_clone(held_result)
    eng.process_frame(*f[2])
    eng.process_frame(*f[3])
    chunk = eng.process_chunk([x[0] for x in f[4:6]], [x[1] for x in f[4:6]])
    _same(held_state, copies[0], "held state")
    _same(held_result, copies[1], "held result")
    # a result from the chunk is its own, too
    copy = tree_clone(chunk)
    eng.process_frame(*f[0])
    _same(chunk, copy, "held chunk")
    # no returned tensor aliases the step's static buffers
    step = eng._get_step(H, W)
    static = {t.data_ptr() for v in step._variants.values()
              for t in leaves(v.state) + leaves(v.result)}
    assert not static & {t.data_ptr() for t in leaves(eng.state)
                         + leaves(held_result) + leaves(chunk)}


def test_precomputed_steps_equal_the_plain_step(seq):
    """process_precomputed with features, then with matches, against the
    plain precomputed steps, from the states the full step reached."""
    from rso_torch.frontend.detect import (detect_features, octave_budget,
                                           octave_k_slots)
    from rso_torch.frontend.pyramid import build_pyramid, to_grayscale

    cfg = _config()
    O = cfg.n_octaves
    Ks = octave_k_slots(cfg.detect.orb_nfeats, O, cfg.tpu.max_kps_per_octave,
                        cfg.tpu.octave_slot_decay)
    budgets = octave_budget(cfg.detect.orb_nfeats, O)
    full = Engine(cfg, seq.cam, device="cpu")
    eng, plain = _engines(cfg, seq)
    for i, (left, right) in enumerate(_frames(seq)[:3]):
        th = (full.state.fast_th if full.state is not None else
              torch.full((O,), cfg.detect.initial_FAST_threshold,
                         dtype=torch.int32))
        octs = []
        for o, (pl, pr) in enumerate(zip(build_pyramid(to_grayscale(left), O),
                                         build_pyramid(to_grayscale(right), O))):
            ok = torch.arange(Ks[o]) < budgets[o]
            fl, fr = (detect_features(p, cfg.detect, Ks[o], th[o], False,
                                      arc=cfg.tpu.fast_arc) for p in (pl, pr))
            octs.append((fl._replace(valid=fl.valid & ok),
                         fr._replace(valid=fr.valid & ok)))
        full.process_frame(left, right)
        lf, rf = [a for a, _ in octs], [b for _, b in octs]
        _same_result(eng.process_precomputed(lf, rf, img_hw=(H, W)),
                     plain.process_precomputed(lf, rf, img_hw=(H, W)),
                     f"feats frame {i}")
        m = [(np.flatnonzero(o.matches.valid.numpy()),
              o.matches.ridx.numpy()[o.matches.valid.numpy()])
             for o in full.state.prev.octaves]
        _same_result(
            eng.process_precomputed(lf, rf, matches=m, img_hw=(H, W)),
            plain.process_precomputed(lf, rf, matches=m, img_hw=(H, W)),
            f"matches frame {i}")
        _same(eng.state, plain.state, f"state after frame {i}")


@pytest.mark.parametrize("enabled", [True, False])
def test_the_collector_waits_while_a_step_is_captured(enabled):
    """A capture runs with the cyclic garbage collector off (a dead step's
    graphs destroyed inside it would invalidate it) and leaves the
    collector as it found it, an exception included."""
    import gc

    from rso_torch import graphs

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with graphs._no_gc():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(ValueError):
            with graphs._no_gc():
                raise ValueError
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
