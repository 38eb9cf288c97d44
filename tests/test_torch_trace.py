"""The program's tracers on the CPU (rso_torch.metrics.profiler).

PROFILER's host spans: each adds its seconds to `times[name]`, nested
spans inside their enclosing span's time; nothing recorded (and one
shared no-op span) while disabled; the engines' spans at their layer
boundaries.  STAGE_CLOCK: the CPU twin of csrc/graph_cond.cu's
stage_mark_kernel (the same arithmetic on the same table, the host's clock
for %globaltimer) over a few frames of Engine and of a 2-lane BatchEngine
at 160x240: every stage the path runs is charged, `gn_block` counts one
mark a GN block (GN_BLOCK = 1: the iterations the phases ran, for the
lanes the most of any lane), and poses, `valid` and `num_it` are bit for
bit the same with marks on and off.  The CUDA cases (a marked graph, the
graph with marks off, launches) are in test_torch_cuda.py.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from rso_torch.engine import Engine
from rso_torch.metrics import profiler as P
from rso_torch.metrics.profiler import PROFILER, STAGE_CLOCK, STAGES
from rso_torch.parallel import BatchEngine
from rso_torch.synthetic import make_sequence, synthetic_config

H, W = 160, 240
N_FRAMES = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of one thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracers():
    """PROFILER and STAGE_CLOCK cleared, and off again after the test."""
    PROFILER.clear()
    STAGE_CLOCK.reset()
    yield
    PROFILER.enabled = STAGE_CLOCK.on = False
    PROFILER.clear()
    STAGE_CLOCK.reset()


@pytest.fixture(scope="module")
def seqs():
    return [make_sequence(n_frames=N_FRAMES, n_points=1800, H=H, W=W, seed=s)
            for s in range(2)]


def _config(every=1):
    cfg = synthetic_config()
    return cfg.replace(tpu=dataclasses.replace(cfg.tpu, detect_every=every))


def test_spans_time_nested_calls():
    """Each span adds its seconds to times[name]; a nested span's time lies
    inside its enclosing span's, and all inside the caller's clock."""
    p = P.SpanProfiler()
    t0 = time.perf_counter_ns()
    with p.span("frame"):
        with p.span("a"):
            pass
        with p.span("b"):
            with p.span("c"):
                time.sleep(0.001)
    p.enter("frame")
    p.leave("frame")
    t1 = time.perf_counter_ns()
    t = p.times
    assert sorted(t) == ["a", "b", "c", "frame"]
    assert [len(t[k]) for k in ("a", "b", "c", "frame")] == [1, 1, 1, 2]
    assert 0.001 <= t["c"][0] <= t["b"][0]
    assert t["a"][0] + t["b"][0] <= t["frame"][0]
    assert sum(t["frame"]) <= (t1 - t0) * 1e-9


def test_disabled_spans_record_nothing():
    p = P.SpanProfiler(enabled=False)
    assert p.span("a") is p.span("b")
    with p.span("a"):
        with p.span("b"):
            pass
    p.enter("c")
    p.leave("c")
    assert not p.times
    assert PROFILER.enabled is False and STAGE_CLOCK.on is False


def test_host_mark_charges_the_previous_stage():
    """stage_mark_kernel's arithmetic: each mark charges the time since
    the previous one to the previous one's stage; `end` closes it."""
    a = np.zeros((2, len(STAGES) + 1), dtype=np.int64)
    i = {name: k for k, name in enumerate(STAGES)}
    for stage, now in (("_stg1", 100), ("_stg2", 130), ("_stg1", 150),
                       ("end", 200), ("_stg1", 1000), ("end", 1010)):
        P._host_mark(a, P._INDEX[stage], now)
    assert a[0, i["_stg1"]] == 30 + 50 + 10 and a[1, i["_stg1"]] == 3
    assert a[0, i["_stg2"]] == 20 and a[1, i["_stg2"]] == 1
    assert a[1, -1] == 0 and a[0].sum() - a[0, -1] == 110


def _inside(times, outer, inner, n):
    """Each of the n `outer` spans takes at least the time of the `inner`
    spans it encloses (inner: name -> spans an outer span)."""
    for i in range(n):
        held = sum(sum(times[name][i * k:(i + 1) * k])
                   for name, k in inner.items())
        assert held <= times[outer][i], (outer, i)


def test_engine_spans(seqs, tracers):
    """Engine's spans: processNewImagePair around each frame, with
    images_in and the compiled step's copies and launch inside it;
    process_chunk around a chunk, with the step's spans once a frame."""
    seq = seqs[0]
    eng = Engine(_config(), seq.cam, device="cpu")
    PROFILER.enabled = True
    for left, right in seq.frames[:2]:
        eng.process_frame(left, right)
    frame = dict(PROFILER.times)
    step = ("step.copy_in", "step.launch", "step.copy_out")
    assert {k: len(v) for k, v in frame.items()} == {
        "processNewImagePair": 2, "images_in": 2, **{k: 2 for k in step}}
    _inside(frame, "processNewImagePair",
            {"images_in": 1, **{k: 1 for k in step}}, 2)
    PROFILER.clear()
    eng.process_chunk([torch.from_numpy(f[0]) for f in seq.frames[2:4]],
                      [torch.from_numpy(f[1]) for f in seq.frames[2:4]])
    chunk = PROFILER.times
    assert {k: len(v) for k, v in chunk.items()} == {
        "process_chunk": 1, "images_in": 1, **{k: 2 for k in step}}
    _inside(chunk, "process_chunk", {"images_in": 1, **{k: 2 for k in step}},
            1)


@pytest.mark.parametrize("every", [1, 2])
def test_engine_stage_clock(seqs, tracers, every):
    """Every stage the path runs is charged (detect_every 2: propagate on
    the second and fourth frames), one gn_block mark an iteration run,
    and the results bit for bit the same with marks off."""
    seq, cfg = seqs[0], _config(every)
    runs = []
    for on in (False, True):
        STAGE_CLOCK.on = on
        eng = Engine(cfg, seq.cam, device="cpu")
        runs.append([eng.process_frame(l, r) for l, r in seq.frames])
    STAGE_CLOCK.on = False
    for off, on in zip(*runs):
        for field in ("pose", "valid", "num_it", "num_it_final", "error_code"):
            assert torch.equal(getattr(off, field), getattr(on, field)), field
    ns, marks = STAGE_CLOCK.settle()
    ran = {"propagate"} if every == 1 else set()
    assert set(marks) == set(STAGES) - ran
    assert all(ns[name] > 0 for name in marks)
    assert marks["_stg1"] == marks["update"] == N_FRAMES
    assert marks["propagate"] == (N_FRAMES // 2 if every == 2 else 0)
    assert marks["_stg2"] == N_FRAMES - marks["propagate"]
    assert marks["gn_block"] == sum(int(r.num_it) + int(r.num_it_final)
                                    for r in runs[1])
    assert marks["_stg5"] == 3 * N_FRAMES
    # a second settle adds nothing; the tables were zeroed
    assert STAGE_CLOCK.settle()[1] == marks


def test_marks_are_part_of_the_variant_key(seqs, tracers):
    """Turning marks on makes (and runs) a second variant of the step;
    turning them off again goes back to the first."""
    seq = seqs[0]
    eng = Engine(_config(), seq.cam, device="cpu")
    eng.process_frame(*seq.frames[0])
    step = eng._get_step(H, W)
    first = list(step._variants.values())
    STAGE_CLOCK.on = True
    eng.process_frame(*seq.frames[1])
    assert len(step._variants) == 2
    STAGE_CLOCK.on = False
    eng.process_frame(*seq.frames[2])
    assert list(step._variants.values())[:1] == first
    assert STAGE_CLOCK.settle()[1]["_stg1"] == 1


def test_batch_stage_clock(seqs, tracers):
    """A 2-lane BatchEngine (the step under torch.func.vmap): one mark for
    all lanes, gn_block counting the blocks the loop ran for the lanes
    (the most iterations of any lane), results bit for bit with marks
    off."""
    cfg = _config()
    lefts = [np.stack([s.frames[i][0] for s in seqs]) for i in range(N_FRAMES)]
    rights = [np.stack([s.frames[i][1] for s in seqs]) for i in range(N_FRAMES)]
    runs = []
    for on in (False, True):
        STAGE_CLOCK.on = on
        be = BatchEngine(cfg, seqs[0].cam, 2, H, W, device="cpu")
        runs.append([be.process_frames(l, r) for l, r in zip(lefts, rights)])
    STAGE_CLOCK.on = False
    for off, on in zip(*runs):
        for field in ("pose", "valid", "num_it", "num_it_final"):
            assert torch.equal(getattr(off, field), getattr(on, field)), field
    ns, marks = STAGE_CLOCK.settle()
    assert set(marks) == set(STAGES) - {"propagate"}
    assert marks["_stg1"] == N_FRAMES
    assert marks["gn_block"] == sum(int(r.num_it.max()) + int(r.num_it_final.max())
                                    for r in runs[1])
    PROFILER.enabled = True
    be.process_chunk(np.stack(lefts[:2], 1), np.stack(rights[:2], 1))
    t = PROFILER.times
    assert [len(t[k]) for k in ("process_chunk", "images_in",
                                "step.launch")] == [1, 1, 2]
    _inside(t, "process_chunk", {"images_in": 1, "step.launch": 2}, 1)


@pytest.mark.parametrize("ba", [False, True], ids=["vo", "ba"])
def test_demo_profile_reports_spans_and_stages(monkeypatch, capsys, tmp_path,
                                               ba):
    """rso-demo --profile: the host spans' report (with --ba, a span around
    each VOWithBA frame), then ms a frame by stage over the frames after
    the first; both tracers off after it."""
    import functools

    import rso_torch.synthetic as S
    from rso_torch.cli import demo

    monkeypatch.setattr(S, "make_sequence",
                        functools.partial(S.make_sequence, H=H, W=W))
    rc = demo.main(["--synthetic", "--frames", "3", "--profile",
                    "--out", str(tmp_path / "traj.txt")]
                   + ["--ba"] * ba, device="cpu")
    out = capsys.readouterr().out
    assert rc == 0
    assert "processNewImagePair" in out and "step.launch" in out
    assert ("ba.process_frame" in out) == ba
    assert "stage clock over 2 frames after the first" in out
    for name in ("_stg1", "gn_block", "update", "all stages"):
        assert name in out
    assert PROFILER.enabled is False and STAGE_CLOCK.on is False
