"""The reduction of a profiler trace and the readers that use it."""
import types

import pytest

import _cells  # noqa: F401
from vobench import trace
from vobench.metrics import device_idle_pct, own_kernels_pct, own_kernels_roofline


class Ev:
    def __init__(self, name, kind, s, t, annotation=False):
        self._n, self._k, self._s, self._t, self._a = name, kind, s, t, annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._k}"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_base_names():
    b = trace.base_name
    assert b("void at::native::vectorized_elementwise_kernel<4, F, A>(int, F, A)") \
        == "vectorized_elementwise_kernel"
    assert b("corner_response_kernel(float const*, int const*, float*, int, int, int)") \
        == "corner_response_kernel"
    assert b("void (anonymous namespace)::foo<int>(int)") == "foo"
    assert b("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"


def test_reduce_busy_gaps_and_spans():
    us = 1000
    spans = [(0, 100 * us, "process_frame"), (100 * us, 200 * us, "read_pose")]
    ev = [
        Ev("process_frame", "CUDA", 0, 200 * us, annotation=True),
        Ev("corner_response_kernel(float const*)", "CUDA", 10 * us, 30 * us),
        Ev("stereo_sad_kernel(float const*)", "CUDA", 25 * us, 40 * us),
        Ev("void at::native::reduce_kernel<1>(x)", "CUDA", 42 * us, 110 * us),
        Ev("track_sad_kernel(float const*)", "CUDA", 150 * us, 170 * us),
    ]
    t = trace.reduce(ev, spans, window_s=200e-6)
    assert t.busy_s == pytest.approx((40 - 10 + 68 + 20) * 1e-6)
    assert t.kernel_n == {"corner_response_kernel": 1, "stereo_sad_kernel": 1,
                          "reduce_kernel": 1, "track_sad_kernel": 1}
    gaps = dict(t.idle_gaps)
    assert gaps["process_frame (short)"] == pytest.approx(2e-6)     # 40 -> 42
    assert gaps["read_pose"] == pytest.approx(40e-6)                # 110 -> 150
    assert trace.reduce([Ev("x", "CPU", 0, 1)], spans, 1.0) is None


def test_spans_are_kept_only_while_traced():
    with trace.span("outside"):
        pass
    assert trace._SPANS is None
    trace._SPANS = []
    try:
        with trace.span("inside"):
            pass
        (t0, t1, name), = trace._SPANS
        assert name == "inside" and t1 >= t0
    finally:
        trace._SPANS = None


def test_readers_over_a_trace():
    t = trace.Trace(busy_s=0.5, window_s=2.0,
                    kernel_s={"corner_response_kernel": 0.01, "nullvec9_kernel": 0.002,
                              "reduce_kernel": 0.2},
                    kernel_n={"corner_response_kernel": 600, "nullvec9_kernel": 200,
                              "reduce_kernel": 9000},
                    device_ops=[], idle_gaps=[])
    rec = types.SimpleNamespace(trace=t, lanes=1, trace_frames=50,
                                window_frames=2000, window_s=20.0)
    cell = {"cfg": {"camera": {"height": 376, "width": 1241}},
            "ini": str(_cells.ROOT / "vobench" / "configs" / "kitti.ini")}
    # 10 ms of device work a frame in the slice, 10 ms a frame untraced
    assert device_idle_pct.read(rec, cell) == pytest.approx(0.0)
    rec.window_s = 40.0
    assert device_idle_pct.read(rec, cell) == pytest.approx(50.0)
    assert own_kernels_pct.read(rec, cell) == pytest.approx(100 * 0.012 / 0.5)
    from vobench import roofline
    f = roofline.frame_launches(376, 1241, 500, 3)
    least = 600 * sum(f["corner_response_kernel"]) / 6 + 200 * sum(f["nullvec9_kernel"]) / 2
    assert own_kernels_roofline.read(rec, cell) == pytest.approx(100 * least / 0.012)
    none = types.SimpleNamespace(trace=None, lanes=1, trace_frames=0)
    assert own_kernels_roofline.read(none, cell) is None
    assert device_idle_pct.read(none, cell) is None
