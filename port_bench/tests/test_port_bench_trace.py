"""The trace's reduction on a hand-made Chrome trace (times in µs)."""
import pytest

from port_bench import trace

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "call", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "span.a", "ts": 10, "dur": 30},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 10, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 50, "dur": 2,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "k2", "ts": 55, "dur": 5, "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "cp", "ts": 58, "dur": 10,
     "args": {"correlation": 3}},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
]


def test_reduction():
    r = trace.reduce_events(EVENTS, ["span.a", "span.missing"])
    assert r.busy_s == pytest.approx(23e-6)  # [20, 30] and [55, 68]
    assert r.kernels == 2  # the copy is device time, not a launch
    assert r.span_device_s == {"span.a": pytest.approx(10e-6), "span.missing": 0.0}
    assert r.span_calls == {"span.a": 1, "span.missing": 0}
    assert [n for n, _ in r.device_ops] == ["k1", "cp", "k2"]
    # the gap [30, 55] began while the host was inside span.a
    assert r.idle_gaps == [["span.a", pytest.approx(25e-6)]]


def test_no_device_record_reads_nothing():
    host_only = [e for e in EVENTS if e["cat"] not in trace.DEVICE_CATS]
    assert trace.reduce_events(host_only, []).busy_s == 0
