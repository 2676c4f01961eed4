"""The readers of the program's own spans and tallies (``program_spans.py``):
the nine metrics on a hand-made run, the whole path on the CPU with the
program's spans, and nothing read from a program without them."""
import sys
from types import SimpleNamespace

import pytest
import torch

from port_bench import program, program_spans, readings, spec

SPAN_METRICS = {
    "condition_ms.floor2d": "gpt.condition",
    "apply_posterior_ms.floor2d": "gpt.apply.posterior",
    "apply_jacobian_ms.floor2d": "gpt.apply.jacobian",
    "apply_pushforward_ms.floor2d": "gpt.apply.pushforward",
}
HOST_METRICS = {
    "enqueue_ms.floor2d": "gpt.transport_batched",
    "lbfgs_direction_host_ms.refit": "exact_gp.lbfgs.direction",
    "lbfgs_search_host_ms.refit": "exact_gp.lbfgs.search",
    "lbfgs_update_host_ms.refit": "exact_gp.lbfgs.update",
}
USEFUL = "exact_gp.lbfgs.useful_candidate_lanes"
LANES = "exact_gp.lbfgs.candidate_lanes"


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No reading kept and the program's spans off, before and after."""
    lu = program.module("utils.logging_utils")
    monkeypatch.setattr(program_spans, "_started", False)
    monkeypatch.setattr(program_spans, "_reading", None)
    monkeypatch.setattr(program_spans, "_reading_of", None)
    lu.spans(False)
    lu.collect()
    yield
    lu.spans(False)
    lu.collect()


def _traced(calls):
    return readings.Traced({}, {}, 8, [0.01] * calls, {}, 0, 0.0)


def _rec(name, call, host, device):
    return SimpleNamespace(name=name, call=call, host_ms=host, device_ms=device)


def _reader(name):
    return spec.module("layer_metrics", name)


def _kept(monkeypatch, reading, t):
    """``reading`` as if run ``t`` had collected it (the readers loaded,
    and the spans off again)."""
    for m in list(SPAN_METRICS) + list(HOST_METRICS) + ["search_useful_share.refit"]:
        _reader(m)
    program.module("utils.logging_utils").spans(False)
    monkeypatch.setattr(program_spans, "_started", False)
    monkeypatch.setattr(program_spans, "_reading", reading)
    monkeypatch.setattr(program_spans, "_reading_of", t)


def test_the_nine_readers_on_a_hand_made_run(monkeypatch):
    # two window calls; each span twice in the first, once in the second
    calls = []
    for call in range(2):
        recs = []
        for k, span in enumerate(list(SPAN_METRICS.values()) + list(HOST_METRICS.values())):
            for _ in range(2 - call):
                recs.append(_rec(span, call, host=1.0 + k, device=0.5 + k))
        calls.append(recs)
    t = _traced(2)
    _kept(monkeypatch, program_spans.Reading(calls, {USEFUL: 30, LANES: 120}), t)
    for k, (metric, span) in enumerate(list(SPAN_METRICS.items())):
        assert _reader(metric).read(t) == pytest.approx(3 * (0.5 + k) / 2), metric
    for k, (metric, span) in enumerate(list(HOST_METRICS.items()), len(SPAN_METRICS)):
        assert _reader(metric).read(t) == pytest.approx(3 * (1.0 + k) / 2), metric
    assert _reader("search_useful_share.refit").read(t) == pytest.approx(25.0)
    # another run reads nothing of it, nor a run with more calls than it holds
    assert all(_reader(m).read(_traced(2)) is None for m in {**SPAN_METRICS, **HOST_METRICS})
    t3 = _traced(3)
    _kept(monkeypatch, program_spans.Reading(calls, {USEFUL: 30, LANES: 120}), t3)
    assert all(_reader(m).read(t3) is None for m in {**SPAN_METRICS, **HOST_METRICS})


def test_nothing_read_without_events_or_tallies(monkeypatch):
    calls = [[_rec("gpt.condition", 0, 1.0, None), _rec("gpt.transport_batched", 0, 2.0, None)]]
    t = _traced(1)
    _kept(monkeypatch, program_spans.Reading(calls, {LANES: 0}), t)
    assert _reader("condition_ms.floor2d").read(t) is None  # CPU work: no CUDA events
    assert _reader("apply_posterior_ms.floor2d").read(t) is None  # no such record
    assert _reader("enqueue_ms.floor2d").read(t) == pytest.approx(2.0)
    assert _reader("search_useful_share.refit").read(t) is None


def _floor_case(E=4, n=8, Q=16):
    from gaussian_process_transportation_tpu_torch import kernels as K

    g = torch.Generator().manual_seed(0)
    S = torch.rand(n, 2, generator=g)
    targets = S + 0.1 * torch.randn(E, n, 2, generator=g)
    X, dX = torch.rand(Q, 2, generator=g), 0.01 * torch.randn(Q, 2, generator=g)
    kern = K.Constant(1.0) * K.RBF(torch.ones(2)) + K.White(0.01)
    return kern, S, targets, X, dX


def test_the_program_spans_read_on_the_cpu():
    torch.set_num_threads(1)
    gpt = program.module("transport.gpt")
    lu = program.module("utils.logging_utils")
    exact_gp = program.module("models.exact_gp")
    case = _floor_case()
    gpt.fit_and_transport_batched(*case)  # before start(): not counted
    assert program_spans.start() and lu.spans_on()
    kern, S, targets = case[:3]  # a fit outside an entry call: no window call
    exact_gp.fit_ensemble_fused(kern, S.expand(4, 8, 2), targets - S, n_restarts=1, maxiter=1)
    for _ in range(3):  # the window
        gpt.fit_and_transport_batched(*case)
    gpt.fit_and_transport_batched_opt(*case, maxiter=2)  # after it (the profiled stretch)
    t = _traced(3)
    r = program_spans.reading(t)
    assert not lu.spans_on() and len(r.calls) == 3
    assert [c[0].name for c in r.calls] == ["gpt.transport_batched"] * 3
    assert _reader("enqueue_ms.floor2d").read(t) > 0
    assert _reader("condition_ms.floor2d").read(t) is None  # the CPU has no events
    assert 0 < _reader("search_useful_share.refit").read(t) <= 100  # the tallies are whole
    assert _reader("lbfgs_search_host_ms.refit").read(t) is None  # no fit in the window
    # the next run in the process: its spans were never turned on, so it reads nothing
    assert program_spans.reading(_traced(3)) is None
    assert _reader("enqueue_ms.floor2d").read(_traced(3)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(program_spans, "_logging_utils", lambda: None)
    assert program_spans.start() is False
    t = _traced(1)
    for m in list(SPAN_METRICS) + list(HOST_METRICS) + ["search_useful_share.refit"]:
        assert _reader(m).read(t) is None, m


def test_a_reader_turns_the_spans_on_when_loaded(monkeypatch):
    lu = program.module("utils.logging_utils")
    key = "port_bench.layer_metrics._condition_ms_floor2d"
    monkeypatch.delitem(sys.modules, key, raising=False)
    assert not lu.spans_on()
    spec.module("layer_metrics", "condition_ms.floor2d")
    assert lu.spans_on() and program_spans._started
