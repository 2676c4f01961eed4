"""Milliseconds a call in ``transport.gpt.transport_apply``, by its CUDA events."""
from port_bench.readings import span_ms_per_call

SPANS = ["transport.gpt.transport_apply"]


def read(t):
    return span_ms_per_call(t, SPANS[0])
