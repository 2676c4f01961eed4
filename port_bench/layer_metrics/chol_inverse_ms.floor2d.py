"""Milliseconds a call in ``transport.gpt.spd_inverse_elast_auto``, by its CUDA events."""
from port_bench.readings import span_ms_per_call

SPANS = ["transport.gpt.spd_inverse_elast_auto"]


def read(t):
    return span_ms_per_call(t, SPANS[0])
