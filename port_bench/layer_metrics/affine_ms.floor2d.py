"""Milliseconds a call in ``models.affine.fit_batched``, by its CUDA events."""
from port_bench.readings import span_ms_per_call

SPANS = ["models.affine.fit_batched"]


def read(t):
    return span_ms_per_call(t, SPANS[0])
