"""Milliseconds a call in ``models.exact_gp.fit_ensemble_fused``, by its CUDA events."""
from port_bench.readings import span_ms_per_call

SPANS = ["models.exact_gp.fit_ensemble_fused"]


def read(t):
    return span_ms_per_call(t, SPANS[0])
