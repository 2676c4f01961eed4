"""Launches of the fused LML kernel (value and gradient, and value only) a
call: the wrapper's own counter over the profiled calls."""
from port_bench.readings import counter_per_call

COUNTERS = ["ops.fused_lml.small_lml_value_grad_md.launches"]


def read(t):
    return counter_per_call(t, COUNTERS[0])
