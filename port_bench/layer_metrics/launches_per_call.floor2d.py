"""Kernel launches in the profiled stretch over its calls."""
from port_bench.readings import launches_per_call


def read(t):
    return launches_per_call(t)
