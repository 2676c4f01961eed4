"""95th percentile of the call time over every call of the traced run."""
from port_bench.readings import p95_ms


def read(t):
    return p95_ms(t.call_s)
