"""95th percentile, over every call of the window, of the time from a
call's start to the host holding its min|det J_Φ|."""
from port_bench.readings import p95_ms


def read(w):
    return p95_ms(w.call_s)
