"""Share (%) of the H100's roofline that ``transport_apply`` reaches: the
least time of its outputs over the device time of the kernels its span
launched."""
from port_bench import counts
from port_bench.readings import roofline, shape

SPANS = ["transport.gpt.transport_apply"]


def read(t):
    E, n, Q, D, P = shape(t)
    return roofline(t, SPANS[0], counts.apply(E, n, Q, D, P))
