"""Share (%) of the H100's roofline that the small Cholesky and inverse
reach: the least time of E (n, n) factors and inverses over the device
time of the kernels its span launched."""
from port_bench import counts
from port_bench.readings import roofline, shape

SPANS = ["transport.gpt.spd_inverse_elast_auto"]


def read(t):
    E, n, _, _, _ = shape(t)
    return roofline(t, SPANS[0], counts.chol_inverse(E, n))
